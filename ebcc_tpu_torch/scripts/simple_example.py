"""Minimal direct-compressor example.

    python -m ebcc_tpu_torch.scripts.simple_example [--device cpu]

The port of ``scripts/simple_example.py`` (parity with the reference's
simple_ebcc_example.py:34-56): one variable, a pointwise bound of 1 % of
the data range everywhere, ``DirectCompressor(base_cr=100)`` compress and
decompress, the CR and the bound check.  The frame is the one
``$EBCC_REFERENCE_FRAME`` names, else the synthetic 721x1440 field.  A
point past its bound fails the run.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..models.direct import DirectCompressor
from . import common


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ebcc_tpu_torch.scripts.simple_example",
        description=__doc__.split("\n\n")[0])
    common.add_device_args(p, data=False)
    args = p.parse_args(argv)
    common.resolve_device(args.device)  # raises without a card

    data = common.reference_or_synthetic()
    # bound: 1% of the data range, everywhere
    eb = np.full_like(data, 0.01 * (data.max() - data.min()))
    comp = DirectCompressor(base_cr=100, device=args.device)
    blob = comp.compress(data, eb)
    rec = comp.decompress(blob)

    viol = int(np.sum(np.abs(rec - data) > eb))
    print(f"original: {data.nbytes} B, compressed: {len(blob)} B, "
          f"CR = {data.nbytes / len(blob):.1f}x")
    print(f"max error: {np.abs(rec - data).max():.4f} "
          f"(bound {eb.flat[0]:.4f}), violations: {viol}")
    if viol:
        raise AssertionError(f"{viol} points past the bound")
    return 0


if __name__ == "__main__":
    sys.exit(main())
