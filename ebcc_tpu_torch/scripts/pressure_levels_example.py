"""Per-pressure-level compression example.

    python -m ebcc_tpu_torch.scripts.pressure_levels_example [STACK.npy]
        [--ratio 1.0] [--rel-bound 0.01] [--device cpu]

The port of ``scripts/pressure_levels_example.py`` (the reference's
pressure_levels_ebcc_example.py:45-135): compress a [L, H, W] stack of
pressure levels level by level with the direct pointwise compressor,
report each level's CR and hold each level to its bound.  Without an
input, 8 synthetic 240x480 levels.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..models.direct import DirectCompressor
from . import common


def synthetic_stack() -> np.ndarray:
    """The JAX script's 8 synthetic levels of 240x480 (seed 1)."""
    rng = np.random.default_rng(1)
    y, x = np.mgrid[0:240, 0:480]
    return np.stack([
        (250 + 10 * lvl + 20 * np.sin(y / 240 * np.pi + lvl) *
         np.cos(x / 480 * np.pi)).astype(np.float32) +
        rng.normal(0, 0.2, (240, 480)).astype(np.float32)
        for lvl in range(8)])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ebcc_tpu_torch.scripts.pressure_levels_example",
        description=__doc__.split("\n\n")[0])
    p.add_argument("input", nargs="?", default=None)
    p.add_argument("--ratio", type=float, default=1.0)
    p.add_argument("--rel-bound", type=float, default=0.01,
                   help="per-level bound = rel * (max - min)")
    common.add_device_args(p, data=False)
    args = p.parse_args(argv)
    common.resolve_device(args.device)  # raises without a card

    stack = (np.load(args.input).astype(np.float32) if args.input
             else synthetic_stack())
    comp = DirectCompressor(base_cr=100, ratio=args.ratio,
                            device=args.device)
    total_in = total_out = 0
    for lvl in range(stack.shape[0]):
        data = stack[lvl]
        eb = np.full_like(data, args.rel_bound * (data.max() - data.min()))
        blob = comp.compress(data, eb)
        rec = comp.decompress(blob)
        viol = int(np.sum(np.abs(rec - data) > eb))
        total_in += data.nbytes
        total_out += len(blob)
        print(f"level {lvl:2d}: CR={data.nbytes / len(blob):7.1f}x  "
              f"violations={viol}")
        if viol:
            raise AssertionError(f"level {lvl}: {viol} points past the "
                                 "bound")
    print(f"total: CR={total_in / total_out:.1f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
