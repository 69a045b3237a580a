"""Standard-vs-delta comparison with hard bound verification.

    python -m ebcc_tpu_torch.scripts.delta_compression_test [STACK.npy]
        [--error 0.5] [--levels 6] [--device cpu]

The port of ``scripts/delta_compression_test.py`` (the reference's
delta_compression_test.py:25-199): runs the direct pointwise compressor
slice by slice and the delta chain over a multi-level stack, holds
``|x - x_hat| <= eb`` at every point, prints a PASS/FAIL line per method
and exits 1 on a violation.  Without an input, ``--levels`` synthetic
240x480 levels.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..models.delta import DeltaCompressor
from ..models.direct import DirectCompressor
from . import common


def synthetic_stack(levels: int) -> np.ndarray:
    """The JAX script's synthetic 240x480 levels (seed 0): each level 0.97
    of the one above plus N(0, 0.3) noise."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:240, 0:480]
    base = 260 + 25 * np.sin(y / 240 * np.pi) * np.cos(x / 480 * np.pi)
    out = [base.astype(np.float32)]
    for _ in range(levels - 1):
        out.append(out[-1] * 0.97 +
                   rng.normal(0, 0.3, base.shape).astype(np.float32))
    return np.stack(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ebcc_tpu_torch.scripts.delta_compression_test",
        description=__doc__.split("\n\n")[0])
    p.add_argument("input", nargs="?", default=None,
                   help=".npy stack [L, H, W]; synthetic if omitted")
    p.add_argument("--error", type=float, default=0.5)
    p.add_argument("--levels", type=int, default=6)
    common.add_device_args(p, data=False)
    args = p.parse_args(argv)
    common.resolve_device(args.device)  # raises without a card

    if args.input:
        stack = np.load(args.input).astype(np.float32)
        stack = stack.reshape(-1, stack.shape[-2], stack.shape[-1])
    else:
        stack = synthetic_stack(args.levels)
    eb = np.full_like(stack, args.error)

    ok = True
    for name in ("standard", "delta"):
        t0 = time.perf_counter()
        if name == "standard":
            direct = DirectCompressor(base_cr=100, device=args.device)
            blobs = [direct.compress(stack[i], eb[i])
                     for i in range(len(stack))]
            size = sum(map(len, blobs))
            rec = np.stack([direct.decompress(b) for b in blobs])
        else:
            comp = DeltaCompressor(base_cr=100, device=args.device)
            blob = comp.compress(stack, eb)
            size = len(blob)
            rec = comp.decompress(blob)
        dt = time.perf_counter() - t0
        viol = int(np.sum(np.abs(rec - stack) > eb))
        cr = stack.nbytes / size
        status = "PASS" if viol == 0 else "FAIL"
        ok &= viol == 0
        print(f"{name:10s} CR={cr:7.1f}x  max_err="
              f"{float(np.abs(rec - stack).max()):.4g}  violations={viol}  "
              f"({dt:.1f}s)  {status}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
