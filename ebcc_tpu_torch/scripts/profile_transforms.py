"""Micro-benchmark of the device-side stages of the encode.

    python -m ebcc_tpu_torch.scripts.profile_transforms [--device cpu]

The port of ``scripts/profile_transforms.py`` at its shape (B = 8 frames
of 768x1472: N(0, 1) f32 frames and Laplace(0, 100) int32 coefficients,
seed 0; the codec's geometry of 5 levels, 22 planes, 8 chunks).  Prints
one JSON dict of best seconds of one call (best of 5 after a warm call;
CUDA events on a card, the host clock on the CPU) under the JAX script's
keys:

* ``dwt5``: the forward 5-level DWT (``ops/dwt.py``, plain torch);
* ``idwt5``: the inverse (the idwt kernel, ``csrc/idwt.cu``, on a card);
* ``scan_iter``: one candidate evaluation (one K1 call,
  ``csrc/fused_eval.cu``: truncated recon, inverse DWT, error max and
  violation count), as the searches make it;
* ``analyze``: ``bp.analyze`` (msb planes and the max pyramid);
* ``segment_counts``: ``bp.segment_counts`` (K2, ``csrc/level0_counts.cu``,
  and its torch glue);
* ``est_base_search``: ``(22 + 8) * scan_iter + 2 * dwt5``, the JAX
  script's estimate of one base search.

The port's own keys: ``base_transform`` (``FrameCodec._base_transform_scaled``:
padding, DC, the DWT and the weighted quantisation), ``resid_transform``
(``FrameCodec._resid_transform``: range, normalisation, DC, the 3-level
DWT and the quantisation of a residual field of the same shape),
``candidate_bits``, ``batch``, ``shape``, ``device``, ``card`` and
``timing``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..codec.config import EBCCConfig
from ..codec.pipeline import FrameCodec, _Eval
from ..ops import bitplane as bp
from ..ops import dwt
from . import common

BATCH, HEIGHT, WIDTH, LEVELS, REPS = 8, 768, 1472, 5, 5


def profile_transforms(batch: int = BATCH, h: int = HEIGHT, w: int = WIDTH,
                       device="cuda", reps: int = REPS) -> dict:
    """Best seconds of one call of each stage at [batch, h, w] (``h`` and
    ``w`` multiples of 2**(LEVELS + 1), so no padding)."""
    dev = common.resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (batch, h, w)).astype(
        np.float32)).to(dev)
    ci = torch.from_numpy(rng.laplace(0, 100, (batch, h, w)).astype(
        np.int32)).to(dev)
    codec = FrameCodec(h, w, EBCCConfig(base_levels=LEVELS, max_batch=batch),
                       dev)
    spec = codec.base.spec
    if (spec.height, spec.width) != (h, w):
        raise ValueError(f"{h}x{w} needs padding at {LEVELS} levels")
    an = bp.analyze(ci, spec)
    counts = bp.segment_counts(an, spec)
    zeros = torch.zeros(batch, device=dev)
    ev = _Eval(codec.base, h, w, ci, x, torch.full((batch,), 0.5,
                                                   device=dev),
               "base", zeros, zeros, torch.ones(batch, device=dev))
    b8 = torch.full((batch,), 8, dtype=torch.int32, device=dev)
    uf = torch.from_numpy(rng.integers(0, 65536, (batch, h, w)).astype(
        np.float32)).to(dev)

    def best(fn):
        return common.best_seconds(fn, reps, dev)

    t = {"dwt5": best(lambda: dwt.dwt2d_multi(x, LEVELS)),
         "idwt5": best(lambda: dwt.idwt2d_multi(x, LEVELS)),
         "scan_iter": best(lambda: ev.trunc(b8)),
         "analyze": best(lambda: bp.analyze(ci, spec)),
         "segment_counts": best(lambda: bp.segment_counts(an, spec))}
    t["est_base_search"] = (spec.nplanes + 8) * t["scan_iter"] + \
        2 * t["dwt5"]
    t["base_transform"] = best(lambda: codec._base_transform_scaled(uf))
    t["candidate_bits"] = best(lambda: bp.candidate_bits(counts, spec))
    t["resid_transform"] = best(lambda: codec._resid_transform(x))
    t.update(batch=batch, shape=[batch, h, w], device=str(dev),
             card=common.card_line(dev), timing=common.timing(dev))
    return t


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ebcc_tpu_torch.scripts.profile_transforms",
        description=__doc__.split("\n\n")[0])
    common.add_device_args(p, data=False)
    args = p.parse_args(argv)
    common.resolve_device(args.device)  # raises without a card
    print(json.dumps(profile_transforms(device=args.device),
                     indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
