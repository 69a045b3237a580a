"""Design study: per-stripe (chunk-masked) truncation of the last coded
plane against the fine-truncation prefix.

    python -m ebcc_tpu_torch.scripts.stripe_adaptive_study [FRAME.npy]
        [--device cpu]

The port of ``scripts/stripe_adaptive_study.py``.  It quantifies the CR
headroom of replacing the fine-truncation PREFIX (js, jr) of the base
layer's last coded plane with per-chunk presence MASKS.  For each of three
configs of one frame (clean MAX_ERROR 0.5, the frame plus N(0, 0.05)
noise at MAX_ERROR 0.5, clean RELATIVE_ERROR 0.009), :func:`measure`
encodes it with ``FrameCodec.encode_error_bounded`` (K1 and K2 on a
card), takes the codec's pure selection (plane ``bs``, fine chunk
``ks``) and its candidate bits, then drops the last plane stripe by
stripe, greedily, wherever the bound still holds: each trial is a base
reconstruction (``FrameCodec._base_recon``, the inverse-DWT kernel on a
card) of the integer coefficients truncated per stripe, with the
midpoint of the dropped planes added back.  It prints the prefix's bits
(``chosen``), the masked selection's bits and the saving.  PERF.md
records the card's run of it.

The frame is the input, else the one ``$EBCC_REFERENCE_FRAME`` names;
without either the run stops, as the JAX script does without its
fixture.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..codec.config import EBCCConfig, ResidualMode
from ..codec.pipeline import FrameCodec
from ..ops import bitplane as bp
from . import common


def measure(frame: np.ndarray, mode: ResidualMode, err: float,
            device="cuda") -> dict:
    """The study's numbers for one frame [H, W] at ``mode`` / ``err`` on
    ``device``: the pure selection (``bs``, ``ks``), its bits
    (``chosen``), the bits of the last full plane before it
    (``full_prev``), the stripes that keep plane ``bs`` (``keep``), and
    ``masked``, the bits of the per-stripe selection, or None where
    dropping every droppable stripe together breaks the bound."""
    dev = common.resolve_device(device)
    frame = np.asarray(frame, np.float32)
    cfg = EBCCConfig(mode=mode, error=err, base_cr=100, max_batch=1)
    codec = FrameCodec(*frame.shape, cfg, dev)
    tgt = (err * (frame.max() - frame.min())
           if mode == ResidualMode.RELATIVE_ERROR else err)
    ref = torch.from_numpy(frame).to(dev)
    res = codec.encode_error_bounded(
        ref[None], torch.full((1,), tgt, dtype=torch.float32, device=dev),
        1e-6)
    spec = codec.base.spec
    an = bp.analyze(res.base_coef, spec)
    cand = bp.candidate_bits(bp.segment_counts(an, spec),
                             spec)[0].cpu().numpy()
    P, K2 = cand.shape
    J = K2 // 2
    bs, ks = int(res.bs_pure[0]), int(res.ks_pure[0])
    pidx = P - 1 - bs
    chosen = int(cand[pidx, ks])
    full_prev = int(cand[pidx - 1, K2 - 1]) if pidx >= 1 else 0
    inc = np.diff(np.concatenate([[full_prev], cand[pidx]]))
    ci = res.base_coef[0].long()
    mag, sign = ci.abs(), ci.sign()
    stripe = (torch.arange(ci.shape[0], device=dev) * J) // ci.shape[0]

    def err_at(depths):
        """Max error of the frame with stripe j truncated below plane
        ``depths[j]``: integer shifts of the int64 coefficients, the
        dropped planes' midpoint in float64, the recon in float32."""
        d = torch.tensor(depths, dtype=torch.int64, device=dev)[stripe][:,
                                                                      None]
        kept = (mag >> d) << d
        half = torch.where((kept > 0) & (d > 0),
                           ((torch.ones_like(d) << d) - 1).double() * 0.5,
                           0.0)
        rec = torch.where(kept > 0, kept + half, 0.0) * sign
        out = codec._base_recon(rec[None].float(), res.mn, res.mx,
                                res.dc_b)[0]
        return float((out - ref).abs().max())

    depths = [bs] * J
    for j in range(J):
        t = depths.copy()
        t[j] = bs + 1
        if err_at(t) <= tgt:
            depths[j] = bs + 1
    keep = [j for j in range(J) if depths[j] == bs]
    masked = None
    if err_at(depths) <= tgt:
        masked = full_prev + sum(int(inc[j]) + int(inc[J + j])
                                 for j in keep)
    return dict(bs=bs, ks=ks, chosen=chosen, full_prev=full_prev,
                keep=keep, masked=masked)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ebcc_tpu_torch.scripts.stripe_adaptive_study",
        description=__doc__.split("\n\n")[0])
    p.add_argument("input", nargs="?", default=common.reference_path(),
                   help="the frame (.npy); default: the frame "
                        f"${common.REFERENCE_FRAME_ENV} names")
    common.add_device_args(p, data=False)
    args = p.parse_args(argv)
    common.resolve_device(args.device)  # raises without a card
    if args.input is None:
        p.error(f"no input: pass a .npy frame or set "
                f"{common.REFERENCE_FRAME_ENV}")

    base = np.load(args.input).astype(np.float32)
    rng = np.random.default_rng(0)
    noisy = (base + rng.normal(0, 0.05, base.shape)).astype(np.float32)
    for label, frame, mode, err in (
            ("clean max-0.5", base, ResidualMode.MAX_ERROR, 0.5),
            ("noisy max-0.5", noisy, ResidualMode.MAX_ERROR, 0.5),
            ("clean rel-0.009", base, ResidualMode.RELATIVE_ERROR, 0.009)):
        m = measure(frame, mode, err, args.device)
        if m["masked"] is None:
            print(f"{label}: combined drop infeasible; masked = prefix")
        else:
            print(f"{label}: chosen {m['chosen']} masked {m['masked']} "
                  f"save {100 * (1 - m['masked'] / m['chosen']):.1f}% "
                  f"(kept {m['keep']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
