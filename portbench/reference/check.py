"""The comparison that decides ``correct``: what the window's requests
returned, held to the configuration's guarantee by the plain decoder.

Every container of the window is split and every frame's header read: a
frame missing, extra, unreadable or of another grid or mode counts in
``frames_unreadable`` (limit 0).  Every readable frame's header also
carries the minimum and maximum of the frame it was made from, exact in
float32: a frame whose pair differs from that of the frame its request
sent in its place (another request's, another writer's, an altered
input) counts in ``frames_not_their_input`` (limit 0).  The pool's
frames have pairwise distinct pairs, so a frame swapped for another of
the pool shows.  A sample of the readable frames, drawn
from the run's seed, is decoded whole by :mod:`.decode` and compared with
the frame that was sent, point by point, in float64: ``max_err_over_bound``
is the largest |decoded - sent| / bound over those points, and the
configuration's guarantee says it is at most 1 (``abs``: the bound is the
configuration's error; ``pointwise``: the per-point bound times the
ratio).
"""

from __future__ import annotations

import torch

from portbench import fields
from portbench.reference import decode


def _bound(config, inputs, idx, device):
    g = config["guarantee"]
    if g["kind"] == "abs":
        return float(g["bound"])
    if g["kind"] == "pointwise":
        return torch.from_numpy(inputs["bound"][idx]).to(device).double() \
            * float(g["ratio"])
    raise ValueError(f"unknown guarantee {g['kind']!r}")


def check(requests, inputs, config, frames_per_request, seed, n_sample,
          device) -> dict:
    h, w = config["h"], config["w"]
    pointwise = config["guarantee"]["kind"] == "pointwise"
    pool = inputs["frames"].reshape(len(inputs["frames"]), -1)
    lo, hi = pool.min(1), pool.max(1)
    unreadable, foreign, frames = 0, 0, []
    for r in requests:
        if r.blob is None:
            unreadable += frames_per_request
            continue
        try:
            bufs = decode.split_blob(r.blob)
        except decode.CorruptFrame:
            unreadable += frames_per_request
            continue
        unreadable += abs(len(bufs) - frames_per_request)
        for j, buf in enumerate(bufs[:frames_per_request]):
            try:
                f = decode.parse_frame(buf)
                ok = ((f["h"], f["w"]) == (h, w) and
                      bool(f["flags"] & decode.FLAG_POINTWISE) == pointwise)
            except decode.CorruptFrame:
                ok = False
            if ok:
                idx = r.offset + j
                foreign += (f["mn"], f["mx"]) != (lo[idx], hi[idx])
                frames.append((idx, buf))
            else:
                unreadable += 1
    pick = fields.rng(seed, 11).choice(len(frames),
                                       min(n_sample, len(frames)),
                                       replace=False) if frames else []
    worst = None
    for k in sorted(pick):
        idx, buf = frames[k]
        try:
            dec = decode.decode_frame(buf, device)
        except decode.CorruptFrame:
            unreadable += 1
            continue
        sent = torch.from_numpy(inputs["frames"][idx]).to(device).double()
        ratio = float(((dec.double() - sent).abs()
                       / _bound(config, inputs, idx, device)).max())
        worst = ratio if worst is None else max(worst, ratio)
    return {"frames_unreadable": {"value": unreadable, "limit": 0},
            "frames_not_their_input": {"value": int(foreign), "limit": 0},
            "max_err_over_bound": {"value": worst, "limit": 1.0}}
