"""Per-stage profile of one batch through compress and decompress.

    python -m ebcc_tpu_torch.scripts.profile_stages [--device cpu]
        [--data FRAME.npy]

The port of ``scripts/profile_stages.py``: one batch (default B = 8) of
the bench stack (721x1440, MAX_ERROR 0.5, base_cr 100) goes through the
stages of ``api.compress`` -> ``api._drain`` and of ``api.decompress`` ->
``api._device_batch`` one at a time, each timed on the host clock after a
synchronise, and the script prints a JSON dict of stage -> seconds under
the JAX script's keys:

* encode: ``0_host_scale_u16`` (native u16 quantisation and the targets),
  ``1_device_encode_search`` (``encode_error_bounded_hostq``, synchronised;
  the best of 3 warm calls: on a card, replays of its CUDA graph),
  ``2_device_to_host_transfer_small`` (the packed metadata's copy,
  ``api._unpack_meta`` and the early pure decision; ``2_meta_bytes``),
  ``3_coef_fetch_plus_native_pack``, ``4_zstd``, ``5_assemble`` (the base
  streams' zstd, frames and container);
* decode: ``6_unzstd`` (headers and both layers' zstd),
  ``7_native_base_decode``, ``8_native_resid_decode``, ``9_device_recon``
  (``recon_packed`` on resident planes, synchronised; a warm call: on a
  card a replay);
* ``max_err``, ``total_enc`` and ``total_dec`` (the sums of the encode and
  decode stages; unlike the JAX script's, stage 0 and the port's upload
  and fetch stages below are in them);
* the on-device breakdown of stage 1 as ``cum_<stage>`` / ``stage_<stage>``
  for ``transform_counts`` (``_hostq_prelude``, ``bp.analyze``,
  ``bp.segment_counts``, ``bp.candidate_bits``), ``truncation_bisections``
  (both ``_search_truncation``), ``mask_greedy_scans`` (both
  ``_search_mask``) and ``residual_and_packings`` (``_eb_results``: the
  base recon at the selection, ``_resid_layer`` and, on a card, both
  layers' packed streams, then ``_pack_meta``): CUDA events between the
  calls of ``FrameCodec._eb_multi_core`` (the host clock on the CPU), best
  of 3 per stage, and its result must equal the encode's field by field.

The port's own keys: ``0a_h2d_upload`` (the u16 planes, ranges and
targets to the device; ``*_bytes``, ``*_gbps``), ``1a_encode_enqueue``
(the encode call's return, before the synchronise, in the run of stage
1's best wall: when it is close to that wall, the host's launches set the
pace), ``1c_encode_capture`` (the key's second call, synchronised: on a
card the capture and the first replay, the first call having run the
stage eagerly;
``1c_capture_reserved_bytes`` / ``1c_capture_held_bytes``, the device
memory the capture added to the graphs' pool and the static inputs and
outputs it keeps, None on the CPU), ``1e_encode_eager`` and
``1e_encode_eager_enqueue`` (the eager stage
``FrameCodec._eb_multi_hostq``, as stage 1 and 1a), ``9c_recon_capture``
(the second ``recon_packed`` call, the capture), ``3a_arena_d2h``
(``api._start_transfers``: the packed streams of each layer the api
reads, trimmed to the batch's longest truncation, copied ``non_blocking``
into pinned memory and waited on; ``*_bytes`` beside
``3a_coef_int32_bytes``, the int32 planes of the same layers, which no
longer cross; ``*_gbps``), ``3b_host_pack`` (``api._pack_layer_streams``
of both layers: the arenas taken off the copies on a card, the native
coder on the int32 planes off one), ``3_packed_on`` ("card" or "host"),
``9a_h2d_upload`` and ``9b_d2h_frames`` (the decoded planes up, the
frames down into pinned memory), ``batch``, ``device``, ``card`` and
``timing``.

The stages call the api's own functions in the api's order, and the
assembled container is the one ``compress`` writes for the batch.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import api
from ..codec import container
from ..codec.config import ResidualMode, base_error_quantile
from ..codec.pipeline import FrameCodec, _Eval
from ..ops import bitplane as bp
from ..runtime import native
from . import common
from .bench import bench_config

BATCH = 8
DEVICE_STAGES = ("transform_counts", "truncation_bisections",
                 "mask_greedy_scans", "residual_and_packings")
# the forms' names as the stage keys print them
ENCODE_KEYS = ("0_host_scale_u16", "0a_h2d_upload", "1_device_encode_search",
               "2_device_to_host_transfer_small",
               "3_coef_fetch_plus_native_pack", "4_zstd", "5_assemble")
DECODE_KEYS = ("6_unzstd", "7_native_base_decode", "8_native_resid_decode",
               "9a_h2d_upload", "9_device_recon", "9b_d2h_frames")


def _encode_marked(codec: FrameCodec, u, mn, mx, target, qbase: float,
                   marks: common.Marks) -> tuple:
    """``encode_error_bounded_hostq`` at one quantile, call for call as
    ``FrameCodec._eb_multi_core`` makes it, with a mark after each device
    stage: (the result, its packed metadata)."""
    base, spec = codec.base, codec.base.spec
    dataq, const, dc, ci = codec._hostq_prelude(u, mn, mx)
    an_b = bp.analyze(ci, spec)
    counts_b = bp.segment_counts(an_b, spec)
    cand_b = bp.candidate_bits(counts_b, spec)
    ev_b = _Eval(base, codec.h, codec.w, ci, dataq, target, "base", dc, mn,
                 mx)
    marks.mark("transform_counts")
    sels = []
    for qallow in (0.0, float(qbase)):
        bits, feas, maxd, bs, ks = codec._search_truncation(base, cand_b,
                                                            ev_b, qallow)
        marks.mark("truncation_bisections")
        mask = codec._search_mask(base, ev_b, qallow, bs, bits, feas,
                                  counts_b)
        marks.mark("mask_greedy_scans")
        sels.append((bits, feas, maxd, bs, ks, mask))
    del ev_b
    res = codec._eb_results(dataq, mn, mx, const, dc, ci, target, an_b,
                            counts_b, sels[0], sels[1:])[0]
    meta = codec._pack_meta(res)
    marks.mark("residual_and_packings")
    return res, meta


def device_stage_breakdown(codec: FrameCodec, u, mn, mx, target,
                           qbase: float, reps: int = 3):
    """({cum_<stage>, stage_<stage>: best seconds}, the encode's (result,
    packed metadata))."""
    best = dict.fromkeys(DEVICE_STAGES, float("inf"))
    res = None
    for _ in range(reps):
        common.sync(codec.device)
        marks = common.Marks(codec.device)
        res = _encode_marked(codec, u, mn, mx, target, qbase, marks)
        for k, v in marks.seconds().items():
            best[k] = min(best[k], v)
    out, cum = {}, 0.0
    for name in DEVICE_STAGES:
        cum += best[name]
        out[f"cum_{name}"] = cum
        out[f"stage_{name}"] = best[name]
    return out, res


def _targets(frames, mnb, mxb, maxq, config):
    """``api._batch_inputs``' error targets of the error-bounded modes."""
    if config.mode == ResidualMode.RELATIVE_ERROR:
        return (config.error * (mxb - mnb)).astype(np.float32) - maxq
    return np.full(len(frames), config.error, np.float32) - maxq


def _gbps(nbytes: int, s: float) -> float:
    return nbytes / s / 1e9 if s > 0 else float("inf")


def profile_stages(data, device="cuda", config=None, qbase=None,
                   reps: int = 3):
    """Stage -> seconds of one batch ``data`` [B, H, W] (MAX_ERROR or
    RELATIVE_ERROR ``config``, default the bench's with ``max_batch = B``)
    through compress and decompress on ``device``.  Returns (the dict, the
    assembled container blob)."""
    dev = common.resolve_device(device)
    data = np.asarray(data, np.float32)
    frames, cfg = api._prepare(
        data, config or bench_config(len(data), *data.shape[-2:]))
    if cfg.mode not in (ResidualMode.MAX_ERROR, ResidualMode.RELATIVE_ERROR):
        raise ValueError("profile_stages runs the MAX_ERROR / RELATIVE_ERROR "
                         "path")
    n, h, w = frames.shape
    if n > cfg.max_batch:
        raise ValueError(f"{n} frames are more than one batch of "
                         f"{cfg.max_batch}")
    qbase = base_error_quantile() if qbase is None else float(qbase)
    codec = FrameCodec(h, w, cfg, dev)
    # the key's first call (kernel builds, first launches; eager on a card
    # too), then its second: on a card the capture
    warm = api._batch_inputs(frames, 0, n, cfg, None, dev)
    codec.encode_error_bounded_hostq(*warm, qbase)
    common.sync(dev)
    t0 = time.perf_counter()
    codec.encode_error_bounded_hostq(*warm, qbase)
    common.sync(dev)
    t = {"batch": n, "device": str(dev), "card": common.card_line(dev),
         "timing": "host clock after a synchronise; device stages by " +
         common.timing(dev), "1c_encode_capture": time.perf_counter() - t0}
    [entry] = codec.graph_entries().values() or [None]
    t["1c_capture_reserved_bytes"] = entry and entry.reserved_bytes
    t["1c_capture_held_bytes"] = entry and entry.held_bytes

    t0 = time.perf_counter()
    u, mnb, mxb, maxq = api._scale_u16_host(frames)
    target = _targets(frames, mnb, mxb, maxq, cfg)
    t["0_host_scale_u16"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    inputs = (api._upload_u16(u, dev), torch.from_numpy(mnb).to(dev),
              torch.from_numpy(mxb).to(dev),
              torch.from_numpy(target).to(dev))
    common.sync(dev)
    t["0a_h2d_upload"] = time.perf_counter() - t0
    t["0a_h2d_upload_bytes"] = u.nbytes + mnb.nbytes + mxb.nbytes + \
        target.nbytes
    t["0a_h2d_upload_gbps"] = _gbps(t["0a_h2d_upload_bytes"],
                                    t["0a_h2d_upload"])

    def encode_rows(encode, wall_key, enqueue_key):
        t[wall_key] = float("inf")
        for _ in range(reps):  # the run with the best synchronised wall
            common.sync(dev)
            t0 = time.perf_counter()
            out = encode()
            enqueued = time.perf_counter() - t0
            common.sync(dev)
            wall = time.perf_counter() - t0
            if wall < t[wall_key]:
                t[wall_key], t[enqueue_key] = wall, enqueued
        return out

    encode_rows(lambda: codec._eb_multi_hostq(*inputs, (qbase,)),
                "1e_encode_eager", "1e_encode_eager_enqueue")
    res, meta = encode_rows(
        lambda: codec.encode_error_bounded_hostq(*inputs, qbase),
        "1_device_encode_search", "1a_encode_enqueue")

    stages, (res_marked, meta_marked) = device_stage_breakdown(
        codec, *inputs, qbase, reps)
    t.update(stages)
    for k, v in [*res._asdict().items(), ("meta", meta)]:
        if not torch.equal(v, meta_marked if k == "meta"
                           else getattr(res_marked, k)):
            raise AssertionError(f"the stage breakdown's encode differs from "
                                 f"encode_error_bounded_hostq in {k}")
    del res_marked, meta_marked

    # api._drain of one result, stage by stage
    rd = res._asdict()
    t0 = time.perf_counter()
    rd["_meta"] = api._D2H({0: meta})
    resn = api._fetch_small([rd], codec, cfg)[0]
    api._check_plane_budget(resn, cfg)
    t["2_device_to_host_transfer_small"] = time.perf_counter() - t0
    t["2_meta_bytes"] = meta.numel() * meta.element_size()

    # the packed streams _drain reads, copied as it copies them (a layer
    # no frame keeps bits of stays on the device)
    t0 = time.perf_counter()
    api._start_transfers([rd], [resn])
    rd["_arenas"].wait()
    t["3a_arena_d2h"] = time.perf_counter() - t0
    t["3a_arena_d2h_bytes"] = sum(a.nbytes for a in rd["_arenas"].host
                                  .values())
    t["3a_coef_int32_bytes"] = sum(
        rd[f"{layer}_coef"].numel() * 4 for layer in ("base", "resid")
        if int(rd["_trunc"][layer].max(initial=0)) > 0)
    t["3a_arena_d2h_gbps"] = _gbps(t["3a_arena_d2h_bytes"],
                                   t["3a_arena_d2h"])
    t["3_packed_on"] = "card" if rd["_arenas"].host else "host"
    t0 = time.perf_counter()
    streams = (api._pack_layer_streams(codec, rd, "base"),
               api._pack_layer_streams(codec, rd, "resid"))
    t["3b_host_pack"] = time.perf_counter() - t0
    t["3_coef_fetch_plus_native_pack"] = t["3a_arena_d2h"] + \
        t["3b_host_pack"]

    t0 = time.perf_counter()
    zblobs = api._zstd_stage(resn, streams, n, cfg)
    t["4_zstd"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    zbase = api._zstd_base(resn, range(n), cfg, streams[0], zblobs)
    blob = container.pack_blob([
        api._assemble_frame(resn, i, h, w, cfg, streams, zblobs, zbase)
        for i in range(n)])
    t["5_assemble"] = time.perf_counter() - t0
    del res, rd, inputs

    rec = _decode_stages(blob, codec, t)
    t["max_err"] = float(np.max(np.abs(rec - frames)))
    t["total_enc"] = sum(t[k] for k in ENCODE_KEYS)
    t["total_dec"] = sum(t.get(k, 0.0) for k in DECODE_KEYS)
    return t, blob


def _decode_stages(blob: bytes, codec: FrameCodec, t: dict) -> np.ndarray:
    """``api.decompress`` of one batch's ``blob`` on ``codec``'s device
    (whose geometry the blob's frames have), stage by stage into ``t``."""
    dev = codec.device
    metas = [container.unpack_frame(f) for f in container.unpack_blob(blob)]
    out = np.stack([np.full((m[0].h, m[0].w), m[0].mn, np.float32)
                    for m in metas])
    todo = [i for i, m in enumerate(metas)
            if not m[0].flags & container.FLAG_CONST]
    for k in DECODE_KEYS:
        t[k] = 0.0
    if not todo:
        return out
    bspec, rspec = codec.base.spec, codec.resid.spec
    geo_b = (bspec.height, bspec.width, bspec.group_levels, bspec.nplanes,
             bspec.nchunks)
    geo_r = (rspec.height, rspec.width, rspec.group_levels, rspec.nplanes,
             rspec.nchunks)

    t0 = time.perf_counter()
    bs, rs, f, i, hasr = api._layer_inputs(metas, todo)
    t["6_unzstd"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    v16_b, bend_b, ok_b = native.coder_decode_batch_u16(
        bs, i["bb"], i["msb"], *geo_b, i["mask_b"], i["keep_b"])
    t["7_native_base_decode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    v16_r, bend_r, ok_r = native.coder_decode_batch_u16(
        rs, i["rb"], i["msr"], *geo_r, i["mask_r"], i["keep_r"])
    t["8_native_resid_decode"] = time.perf_counter() - t0
    packed = bool(ok_b.all() and ok_r.all())
    if not packed:  # more than 14 decoded planes: f32 coefficients
        t0 = time.perf_counter()
        coef_b = native.coder_decode_batch(
            bs, i["bb"], i["msb"], *geo_b, i["mask_b"], i["keep_b"])
        t["7_native_base_decode"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        coef_r = native.coder_decode_batch(
            rs, i["rb"], i["msr"], *geo_r, i["mask_r"], i["keep_r"])
        t["8_native_resid_decode"] += time.perf_counter() - t0

    def up(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    t0 = time.perf_counter()
    common_args = (up(f["mn"]), up(f["mx"]), up(f["dc_b"]), up(hasr))
    resid_args = (up(f["rmin"]), up(f["rmax"]), up(f["dc_r"]))
    if packed:
        recon, args = codec.recon_packed, (
            api._upload_u16(v16_b, dev), up(bend_b), *common_args,
            api._upload_u16(v16_r, dev), up(bend_r), *resid_args)
    else:
        recon, args = codec.recon, (up(coef_b), *common_args, up(coef_r),
                                    *resid_args)
    common.sync(dev)
    t["9a_h2d_upload"] = time.perf_counter() - t0

    recon(*args)  # warm-up, as the JAX script's: eager
    common.sync(dev)
    t0 = time.perf_counter()
    recon(*args)  # on a card the capture
    common.sync(dev)
    t["9c_recon_capture"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec_dev = recon(*args)
    common.sync(dev)
    t["9_device_recon"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec = api._D2H({"rec": rec_dev}).get("rec")
    t["9b_d2h_frames"] = time.perf_counter() - t0
    out[todo] = rec
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ebcc_tpu_torch.scripts.profile_stages",
        description=__doc__.split("\n\n")[0])
    common.add_device_args(p)
    args = p.parse_args(argv)
    common.resolve_device(args.device)  # raises without a card
    base, label = common.base_frame(path=args.data)
    print(f"data: {label}, {BATCH} frames", flush=True)
    t, _ = profile_stages(common.bench_frames(BATCH, *base.shape,
                                              base=base), args.device)
    print(json.dumps(t, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
