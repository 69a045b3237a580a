"""The device stream packer (``ops/pack.py``) and the api's route through
it, on the CPU.

* ``pack_streams`` on CPU tensors (the plain torch version, built on
  ``bitplane.encode_frame``) equals the native ``coder_encode_batch``
  arena byte for byte up to the truncation, and is zero past it: for
  random planes of three geometries (uneven stripes among them) and for a
  codec's own base planes, with the truncation inside a group, a
  significance, a sign and a refinement segment, at a plane's end, at 0
  and at the whole stream;
* ``stream_capacity`` holds the longest stream a plane can give;
* the wrapper raises on a wrong dtype, shape or device;
* ``compress`` / ``compress_multi_q`` through the codec's packer route
  (``FrameCodec.packs_streams``, which a card turns on) give the native
  encoder's containers in every residual mode, and the ``coder.pack``
  spans say where each layer was packed and how many frames.

One intra-op thread for the module (small torch ops; see SKILL.md).
"""

import time

import numpy as np
import pytest
import torch

import ebcc_tpu_torch
from ebcc_tpu_torch import EBCCConfig, ResidualMode, api
from ebcc_tpu_torch.codec.pipeline import FrameCodec
from ebcc_tpu_torch.ops import bitplane as bp
from ebcc_tpu_torch.ops import pack
from ebcc_tpu_torch.runtime import cpu_encoder, native
from ebcc_tpu_torch.scripts import common
from ebcc_tpu_torch.utils import profiling

# (height, width, group levels, planes, stripes) of the random planes
GEOMS = {"base_like": (64, 96, 4, 14, 8), "resid_like": (48, 80, 3, 10, 4),
         "uneven_stripes": (40, 48, 2, 9, 3)}
KINDS = ("group", "significance", "sign", "refinement", "plane_end", "zero",
         "whole")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_planes(geom, seed=0):
    """(int32 [2, h, w] coefficients, their spec): heavy-tailed magnitudes
    below the top plane, a zero band (rows the coder skips)."""
    h, w, g, p, j = GEOMS[geom]
    rng = np.random.default_rng(seed)
    mag = (rng.pareto(1.2, (2, h, w)) * 6).astype(np.int64)
    mag = np.minimum(mag, (1 << (p - 1)) - 1)
    mag[:, h // 4:h // 2] = 0
    coef = mag * rng.choice([-1, 1], mag.shape)
    return (torch.from_numpy(coef.astype(np.int32)),
            bp.CoderSpec(height=h, width=w, group_levels=g, nplanes=p,
                         nchunks=j))


def _codec_planes():
    """A codec's own base planes of two bench frames at 64x96."""
    cfg = EBCCConfig(max_batch=2, base_levels=3, residual_levels=2)
    codec = FrameCodec(64, 96, cfg, "cpu")
    u, mn, mx, _ = api._scale_u16_host(common.bench_frames(2, 64, 96))
    _, _, _, ci = codec._hostq_prelude(api._upload_u16(u, "cpu"),
                                       torch.from_numpy(mn),
                                       torch.from_numpy(mx))
    return ci, codec.base.spec


def _truncation(counts, spec, kind):
    """Per frame, a truncation of ``kind``: inside a segment of that kind
    (the middle one of the frame's non-empty ones, halfway through it),
    at the end of the plane where half the stream is written, at 0, or at
    the whole stream."""
    g, j = spec.group_levels, spec.nchunks
    out = []
    for row in counts.numpy():
        flat = row.reshape(-1)
        start = np.concatenate([[0], np.cumsum(flat)[:-1]])
        seg = np.arange(flat.size) % spec.nsegments
        total = int(flat.sum())
        if kind == "zero":
            out.append(0)
            continue
        if kind == "whole":
            out.append(total)
            continue
        if kind == "plane_end":
            ends = np.cumsum(row.sum(-1))
            out.append(int(ends[np.searchsorted(ends, total // 2)]))
            continue
        pick = {"group": seg < g,
                "significance": (seg >= g) & (seg < g + 2 * j) &
                                ((seg - g) % 2 == 0),
                "sign": (seg >= g) & (seg < g + 2 * j) & ((seg - g) % 2 == 1),
                "refinement": seg >= g + 2 * j}[kind] & (flat >= 2)
        idx = np.flatnonzero(pick)
        assert idx.size, kind
        e = idx[idx.size // 2]
        out.append(int(start[e] + flat[e] // 2))
    return torch.tensor(out, dtype=torch.int64)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("source", [*GEOMS, "codec_base"])
def test_plain_packer_equals_native_arena(source, kind):
    coef, spec = (_codec_planes() if source == "codec_base"
                  else _random_planes(source))
    an = bp.analyze(coef, spec)
    counts = bp.segment_counts(an, spec)
    trunc = _truncation(counts, spec, kind)
    arena = pack.pack_streams(coef, an, counts, trunc, spec).numpy()
    assert arena.shape == (2, pack.stream_capacity(spec))
    ref = native.coder_encode_batch(coef.numpy(), trunc.numpy(),
                                    spec.group_levels, spec.nplanes,
                                    spec.nchunks)
    for i, t in enumerate(trunc.tolist()):
        nbytes = (t + 7) // 8
        np.testing.assert_array_equal(arena[i, :nbytes], ref[i, :nbytes])
        assert not arena[i, nbytes:].any()
    if kind == "whole":  # the stream written to its end
        assert (trunc == counts.flatten(1).sum(-1)).all() and arena.any()


def test_stream_capacity_holds_the_longest_stream():
    """Every magnitude at the top plane's value and every sign negative:
    each level-0 cell emits P + 1 bits, and the capacity holds them."""
    spec = bp.CoderSpec(height=32, width=48, group_levels=3, nplanes=9,
                        nchunks=4)
    coef = torch.full((1, 32, 48), -((1 << 9) - 1), dtype=torch.int32)
    an = bp.analyze(coef, spec)
    counts = bp.segment_counts(an, spec)
    total = int(counts.sum())
    assert total >= (spec.nplanes + 1) * 32 * 48
    assert 8 * pack.stream_capacity(spec) >= total
    arena = pack.pack_streams(coef, an, counts, counts.flatten(1).sum(-1),
                              spec)
    ref = native.coder_encode_batch(coef.numpy(), [total], 3, 9, 4)
    np.testing.assert_array_equal(arena[0, :(total + 7) // 8].numpy(),
                                  ref[0, :(total + 7) // 8])


def _bad_inputs(case):
    coef, spec = _random_planes("resid_like")
    an = bp.analyze(coef, spec)
    counts = bp.segment_counts(an, spec)
    trunc = torch.full((2,), 100, dtype=torch.int64)
    args = dict(coef=coef, an=an, counts=counts, trunc=trunc, spec=spec)
    if case == "coef_dtype":
        args["coef"] = coef.long()
    elif case == "counts_shape":
        args["counts"] = counts[:, :-1]
    elif case == "trunc_dtype":
        args["trunc"] = trunc.int()
    elif case == "smax_shape":
        args["an"] = an._replace(smax=(an.smax[0], an.smax[1][:, :-1],
                                       *an.smax[2:]))
    elif case == "device":
        args["trunc"] = trunc.to("meta")
    elif case == "coef_rank":
        args["coef"] = coef[0]
    elif case == "max_step_shape":
        args["an"] = an._replace(max_step=an.max_step[:1])
    return args


@pytest.mark.parametrize("case", ["coef_dtype", "counts_shape",
                                  "trunc_dtype", "smax_shape", "device",
                                  "coef_rank", "max_step_shape"])
def test_pack_streams_raises_on_bad_input(case):
    with pytest.raises(ValueError, match="pack_streams"):
        pack.pack_streams(**_bad_inputs(case))


H, W = 48, 80
QS = (1e-6, 1e-3)
MODES = {
    "max_error": dict(mode=ResidualMode.MAX_ERROR, error=0.05),
    "relative_error": dict(mode=ResidualMode.RELATIVE_ERROR, error=2e-4),
    "pointwise": dict(mode=ResidualMode.POINTWISE_MAX_ERROR),
    "none": dict(mode=ResidualMode.NONE, base_cr=20),
    "sparsification": dict(mode=ResidualMode.SPARSIFICATION_FACTOR,
                           base_cr=40, residual_cr=10),
    "multi_q": dict(mode=ResidualMode.MAX_ERROR, error=0.05),
}


def _spans_since(since):
    return [r for r in profiling.records()
            if r.name == "coder.pack" and r.start >= since]


@pytest.mark.parametrize("mode", list(MODES))
def test_packer_route_gives_native_containers(mode, monkeypatch):
    """5 frames in batches of 2 (a padded last batch), the pure-base
    fallback off and a base quantile of 1e-3 so residual layers stay on
    some frames and not on others: through the codec's packer
    route, the containers are the native encoder's, every layer is packed
    by the codec ("card") and none by the host."""
    monkeypatch.setenv("EBCC_DISABLE_PURE_JP2_FALLBACK", "1")
    cfg = EBCCConfig(max_batch=2, base_levels=3, residual_levels=2,
                     **MODES[mode])
    data = common.bench_frames(5, H, W, seed=6)
    eb = (np.random.default_rng(2).uniform(0.02, 0.08, data.shape)
          .astype(np.float32) if mode == "pointwise" else None)
    codec = FrameCodec(H, W, cfg, "cpu")
    codec.packs_streams = True
    monkeypatch.setattr(api, "_codec_for", lambda *a: codec)
    since = time.perf_counter()
    if mode == "multi_q":
        got = ebcc_tpu_torch.compress_multi_q(data, QS, cfg, device="cpu")
        want = [cpu_encoder.compress(data, cfg, qbase=q) for q in QS]
    else:
        got = ebcc_tpu_torch.compress(data, cfg, error_bound=eb,
                                      device="cpu", qbase=QS[1])
        want = cpu_encoder.compress(data, cfg, error_bound=eb, qbase=QS[1])
    assert got == want
    spans = _spans_since(since)
    assert {r.attrs["where"] for r in spans} == {"card"}
    layers = {r.attrs["layer"] for r in spans}
    assert layers == ({"base"} if mode == "none" else {"base", "resid"})
    # three batches, each packing its base layer once
    assert sorted(r.attrs["frames"] for r in spans
                  if r.attrs["layer"] == "base") == [1, 2, 2]


@pytest.mark.parametrize("packs", [False, True], ids=["host", "card"])
def test_coder_pack_span_says_where(packs):
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5, max_batch=3,
                     base_levels=3, residual_levels=2)
    data = common.bench_frames(3, H, W, seed=1)
    codec = FrameCodec(H, W, cfg, "cpu")
    codec.packs_streams = packs
    since = time.perf_counter()
    blob = ebcc_tpu_torch.compress(data, cfg, codec=codec)
    assert blob == cpu_encoder.compress(data, cfg)
    spans = _spans_since(since)
    assert spans and all(r.attrs["where"] == ("card" if packs else "host")
                         and r.attrs["frames"] == 3 for r in spans)
