"""The port's CUDA kernels and its cuda path against their plain versions,
on a card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports neither jax nor ebcc_tpu, so it also runs where only the
port's dependencies are installed:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import functools
import json

import numpy as np
import pytest
import torch

import ebcc_tpu_torch
from ebcc_tpu_torch.codec.config import EBCCConfig, ResidualMode
from ebcc_tpu_torch.codec.pipeline import FrameCodec, _Eval
from ebcc_tpu_torch.ops import bitplane as bp
from ebcc_tpu_torch.ops import dwt
from ebcc_tpu_torch.ops import fused_eval as fe
from ebcc_tpu_torch.ops import idwt
from ebcc_tpu_torch.ops import idwt_probe as ip
from ebcc_tpu_torch.ops import level0_counts as l0
from ebcc_tpu_torch.ops import pack as pk
from ebcc_tpu_torch.runtime import cpu_decoder, cpu_encoder, native
from test_torch_pack import KINDS as PACK_KINDS
from test_torch_pack import _truncation

pytestmark = pytest.mark.cuda

B, H, W = 4, 96, 160


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _field(n, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (260 + 25 * np.sin(y / h * np.pi) *
            np.cos(x / w * 2 * np.pi)).astype(np.float32)
    return np.stack([base + rng.normal(0, 0.3, base.shape)
                     .astype(np.float32) for _ in range(n)])


# K2 at the codec paths' shapes (base, resid; B = 3, 16 and 1), at 96x160
# with 8 stripes (a stripe is smaller than one CTA's share), at widths
# whose rows are not a multiple of 4 values (a scalar head and tail), on a
# field of -1 only (every value in one bin), on values above P - 1, and
# on a stripe of 4096 x 16386 values, 99 % of them -1: each thread bins
# more than 65,535 values into one bin, so the kernel must flush its
# 16-bit columns in rounds
L0_CASES = [
    pytest.param((3, 768, 1472), 8, 22, "analyze", id="base-3"),
    pytest.param((3, 736, 1440), 8, 14, "analyze", id="resid-3"),
    pytest.param((16, 768, 1472), 8, 22, "analyze", id="base-16"),
    pytest.param((16, 736, 1440), 8, 14, "analyze", id="resid-16"),
    pytest.param((1, 768, 1472), 8, 22, "analyze", id="base-1"),
    pytest.param((3, 96, 160), 8, 14, "analyze", id="96x160"),
    pytest.param((2, 96, 166), 8, 14, "random", id="96x166"),
    pytest.param((2, 64, 10), 4, 9, "random", id="64x10"),
    pytest.param((4, 768, 1472), 8, 22, "minus_one", id="all-minus-one"),
    pytest.param((4, 736, 1440), 8, 14, "above_p", id="above-p"),
    pytest.param((1, 8 * 4096, 16386), 8, 4, "sparse", id="long-stripe"),
]


def _level0_inputs(dev, shape, j, p, kind):
    """(msb, smax1) int32 of ``kind``: the analysis of random coefficients
    (every third row 0), uniform values in [-1, P - 1], all -1, values in
    [-1, P + 5], or (made on the card) -1 but for 1 % in [-1, P]."""
    b, hp, wp = shape
    if kind == "sparse":
        g = torch.Generator(device=dev).manual_seed(hp + wp + p)

        def field(shape):
            v = torch.randint(-1, p + 1, shape, generator=g, device=dev,
                              dtype=torch.int32)
            rare = torch.rand(shape, generator=g, device=dev) < 0.01
            return torch.where(rare, v, torch.full_like(v, -1))

        return field((b, hp, wp)), field((b, hp // 2, wp // 2))
    rng = np.random.default_rng(hp + wp + p)
    if kind == "analyze":
        spec = bp.CoderSpec(height=hp, width=wp, group_levels=1, nplanes=p,
                            nchunks=j)
        coefs = rng.integers(-(1 << 18), 1 << 18, (b, hp, wp)).astype(
            np.int32)
        coefs[:, ::3] = 0
        an = bp.analyze(torch.from_numpy(coefs).to(dev), spec)
        return an.msb, an.smax[1]
    hi = {"random": p, "minus_one": 0, "above_p": p + 6}[kind]
    msb = rng.integers(-1, hi, (b, hp, wp)).astype(np.int32)
    smax1 = rng.integers(-1, hi, (b, hp // 2, wp // 2)).astype(np.int32)
    return (torch.from_numpy(msb).to(dev), torch.from_numpy(smax1).to(dev))


@pytest.mark.parametrize("shape,j,p,kind", L0_CASES)
def test_level0_counts_kernel_matches_plain(card, shape, j, p, kind):
    """K2 integer-equal to its plain version, one launch a call."""
    msb, smax1 = _level0_inputs(card, shape, j, p, kind)
    before = l0.KERNEL.launches
    out = l0.level0_counts(msb, smax1, p, j)
    assert l0.KERNEL.launches == before + 1
    assert torch.equal(out, l0.level0_counts_ref(msb, smax1, p, j))


def test_level0_counts_kernel_unaligned(card):
    """msb and smax[1] 4 bytes past a 16-byte boundary: each stripe takes
    a scalar head and tail around its 16-byte body."""
    msb, smax1 = _level0_inputs(card, (3, 96, 160), 8, 14, "random")
    flat_m = torch.empty(1 + msb.numel(), dtype=torch.int32, device=card)
    flat_s = torch.empty(1 + smax1.numel(), dtype=torch.int32, device=card)
    m = flat_m[1:].view(msb.shape)
    q = flat_s[1:].view(smax1.shape)
    m.copy_(msb)
    q.copy_(smax1)
    assert m.data_ptr() % 16 == 4 and q.data_ptr() % 16 == 4
    assert torch.equal(l0.level0_counts(m, q, 14, 8),
                       l0.level0_counts_ref(msb, smax1, 14, 8))


def test_level0_counts_allocates_only_its_output(card):
    """K2 keeps its histograms in shared memory: a call allocates its
    output and nothing else on the device, at any moment of the call."""
    msb, smax1 = _level0_inputs(card, (4, 768, 1472), 8, 22, "random")
    l0.level0_counts(msb, smax1, 22, 8)  # build and load first
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    out = l0.level0_counts(msb, smax1, 22, 8)
    torch.cuda.synchronize()
    # the caching allocator rounds a block up to 512 bytes
    nbytes = -(-out.nbytes // 512) * 512
    assert torch.cuda.memory_allocated(card) - before == nbytes
    assert torch.cuda.max_memory_allocated(card) - before == nbytes


def _layers(dev, pointwise=False):
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.25, base_cr=200,
                     max_batch=B)
    c = FrameCodec(H, W, cfg, dev)
    u, mn, mx, maxq = native.scale_u16_batch(_field(B))
    mn, mx = torch.from_numpy(mn).to(dev), torch.from_numpy(mx).to(dev)
    dataq, _, dc, ci = c._hostq_prelude(
        torch.from_numpy(u.astype(np.int32)).to(dev), mn, mx)
    if pointwise:
        eb = 0.2 + 0.2 * np.random.default_rng(9).random((B, H, W))
        tgt = torch.from_numpy(eb.astype(np.float32) -
                               maxq[:, None, None]).to(dev)
    else:
        tgt = torch.from_numpy(np.full(B, 0.25, np.float32) - maxq).to(dev)
    an = bp.analyze(ci, c.base.spec)
    coef = bp.recon_truncated(an, torch.full((B,), 8, dtype=torch.int32,
                                             device=dev), spec=c.base.spec)
    base_rec = c._base_recon(coef, mn, mx, dc)
    rmin, rmax, dcr, cir = c._resid_transform(dataq - base_rec)
    return [(c.base, _Eval(c.base, H, W, ci, dataq, tgt, "base", dc, mn,
                           mx)),
            (c.resid, _Eval(c.resid, H, W, cir, dataq, tgt, "resid", dcr,
                            rmin, rmax, base_rec=base_rec))]


@pytest.mark.parametrize("pointwise", [False, True],
                         ids=["scalar", "target_field"])
def test_eval_stats_kernel_matches_plain(card, pointwise):
    vec = torch.arange(B, dtype=torch.int32, device=card)
    for geom, ev in _layers(card, pointwise):
        assert (ev.args["tgt_field"] is not None) == pointwise
        a = dict(ev.args)
        ci, ref = a.pop("ci"), a.pop("ref")
        p, j = geom.spec.nplanes, geom.spec.nchunks
        cands = [("trunc", dict(js=j, jr=j)), ("trunc", dict(js=3, jr=0)),
                 ("trunc", dict(js=j, jr=5)),
                 ("masked", dict(dropmask=vec * 37 % (1 << j)))]
        for mode, cand in cands:
            for b0 in range(p):
                b = (vec + b0) % p
                mk, ck = fe.eval_stats(ci, ref, b, mode=mode, **a, **cand)
                mr, cr = fe.eval_stats_ref(ci, ref, b, mode=mode, **a,
                                           **cand)
                _assert_same_stats((mk, ck), (mr, cr))


def _assert_same_stats(ours, plain):
    """Equal maxd bits and equal violation counts."""
    (mk, ck), (mr, cr) = ours, plain
    assert torch.equal(mk.view(torch.int32), mr.view(torch.int32)), (mk, mr)
    assert torch.equal(ck, cr), (ck, cr)


# (levels, hp, wp, h, w, frames): 0, 1 and 5 levels at small sizes; the
# benchmark cells' base and residual layers at their batch of 8 and at 3;
# column passes whose bands split the height unevenly (768 rows at B=3,
# 520 rows at B=2) or take it in one band (40 rows at B=64), and the
# scalar copies of the column pass (a level width or a row stride not a
# multiple of 4)
EVAL_LEVEL_CASES = [
    pytest.param(0, 33, 50, 30, 45, 3, id="0-33-50-30-45"),
    pytest.param(1, 64, 96, 60, 90, 3, id="1-64-96-60-90"),
    pytest.param(5, 96, 160, 90, 150, 3, id="5-96-160-90-150"),
    pytest.param(5, 768, 1472, 721, 1440, 8, id="base-B8"),
    pytest.param(5, 768, 1472, 721, 1440, 3, id="base-B3"),
    pytest.param(3, 736, 1440, 721, 1440, 8, id="resid-B8"),
    pytest.param(3, 736, 1440, 721, 1440, 3, id="resid-B3"),
    pytest.param(2, 520, 200, 515, 190, 2, id="uneven-bands"),
    pytest.param(1, 40, 64, 37, 60, 64, id="one-band"),
    pytest.param(2, 64, 100, 60, 99, 3, id="scalar-level-1"),
    pytest.param(1, 64, 98, 61, 95, 3, id="scalar-row-stride"),
]


@pytest.mark.parametrize("target", ["scalar", "field"])
@pytest.mark.parametrize("kind", ["base", "resid"])
@pytest.mark.parametrize("levels,hp,wp,h,w,nb", EVAL_LEVEL_CASES)
def test_eval_stats_kernel_bit_equal_by_levels(card, levels, hp, wp, h, w,
                                                nb, kind, target):
    """Kernel vs plain on random inputs with a valid region smaller than
    the frame (h < hp, w < wp): the one fused pass of levels == 0, the
    vector and scalar forms of the row pass (at 5 levels of 96x160 the two
    deepest rows have an n2 that is not a multiple of 4) and of the column
    pass, and the column pass's tiles at the cells' geometries and batch
    (``EVAL_LEVEL_CASES``)."""
    rng = np.random.default_rng(10 * levels + (kind == "resid"))
    nchunks = 8
    scale = 1 << (14 if kind == "base" else 8)
    ci = rng.integers(-scale, scale, (nb, hp, wp)).astype(np.int32)
    ci[:, ::3] //= 16
    if kind == "base":
        dc, lo, hi = 30000.0, 250.0, 290.0
    else:
        dc, lo, hi = 128.0, -0.5, 0.5
    ref = lo + (hi - lo) * rng.random((nb, hp, wp))
    base_rec = (rng.normal(0, 0.1, (nb, hp, wp)) if kind == "resid"
                else None)

    def dev(a, dtype=torch.float32):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(card, dtype)

    tg = dict(tgt=0.02 if kind == "base" else 0.2) if target == "scalar" \
        else dict(tgt_field=dev(rng.uniform(0.0, 0.05, (nb, hp, wp))))
    a = dict(kind=kind, levels=levels, nchunks=nchunks, h=h, w=w, dc=dc,
             lo=lo, hi=hi, base_rec=dev(base_rec), **tg)
    ci_d, ref_d = dev(ci, torch.int32), dev(ref)
    vec = torch.arange(nb, dtype=torch.int32, device=card)
    cands = [("trunc", 0, dict(js=nchunks, jr=nchunks)),
             ("trunc", 3, dict(js=3, jr=0)), ("trunc", 7, dict(js=8, jr=5)),
             ("masked", 2, dict(dropmask=vec * 37 % (1 << nchunks))),
             ("masked", 5, dict(dropmask=0b10110101))]
    for mode, b0, cand in cands:
        b = vec + b0
        _assert_same_stats(
            fe.eval_stats(ci_d, ref_d, b, mode=mode, **a, **cand),
            fe.eval_stats_ref(ci_d, ref_d, b, mode=mode, **a, **cand))


def test_eval_stats_rejects_bad_tensors(card):
    geom, ev = _layers(card)[0]
    a = dict(ev.args)
    ci, ref = a.pop("ci"), a.pop("ref")
    b = torch.zeros(B, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):  # wrong dtype
        fe.eval_stats(ci.float(), ref, b, mode="trunc", **a)
    with pytest.raises(ValueError):  # not contiguous
        fe.eval_stats(ci.transpose(1, 2).contiguous().transpose(1, 2), ref,
                      b, mode="trunc", **a)
    with pytest.raises(ValueError):  # mixed devices
        fe.eval_stats(ci, ref.cpu(), b, mode="trunc", **a)


IDWT_CASES = [((16, 768, 1472), 5), ((16, 736, 1440), 3),
              ((1, 768, 1472), 1), ((1, 768, 1472), 5), ((3, 96, 160), 3),
              ((2, 64, 96), 0), ((2, 64, 96), 1),
              ((1, 16, 24576), 2)]  # the widest row supported() takes


@pytest.mark.parametrize("shape,levels", IDWT_CASES)
def test_idwt_kernel_matches_plain(card, shape, levels):
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0, 100, shape).astype(np.float32)).to(card)
    x0 = x.clone()
    out = dwt.idwt2d_multi(x, levels)
    ref = dwt.idwt2d_multi_ref(x0, levels)
    assert torch.equal(out, ref)
    assert torch.equal(x, x0)  # the input is left as it was


@pytest.mark.parametrize("shape,levels", IDWT_CASES)
def test_idwt_kernel_in_place(card, shape, levels):
    """out is x: the transform overwrites its input."""
    x = torch.from_numpy(np.random.default_rng(3).normal(
        0, 100, shape).astype(np.float32)).to(card)
    ref = dwt.idwt2d_multi_ref(x, levels)
    out = idwt.idwt2d_multi_cuda(x, levels, out=x)
    assert out is x
    assert torch.equal(x, ref)


def test_idwt_rejects_bad_tensors(card):
    x = torch.zeros((2, 96, 160), device=card)
    with pytest.raises(ValueError):  # wrong dtype
        idwt.idwt2d_multi_cuda(x.double(), 3)
    with pytest.raises(ValueError):  # not contiguous
        idwt.idwt2d_multi_cuda(x.transpose(1, 2), 3)
    with pytest.raises(ValueError):  # odd level sub-shape
        idwt.idwt2d_multi_cuda(torch.zeros((1, 90, 160), device=card), 3)


# every probe at the probes' frame, B = 1 and 16; k1, k2 and k3 also at
# the edges of their designs: a ragged last tile or quad with W % 4 == 2,
# one 2x2 frame, a tile and a row and a column more; k2 at W = 32768,
# wider than a row of lifting.cuh's kRowSmem
PROBE_CASES = (
    [pytest.param(name, (batch, 768, 1472), id=f"{name}-{batch}")
     for batch in (1, 16) for name in ip.PLAIN] +
    [pytest.param(name, shape, id=f"{name}-" + "x".join(map(str, shape)))
     for name in ("probe_lane_interleave", "probe_transpose",
                  "probe_row_interleave")
     for shape in ((3, 770, 1474), (1, 2, 2), (2, 66, 130))] +
    [pytest.param("probe_lane_interleave", (1, 4, 32768),
                  id="probe_lane_interleave-1x4x32768")])


@pytest.mark.parametrize("name,shape", PROBE_CASES)
def test_idwt_probe_kernel_matches_plain(card, name, shape):
    """Each probe kernel bit-equal to its plain version, one launch a
    call."""
    x = torch.from_numpy(np.random.default_rng(shape[0]).standard_normal(
        shape).astype(np.float32)).to(card)
    before = ip.KERNELS[name].launches
    out = ip.probe(name, x)
    assert ip.KERNELS[name].launches == before + 1
    assert torch.equal(out, ip.PLAIN[name](x))


@pytest.mark.parametrize("name", ["probe_lane_interleave", "probe_transpose",
                                  "probe_row_interleave"])
def test_idwt_probe_kernel_unaligned(card, name):
    """A tensor 8 bytes past a 16-byte boundary takes the scalar form of
    the same kernel, bit-equal."""
    flat = torch.from_numpy(np.random.default_rng(5).standard_normal(
        2 + 2 * 66 * 128).astype(np.float32)).to(card)
    x = flat[2:].view(2, 66, 128)
    assert x.data_ptr() % 16 == 8
    assert torch.equal(ip.probe(name, x), ip.PLAIN[name](x))


def test_probe_transpose_allocates_only_its_output(card):
    """k3's scratch is shared memory: a call allocates its output and
    nothing else on the device, at any moment of the call."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 768, 1472)).astype(np.float32)).to(card)
    ip.probe("probe_transpose", x)  # build and load first
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    out = ip.probe("probe_transpose", x)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(card) - before == out.nbytes
    assert torch.cuda.max_memory_allocated(card) - before == out.nbytes


def test_cuda_pointwise_compress_matches_cpu_and_native(card):
    data = _field(5, seed=4)
    eb = (0.2 + 0.3 * np.random.default_rng(5).random(data.shape)).astype(
        np.float32)
    cfg = EBCCConfig(mode=ResidualMode.POINTWISE_MAX_ERROR, base_cr=200,
                     max_batch=2)
    blob = ebcc_tpu_torch.compress(data, cfg, error_bound=eb, device="cuda")
    assert blob == ebcc_tpu_torch.compress(data, cfg, error_bound=eb,
                                           device="cpu")
    assert blob == cpu_encoder.compress(data, cfg, error_bound=eb)
    rec = ebcc_tpu_torch.decompress(blob, cfg, device="cuda")
    np.testing.assert_array_equal(rec, cpu_decoder.decompress(blob))
    assert np.all(np.abs(rec - data) <= eb)


def test_cuda_t2m_day_pointwise(card):
    """A day of the benchmark's pointwise deployment
    (``portbench/configs/era5_t2m_pointwise.json``: 24 frames of 721x1440
    2 m temperature under the generated ensemble spread, ratio 1.0) on the
    card: the per-point targets computed there are bit-equal to the host
    route's, the containers equal the native encoder's, and every decoded
    point holds its bound."""
    import dataclasses
    import time

    from ebcc_tpu_torch import api
    from ebcc_tpu_torch.utils import profiling
    from portbench import core

    with open("portbench/configs/era5_t2m_pointwise.json") as f:
        config = dict(json.load(f), pool_frames=24)
    inputs = core.make_inputs(config)
    frames, eb = inputs["frames"], inputs["bound"]
    cfg = core.codec_config(config)
    ratio = cfg.pointwise_max_error_ratio
    _, _, _, tgt = api._batch_inputs(frames, 0, 8, cfg,
                                     api._pointwise_bound(frames, cfg, eb),
                                     card)
    _, _, _, maxq = api._scale_u16_host(frames[:8])
    want = api.pointwise_targets(frames[:8], eb[:8], ratio) - \
        maxq[:, None, None]
    assert tgt.is_cuda
    np.testing.assert_array_equal(tgt.cpu().numpy().view(np.uint32),
                                  want.view(np.uint32))
    t0 = time.perf_counter()
    blob = ebcc_tpu_torch.compress(frames, cfg, error_bound=eb,
                                   device="cuda")
    where = [r.attrs for r in profiling.records()
             if r.start >= t0 and r.name == "compress.targets"]
    assert where == [{"frames": 8, "where": "card"}] * 3
    assert blob == ebcc_tpu_torch.compress(
        frames, dataclasses.replace(cfg, encode_backend="cpu"),
        error_bound=eb)
    rec = ebcc_tpu_torch.decompress(blob, cfg, device="cuda")
    np.testing.assert_array_equal(rec, cpu_decoder.decompress(blob))
    assert np.all(np.abs(rec - frames) <= eb * np.float32(ratio))


def test_cuda_compress_matches_cpu_and_native(card):
    data = _field(5, seed=3)
    for mode, err in ((ResidualMode.MAX_ERROR, 0.25),
                      (ResidualMode.RELATIVE_ERROR, 0.004)):
        cfg = EBCCConfig(mode=mode, error=err, base_cr=200, max_batch=2)
        blob = ebcc_tpu_torch.compress(data, cfg, device="cuda")
        assert blob == ebcc_tpu_torch.compress(data, cfg, device="cpu")
        assert blob == cpu_encoder.compress(data, cfg)
        rec = ebcc_tpu_torch.decompress(blob, cfg, device="cuda")
        np.testing.assert_array_equal(
            rec, ebcc_tpu_torch.decompress(blob, cfg, device="cpu"))


# the stream packer (csrc/pack.cu) at the codec layers' geometries:
# (height, width, group levels, planes, stripes); the truncations are
# test_torch_pack.py's
PACK_GEOMS = {"base": (768, 1472, 6, 22, 8), "resid": (736, 1440, 4, 14, 8)}


@functools.lru_cache(maxsize=4)
def _pack_planes(geom, source, card):
    """int32 [2, h, w] planes of a layer on the card, and their spec:
    heavy-tailed random magnitudes with a zero band, or a codec batch's
    own planes of that layer (two 721x1440 bench frames, MAX_ERROR 0.5
    with the base quantile 1e-3, so the residual planes are coded)."""
    h, w, g, p, j = PACK_GEOMS[geom]
    spec = bp.CoderSpec(height=h, width=w, group_levels=g, nplanes=p,
                        nchunks=j)
    if source == "random":
        rng = np.random.default_rng(21)
        mag = np.minimum((rng.pareto(1.1, (2, h, w)) * 9).astype(np.int64),
                         (1 << (p - 1)) - 1)
        mag[:, h // 3:h // 2] = 0
        coef = (mag * rng.choice([-1, 1], mag.shape)).astype(np.int32)
        return torch.from_numpy(coef).to(card), spec
    from ebcc_tpu_torch import api
    from ebcc_tpu_torch.scripts import common
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5, max_batch=2)
    codec = FrameCodec(721, 1440, cfg, card)
    data = common.bench_frames(2)
    u, mn, mx, maxq = api._scale_u16_host(data)
    res, _ = codec._eb_multi_hostq(
        api._upload_u16(u, card), torch.from_numpy(mn).to(card),
        torch.from_numpy(mx).to(card),
        torch.from_numpy(np.float32(0.5) - maxq).to(card), (1e-3,))
    coef = res[0].base_coef if geom == "base" else res[0].resid_coef
    assert (codec.base if geom == "base" else codec.resid).spec == spec
    return coef, spec


@pytest.mark.parametrize("kind", PACK_KINDS)
@pytest.mark.parametrize("source", ["random", "codec"])
@pytest.mark.parametrize("geom", list(PACK_GEOMS))
def test_pack_kernel_equals_native_arena(card, geom, source, kind):
    """The kernel's arena equals native's coder_encode_batch byte for byte
    up to the truncation, and is zero past it."""
    coef, spec = _pack_planes(geom, source, card)
    an = bp.analyze(coef, spec)
    counts = bp.segment_counts(an, spec)
    trunc = _truncation(counts.cpu(), spec, kind).to(card)
    arena = pk.pack_streams(coef, an, counts, trunc, spec)
    torch.cuda.synchronize()
    arena = arena.cpu().numpy()
    assert arena.shape == (2, pk.stream_capacity(spec))
    ref = native.coder_encode_batch(coef.cpu().numpy(), trunc.cpu().numpy(),
                                    spec.group_levels, spec.nplanes,
                                    spec.nchunks)
    for i, t in enumerate(trunc.tolist()):
        nbytes = (t + 7) // 8
        np.testing.assert_array_equal(arena[i, :nbytes], ref[i, :nbytes])
        assert not arena[i, nbytes:].any()


def test_pack_kernel_equals_plain_and_refuses_bad_tensors(card):
    """At 96x160 the kernel's arena is the plain version's on the same
    tensors (every frame cut at another plane's end); it launches once and
    refuses a non-contiguous or a mixed-device input."""
    spec = bp.CoderSpec(96, 160, 4, 14, 8)
    rng = np.random.default_rng(6)
    coef = torch.from_numpy((rng.standard_normal((3, 96, 160)) * np.exp(
        rng.uniform(0, 7, (3, 96, 160)))).astype(np.int32)).to(card)
    an = bp.analyze(coef, spec)
    counts = bp.segment_counts(an, spec)
    trunc = bp.candidate_bits(counts, spec)[[0, 1, 2], [2, 6, 13], -1].long()
    pk.KERNEL.launches = 0
    arena = pk.pack_streams(coef, an, counts, trunc, spec)
    assert pk.KERNEL.launches == 1
    ref = pk.pack_streams_ref(an, trunc, spec)
    assert torch.equal(arena, ref)
    with pytest.raises(ValueError, match="contiguous"):
        pk.pack_streams(coef.transpose(1, 2).contiguous().transpose(1, 2),
                          an, counts, trunc, spec)
    with pytest.raises(ValueError, match="pack_streams"):
        pk.pack_streams(coef, an, counts, trunc.cpu(), spec)


def _z500_day(n=24):
    """The benchmark configuration's first day of frames and its codec
    configuration (portbench/configs/era5_z500_maxerr.json)."""
    from portbench import core
    with open("portbench/configs/era5_z500_maxerr.json") as f:
        config = json.load(f)
    frames = core.make_inputs(dict(config, pool_frames=n))["frames"]
    return frames, core.codec_config(config), config["env"]


def _host_packed(h, w, cfg, card):
    """A codec on the card whose streams the host's native coder packs
    from the int32 planes (the CPU's route)."""
    codec = FrameCodec(h, w, cfg, card)
    codec.packs_streams = False
    return codec


def test_cuda_packer_containers_equal_host_coder(card, monkeypatch):
    """``api.compress`` on the card: a seeded z500 day at the benchmark's
    configuration, a POINTWISE batch and a ``compress_multi_q`` batch give
    the containers of the host coder's path and of the native encoder."""
    from ebcc_tpu_torch import api
    from ebcc_tpu_torch.scripts import common
    day, cfg, env = _z500_day()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    blob = ebcc_tpu_torch.compress(day, cfg, device="cuda")
    assert blob == ebcc_tpu_torch.compress(
        day, cfg, codec=_host_packed(721, 1440, cfg, card))
    assert blob == cpu_encoder.compress(day, cfg)
    monkeypatch.delenv("EBCC_DISABLE_PURE_JP2_FALLBACK")
    data = common.bench_frames(8)
    eb = np.random.default_rng(3).uniform(0.2, 0.6, data.shape).astype(
        np.float32)
    pw = EBCCConfig(mode=ResidualMode.POINTWISE_MAX_ERROR, max_batch=8)
    blob = ebcc_tpu_torch.compress(data, pw, error_bound=eb, device="cuda")
    assert blob == ebcc_tpu_torch.compress(
        data, pw, error_bound=eb, codec=_host_packed(721, 1440, pw, card))
    assert blob == cpu_encoder.compress(data, pw, error_bound=eb)
    mq = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5, max_batch=8)
    qs = (1e-6, 1e-3)
    blobs = ebcc_tpu_torch.compress_multi_q(data, qs, mq, device="cuda")
    monkeypatch.setattr(api, "_codec_for",
                        lambda h, w, c, d: _host_packed(h, w, c, card))
    assert blobs == ebcc_tpu_torch.compress_multi_q(data, qs, mq,
                                                    device="cuda")
    for q, b in zip(qs, blobs):
        assert b == cpu_encoder.compress(data, mq, qbase=q)


def test_cuda_rate_modes_match_cpu_and_native(card):
    data = _field(5, seed=6)
    for mode in (ResidualMode.NONE, ResidualMode.SPARSIFICATION_FACTOR):
        cfg = EBCCConfig(mode=mode, base_cr=45, residual_cr=10, max_batch=2)
        blob = ebcc_tpu_torch.compress(data, cfg, device="cuda")
        assert blob == ebcc_tpu_torch.compress(data, cfg, device="cpu")
        assert blob == cpu_encoder.compress(data, cfg)
        rec = ebcc_tpu_torch.decompress(blob, cfg, device="cuda")
        np.testing.assert_array_equal(rec, cpu_decoder.decompress(blob))


def test_cuda_union_and_multi_q_match_native(card, monkeypatch):
    """With the pure-base fallback off, so frames keep a residual and both
    layers search masks: the union rule and every multi-q blob equal the
    native encoder's, and the cuda decode holds the bound."""
    monkeypatch.setenv("EBCC_DISABLE_PURE_JP2_FALLBACK", "1")
    data = _field(5, seed=7)
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5, base_cr=100,
                     max_batch=2)
    union = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5, base_cr=100,
                       max_batch=2, mask_search="union")
    blob = ebcc_tpu_torch.compress(data, union, device="cuda", qbase=1e-3)
    assert blob == cpu_encoder.compress(data, union, qbase=1e-3)
    qs = (0.0, 1e-6, 1e-3)
    blobs = ebcc_tpu_torch.compress_multi_q(data, qs, cfg, device="cuda")
    for q, b in zip(qs, blobs):
        assert b == cpu_encoder.compress(data, cfg, qbase=q)
    for b in blobs + [blob]:
        rec = ebcc_tpu_torch.decompress(b, cfg, device="cuda")
        assert np.abs(rec - data).max() <= 0.5


def _advecting(t=6, h=H, w=W):
    """tests/test_models.py's advecting texture at this file's size."""
    rng = np.random.default_rng(5)
    texture = rng.normal(0, 2.0, (h, w)).astype(np.float32)
    y, _ = np.mgrid[0:h, 0:w]
    base = (260 + 10 * np.sin(y / h * np.pi)).astype(np.float32)
    return np.stack([base + np.roll(texture, 3 * k, axis=1)
                     for k in range(t)]).astype(np.float32)


def test_cuda_forecast_is_deterministic_and_near_the_cpu(card):
    """The forecast replays bit-equal on the card (cuDNN without TF32, no
    benchmarked algorithm), and the same weights forecast on the CPU
    within 1e-4 of the data's spread."""
    from ebcc_tpu_torch.models import forecast
    frames = _advecting()
    model, meta = forecast.train_forecaster(frames[:5], warmup=2,
                                            features=8, steps=20,
                                            device="cuda")
    assert next(model.parameters()).is_cuda
    fn = forecast.make_forecast_fn(model, meta, device="cuda")
    hist = [frames[3], frames[4]]
    first = fn(hist)
    for _ in range(3):
        np.testing.assert_array_equal(fn(hist), first)
    on_cpu = forecast.make_forecast_fn(model, meta, device="cpu")(hist)
    np.testing.assert_allclose(first, on_cpu, rtol=0,
                               atol=1e-4 * meta["sd"])


def test_cuda_metrics_match_the_cpu(card):
    from ebcc_tpu_torch.ops import metrics
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(100, 10, (B, H, W)).astype(np.float32))
    y = x + torch.from_numpy(rng.uniform(-0.5, 0.5, x.shape).astype(
        np.float32))
    eb = torch.from_numpy(rng.uniform(0.1, 0.45, x.shape).astype(
        np.float32))
    for name, args in (("data_range", (x,)), ("max_error", (x, y)),
                       ("pointwise_violations", (x, y, eb))):
        out = getattr(metrics, name)(*(a.to(card) for a in args))
        assert out.is_cuda
        assert torch.equal(out.cpu(), getattr(metrics, name)(*args)), name
    # sums in another order than the CPU's
    for name, args in (("rmse", (x, y)), ("psnr", (x, y)),
                       ("max_relative_error", (x, y)),
                       ("error_quantile", (x, y, eb))):
        out = getattr(metrics, name)(*(a.to(card) for a in args))
        torch.testing.assert_close(out.cpu(), getattr(metrics, name)(*args),
                                   rtol=1e-5, atol=0)


def test_cuda_cli_compress_matches_native(card, tmp_path, capsys):
    import json
    from ebcc_tpu_torch import cli
    data = _field(3, seed=9)
    np.save(tmp_path / "in.npy", data)
    blob_path, rec_path = tmp_path / "x.ebt", tmp_path / "rec.npy"
    cli.main(["compress", str(tmp_path / "in.npy"), str(blob_path),
              "--error", "0.25", "--base-cr", "200"])
    row = json.loads(capsys.readouterr().out)
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.25, base_cr=200)
    blob = blob_path.read_bytes()
    assert row["bytes"] == len(blob)
    assert blob == cpu_encoder.compress(data, cfg)
    cli.main(["decompress", str(blob_path), str(rec_path)])
    np.testing.assert_array_equal(np.load(rec_path),
                                  cpu_decoder.decompress(blob))


def _cuda_mesh(n_data, n_space):
    """Logical shards of cuda:0 (one card, one rank: exchanges are
    copies)."""
    from ebcc_tpu_torch.parallel import mesh as pmesh
    return pmesh.make_mesh(n_data, n_space,
                           devices=["cuda:0"] * (n_data * n_space))


@pytest.mark.parametrize("n_data,n_space", [(1, 4), (2, 4)],
                         ids=["space4", "2x4"])
def test_cuda_halo_dwt_equals_dense(card, n_data, n_space):
    from ebcc_tpu_torch.ops import dwt_sharded as ds
    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 100, (2, 192, 160)).astype(np.float32)).to(card)
    fwd, inv = ds.make_sharded_dwt2d(_cuda_mesh(n_data, n_space), 3)
    per_shard = fwd(x)
    ref = dwt.dwt2d_multi(x, 3)
    assert per_shard.is_cuda
    assert torch.equal(ds.to_canonical(per_shard, n_space, 3), ref)
    assert torch.equal(inv(per_shard), dwt.idwt2d_multi_ref(ref, 3))


def test_cuda_sharded_codecs_equal_dense_and_native(card):
    """ShardedCodec (data 2) and SpatialShardedCodec (data 2 x space 2) on
    logical shards of cuda:0: the dense codec's selections, native's
    containers."""
    from ebcc_tpu_torch import api
    from ebcc_tpu_torch.parallel.batch import ShardedCodec, compress_sharded
    from ebcc_tpu_torch.parallel.spatial import SpatialShardedCodec
    h, w = 256, 160
    data = _field(4, h, w, seed=3)
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5, base_cr=100,
                     max_batch=4)
    tgt = torch.full((4,), 0.5, device=card)
    dense = FrameCodec(h, w, cfg, card).encode_error_bounded(
        torch.from_numpy(data).to(card), tgt, 1e-6)
    native_blob = cpu_encoder.compress(data, cfg)
    assert compress_sharded(data, cfg, _cuda_mesh(2, 1)) == native_blob
    for sc in (ShardedCodec(h, w, cfg, _cuda_mesh(2, 1)),
               SpatialShardedCodec(h, w, cfg, _cuda_mesh(2, 2))):
        res = sc.encode_error_bounded(torch.from_numpy(data).to(card), tgt,
                                      1e-6)
        for f in ("base_coef", "bs_q", "ks_q", "km_q", "mbits_q", "segs_q",
                  "bs_pure", "ks_pure", "km_pure", "mbits_pure",
                  "segs_pure", "skip_residual", "resid_feasible"):
            assert torch.equal(getattr(res, f), getattr(dense, f)), f
        assert api.compress(data, cfg, codec=sc) == native_blob


def test_cuda_packer_equals_native(card):
    spec = bp.CoderSpec(96, 160, 4, 14, 8)
    rng = np.random.default_rng(6)
    coef = (rng.standard_normal((3, 96, 160)) * np.exp(rng.uniform(
        0, 7, (3, 96, 160)))).astype(np.int32)
    c = torch.from_numpy(coef).to(card)
    counts = bp.segment_counts(bp.analyze(c, spec), spec)
    trunc = bp.candidate_bits(counts, spec)[:, 6, 5].long()
    words, _, max_step = bp.encode_batch(c, trunc, spec,
                                         int(trunc.max()) // 32 + 1)
    arena = native.coder_encode_batch(coef, trunc.cpu().numpy(), 4, 14, 8)
    streams = [bp.words_to_bytes(words[i], trunc[i]) for i in range(3)]
    for i, s in enumerate(streams):
        assert s == arena[i, :len(s)].tobytes()
    rec = bp.decode_batch(words, trunc, max_step, spec)
    ref = native.coder_decode_batch(streams, trunc.cpu().numpy(),
                                    max_step.cpu().numpy(), 96, 160, 4, 14,
                                    8, np.full(3, -1), np.zeros(3))
    np.testing.assert_array_equal(rec.cpu().numpy().view(np.uint32),
                                  ref.view(np.uint32))


def test_cuda_profile_stages_container_is_compress(card):
    """The stage-by-stage profile of a batch of 2 bench frames on the card
    writes ``compress``'s container (and the native encoder's), within the
    bound, with the packed streams' copy measured."""
    from ebcc_tpu_torch.scripts import common, profile_stages
    from ebcc_tpu_torch.scripts.bench import bench_config
    data = common.bench_frames(2)
    t, blob = profile_stages.profile_stages(data, "cuda")
    cfg = bench_config(2)
    assert blob == ebcc_tpu_torch.compress(data, cfg, device="cuda")
    assert blob == cpu_encoder.compress(data, cfg)
    assert t["max_err"] <= 0.5 and t["device"] == "cuda"
    # the card packs the base: its packed prefix crosses, a small part of
    # its int32 planes' bytes
    assert t["3a_coef_int32_bytes"] == 2 * 768 * 1472 * 4
    assert t["3_packed_on"] == "card"
    assert 0 < t["3a_arena_d2h_bytes"] < t["3a_coef_int32_bytes"] / 20
    assert t["3a_arena_d2h_gbps"] > 0
    assert t["1_device_encode_search"] >= t["1a_encode_enqueue"] > 0


def test_cuda_drivers_match_cpu_and_native(card, tmp_path, monkeypatch,
                                           capsys):
    """Three drivers of ``ebcc_tpu_torch/scripts/`` at their default
    device, the card, at 96x160: simple_example's size is the CPU's,
    compression_sweep's CR the native encoder's, and the stripe study's
    numbers the CPU's; each launches K2, K1 and idwt."""
    from ebcc_tpu_torch.models.direct import DirectCompressor
    from ebcc_tpu_torch.scripts import (common, compression_sweep,
                                        simple_example,
                                        stripe_adaptive_study)
    frames = common.bench_frames(3, H, W)
    frame_path, stack_path = tmp_path / "frame.npy", tmp_path / "stack.npy"
    np.save(frame_path, frames[0])
    np.save(stack_path, frames)
    kernels = (l0.KERNEL, fe.KERNEL, idwt.KERNEL)
    for k in kernels:
        k.launches = 0
    monkeypatch.setenv(common.REFERENCE_FRAME_ENV, str(frame_path))
    capsys.readouterr()
    assert simple_example.main([]) == 0
    out = capsys.readouterr().out
    eb = np.full_like(frames[0], 0.01 * (frames[0].max() - frames[0].min()))
    size = len(DirectCompressor(base_cr=100, device="cpu").compress(
        frames[0], eb))
    assert f"compressed: {size} B," in out and "violations: 0" in out
    csv_path = str(tmp_path / "sweep.csv")
    assert compression_sweep.main([str(stack_path), "--errors", "0.5",
                                   "--out", csv_path]) == 0
    [row] = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5, base_cr=100.0)
    assert row["max_error"] <= 0.5
    assert row["cr"] == frames.nbytes / len(cpu_encoder.compress(frames,
                                                                 cfg))
    got = stripe_adaptive_study.measure(frames[0], ResidualMode.MAX_ERROR,
                                        0.5)
    assert got == stripe_adaptive_study.measure(
        frames[0], ResidualMode.MAX_ERROR, 0.5, "cpu")
    assert all(k.launches > 0 for k in kernels), [k.launches
                                                   for k in kernels]


def _hostq_inputs(codec, data, pointwise):
    """One batch's u16 planes, ranges and targets on the card, as
    ``api._batch_inputs`` makes them (a per-point field for pointwise)."""
    from ebcc_tpu_torch import api
    u, mn, mx, maxq = api._scale_u16_host(data)
    if pointwise:
        eb = 0.2 + 0.3 * np.random.default_rng(8).random(data.shape)
        tgt = api.pointwise_targets(data, eb.astype(np.float32), 1.0) - \
            maxq[:, None, None]
    else:
        tgt = np.full(len(data), 0.25, np.float32) - maxq
    return (api._upload_u16(u, codec.device), *(
        torch.from_numpy(np.ascontiguousarray(a)).to(codec.device)
        for a in (mn, mx, tgt)))


def _assert_same_result(ours, eager):
    (res, meta), (eres, emeta) = ours, eager
    assert torch.equal(meta, emeta)
    for name in res._fields:
        a, b = getattr(res, name), getattr(eres, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("pointwise", [False, True],
                         ids=["max_error", "pointwise"])
def test_cuda_graph_replay_equals_eager(card, pointwise):
    """``encode_error_bounded_hostq`` on the card replays its CUDA graph
    (eager at the key's first call, captured at the second, replayed
    after) and equals the eager stage on every ``EncodeResult`` field and
    the packed metadata, batch after batch and at a second base quantile,
    which replays the same graph (the quantile is a tensor input); the
    replays count the kernels' launches."""
    codec = FrameCodec(H, W, EBCCConfig(max_batch=B), card)
    batches = [_hostq_inputs(codec, _field(B, seed=s), pointwise)
               for s in (9, 10, 12)]
    kernels = {l0.KERNEL, fe.KERNEL, idwt.KERNEL, pk.KERNEL}
    for k in kernels:
        k.launches = 0
    outs = [codec.encode_error_bounded_hostq(*b, 1e-6) for b in batches]
    assert len(codec.graph_entries()) == 1
    [entry] = codec.graph_entries().values()
    assert entry.replays == 2 and entry.launches
    # the eager first call launched each kernel once a batch, the capture
    # none, each of the two replays once; the stream packer among them
    assert set(entry.launches) == kernels
    assert all(k.launches == 3 * n for k, n in entry.launches.items())
    for out, b in zip(outs, batches):
        eres, emetas = codec._eb_multi_hostq(*b, (1e-6,))
        _assert_same_result(out, (eres[0], emetas[0]))
    q2 = codec.encode_error_bounded_hostq(*batches[0], 1e-3)
    assert len(codec.graph_entries()) == 1 and entry.replays == 3
    eres, emetas = codec._eb_multi_hostq(*batches[0], (1e-3,))
    _assert_same_result(q2, (eres[0], emetas[0]))


def test_cuda_graph_prefetch_keeps_each_batch(card):
    """Four batches in flight two at a time (``prefetch_batches=2``) give
    the containers of one batch at a time (``prefetch_batches=0``) and of
    the native encoder: a replay never overwrites a batch still in
    flight."""
    data = _field(8, seed=11)
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.25, base_cr=100,
                     max_batch=2, prefetch_batches=2)
    blob = ebcc_tpu_torch.compress(data, cfg, device="cuda")
    serial = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.25,
                        base_cr=100, max_batch=2, prefetch_batches=0)
    assert blob == ebcc_tpu_torch.compress(data, serial, device="cuda")
    assert blob == cpu_encoder.compress(data, cfg)
    rec = ebcc_tpu_torch.decompress(blob, cfg, device="cuda")
    np.testing.assert_array_equal(rec, cpu_decoder.decompress(blob))


def test_cuda_graph_threads_get_their_own_containers(card):
    """Threads compressing stacks of one shape at once (a numcodecs filter
    under dask) share the codec and its graphs and each get the native
    encoder's container of its own stack."""
    import threading
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.25, base_cr=100,
                     max_batch=2)
    stacks = [_field(4, seed=20 + i) for i in range(4)]
    for _ in range(2):  # the eager first call, then the capture
        ebcc_tpu_torch.compress(stacks[0], cfg, device="cuda")
    blobs, errors = {}, []

    def work(i):
        try:
            for _ in range(3):
                blobs[i] = ebcc_tpu_torch.compress(stacks[i], cfg,
                                                   device="cuda")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for i, stack in enumerate(stacks):
        assert blobs[i] == cpu_encoder.compress(stack, cfg), i


def test_cuda_pointwise_threads_get_their_own_containers(card):
    """Threads compressing pointwise stacks at once, each batch's rows
    through pinned memory without a wait and each copy back waited for on
    a blocking event, each get the native encoder's container of its own
    stack under its own bound."""
    import threading

    from ebcc_tpu_torch import api
    cfg = EBCCConfig(mode=ResidualMode.POINTWISE_MAX_ERROR, base_cr=100,
                     max_batch=2)
    stacks = [_field(5, seed=30 + i) for i in range(4)]
    bounds = [np.random.default_rng(40 + i).uniform(
        0.05, 0.5, s.shape).astype(np.float32) for i, s in enumerate(stacks)]
    rows = api._upload_pinned(bounds[0][:2], card)
    assert rows.is_cuda and rows.dtype == torch.float32
    np.testing.assert_array_equal(rows.cpu().numpy(), bounds[0][:2])
    for _ in range(2):  # the eager first call, then the capture
        ebcc_tpu_torch.compress(stacks[0], cfg, error_bound=bounds[0],
                                device="cuda")
    blobs, errors = {}, []

    def work(i):
        try:
            for _ in range(3):
                blobs[i] = ebcc_tpu_torch.compress(
                    stacks[i], cfg, error_bound=bounds[i], device="cuda")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for i, stack in enumerate(stacks):
        assert blobs[i] == cpu_encoder.compress(stack, cfg,
                                                error_bound=bounds[i]), i


def test_cuda_graph_spans_name_each_kind_of_call(card):
    """On the card a key's three first calls record ``graph.eager``,
    ``graph.capture`` and ``graph.replay``, each after its
    ``graph.lock_wait``, with the stage's name; inside ``compress`` every
    ``graph.*`` span carries the call's request id."""
    import time
    from ebcc_tpu_torch.runtime import graphs
    from ebcc_tpu_torch.utils import profiling

    def stage(x):
        return (x * 2 + 1,)

    x = torch.arange(8.0, device=card)
    cache = graphs.GraphCache()
    t0 = time.perf_counter()
    outs = [cache.run(0, "st", stage, (x,), card) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(o[0], x * 2 + 1) for o in outs)
    recs = [r for r in profiling.records() if r.start >= t0]
    assert [r.name for r in recs] == [
        "graph.lock_wait", "graph.eager", "graph.lock_wait", "graph.capture",
        "graph.lock_wait", "graph.replay"]
    assert all(r.attrs == {"stage": "st"} for r in recs[1::2])
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.25, base_cr=100,
                     max_batch=2)
    t1 = time.perf_counter()
    ebcc_tpu_torch.compress(_field(6, seed=31), cfg, device="cuda")
    recs = [r for r in profiling.records() if r.start >= t1]
    (call,) = [r for r in recs if r.name == "compress"]
    kinds = [r for r in recs if r.name.startswith("graph.")]
    assert {r.name for r in kinds} >= {"graph.lock_wait", "graph.replay"}
    assert all(r.request == call.request for r in kinds)
