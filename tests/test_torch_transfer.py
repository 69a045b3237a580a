"""The coefficient transfer forms and the batch pipelining of
``ebcc_tpu_torch`` on the CPU, against the JAX package and the native codec.

* ``FrameCodec._pack_small`` (u16 / u8 forms, shifts, validity) and
  ``_sparsify`` (the (delta, value) pairs, including all-zero frames,
  frames past the cap and gaps over 65535) equal the JAX package's;
* ``api._sparse_bucket`` at ``tests/test_sparse_transfer.py``'s points;
* the packed metadata: ``_unpack_meta(_pack_meta(res))`` is every small
  field of ``res``, and after ``_decide_pure`` equals the JAX package's
  ``_unpack_meta`` dict on the same frames, field for field;
* the forms' flags, shifts and counts of each layer and frame equal the
  JAX package's for the error-bounded, multi-quantile and rate-targeted
  encodes;
* the containers with the forms equal those with the fetch forced to the
  int32 planes and the native encoder's (a sparse base, a u8 residual,
  multi-q), and ``compress`` / ``decompress`` give the same bytes and
  frames at ``prefetch_batches`` 0, 1 and 2;
* the sharded codecs' containers stay the dense ones; the spatial codec
  never takes the sparse form (as the JAX package's);
* the native sparse, u16 and u8 entries give the int32 entry's arena.

Every comparison is exact.  One intra-op thread for the module (small
torch ops; see SKILL.md).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ebcc_tpu
import ebcc_tpu.api as jax_api
import ebcc_tpu_torch
from ebcc_tpu.codec.pipeline import FrameCodec as JaxCodec
from ebcc_tpu_torch import EBCCConfig, ResidualMode, api
from ebcc_tpu_torch.codec.pipeline import FrameCodec
from ebcc_tpu_torch.ops import bitplane as bp
from ebcc_tpu_torch.parallel import mesh as pmesh
from ebcc_tpu_torch.parallel.batch import ShardedCodec, compress_sharded
from ebcc_tpu_torch.parallel.spatial import SpatialShardedCodec
from ebcc_tpu_torch.runtime import cpu_encoder, native
from ebcc_tpu_torch.scripts import common

H, W = 96, 160
QS = (1e-6, 1e-3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(**kw):
    """The same configuration for the port and the JAX package."""
    kw = dict(mode=ResidualMode.MAX_ERROR, error=0.5, base_cr=100,
              max_batch=2, **kw)
    return EBCCConfig(**kw), ebcc_tpu.EBCCConfig(**kw)


@pytest.fixture(scope="module")
def frames():
    return common.bench_frames(2, H, W)


def _smooth(seed, h=128, w=256):
    y, x = np.mgrid[0:h, 0:w]
    return (260 + 25 * np.sin(y / h * np.pi) *
            np.cos(x / w * 2 * np.pi)).astype(np.float32)


@pytest.fixture(scope="module")
def noisy():
    """``tests/test_sparse_transfer.py``'s noisy fixture: a smooth field
    with 40 spikes a frame."""
    base = _smooth(0)
    rng = np.random.default_rng(7)
    out = np.stack([base, base * 1.001]).astype(np.float32)
    for b in range(2):
        ys = rng.integers(0, 128, 40)
        xs = rng.integers(0, 256, 40)
        out[b, ys, xs] += rng.choice([-2.0, 2.0], 40).astype(np.float32)
    return out


def _hostq(frames, cfg):
    """One batch's host-quantised inputs: (port tensors, JAX arrays)."""
    u, mn, mx, maxq = api._scale_u16_host(frames)
    tgt = np.float32(cfg.error) - maxq
    return ((api._upload_u16(u, "cpu"), torch.from_numpy(mn),
             torch.from_numpy(mx), torch.from_numpy(tgt)),
            (u, mn, mx, tgt))


@pytest.fixture(scope="module")
def encodes(frames):
    """The error-bounded, multi-quantile and rate-targeted encodes of the
    same two frames by both packages: {kind: ([port (res, meta)], [JAX
    (res, meta)])}."""
    cfg, jcfg = _configs()
    ours, theirs = FrameCodec(H, W, cfg, "cpu"), JaxCodec(H, W, jcfg)
    t_in, j_in = _hostq(frames, cfg)
    budgets = (int(32 * H * W / 100), int(8 * H * W / 10))
    out = {"error_bounded": (
        [ours.encode_error_bounded_hostq(*t_in, 1e-6)],
        [theirs.encode_error_bounded_hostq(*j_in, 1e-6)])}
    res, metas = ours.encode_error_bounded_multi_hostq(*t_in, QS)
    jres, jmetas = theirs.encode_error_bounded_multi_hostq(
        *j_in, np.asarray(QS, np.float32))
    out["multi_q"] = (list(zip(res, metas)), list(zip(jres, jmetas)))
    out["rate"] = (
        [ours.encode_rate_targeted_hostq(*t_in[:3], *budgets)],
        [theirs.encode_rate_targeted_hostq(
            *j_in[:3], *(np.full(2, b, np.int32) for b in budgets))])
    out["jax_codec"] = theirs
    return out


# ---------------- the forms on the device ----------------


def _planes(max_step, seed):
    """int32 [3, 64, 96] coefficients whose top plane is ``max_step``."""
    rng = np.random.default_rng(seed)
    mag = rng.integers(0, 1 << (max_step + 1), (3, 64, 96))
    mag[:, 0, 0] = 1 << max_step
    return (mag * rng.choice([-1, 1], mag.shape)).astype(np.int32)


@pytest.mark.parametrize("max_step, b_low", [
    (5, (0, 2, 5)),      # u16 and u8 both exact
    (12, (0, 5, 8)),     # u16 exact, u8 only where b_low >= 6
    (20, (3, 6, 14)),    # u16 where b_low >= 6, u8 where >= 14
])
def test_pack_small_equals_jax(max_step, b_low):
    ci = _planes(max_step, max_step)
    step = np.full(3, max_step, np.int32)
    low = np.asarray(b_low, np.int32)
    ours = FrameCodec._pack_small(torch.from_numpy(ci),
                                  torch.from_numpy(step),
                                  torch.from_numpy(low))
    theirs = JaxCodec._pack_small(jnp.asarray(ci), jnp.asarray(step),
                                  jnp.asarray(low))
    for name, a, b in zip(("p16", "p8", "shift16", "shift8", "ok16", "ok8"),
                          ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
        assert a.numpy().dtype == np.asarray(b).dtype, name
    ok16, ok8 = ours[4].numpy(), ours[5].numpy()
    np.testing.assert_array_equal(ok16, low >= max(0, max_step - 14))
    np.testing.assert_array_equal(ok8, low >= max(0, max_step - 6))


def _sparse_case(case):
    """(p16 uint16 [3, h, w], pack16_ok) of one case."""
    rng = np.random.default_rng(11)
    shape = (3, 256, 512) if case == "gap" else (3, 128, 192)
    p = np.zeros(shape, np.uint16)
    if case == "gap":
        # frame 0: a gap over 65535; frame 1: a gap of exactly 65535;
        # frame 2: pack16 not exact
        p[0].flat[[5, 5 + 70000, 5 + 70001]] = [3, 40000, 65535]
        p[1].flat[[0, 65535]] = [7, 9]
        p[2].flat[[1, 2]] = 1
        return p, np.array([True, True, False])
    density = {"zero": 0.0, "sparse": 0.02, "past_cap": 0.3}[case]
    m = rng.random(shape) < density
    p[m] = rng.integers(1, 65536, m.sum()).astype(np.uint16)
    return p, np.ones(3, bool)


@pytest.mark.parametrize("case", ["zero", "sparse", "past_cap", "gap"])
def test_sparsify_equals_jax(case):
    p, ok = _sparse_case(case)
    k = p.shape[1] * p.shape[2] // 8
    jcodec = JaxCodec(128, 192, ebcc_tpu.EBCCConfig(max_batch=3))
    ours = FrameCodec(128, 192, EBCCConfig(max_batch=3), "cpu")._sparsify(
        torch.from_numpy(p), torch.from_numpy(ok), k)
    theirs = jax.jit(jcodec._sparsify, static_argnums=2)(
        jnp.asarray(p), jnp.asarray(ok), k)
    for name, a, b in zip(("delta", "val", "nsig", "ok"), ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
        assert a.numpy().dtype == np.asarray(b).dtype, name
    nsig, valid = ours[2].numpy(), ours[3].numpy()
    if case == "past_cap":
        assert (nsig > k).all() and not valid.any()
    elif case == "gap":
        assert valid.tolist() == [False, True, False]
    else:
        assert valid.all() and (nsig <= k).all()


def test_sparse_bucket_trim_is_lossless():
    """``tests/test_sparse_transfer.py``'s points."""
    assert api._sparse_bucket(0, 100_000) == 4096
    assert api._sparse_bucket(4096, 100_000) == 4096
    assert api._sparse_bucket(4097, 100_000) == 8192
    assert api._sparse_bucket(70_000, 100_000) == 73_728
    assert api._sparse_bucket(99_999, 100_000) == 100_000
    for kmax in (0, 1, 4096, 8192, 8193, 70_000, 141_312):
        k = api._sparse_bucket(kmax, 141_312)
        assert k == jax_api._sparse_bucket(kmax, 141_312)
        assert kmax <= k <= 141_312


# ---------------- the small fields and the flags ----------------

# the small fields the port holds equal to the JAX package's on these
# frames: the base layer's selections and masks, the decision, and every
# transfer-form flag, shift and count
JAX_EQUAL = (
    "mn", "mx", "const", "dc_b", "max_step_b", "base_bits_q",
    "base_bits_pure", "base_feasible_pure", "bs_q", "ks_q", "bs_pure",
    "ks_pure", "km_q", "km_pure", "mbits_q", "mbits_pure", "segs_q",
    "segs_pure", "skip_residual", "decided_pure")
FORM_FLAGS = tuple(f"{layer}_{f}" for layer in ("base", "resid")
                   for f in ("shift", "shift8", "pack16_ok", "pack8_ok",
                             "nsig", "sparse_ok"))


def test_packed_metadata_round_trips_and_equals_jax(encodes):
    (res, meta), = encodes["error_bounded"][0]
    (jres, jmeta), = encodes["error_bounded"][1]
    cfg, _ = _configs()
    got = api._unpack_meta(meta.numpy(), cfg.nchunks)
    small = [f for f in res._fields if f not in
             ebcc_tpu_torch.codec.pipeline.DEFERRED_FIELDS]
    assert list(got) == small
    for name in small:
        v = getattr(res, name).numpy()
        assert got[name].dtype == (v.dtype if v.dtype in (np.float32, bool)
                                   else np.int32), name
        np.testing.assert_array_equal(got[name], v, name)
    got["decided_pure"] = api._decide_pure(got, cfg.mode)
    theirs = jax_api._unpack_meta(jmeta, cfg.nchunks)
    theirs["decided_pure"] = jax_api._decide_pure(theirs, cfg.mode)
    assert set(got) == set(theirs)
    for name in JAX_EQUAL + FORM_FLAGS:
        np.testing.assert_array_equal(got[name], theirs[name], name)


@pytest.mark.parametrize("kind", ["error_bounded", "multi_q", "rate"])
def test_form_flags_equal_jax(encodes, kind):
    """Each layer's flags, shifts and counts, frame by frame, equal the JAX
    package's; the base forms are the same planes.  The JAX package's
    residual coefficients can differ from the port's by a few units (XLA
    fuses the base reconstruction with other fma choices; the port
    follows the native encoder), which moves the residual's count of
    nonzeros: in the rate encode it is held instead, with every other
    residual form, to the JAX functions run on the port's own residual
    plane."""
    ours, theirs = encodes[kind]
    jcodec = encodes["jax_codec"]
    assert len(ours) == len(theirs) == (len(QS) if kind == "multi_q" else 1)
    for (res, _), (jres, _) in zip(ours, theirs):
        for name in FORM_FLAGS:
            if kind == "rate" and name == "resid_nsig":
                continue
            np.testing.assert_array_equal(
                getattr(res, name).numpy(), np.asarray(getattr(jres, name)),
                f"{kind}: {name}")
        for name in ("base_pack16", "base_pack8", "base_sp_delta",
                     "base_sp_val"):
            np.testing.assert_array_equal(
                getattr(res, name).numpy(), np.asarray(getattr(jres, name)),
                f"{kind}: {name}")
        low = np.where(res.skip_residual.numpy(), jcodec.resid.spec.nplanes,
                       res.bs_r.numpy()).astype(np.int32)
        p16, p8, s16, s8, ok16, ok8 = JaxCodec._pack_small(
            jnp.asarray(res.resid_coef.numpy()),
            jnp.asarray(res.max_step_r.numpy()), jnp.asarray(low))
        d, v, nsig, oksp = jcodec._sparsify(p16, ok16,
                                            jcodec.resid_sparse_k)
        for name, b in (("pack16", p16), ("pack8", p8), ("shift", s16),
                        ("shift8", s8), ("pack16_ok", ok16),
                        ("pack8_ok", ok8), ("sp_delta", d), ("sp_val", v),
                        ("nsig", nsig), ("sparse_ok", oksp)):
            np.testing.assert_array_equal(
                getattr(res, f"resid_{name}").numpy(), np.asarray(b),
                f"{kind}: resid_{name} of the port's plane")
    # the forms are all exercised: the bench frames' base is sparse
    assert all(r.base_sparse_ok.all() for r, _ in ours)


# ---------------- the containers ----------------


def _forced_int32(monkeypatch):
    monkeypatch.setattr(api, "_fetch_coef", lambda res, rd, layer: (
        "dense", api._host(rd, f"{layer}_coef"), None))


def _forms_taken(monkeypatch):
    """Record (layer, form, dtype) of every fetch the api makes."""
    taken, orig = [], api._fetch_coef

    def record(res, rd, layer):
        form = orig(res, rd, layer)
        taken.append((layer, form[0], form[1].dtype.name))
        return form

    monkeypatch.setattr(api, "_fetch_coef", record)
    return taken


@pytest.mark.parametrize("case", ["sparse_base", "u16_base_sparse_resid",
                                  "int32_base_u8_resid", "multi_q"])
def test_blobs_equal_forced_int32_and_native(case, noisy, monkeypatch):
    """Each rung of the ladder, taken by a real encode: the container is
    the one with the fetch forced to the int32 planes, and the native
    encoder's."""
    if case in ("sparse_base", "multi_q"):
        data, qbase = _smooth(0)[None].repeat(2, 0), 1e-6
        data = data + np.random.default_rng(3).normal(
            0, 0.02, data.shape).astype(np.float32)
        cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=2.0,
                         base_cr=100, max_batch=2)
        expect = {("base", "sparse", "uint16")}
        if case == "multi_q":  # q 1e-3 keeps a sparse residual
            expect.add(("resid", "sparse", "uint16"))
    else:
        # the residual layer carries the spikes: no pure fallback
        monkeypatch.setenv("EBCC_DISABLE_PURE_JP2_FALLBACK", "1")
        data = noisy
        if case == "u16_base_sparse_resid":
            qbase, error = 1e-2, 0.25
            expect = {("base", "dense", "uint16"),
                      ("resid", "sparse", "uint16")}
        else:  # more than 15 base planes coded
            qbase, error = 0.02, 0.1
            expect = {("base", "dense", "int32"), ("resid", "dense", "uint8")}
        cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=error,
                         base_cr=150, max_batch=2)

    def run():
        if case == "multi_q":
            return ebcc_tpu_torch.compress_multi_q(data, QS, cfg,
                                                   device="cpu")
        return [ebcc_tpu_torch.compress(data, cfg, device="cpu",
                                        qbase=qbase)]

    with monkeypatch.context() as m:
        taken = _forms_taken(m)
        blobs = run()
    assert set(taken) == expect
    with monkeypatch.context() as m:
        _forced_int32(m)
        assert run() == blobs
    for q, blob in zip(QS if case == "multi_q" else (qbase,), blobs):
        assert blob == cpu_encoder.compress(data, cfg, qbase=q)
    rec = ebcc_tpu_torch.decompress(blobs[0], device="cpu")
    assert np.abs(rec - data).max() <= cfg.error


@pytest.fixture(scope="module")
def five():
    """5 frames in batches of 2 (a partial last batch): the blob, equal to
    the native encoder's, and its frames."""
    cfg, _ = _configs()
    data = common.bench_frames(5, H, W, seed=4)
    blob = ebcc_tpu_torch.compress(data, cfg, device="cpu")
    assert blob == cpu_encoder.compress(data, cfg)
    return cfg, data, blob, ebcc_tpu_torch.decompress(blob, device="cpu")


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_prefetch_batches_give_the_same_bytes_and_frames(five, prefetch):
    cfg, data, blob, rec = five
    pcfg = dataclasses.replace(cfg, prefetch_batches=prefetch)
    assert ebcc_tpu_torch.compress(data, pcfg, device="cpu") == blob
    np.testing.assert_array_equal(
        ebcc_tpu_torch.decompress(blob, pcfg, device="cpu").view(np.uint32),
        rec.view(np.uint32))
    assert ebcc_tpu_torch.compress_multi_q(data, QS[:1], pcfg,
                                           device="cpu") == [blob]


def test_sharded_blobs_unchanged_and_spatial_never_sparse(frames):
    # shallow transforms: 2 row blocks of 48 rows need 48 % 2**L == 0
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=1.0, max_batch=2,
                     base_levels=3, residual_levels=2)
    dense = ebcc_tpu_torch.compress(frames, cfg, device="cpu")
    assert dense == cpu_encoder.compress(frames, cfg)
    mesh = pmesh.make_mesh(2, 1, devices=["cpu"] * 2)
    assert compress_sharded(frames, cfg, mesh) == dense
    assert ebcc_tpu_torch.compress(frames, cfg,
                                   codec=ShardedCodec(H, W, cfg, mesh)) == \
        dense
    sc = SpatialShardedCodec(H, W, cfg,
                             pmesh.make_mesh(1, 2, devices=["cpu"] * 2))
    assert ebcc_tpu_torch.compress(frames, cfg, codec=sc) == dense
    t_in, _ = _hostq(frames, cfg)
    res, meta = sc.encode_error_bounded_hostq(*t_in, 1e-6)
    ref, _ = FrameCodec(H, W, cfg, "cpu").encode_error_bounded_hostq(
        *t_in, 1e-6)
    assert ref.base_sparse_ok.all()  # the dense codec takes it here
    for layer in ("base", "resid"):
        assert not getattr(res, f"{layer}_sparse_ok").any()
        for f in ("sp_delta", "sp_val", "nsig"):
            assert not getattr(res, f"{layer}_{f}").to(torch.int32).any()
        for f in ("pack16", "pack8", "shift", "shift8", "pack16_ok",
                  "pack8_ok"):
            assert torch.equal(getattr(res, f"{layer}_{f}"),
                               getattr(ref, f"{layer}_{f}")), f
    got = api._unpack_meta(meta.numpy(), cfg.nchunks)
    assert not got["base_sparse_ok"].any()


# ---------------- the native entries ----------------


@pytest.mark.parametrize("max_step, b_low", [(6, 0), (13, 9)])
def test_native_sparse_u16_u8_equal_int32_arena(max_step, b_low):
    """Every form of a plane, through its native entry, gives the arena of
    the int32 plane it stands for (the coefficients below the lowest coded
    plane zeroed) through the coded planes: complete in frame 0, cut
    inside them in frames 1 and 2."""
    ci = _planes(max_step, 3)
    ci[:, 8:40, 16:80] = 0  # rows the coder skips
    step = np.full(3, max_step, np.int32)
    low = np.full(3, b_low, np.int32)
    codec = FrameCodec(64, 96, EBCCConfig(max_batch=3), "cpu")
    p16, p8, s16, s8, ok16, ok8 = (t.numpy() for t in codec._pack_small(
        torch.from_numpy(ci), torch.from_numpy(step), torch.from_numpy(low)))
    assert ok16.all() and ok8.all()
    k = 64 * 96
    d, v, nsig, oksp = (t.numpy() for t in codec._sparsify(
        torch.from_numpy(p16), torch.from_numpy(ok16), k))
    assert oksp.all()
    plane = np.where(np.abs(ci) >> b_low > 0, ci, 0)
    spec = bp.CoderSpec(height=64, width=96, group_levels=3, nplanes=14,
                        nchunks=4)
    cand = bp.candidate_bits(bp.segment_counts(
        bp.analyze(torch.from_numpy(plane), spec), spec), spec).numpy()
    coded = cand[:, spec.nplanes - 1 - b_low, -1].astype(np.int64)
    trunc = coded * np.array([2, 1, 1]) // np.array([2, 2, 7])
    geo = (spec.group_levels, spec.nplanes, spec.nchunks)
    ref = native.coder_encode_batch(plane, trunc, *geo)
    assert ref.any()
    np.testing.assert_array_equal(
        native.coder_encode_batch(p16, trunc, *geo, shifts=s16), ref)
    np.testing.assert_array_equal(
        native.coder_encode_batch(p8, trunc, *geo, shifts=s8), ref)
    kb = api._sparse_bucket(int(nsig.max()), k)
    np.testing.assert_array_equal(native.coder_encode_batch_sparse(
        d[:, :kb], v[:, :kb], nsig, s16, 64, 96, trunc, *geo), ref)
    with pytest.raises(ValueError, match="shifts"):
        native.coder_encode_batch(p16, trunc, *geo)
