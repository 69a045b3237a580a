"""The PyTorch port's tensor ops against the JAX package and the native
codec, on the CPU.

Inputs come from numpy seeds and go through both packages; JAX stays on
the CPU.  Exactness is asserted where the arithmetic is integer or fixed
by the native codec's fma sites; the float DWT against JAX carries a
stated tolerance (XLA contracts multiply-adds by fusion context).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ebcc_tpu.codec.pipeline import FrameCodec as JaxCodec
from ebcc_tpu.codec.config import EBCCConfig as JaxConfig
from ebcc_tpu.ops import bitplane as jbp
from ebcc_tpu.ops import dwt as jdwt
from ebcc_tpu.ops import weights as jweights
from ebcc_tpu import dataprep as jdataprep

from ebcc_tpu_torch.codec.config import EBCCConfig, ResidualMode
from ebcc_tpu_torch.codec.pipeline import FrameCodec
from ebcc_tpu_torch.ops import bitplane as bp
from ebcc_tpu_torch import dataprep
from ebcc_tpu_torch.ops import dwt, weights
from ebcc_tpu_torch.ops import fused_eval as fe
from ebcc_tpu_torch.runtime import native

CPU = torch.device("cpu")


def _field(h, w, n=1, seed=0, noise=0.3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (260 + 25 * np.sin(y / h * np.pi) *
            np.cos(x / w * 2 * np.pi)).astype(np.float32)
    return np.stack([base + rng.normal(0, noise, base.shape)
                     .astype(np.float32) for _ in range(n)])


@pytest.mark.parametrize("hp,wp,levels", [(768, 1472, 5), (736, 1440, 3),
                                          (128, 192, 5), (96, 160, 3)])
def test_weight_array_bit_identical(hp, wp, levels):
    ours = weights.weight_array(hp, wp, levels)
    ref = jweights.weight_array(hp, wp, levels)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("h,w", [(96, 160), (721, 1440)])
def test_base_coefficients_equal_native(h, w):
    """u16 scale -> pad -> DC -> forward DWT -> weights -> trunc, integer
    for integer against the native encoder's debug hook."""
    frame = _field(h, w, seed=1, noise=0.5)[0]
    ref, dc_ref = native.debug_base_coef(frame, 5)
    u, _, _, _ = native.scale_u16_batch(frame[None])
    codec = FrameCodec(h, w, EBCCConfig(), CPU)
    dc, ci = codec._base_transform_scaled(
        torch.from_numpy(u.astype(np.float32)))
    assert float(dc[0]) == dc_ref
    np.testing.assert_array_equal(ci[0].numpy(), ref)


@pytest.mark.parametrize("levels", [1, 3])
def test_dwt_matches_jax(levels):
    rng = np.random.default_rng(2)
    x = (rng.normal(0, 100, (2, 96, 160))).astype(np.float32)
    ours = dwt.dwt2d_multi(torch.from_numpy(x), levels).numpy()
    ref = np.asarray(jdwt.dwt2d_multi(jnp.asarray(x), levels))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * scale)
    inv = dwt.idwt2d_multi(torch.from_numpy(ours), levels).numpy()
    inv_ref = np.asarray(jdwt.idwt2d_multi(jnp.asarray(ref), levels))
    np.testing.assert_allclose(inv, inv_ref, rtol=0,
                               atol=1e-5 * np.abs(inv_ref).max())
    np.testing.assert_allclose(inv, x, rtol=0, atol=1e-4 * np.abs(x).max())


@pytest.mark.parametrize("shape,levels", [((2, 96, 160), 3),
                                          ((1, 128, 192), 5),
                                          ((2, 96, 160), 1)])
def test_idwt_dispatch_on_cpu_is_plain_and_near_jax(shape, levels):
    """On a CPU tensor :func:`dwt.idwt2d_multi` is its plain version, bit
    for bit, and within 1e-5 (relative to the largest value) of the JAX
    package's inverse (XLA contracts other multiply-adds)."""
    rng = np.random.default_rng(8)
    x = rng.normal(0, 50, shape).astype(np.float32)
    ours = dwt.idwt2d_multi(torch.from_numpy(x), levels).numpy()
    ref = dwt.idwt2d_multi_ref(torch.from_numpy(x), levels).numpy()
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))
    jref = np.asarray(jdwt.idwt2d_multi(jnp.asarray(x), levels))
    np.testing.assert_allclose(ours, jref, rtol=0,
                               atol=1e-5 * np.abs(jref).max())


def test_eval_stats_ref_stays_plain(monkeypatch):
    """The plain candidate evaluation calls the plain inverse DWT, never
    the dispatching one (which launches the kernel for CUDA tensors)."""
    def boom(*a, **k):
        raise AssertionError("eval_stats_ref reached dwt.idwt2d_multi")

    monkeypatch.setattr(dwt, "idwt2d_multi", boom)
    rng = np.random.default_rng(9)
    ci = torch.from_numpy(rng.integers(-500, 500, (2, 64, 96)).astype(
        np.int32))
    ref = torch.from_numpy(rng.normal(0, 1, (2, 64, 96)).astype(np.float32))
    maxd, cnt = fe.eval_stats_ref(ci, ref, torch.full((2,), 3), kind="base",
                                  mode="trunc", levels=3, nchunks=8, h=60,
                                  w=90, js=8, jr=8, dc=0.0, lo=0.0, hi=1.0,
                                  tgt=0.1)
    assert maxd.shape == cnt.shape == (2,)


@pytest.mark.parametrize("fn", ["upsample_3t_2s", "interpolate_to_grid",
                                "interpolate_time"])
def test_dataprep_bit_equal_to_jax_package(fn):
    rng = np.random.default_rng(10)
    spread = (0.1 + rng.random((4, 19, 36))).astype(np.float32)
    lat, lon = np.linspace(90, -90, 19), np.arange(0, 360, 10.0)
    if fn == "upsample_3t_2s":
        args = (spread,)
    elif fn == "interpolate_to_grid":
        args = (spread, lat, lon, np.linspace(-90, 90, 37),
                np.arange(0, 360, 4.0))
    else:
        args = (spread, np.arange(4) * 6.0, np.arange(0, 20, 1.5))
    ours = getattr(dataprep, fn)(*args)
    theirs = getattr(jdataprep, fn)(*args)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours.view(np.uint32),
                                  theirs.view(np.uint32))


@pytest.fixture(scope="module")
def coefs():
    """Integer base coefficients of a 2-frame 96x160 batch, plus both
    packages' analyses of them."""
    data = _field(96, 160, n=2, seed=3)
    u, _, _, _ = native.scale_u16_batch(data)
    codec = FrameCodec(96, 160, EBCCConfig(), CPU)
    _, ci = codec._base_transform_scaled(torch.from_numpy(
        u.astype(np.float32)))
    spec = codec.base.spec
    jspec = JaxCodec(96, 160, JaxConfig()).base.spec
    assert tuple(spec) == tuple(jspec)
    an = bp.analyze(ci, spec)
    jan = jbp.analyze(jnp.asarray(ci.numpy()), jspec)
    return spec, jspec, an, jan


def test_analyze_matches_jax(coefs):
    spec, _, an, jan = coefs
    np.testing.assert_array_equal(an.mag.numpy(), np.asarray(jan.mag))
    np.testing.assert_array_equal(an.neg.numpy(), np.asarray(jan.neg))
    np.testing.assert_array_equal(an.msb.numpy(), np.asarray(jan.msb))
    for k in range(spec.group_levels + 1):
        np.testing.assert_array_equal(an.smax[k].numpy(),
                                      np.asarray(jan.smax[k]))
    np.testing.assert_array_equal(an.max_step.numpy(),
                                  np.asarray(jan.max_step))


def test_counts_and_candidate_bits_match_jax(coefs):
    spec, jspec, an, jan = coefs
    counts = bp.segment_counts(an, spec)
    jcounts = jbp.segment_counts(jan, jspec)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(
        bp.candidate_bits(counts, spec).numpy(),
        np.asarray(jbp.candidate_bits(jcounts, jspec)))
    bstar = torch.tensor([7, 12], dtype=torch.int32)
    np.testing.assert_array_equal(
        bp.mask_segments(counts, bstar, spec).numpy(),
        np.asarray(jbp.mask_segments(jcounts, jnp.asarray(bstar.numpy()),
                                     jspec)))


@pytest.mark.parametrize("b,js,jr", [(0, None, None), (9, None, None),
                                     (6, 3, 0), (6, 8, 5), (11, 1, 0)])
def test_recon_truncated_matches_jax(coefs, b, js, jr):
    spec, jspec, an, jan = coefs

    def vec(v, lib):
        return None if v is None else lib.full((2,), v, dtype=lib.int32)

    ours = bp.recon_truncated(an, vec(b, torch), vec(js, torch),
                              vec(jr, torch), spec)
    ref = jbp.recon_truncated(jan, vec(b, jnp), vec(js, jnp), vec(jr, jnp),
                              jspec)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_recon_deep_planes_use_exact_midpoint(coefs):
    """XLA's CPU exp2 is inexact for odd integer exponents >= 13
    (exp2(13) = 8192.0039), which moves JAX's midpoint ``(2^d - 1) / 2``
    there; the native codec, and this port, use the exact value.  Below
    depth 13 the two agree bit for bit (test above)."""
    spec, jspec, an, jan = coefs
    b = torch.full((2,), 13, dtype=torch.int32)
    ours = bp.recon_truncated(an, b, spec=spec).numpy()
    ref = np.asarray(jbp.recon_truncated(jan, jnp.asarray(b.numpy()),
                                         spec=jspec))
    mag = an.mag.numpy()
    q = (mag >> 13) << 13
    exact = np.where(q > 0, q.astype(np.float32) + np.float32(4095.5), 0)
    np.testing.assert_array_equal(ours, np.where(an.neg.numpy(), -exact,
                                                 exact))
    xla_err = float(jnp.exp2(jnp.float32(13))) - 8192.0
    assert np.abs(ours - ref).max() <= 0.5 * xla_err


def test_recon_masked_matches_jax(coefs):
    spec, jspec, an, jan = coefs
    rng = np.random.default_rng(4)
    for b in (3, 8):
        drop = rng.random((2, spec.nchunks)) < 0.4
        bv = np.full(2, b, np.int32)
        ours = bp.recon_masked(an, torch.from_numpy(bv),
                               torch.from_numpy(drop), spec)
        ref = jbp.recon_masked(jan, jnp.asarray(bv), jnp.asarray(drop), jspec)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_splice_masked_stream_matches_jax():
    rng = np.random.default_rng(5)
    stream = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    segs = [40, 9, 12, 0, 30, 7, 20, 11, 3, 5]  # J = 4
    for keep in (0b1111, 0b1010, 0b0001):
        assert bp.splice_masked_stream(stream, segs, keep, 4) == \
            jbp.splice_masked_stream(stream, segs, keep, 4)


def test_unscale_is_native_fma():
    """The unscale rounds once (fma), as native and XLA do; a separate
    multiply and add can differ in the last bit."""
    from ebcc_tpu_torch.ops import frame

    rng = np.random.default_rng(6)
    y = rng.integers(0, 65536, (1, 64, 64)).astype(np.float32)
    mn, mx = np.float32(231.25), np.float32(297.5)
    c = np.float32(frame.RECIP_U16) * (mx - mn)
    ref = (y.astype(np.float64) * np.float64(c) + np.float64(mn)).astype(
        np.float32)
    ours = frame.unscale(torch.from_numpy(y), torch.tensor([mn]),
                         torch.tensor([mx]))
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_resid_transform_matches_jax():
    data = _field(96, 160, n=2, seed=7)
    resid = (data - data.mean(axis=(1, 2), keepdims=True)).astype(np.float32)
    ours = FrameCodec(96, 160, EBCCConfig(mode=ResidualMode.MAX_ERROR),
                      CPU)._resid_transform(torch.from_numpy(resid))
    jc = JaxCodec(96, 160, JaxConfig())
    ref = jax.jit(jc._resid_transform)(jnp.asarray(resid))
    for a, b in zip(ours[:3], ref[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    diff = ours[3].numpy() != np.asarray(ref[3])
    # float lifting inside one XLA fusion can move a coefficient across an
    # integer boundary (a few per million); the native recipe is the spec
    assert diff.mean() < 1e-3
