"""The port's torch bit packer (``ops/bitplane.py``: ``encode_batch`` /
``decode_batch``), ``FrameCodec.decode`` and the f32 entry points on the
CPU, against the JAX package's packer and the native host coder.

* the packed words equal the JAX package's ``bp.encode_batch`` words and
  the native ``coder_encode_batch`` arena bytes, for the base and the
  residual layer of a 96x160 frame at several truncations;
* ``decode_batch`` equals the native ``coder_decode_batch`` exactly, on
  prefix streams and on chunk-masked streams spliced as the container
  stores them; it equals the JAX package's decode except at midpoints of
  planes >= 13, where XLA's exp2 is inexact and the port keeps the exact
  ``2**p`` of the native decoder;
* ``FrameCodec.decode`` of those streams is bit-equal to ``recon`` of the
  native decoder's coefficients;
* ``scale_to_u16`` is bit-equal to the native host scaling, and the f32
  entry point's coefficients equal the host-quantised entry point's.
"""

import numpy as np
import pytest
import torch

from ebcc_tpu_torch.api import _scale_u16_host, _upload_u16
from ebcc_tpu_torch.codec.config import EBCCConfig, ResidualMode
from ebcc_tpu_torch.codec.pipeline import FrameCodec
from ebcc_tpu_torch.ops import bitplane as bp
from ebcc_tpu_torch.ops import frame
from ebcc_tpu_torch.runtime import native

B, H, W = 3, 96, 160
CFG = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.25, base_cr=200,
                 max_batch=B)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread a process: these tests run many small torch
    ops, which under several test workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(seed=0, noise=0.3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    base = (260 + 25 * np.sin(y / H * np.pi) *
            np.cos(x / W * 2 * np.pi)).astype(np.float32)
    return np.stack([base + rng.normal(0, noise, base.shape)
                     .astype(np.float32) for _ in range(B)])


@pytest.fixture(scope="module")
def encoded():
    data = _field()
    codec = FrameCodec(H, W, CFG, "cpu")
    res = codec.encode_error_bounded(torch.from_numpy(data),
                                     torch.full((B,), 0.25), 1e-6)
    return data, codec, res


def _layers(codec, res):
    """(name, spec, coefficients, truncations [B] of three kinds: the
    whole stream, the selection, a cut inside an upper plane; the word
    capacity of the whole stream, shared by the three)."""
    out = []
    for layer, sel in (("base", res.base_bits_q), ("resid", res.resid_bits)):
        spec = getattr(codec, layer).spec
        coef = getattr(res, f"{layer}_coef")
        counts = bp.segment_counts(bp.analyze(coef, spec), spec)
        full = bp.bits_at_plane_boundaries(counts)[:, -1]
        upper = bp.candidate_bits(counts, spec)[:, 4, 3]
        for kind, trunc in (("full", full), ("selection", sel),
                            ("upper", upper)):
            out.append((f"{layer}-{kind}", spec, coef, trunc.long(),
                        _cap(full)))
    return out


def _cap(trunc):
    return int(trunc.max()) // 32 + 1


def _streams(words, trunc):
    return [bp.words_to_bytes(words[i], trunc[i]) for i in range(B)]


def test_words_equal_jax_and_native(encoded):
    import jax.numpy as jnp

    from ebcc_tpu.ops import bitplane as jbp

    _, codec, res = encoded
    for name, spec, coef, trunc, cap in _layers(codec, res):
        words, total, max_step = bp.encode_batch(coef, trunc, spec, cap)
        jspec = jbp.CoderSpec(*spec)
        jw, jt, jm = jbp.encode_batch(jnp.asarray(coef.numpy()),
                                      jnp.asarray(trunc.numpy(), jnp.int32),
                                      jspec, cap)
        np.testing.assert_array_equal(words.numpy(),
                                      np.asarray(jw).astype(np.int64),
                                      err_msg=name)
        np.testing.assert_array_equal(total.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(max_step.numpy(), np.asarray(jm))
        arena = native.coder_encode_batch(coef.numpy(), trunc.numpy(),
                                          spec.group_levels, spec.nplanes,
                                          spec.nchunks)
        for i, s in enumerate(_streams(words, trunc)):
            assert s == arena[i, :len(s)].tobytes(), (name, i)


def _native_decode(streams, trunc, max_step, spec, mask=None, keep=None):
    return native.coder_decode_batch(
        streams, trunc.numpy(), max_step.numpy(), spec.height, spec.width,
        spec.group_levels, spec.nplanes, spec.nchunks,
        np.full(B, -1) if mask is None else mask,
        np.zeros(B) if keep is None else keep)


def test_decode_equals_native_and_jax(encoded):
    import jax.numpy as jnp

    from ebcc_tpu.ops import bitplane as jbp

    _, codec, res = encoded
    deep = 0
    for name, spec, coef, trunc, cap in _layers(codec, res):
        words, _, max_step = bp.encode_batch(coef, trunc, spec, cap)
        ours = bp.decode_batch(words, trunc, max_step, spec).numpy()
        ref = _native_decode(_streams(words, trunc), trunc, max_step, spec)
        np.testing.assert_array_equal(ours.view(np.uint32),
                                      ref.view(np.uint32), err_msg=name)
        theirs = np.asarray(jbp.decode_batch(
            jnp.asarray(words.numpy().astype(np.uint32)),
            jnp.asarray(trunc.numpy(), jnp.int32),
            jnp.asarray(max_step.numpy()), jbp.CoderSpec(*spec)))
        off = ours != theirs
        # only midpoints of planes >= 13 (|value| >= 2**13), by XLA's
        # exp2 error there (4e-3 at 2**13, relative 5e-7)
        assert np.all(np.abs(ours[off]) >= 2.0 ** 13), name
        np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0)
        deep += int(off.sum())
    assert deep > 0  # the upper-plane cuts reach the deep planes


def test_masked_streams_decode_as_native(encoded):
    """A chunk-masked stream spliced out of the prefix arena, as the
    container stores it: the torch decode equals the native decoder's,
    and its reconstruction holds the bound on frames that need no
    residual."""
    data, codec, res = encoded
    spec = codec.base.spec
    km = res.km_q.numpy()
    assert (km >= 0).any()
    segs = res.segs_q.numpy()
    trunc = torch.from_numpy(np.where(km >= 0, segs.sum(-1),
                                      res.base_bits_q.numpy()))
    words, _, max_step = bp.encode_batch(res.base_coef, trunc, spec,
                                         _cap(trunc))
    mbits = res.mbits_q.numpy()
    streams, nbits = [], np.zeros(B, np.int64)
    for i, s in enumerate(_streams(words, trunc)):
        if km[i] >= 0:
            s, nbits[i] = bp.splice_masked_stream(s, segs[i], int(km[i]),
                                                  spec.nchunks)
            assert nbits[i] == mbits[i]
        else:
            nbits[i] = int(trunc[i])
        streams.append(s)
    cap = _cap(torch.from_numpy(nbits))
    spliced = torch.from_numpy(np.stack([bp.bytes_to_words(s, cap)
                                         for s in streams]))
    mask = np.where(km >= 0, res.bs_q.numpy(), -1)
    keep = np.where(km >= 0, km, 0)
    ours = bp.decode_batch(spliced, torch.from_numpy(nbits), max_step, spec,
                           mask_plane=torch.from_numpy(mask),
                           keep_mask=torch.from_numpy(keep)).numpy()
    ref = _native_decode(streams, torch.from_numpy(nbits), max_step, spec,
                         mask, keep)
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))
    rec = codec._base_recon(torch.from_numpy(ours), res.mn, res.mx,
                            res.dc_b).numpy()
    sel = res.skip_residual.numpy() & (km >= 0)
    assert sel.any()
    assert np.abs(rec[sel] - data[sel]).max() <= 0.25


def test_frame_codec_decode_equals_recon_of_native(encoded):
    data, codec, res = encoded
    args = []
    for layer, trunc in (("base", res.base_bits_q), ("resid",
                                                     res.resid_bits)):
        spec = getattr(codec, layer).spec
        words, _, max_step = bp.encode_batch(getattr(res, f"{layer}_coef"),
                                             trunc, spec, _cap(trunc))
        coef = _native_decode(_streams(words, trunc), trunc, max_step, spec)
        args.append((words, trunc, max_step, torch.from_numpy(coef)))
    (wb, tb, mb, cb), (wr, tr, mr, cr) = args
    has_r = ~res.skip_residual & res.resid_feasible
    ours = codec.decode(wb, tb, mb, res.mn, res.mx, res.dc_b, has_r, wr, tr,
                        mr, res.rmin, res.rmax, res.dc_r)
    ref = codec.recon(cb, res.mn, res.mx, res.dc_b, has_r, cr, res.rmin,
                      res.rmax, res.dc_r)
    np.testing.assert_array_equal(ours.numpy().view(np.uint32),
                                  ref.numpy().view(np.uint32))
    assert np.isfinite(ours.numpy()).all() and ours.shape == data.shape


def test_scale_to_u16_equals_native_host_scaling():
    data = _field(seed=1, noise=3.0)
    data[1] = 7.0  # a constant frame scales to 0
    u, mn, mx, _ = _scale_u16_host(data)
    t = torch.from_numpy(data)
    tmn, tmx = frame.minmax(t)
    np.testing.assert_array_equal(tmn.numpy(), mn)
    np.testing.assert_array_equal(tmx.numpy(), mx)
    ours = frame.scale_to_u16(t, tmn, tmx).numpy()
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, u.astype(np.float32))


def test_f32_entry_coefficients_equal_hostq(encoded):
    data, codec, res = encoded
    u, mn, mx, maxq = _scale_u16_host(data)
    res_hq, _ = codec.encode_error_bounded_hostq(
        _upload_u16(u, "cpu"), torch.from_numpy(mn), torch.from_numpy(mx),
        torch.from_numpy(np.float32(0.25) - maxq), 1e-6)
    for f in ("base_coef", "mn", "mx", "dc_b", "max_step_b", "const"):
        assert torch.equal(getattr(res, f), getattr(res_hq, f)), f
    rate = codec.encode_rate_targeted(torch.from_numpy(data), 2000, 0)
    rate_hq, _ = codec.encode_rate_targeted_hostq(
        _upload_u16(u, "cpu"), torch.from_numpy(mn), torch.from_numpy(mx),
        2000, 0)
    for f in ("base_coef", "base_bits_q", "bs_q", "ks_q"):
        assert torch.equal(getattr(rate, f), getattr(rate_hq, f)), f
    multi = codec.encode_error_bounded_multi(
        torch.from_numpy(data), torch.full((B,), 0.25), (1e-6, 1e-3))
    assert torch.equal(multi[0].base_coef, res.base_coef)
    for f in res._fields:
        assert torch.equal(getattr(multi[0], f), getattr(res, f)), f
