"""The port's compressor families against the JAX package's, on the CPU.

* every exact-value patch method round-trips;
* DirectCompressor blobs cross between the two packages both ways with no
  point past its bound, those of either decode backend, and are
  byte-identical where no frame keeps a residual layer;
* the blob records the decoder its patch was built against (1 = native
  CPU decoder, the pinned default; 2 = the device reconstruction);
* ``rate_candidates`` (per-slice multi-q): the decoder-exact
  reconstruction, no larger than without candidates, blobs crossing both
  ways;
* RateOptimizedCompressor picks the JAX package's quantile;
* DeltaCompressor and PredictiveCompressor blobs decode in the other
  package within the bound.
"""

import dataclasses
import struct

import numpy as np
import pytest

import ebcc_tpu
from ebcc_tpu import models as jax_models
from ebcc_tpu.models.direct import DirectCompressor as JaxDirect

from ebcc_tpu_torch import (DeltaCompressor, DirectCompressor,
                            PredictiveCompressor, RateOptimizedCompressor)
from ebcc_tpu_torch.codec import container
from ebcc_tpu_torch.codec.config import EBCCConfig
from ebcc_tpu_torch.models.direct import _pack

B, H, W = 2, 96, 160
# tests/test_pallas_eval.py's POINTWISE config, with the native decoder
JAX_CFG = ebcc_tpu.EBCCConfig(
    mode=ebcc_tpu.ResidualMode.POINTWISE_MAX_ERROR, error=0.3, base_cr=200,
    max_batch=B, use_pallas_eval=False, encode_backend="device",
    decode_backend="cpu")
CFG = EBCCConfig(**dataclasses.asdict(JAX_CFG))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    base = (260 + 25 * np.sin(y / H * np.pi) *
            np.cos(x / W * 2 * np.pi)).astype(np.float32)
    return np.stack([base + rng.normal(0, 0.3, base.shape)
                     .astype(np.float32) for _ in range(B)])


def _bound(shape, seed=13):
    """0.25-0.6 per point, and 1e-6 (under a u16 quantum) at a few points
    so the exact-value patch is not empty."""
    rng = np.random.default_rng(seed)
    eb = (0.25 + 0.35 * rng.random(shape)).astype(np.float32)
    flat = eb.reshape(-1)
    flat[rng.choice(flat.size, 7, replace=False)] = 1e-6
    return eb


def _backend(blob):
    magic, code, _, _ = struct.unpack_from("<4sBBQ", blob, 0)
    assert magic == b"EBTE"
    return code


def _core_frames(blob):
    _, _, ndim, blen = struct.unpack_from("<4sBBQ", blob, 0)
    off = struct.calcsize("<4sBBQ") + 4 * ndim
    return [container.unpack_frame(f)[0]
            for f in container.unpack_blob(blob[off:off + blen])]


@pytest.fixture(scope="module")
def blobs():
    """(data, bound, port blob + rec, JAX blob)."""
    data, eb = _data(), _bound((B, H, W))
    ours, rec = DirectCompressor(config=CFG, device="cpu").compress_with_rec(
        data, eb)
    theirs = JaxDirect(config=JAX_CFG).compress(data, eb)
    return data, eb, ours, rec, theirs


@pytest.mark.parametrize("method", range(6))
def test_patch_method_round_trips(method):
    rng = np.random.default_rng(method)
    npoints = 70_000
    idx = np.sort(rng.choice(npoints, 300, replace=False)).astype(np.int64)
    idx[-1] = npoints - 1   # a gap past the u16 escape for method 5
    idx[:5] = np.arange(5)  # a dense run
    vals = rng.normal(0, 1, len(idx)).astype(np.float32)
    deltas = np.diff(idx, prepend=0)
    mask = np.zeros(npoints, bool)
    mask[idx] = True
    enc = {0: idx.tobytes(), 1: np.packbits(mask).tobytes(),
           2: DirectCompressor._varint_encode(deltas),
           3: idx.astype(np.uint32).tobytes(),
           4: DirectCompressor._encode_block(idx),
           5: DirectCompressor._encode_overflow(deltas)}[method]
    z = _pack(enc + vals.tobytes())
    buf = struct.pack("<BII", method, len(idx), len(z)) + z
    got_idx, got_vals, off = DirectCompressor._decode_patch(buf, 0, npoints)
    assert off == len(buf)
    np.testing.assert_array_equal(got_idx, idx)
    np.testing.assert_array_equal(got_vals, vals)
    # the JAX package reads the same patch
    jidx, jvals, _ = JaxDirect._decode_patch(buf, 0, npoints)
    np.testing.assert_array_equal(jidx, idx)
    np.testing.assert_array_equal(jvals, vals)


def test_blobs_cross_between_packages(blobs):
    data, eb, ours, rec, theirs = blobs
    port_dc = DirectCompressor(config=CFG, device="cpu")
    jax_dc = JaxDirect(config=JAX_CFG)
    for out in (jax_dc.decompress(ours), port_dc.decompress(theirs),
                port_dc.decompress(ours)):
        assert out.shape == data.shape
        assert int(np.sum(np.abs(out - data) > eb)) == 0
    np.testing.assert_array_equal(port_dc.decompress(ours), rec)
    assert int(np.sum(eb < 1e-5)) == 7  # the patch is exercised


@pytest.fixture(scope="module")
def device_blobs():
    """Blobs whose patch was built against the device reconstruction
    (backend code 2), one from each package: (data, bound, port blob,
    JAX blob)."""
    data, eb = _data(), _bound((B, H, W))
    ours = DirectCompressor(config=dataclasses.replace(
        CFG, decode_backend="device"), device="cpu").compress(data, eb)
    theirs = JaxDirect(config=dataclasses.replace(
        JAX_CFG, decode_backend="device")).compress(data, eb)
    return data, eb, ours, theirs


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_device_backend_blobs_cross_between_packages(device_blobs,
                                                     direction):
    """A code-2 blob decodes in the other package, through that package's
    own device reconstruction, with no point past its bound.  The two
    reconstructions are not bit-equal (the port's follows the native
    decoder's fma sites, JAX's follows XLA's fusion), so the patch of one
    is held against the other's reconstruction here."""
    data, eb, ours, theirs = device_blobs
    assert _backend(ours) == 2 and _backend(theirs) == 2
    if direction == "port_to_jax":
        out = JaxDirect(config=JAX_CFG).decompress(ours)
    else:
        out = DirectCompressor(config=CFG, device="cpu").decompress(theirs)
    assert out.shape == data.shape
    assert int(np.sum(np.abs(out - data) > eb)) == 0
    assert int(np.sum(eb < 1e-5)) == 7  # the patch is exercised


def test_blobs_byte_identical_without_residual(blobs):
    _, _, ours, _, theirs = blobs
    frames = _core_frames(ours)
    assert not any(h.flags & container.FLAG_RESID for h in frames)
    assert all(h.flags & container.FLAG_POINTWISE for h in frames)
    assert ours == theirs


def test_rate_candidates_not_implemented():
    """``rate_candidates`` is implemented; what still raises is a
    DeltaCompressor given both its own DirectCompressor and candidates
    (they would be ignored), as in the JAX package."""
    direct = DirectCompressor(config=CFG, device="cpu")
    with pytest.raises(ValueError, match="rate_candidates"):
        DeltaCompressor(direct=direct, rate_candidates=(1e-6, 1e-2))
    with pytest.raises(ValueError, match="rate_candidates"):
        jax_models.DeltaCompressor(direct=JaxDirect(config=JAX_CFG),
                                   rate_candidates=(1e-6, 1e-2))
    assert DirectCompressor(config=CFG, rate_candidates=(1e-6, 1e-2),
                            device="cpu").rate_candidates == (1e-6, 1e-2)


def test_backend_code_recorded(blobs):
    data, eb, ours, rec, _ = blobs
    assert DirectCompressor().config.decode_backend == "cpu"
    assert _backend(ours) == 1
    dev = DirectCompressor(config=dataclasses.replace(
        CFG, decode_backend="device"), device="cpu")
    blob = dev.compress(data, eb)
    assert _backend(blob) == 2
    out = dev.decompress(blob)
    assert int(np.sum(np.abs(out - data) > eb)) == 0
    # the port's device reconstruction follows the native decoder, so the
    # two backends agree bit for bit and so do their patches
    np.testing.assert_array_equal(out, rec)
    # a compressor pinned to the other backend follows the blob's record
    np.testing.assert_array_equal(
        DirectCompressor(config=CFG, device="cpu").decompress(blob), rec)


def test_compress_batch_equals_per_slice(blobs):
    data, eb, _, _, _ = blobs
    dc = DirectCompressor(config=CFG, device="cpu")
    datas = np.stack([data, data[::-1].copy()])
    ebs = np.stack([eb, eb[::-1].copy()])
    for (blob, rec), d, e in zip(dc.compress_batch(datas, ebs), datas, ebs):
        one, one_rec = dc.compress_with_rec(d, e)
        assert blob == one
        np.testing.assert_array_equal(rec, one_rec)
        np.testing.assert_array_equal(dc.decompress(blob), rec)


QS = (1e-6, 1e-2)  # the default base quantile and a larger one


@pytest.fixture(scope="module")
def rate_blobs():
    """(data, bound, port blob + rec, JAX blob) under ``QS``."""
    data, eb = _data(1), _bound((B, H, W), seed=14)
    ours, rec = DirectCompressor(config=CFG, rate_candidates=QS,
                                 device="cpu").compress_with_rec(data, eb)
    theirs = JaxDirect(config=JAX_CFG, rate_candidates=QS).compress(data, eb)
    return data, eb, ours, rec, theirs


def test_rate_candidates_rec_contract_and_size(rate_blobs):
    """The reconstruction returned with the blob is the decoder's, and the
    per-slice minimum is no larger than the encode at the default
    quantile, which is among the candidates."""
    data, eb, ours, rec, _ = rate_blobs
    dc = DirectCompressor(config=CFG, rate_candidates=QS, device="cpu")
    np.testing.assert_array_equal(dc.decompress(ours), rec)
    assert int(np.sum(np.abs(rec - data) > eb)) == 0
    plain = DirectCompressor(config=CFG, device="cpu").compress(data, eb)
    assert len(ours) <= len(plain)
    assert dc.compress_batch(data[None], eb[None])[0][0] == ours


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_rate_candidates_blobs_cross_between_packages(rate_blobs,
                                                      direction):
    data, eb, ours, rec, theirs = rate_blobs
    if direction == "port_to_jax":
        out = JaxDirect(config=JAX_CFG).decompress(ours)
        np.testing.assert_array_equal(out, rec)
    else:
        out = DirectCompressor(config=CFG, device="cpu").decompress(theirs)
    assert out.shape == data.shape
    assert int(np.sum(np.abs(out - data) > eb)) == 0


def test_rate_optimizer_best_quantile_matches_jax():
    """MAX_ERROR frames that keep no residual under any candidate: the
    blobs are the JAX package's, and so is the choice."""
    jcfg = dataclasses.replace(JAX_CFG, mode=ebcc_tpu.ResidualMode.MAX_ERROR,
                               error=0.25)
    cfg = EBCCConfig(**dataclasses.asdict(jcfg))
    qs = (0.0, 1e-6)
    data = _data()
    blob, info = RateOptimizedCompressor(cfg, candidates=qs,
                                         device="cpu").compress(data)
    jblob, jinfo = jax_models.RateOptimizedCompressor(
        jcfg, candidates=qs).compress(data)
    assert not any(container.unpack_frame(f)[0].flags & container.FLAG_RESID
                   for f in container.unpack_blob(blob))
    assert info == jinfo and blob == jblob
    assert info["candidate_sizes"][info["best_quantile"]] == len(blob)
    rec = RateOptimizedCompressor(cfg, device="cpu").decompress(blob)
    assert np.abs(rec - data).max() <= 0.25


def _chain(n=3):
    """n chain slices [n, B, H, W]: one field with small per-slice
    noise, so the delta coding of a slice can win."""
    rng = np.random.default_rng(21)
    base = _data()
    return np.stack([base + rng.normal(0, 0.03, base.shape).astype(
        np.float32) for _ in range(n)])


def _chain_flags(blob):
    """The per-slice delta flags of an EBTC blob."""
    magic, n = struct.unpack_from("<4sI", blob, 0)
    assert magic == b"EBTC"
    off, flags = struct.calcsize("<4sI"), []
    for _ in range(n):
        d, blen = struct.unpack_from("<BQ", blob, off)
        off += struct.calcsize("<BQ") + blen
        flags.append(bool(d))
    return flags


@pytest.mark.parametrize("family", ["delta", "predictive"])
def test_chain_blobs_cross_between_packages(family):
    """A DeltaCompressor / PredictiveCompressor blob of either package
    decodes in the other within the bound; both decode through the native
    decoder, so their reconstructions agree bit for bit."""
    stack = _chain()
    eb = np.full_like(stack, 0.3)
    ours_direct = DirectCompressor(config=CFG, device="cpu")
    theirs_direct = JaxDirect(config=JAX_CFG)
    if family == "delta":
        port = DeltaCompressor(direct=ours_direct)
        jax = jax_models.DeltaCompressor(direct=theirs_direct)
    else:
        port = PredictiveCompressor(warmup=1, direct=ours_direct)
        jax = jax_models.PredictiveCompressor(warmup=1, direct=theirs_direct)
    ours, theirs = port.compress(stack, eb), jax.compress(stack, eb)
    if family == "delta":
        assert any(_chain_flags(ours)[1:])
    recs = [jax.decompress(ours), port.decompress(ours),
            port.decompress(theirs), jax.decompress(theirs)]
    for rec in recs:
        assert rec.shape == stack.shape
        assert int(np.sum(np.abs(rec - stack) > eb)) == 0
    np.testing.assert_array_equal(recs[0], recs[1])
    np.testing.assert_array_equal(recs[2], recs[3])
