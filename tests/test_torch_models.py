"""The port's DirectCompressor against the JAX package's, on the CPU.

* every exact-value patch method round-trips;
* blobs cross between the two packages both ways with no point past its
  bound, those of either decode backend, and are byte-identical where no
  frame keeps a residual layer;
* the blob records the decoder its patch was built against (1 = native
  CPU decoder, the pinned default; 2 = the device reconstruction);
* ``rate_candidates`` (multi-q) is not implemented and says so.
"""

import dataclasses
import struct

import numpy as np
import pytest

import ebcc_tpu
from ebcc_tpu.models.direct import DirectCompressor as JaxDirect

from ebcc_tpu_torch import DirectCompressor
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
    with pytest.raises(NotImplementedError, match="compress_multi_q"):
        DirectCompressor(config=CFG, rate_candidates=(1e-6, 1e-2))


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
