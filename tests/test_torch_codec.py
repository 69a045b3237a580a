"""The port's codec end to end on the CPU, against the JAX package and
the native CPU codec.

* containers byte-identical to ``ebcc_tpu.compress`` (device encode on
  the CPU backend) and to the native CPU encoder;
* blobs cross both ways: the JAX package, the port and the native decoder
  each decode the others' blobs within the bound, and the port's and
  JAX's reconstructions agree to the documented device-vs-native gap;
* POINTWISE_MAX_ERROR against a per-point bound array: the same byte
  identity, the bound through every decoder, the pointwise flag;
* ``decode_backend`` routes the decode, ``encode_backend`` the encode;
* configurations cross; the package imports without JAX; asking for CUDA
  without it raises; what is still refused raises.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import ebcc_tpu
from ebcc_tpu.codec import config as jax_config

import ebcc_tpu_torch
from ebcc_tpu_torch import api
from ebcc_tpu_torch.codec import container
from ebcc_tpu_torch.codec.config import MODE_NAMES, EBCCConfig, ResidualMode
from ebcc_tpu_torch.runtime import cpu_decoder, cpu_encoder
from ebcc_tpu_torch.runtime import native

B, H, W = 2, 96, 160
# the geometry and config of tests/test_pallas_eval.py, so the JAX
# pipeline compiles once for the suite (persistent cache)
JAX_CFG = ebcc_tpu.EBCCConfig(
    mode=ebcc_tpu.ResidualMode.MAX_ERROR, error=0.25, base_cr=200,
    max_batch=B, use_pallas_eval=False, encode_backend="device",
    decode_backend="device")
CASES = [(ResidualMode.MAX_ERROR, 0.25), (ResidualMode.RELATIVE_ERROR, 0.004)]


def _data(n=B, seed=0, noise=0.3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    base = (260 + 25 * np.sin(y / H * np.pi) *
            np.cos(x / W * 2 * np.pi)).astype(np.float32)
    return np.stack([base + rng.normal(0, noise, base.shape)
                     .astype(np.float32) for _ in range(n)])


def _bound(data, mode, err):
    if mode == ResidualMode.RELATIVE_ERROR:
        rng = data.max(axis=(1, 2)) - data.min(axis=(1, 2))
        return (np.float32(err) * rng)[:, None, None]
    return err


def _configs(mode, err):
    jcfg = dataclasses.replace(JAX_CFG, mode=ebcc_tpu.ResidualMode(int(mode)),
                               error=err)
    return EBCCConfig(**dataclasses.asdict(jcfg)), jcfg


@pytest.fixture(scope="module")
def blobs():
    """Per case: (data, port blob, JAX blob)."""
    data = _data()
    out = {}
    for mode, err in CASES:
        cfg, jcfg = _configs(mode, err)
        out[mode] = (ebcc_tpu_torch.compress(data, cfg, device="cpu"),
                     ebcc_tpu.compress(data, jcfg))
    return data, out


@pytest.mark.parametrize("mode", [m for m, _ in CASES],
                         ids=lambda m: m.name)
def test_containers_byte_identical_to_jax(blobs, mode):
    _, out = blobs
    ours, theirs = out[mode]
    assert ours == theirs


@pytest.mark.parametrize("mode,err", CASES, ids=lambda v: str(v))
def test_blobs_cross_decode_within_bound(blobs, mode, err):
    data, out = blobs
    ours, theirs = out[mode]
    _, jcfg = _configs(mode, err)
    bound = _bound(data, mode, err)
    rec_port = ebcc_tpu_torch.decompress(theirs, device="cpu")
    rec_jax = np.asarray(ebcc_tpu.decompress(ours, jcfg))
    rec_native = cpu_decoder.decompress(ours)
    for rec in (rec_port, rec_jax, rec_native):
        assert rec.shape == data.shape and np.isfinite(rec).all()
        assert np.all(np.abs(rec - data) <= bound)
    # device-vs-native decoder gap (ebcc_tpu/codec/config.py decode_backend)
    assert np.abs(rec_port - rec_jax).max() <= 2e-3
    # the port's decode follows the native decoder's arithmetic
    np.testing.assert_array_equal(
        ebcc_tpu_torch.decompress(ours, device="cpu"), rec_native)


def test_byte_identical_to_native_encoder_partial_batch_and_const():
    """Three frames at max_batch=2 (the last batch holds one frame), one
    of them constant."""
    data = _data(3, seed=5)
    data[1] = 7.25
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.1, base_cr=100,
                     max_batch=2)
    blob = ebcc_tpu_torch.compress(data, cfg, device="cpu")
    assert blob == cpu_encoder.compress(data, cfg)
    hdr = container.unpack_frame(container.unpack_blob(blob)[1])[0]
    assert hdr.flags & container.FLAG_CONST
    rec = ebcc_tpu_torch.decompress(blob, device="cpu")
    assert np.abs(rec - data).max() <= 0.1


def test_residual_layer_matches_native_and_jax_base(monkeypatch):
    """Frames that keep a (chunk-masked) residual layer: with the pure-
    base fallback disabled and a 1 % base quantile, every frame carries a
    residual stream, packed, spliced and zstd'd on the host.

    The port equals the native encoder byte for byte.  The JAX package
    computes the residual from a base reconstruction that XLA fuses with
    other fma choices, so its residual stream can differ (one frame here:
    rmax moves by 1.5e-5); its base layer is identical."""
    monkeypatch.setenv("EBCC_DISABLE_PURE_JP2_FALLBACK", "1")
    data = _data()
    cfg, jcfg = _configs(ResidualMode.MAX_ERROR, 0.25)
    blob = ebcc_tpu_torch.compress(data, cfg, device="cpu", qbase=1e-2)
    frames = [container.unpack_frame(f) for f in container.unpack_blob(blob)]
    assert all(h.flags & container.FLAG_RESID for h, *_ in frames)
    assert any(h.resid_mask_plane != container.MASK_NONE
               for h, *_ in frames)
    assert blob == cpu_encoder.compress(data, cfg, qbase=1e-2)
    jframes = [container.unpack_frame(f) for f in container.unpack_blob(
        ebcc_tpu.compress(data, jcfg, qbase=1e-2))]
    base_fields = ("flags", "base_nbits", "max_step_b", "dc_b",
                   "base_mask_plane", "base_keep_mask")
    for (h, _, bs, _), (hj, _, bsj, _) in zip(frames, jframes):
        assert [getattr(h, f) for f in base_fields] == \
            [getattr(hj, f) for f in base_fields]
        assert bs == bsj
    rec = ebcc_tpu_torch.decompress(blob, device="cpu")
    np.testing.assert_array_equal(rec, cpu_decoder.decompress(blob))
    assert np.abs(rec - data).max() <= 0.25


def test_deep_decode_takes_float_coefficient_path(monkeypatch):
    """More than 14 decoded planes do not fit the packed u16 state: the
    decode goes through the native float32 coefficients instead."""
    data = _data(1, seed=6)
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=2e-3, max_batch=1)
    blob = ebcc_tpu_torch.compress(data, cfg, device="cpu")
    assert blob == cpu_encoder.compress(data, cfg)
    calls = []
    real = native.coder_decode_batch
    monkeypatch.setattr(native, "coder_decode_batch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rec = ebcc_tpu_torch.decompress(blob, device="cpu")
    assert calls
    np.testing.assert_array_equal(rec, cpu_decoder.decompress(blob))
    assert np.abs(rec - data).max() <= 2e-3


PW_JCFG = dataclasses.replace(
    JAX_CFG, mode=ebcc_tpu.ResidualMode.POINTWISE_MAX_ERROR, error=0.3)
PW_CFG = EBCCConfig(**dataclasses.asdict(PW_JCFG))


def _pointwise_bound(shape, seed=13):
    rng = np.random.default_rng(seed)
    return (0.25 + 0.35 * rng.random(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def pointwise():
    """(data, per-point bound, port blob, JAX blob) of a POINTWISE batch
    (the config of tests/test_pallas_eval.py's pointwise test)."""
    data = _data()
    eb = _pointwise_bound(data.shape)
    return (data, eb,
            ebcc_tpu_torch.compress(data, PW_CFG, error_bound=eb,
                                    device="cpu"),
            ebcc_tpu.compress(data, PW_JCFG, error_bound=eb))


def test_pointwise_targets_bit_equal_to_jax():
    from ebcc_tpu.api import pointwise_targets as jax_targets

    data = _data(3, seed=2)
    eb = _pointwise_bound(data.shape, seed=4)
    eb[0, :4] = 1e-6  # below two quanta: the half-bound floor applies
    for ratio in (1.0, 0.8):
        ours = api.pointwise_targets(data, eb, ratio)
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(
            ours.view(np.uint32), jax_targets(data, eb, ratio).view(np.uint32))


def test_pointwise_containers_byte_identical(pointwise):
    data, eb, ours, theirs = pointwise
    assert ours == theirs
    assert ours == cpu_encoder.compress(data, PW_CFG, error_bound=eb)


def test_pointwise_bound_through_every_decoder(pointwise):
    data, eb, ours, _ = pointwise
    for rec in (ebcc_tpu_torch.decompress(ours, PW_CFG, device="cpu"),
                np.asarray(ebcc_tpu.decompress(ours, PW_JCFG)),
                cpu_decoder.decompress(ours)):
        assert rec.shape == data.shape
        assert np.all(np.abs(rec - data) <= eb)


def test_pointwise_flag_on_every_frame(pointwise):
    _, _, ours, _ = pointwise
    for f in container.unpack_blob(ours):
        hdr = container.unpack_frame(f)[0]
        assert hdr.flags & container.FLAG_POINTWISE
        assert hdr.mode == int(ResidualMode.POINTWISE_MAX_ERROR)


def test_pointwise_partial_batch_matches_native():
    """Three frames at max_batch=2 with a scalar bound broadcast to every
    point: the last batch's targets are its own slice of the field."""
    data = _data(3, seed=8)
    cfg = dataclasses.replace(PW_CFG, max_batch=2)
    eb = np.full(data.shape, 0.2, np.float32)
    blob = ebcc_tpu_torch.compress(data, cfg, error_bound=eb, device="cpu")
    assert blob == cpu_encoder.compress(data, cfg, error_bound=eb)
    rec = ebcc_tpu_torch.decompress(blob, device="cpu")
    assert np.all(np.abs(rec - data) <= eb)


@pytest.mark.parametrize("backend", ["cpu", "device", "auto"])
def test_decode_backend_routes_the_decode(pointwise, monkeypatch, backend):
    """"cpu" is the native CPU decoder; "device" and "auto" reconstruct on
    the given device (here the CPU, with the kernels' plain versions)."""
    _, _, blob, _ = pointwise
    native_rec = cpu_decoder.decompress(blob)
    calls = []
    real = cpu_decoder.decompress
    monkeypatch.setattr(cpu_decoder, "decompress",
                        lambda b: calls.append(1) or real(b))
    cfg = dataclasses.replace(PW_CFG, decode_backend=backend)
    rec = ebcc_tpu_torch.decompress(blob, cfg, device="cpu")
    assert bool(calls) == (backend == "cpu")
    # the port's reconstruction follows the native decoder's arithmetic
    np.testing.assert_array_equal(rec, native_rec)


ENCODE_CASES = CASES + [(ResidualMode.POINTWISE_MAX_ERROR, 0.3)]


def _device_blob(blobs, pointwise, mode, err):
    """(data, bound array or None, config, blob of the device path)."""
    if mode == ResidualMode.POINTWISE_MAX_ERROR:
        data, eb, blob, _ = pointwise
        return data, eb, PW_CFG, blob
    data, out = blobs
    return data, None, _configs(mode, err)[0], out[mode][0]


@pytest.mark.parametrize("mode,err", ENCODE_CASES, ids=lambda v: str(v))
def test_cpu_encode_backend_runs_the_native_encoder(blobs, pointwise,
                                                    monkeypatch, mode, err):
    """encode_backend="cpu" encodes with the native CPU encoder: no
    FrameCodec is built, and the bytes equal the native encoder's and the
    device path's."""
    data, eb, cfg, device_blob = _device_blob(blobs, pointwise, mode, err)
    calls = []
    real = cpu_encoder.compress
    monkeypatch.setattr(cpu_encoder, "compress",
                        lambda *a, **k: calls.append(1) or real(*a, **k))

    def no_codec(*a, **k):
        raise AssertionError("FrameCodec built for encode_backend='cpu'")

    monkeypatch.setattr(api, "FrameCodec", no_codec)
    blob = ebcc_tpu_torch.compress(
        data, dataclasses.replace(cfg, encode_backend="cpu"),
        error_bound=eb, device="cpu")
    assert calls == [1]
    assert blob == device_blob
    assert blob == real(data, cfg, error_bound=eb)


@pytest.mark.parametrize("backend", ["device", "auto"])
def test_device_encode_backends_build_the_codec(blobs, monkeypatch,
                                                backend):
    """"device" and "auto" encode on the given device through FrameCodec
    (the reference's tunnel routing of "auto" is not ported): one codec
    built, through the api's codec cache (cleared first)."""
    data, out = blobs
    cfg, _ = _configs(ResidualMode.MAX_ERROR, 0.25)
    api._codec_for_cached.cache_clear()
    built = []
    real = api.FrameCodec
    monkeypatch.setattr(api, "FrameCodec",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    monkeypatch.setattr(cpu_encoder, "compress", None)
    blob = ebcc_tpu_torch.compress(
        data, dataclasses.replace(cfg, encode_backend=backend), device="cpu")
    assert built == [1]
    assert blob == out[ResidualMode.MAX_ERROR][0]


def test_cpu_encode_backend_needs_the_native_runtime(monkeypatch):
    def missing():
        raise RuntimeError("native runtime build failed")

    monkeypatch.setattr(native, "lib", missing)
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5,
                     encode_backend="cpu")
    with pytest.raises(RuntimeError, match="encode_backend='cpu' needs"):
        ebcc_tpu_torch.compress(_data(1), cfg, device="cpu")


def test_config_round_trips_from_jax():
    jcfg = ebcc_tpu.EBCCConfig(mode=ebcc_tpu.ResidualMode.RELATIVE_ERROR,
                               error=0.01, base_cr=50, nchunks=4,
                               max_batch=3)
    cfg = EBCCConfig(**dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.mode == ResidualMode.RELATIVE_ERROR
    assert [f.name for f in dataclasses.fields(cfg)] == \
        [f.name for f in dataclasses.fields(jcfg)]
    assert {m.name: int(m) for m in ResidualMode} == \
        {m.name: int(m) for m in ebcc_tpu.ResidualMode}
    assert {k: int(v) for k, v in MODE_NAMES.items()} == \
        {k: int(v) for k, v in jax_config.MODE_NAMES.items()}


def test_imports_without_jax():
    modules = ("import ebcc_tpu_torch, ebcc_tpu_torch.runtime.cpu_encoder, "
               "ebcc_tpu_torch.runtime.cpu_decoder, ebcc_tpu_torch.models, "
               "ebcc_tpu_torch.dataprep, ebcc_tpu_torch.ops.idwt_probe, "
               "ebcc_tpu_torch.scripts.idwt_probe, ebcc_tpu_torch.cli, "
               "ebcc_tpu_torch.wrappers.hdf5, ebcc_tpu_torch.wrappers.zarr, "
               "ebcc_tpu_torch.models.forecast, "
               "ebcc_tpu_torch.models.video, ebcc_tpu_torch.ops.metrics, "
               "ebcc_tpu_torch.utils.profiling, "
               "ebcc_tpu_torch.parallel.mesh, ebcc_tpu_torch.parallel.batch, "
               "ebcc_tpu_torch.parallel.spatial, "
               "ebcc_tpu_torch.ops.dwt_sharded, "
               "ebcc_tpu_torch.scripts.launch_multihost, "
               "ebcc_tpu_torch.scripts.common, ebcc_tpu_torch.scripts.bench, "
               "ebcc_tpu_torch.scripts.profile_stages, "
               "ebcc_tpu_torch.scripts.profile_transforms, "
               "ebcc_tpu_torch.scripts.roofline, "
               "ebcc_tpu_torch.scripts.mask_ab, "
               "ebcc_tpu_torch.scripts.scaling_bench, "
               "ebcc_tpu_torch.scripts.simple_example, "
               "ebcc_tpu_torch.scripts.pressure_levels_example, "
               "ebcc_tpu_torch.scripts.delta_compression_test, "
               "ebcc_tpu_torch.scripts.pointwise_sweep, "
               "ebcc_tpu_torch.scripts.compression_sweep, "
               "ebcc_tpu_torch.scripts.scan_cratio, "
               "ebcc_tpu_torch.scripts.compare_codecs, "
               "ebcc_tpu_torch.scripts.run_predictive, "
               "ebcc_tpu_torch.scripts.era5_video_compress, "
               "ebcc_tpu_torch.scripts.nc_to_ebcc_h5, "
               "ebcc_tpu_torch.scripts.plot_error_map, "
               "ebcc_tpu_torch.scripts.stripe_adaptive_study; ")
    # with the JAX side blocked (an import of it raises), then unblocked
    # (none of it may be imported on the way)
    blocked = ("import sys; sys.modules['jax'] = None; "
               "sys.modules['ebcc_tpu'] = None; sys.modules['flax'] = None; "
               "sys.modules['optax'] = None; " + modules +
               "assert 'jax.numpy' not in sys.modules")
    unblocked = ("import sys; " + modules +
                 "assert not {'jax', 'ebcc_tpu', 'flax', 'optax'} & "
                 "set(sys.modules), sorted(sys.modules)")
    for code in (blocked, unblocked):
        subprocess.run([sys.executable, "-c", code], check=True,
                       timeout=120)


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _data(1)
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5)
    with pytest.raises(RuntimeError, match="CUDA"):
        ebcc_tpu_torch.compress(data, cfg, device="cuda")
    blob = ebcc_tpu_torch.compress(data, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ebcc_tpu_torch.decompress(blob, device="cuda")


def test_unsupported_modes_raise():
    """What is still refused: the deprecated QUANTILE mode, a mask rule
    other than "greedy" and "union", and ``compress_multi_q`` in a
    rate-targeted mode."""
    data = _data(1)
    with pytest.raises(ValueError, match="QUANTILE"):
        EBCCConfig(mode=ResidualMode.QUANTILE)
    with pytest.raises(ValueError, match="mask_search"):
        api.compress(data, EBCCConfig(error=0.5, mask_search="best"),
                     device="cpu")
    for mode in (ResidualMode.NONE, ResidualMode.SPARSIFICATION_FACTOR):
        with pytest.raises(ValueError, match="error-bounded"):
            api.compress_multi_q(data, (0.0, 1e-3), EBCCConfig(mode=mode),
                                 device="cpu")


def test_pointwise_without_bound_raises():
    cfg = EBCCConfig(mode=ResidualMode.POINTWISE_MAX_ERROR)
    with pytest.raises(ValueError, match="error_bound"):
        api.compress(_data(1), cfg, device="cpu")
    with pytest.raises(ValueError, match="error_bound"):
        cpu_encoder.compress(_data(1), cfg)
