"""The port's HDF5 and zarr wrappers and video baseline against the JAX
package's, on the CPU.

* ``EBCCFilterParams`` renders the JAX package's configuration,
  ``cd_values``, chunks, h5py kwargs, CDO string and filter id for every
  ``residual_opt`` name either package accepts;
* a ``write_dataset`` file from either package reads in the other (the
  ``"ebcc_tpu"`` attribute and its JSON are shared);
* ``write_filtered_dataset`` stores chunks byte-equal to the plugin's own
  plain write (``create_filtered_dataset`` + ``dset[...] = data``, the
  native encoder), which read back through the plugin within the bound;
  the plugins are the port's build, in its build directory: building
  them and the host library leaves the ``native/`` sources untouched;
* the zarr codec keeps the JAX package's id and import guard;
* ``video.available()`` agrees with the JAX package's.
"""

import ctypes
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from ebcc_tpu.models import video as jax_video
from ebcc_tpu.wrappers import hdf5 as jax_hdf5
from ebcc_tpu.wrappers import zarr as jax_zarr

from ebcc_tpu_torch.codec.config import EBCCConfig, ResidualMode
from ebcc_tpu_torch.models import video
from ebcc_tpu_torch.runtime import build, native
from ebcc_tpu_torch.wrappers import hdf5, zarr

h5py = pytest.importorskip("h5py")



def _field(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (260 + 25 * np.sin(y / h * np.pi) *
            np.cos(x / w * 2 * np.pi)).astype(np.float32)
    return np.stack([base + rng.normal(0, 0.3, base.shape)
                     .astype(np.float32) for _ in range(n)])


# every residual_opt name of hdf5.py's alias table and MODE_NAMES
RESIDUAL_OPTS = [("max_error_target", 0.25), ("relative_error_target", 0.01),
                 ("quantile_target", 12.0), ("fixed_sparsification", 8.0),
                 ("max_error", 0.5), ("relative_error", 0.009),
                 ("sparsification_factor", 10.0),
                 ("pointwise_max_error", 2.0), ("none", 0.0)]


@pytest.mark.parametrize("data_dim", [2, 3, 4])
@pytest.mark.parametrize("opt", RESIDUAL_OPTS, ids=lambda o: o[0])
def test_filter_params_equal_jax(opt, data_dim):
    kw = dict(base_cr=37.5, height=64, width=96, residual_opt=opt,
              data_dim=data_dim)
    ours, theirs = hdf5.EBCCFilterParams(**kw), jax_hdf5.EBCCFilterParams(**kw)
    assert ours.cd_values() == theirs.cd_values()
    assert ours.chunks() == theirs.chunks()
    assert ours.hdf5_kwargs() == theirs.hdf5_kwargs()
    assert ours.cdo_filter_string() == theirs.cdo_filter_string()
    assert ours.filter_id == theirs.filter_id
    assert dataclasses.asdict(ours.to_config()) == \
        dataclasses.asdict(theirs.to_config())


def test_filter_ids_and_attribute_key_equal_jax():
    for name in ("FILTER_ID", "FILTER_ID_POINTWISE", "FILTER_ID_EMULATE",
                 "_ATTR"):
        assert getattr(hdf5, name) == getattr(jax_hdf5, name)
    # the port builds the plugins of the JAX package's plugin directory
    # (native/, which the port never writes) into its own build directory
    ours, theirs = hdf5._plugin_dir(), jax_hdf5._plugin_dir()
    assert os.path.dirname(ours) == build.BUILD_DIR != theirs
    assert sorted(os.listdir(ours)) == ["libh5z_ebcc_tpu.so",
                                        "libh5z_ebcc_tpu_emu.so",
                                        "libh5z_ebcc_tpu_pw.so"]


CFG_KW = dict(mode=ResidualMode.RELATIVE_ERROR, error=0.009, base_cr=50,
              max_batch=2)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_write_dataset_reads_in_the_other_package(writer, tmp_path):
    import ebcc_tpu
    data = _field(2, 64, 128, seed=3)
    jax_cfg = ebcc_tpu.EBCCConfig(**CFG_KW)
    cfg = EBCCConfig(**CFG_KW)
    path = tmp_path / "t.h5"
    with h5py.File(path, "w") as f:
        if writer == "port":
            hdf5.write_dataset(f, "x", data, cfg, device="cpu")
        else:
            jax_hdf5.write_dataset(f, "x", data, jax_cfg)
    with h5py.File(path, "r") as f:
        assert hdf5.is_ebcc_dataset(f["x"]) and \
            jax_hdf5.is_ebcc_dataset(f["x"])
        attr = f["x"].attrs["ebcc_tpu"]
        if writer == "port":
            rec = jax_hdf5.read_dataset(f["x"])
        else:
            rec = hdf5.read_dataset(f["x"], device="cpu")
    # the attribute is the same JSON whichever package wrote it
    with h5py.File(tmp_path / "other.h5", "w") as f:
        if writer == "port":
            jax_hdf5.write_dataset(f, "x", data, jax_cfg)
        else:
            hdf5.write_dataset(f, "x", data, cfg, device="cpu")
        assert json.loads(f["x"].attrs["ebcc_tpu"]) == json.loads(attr)
    assert rec.shape == data.shape
    rng = data.max(axis=(1, 2)) - data.min(axis=(1, 2))
    assert np.all(np.abs(rec - data).max(axis=(1, 2)) / rng <= 0.009)


def test_filtered_chunks_equal_the_plugin_write(tmp_path):
    err = 0.2
    data = _field(2, 96, 160, seed=4)
    params = hdf5.EBCCFilterParams(base_cr=100, height=96, width=160,
                                   data_dim=3,
                                   residual_opt=("max_error_target", err))
    path = tmp_path / "cmp.h5"
    with h5py.File(path, "w") as f:
        plain = hdf5.create_filtered_dataset(f, "plain", data.shape, params)
        plain[...] = data  # the plugin's native encoder
        hdf5.write_filtered_dataset(
            f, "port", data, dataclasses.replace(params.to_config(),
                                                 max_batch=2), device="cpu")
    with h5py.File(path, "r") as f:
        for i in range(len(data)):
            c_plain = f["plain"].id.read_direct_chunk((i, 0, 0))[1]
            c_port = f["port"].id.read_direct_chunk((i, 0, 0))[1]
            assert bytes(c_plain) == bytes(c_port), i
        rec = f["port"][:]
        one = f["port"][1]
    assert rec.dtype == np.float32
    assert float(np.abs(rec - data).max()) <= err
    np.testing.assert_array_equal(one, rec[1])


def test_native_builds_leave_the_sources_untouched(tmp_path, monkeypatch):
    """The port's loader builds the host library and the plugins from the
    ``native/`` sources into its build directory; the source directory's
    listing and mtimes stay as they were (here a copy of it, so that the
    JAX package's own ``make -C native`` in other processes cannot
    interfere)."""
    src = tmp_path / "native"
    shutil.copytree(native.NATIVE_DIR, src,
                    ignore=shutil.ignore_patterns("*.o", "*.so"))
    monkeypatch.setattr(native, "NATIVE_DIR", str(src))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))

    def listing():
        return {p.name: p.stat().st_mtime_ns for p in src.iterdir()}

    before = listing()
    lib = native.build_library()
    plugins = native.build_plugins()
    assert listing() == before
    assert os.path.dirname(os.path.dirname(lib)) == str(tmp_path / "build")
    assert os.path.dirname(plugins) == str(tmp_path / "build")
    assert len(os.listdir(plugins)) == 3
    assert ctypes.CDLL(lib).ebcc_zstd_bound(1) > 0


def test_wrappers_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _field(1, 32, 48)
    with h5py.File(tmp_path / "t.h5", "w") as f:
        with pytest.raises(RuntimeError, match="CUDA"):
            hdf5.write_dataset(f, "x", data, EBCCConfig(**CFG_KW))
        with pytest.raises(RuntimeError, match="CUDA"):
            hdf5.write_filtered_dataset(f, "y", data, EBCCConfig(**CFG_KW))
        hdf5.write_dataset(f, "z", data, EBCCConfig(**CFG_KW), device="cpu")
        with pytest.raises(RuntimeError, match="CUDA"):
            hdf5.read_dataset(f["z"])


def test_zarr_shim_gated():
    assert zarr.EBCCZarrFilter.codec_id == jax_zarr.EBCCZarrFilter.codec_id
    assert zarr.HAVE_NUMCODECS == jax_zarr.HAVE_NUMCODECS
    if zarr.HAVE_NUMCODECS:
        codec = zarr.EBCCZarrFilter(64, 96, error=0.05, base_cr=50,
                                    device="cpu")
        assert codec.get_config() == jax_zarr.EBCCZarrFilter(
            64, 96, error=0.05, base_cr=50).get_config()
        data = _field(1, 64, 96)
        out = np.frombuffer(codec.decode(codec.encode(data)),
                            np.float32).reshape(data.shape)
        assert np.max(np.abs(out - data)) <= 0.05
    else:
        with pytest.raises(ImportError):
            zarr.EBCCZarrFilter(64, 96)


def test_video_available_matches_jax():
    assert video.available() == jax_video.available()
    if not video.available():
        with pytest.raises(RuntimeError, match="ffmpeg"):
            video.VideoArrayCompressor()


def test_video_roundtrip():
    if not video.available():
        pytest.skip("ffmpeg not installed")
    rng = np.random.default_rng(0)
    data = np.clip(0.5 + rng.normal(0, 0.01, (4, 64, 96)), 0, 1).astype(
        np.float32)
    comp = video.VideoArrayCompressor(codec="x264", crf=18)
    blob = comp.compress(data)
    rec = comp.decompress(blob)
    assert rec.shape == data.shape
    assert len(blob) < data.nbytes
    assert float(np.abs(rec - data).max()) < 0.25
    np.testing.assert_array_equal(
        rec, jax_video.VideoArrayCompressor().decompress(blob))
