"""The port's command line against the JAX package's, on the CPU
(``--device cpu``).

* ``compress`` writes the native encoder's bytes, and the JAX CLI's where
  no frame keeps a residual layer;
* ``decompress`` writes ``ebcc_tpu_torch.decompress``'s array;
* ``info`` and ``filter-string`` print the JAX CLI's JSON (but for the
  plugin directory: the port's own build of the plugins);
* ``sweep`` rows have the JAX CLI's keys and hold every bound;
* ``python -m ebcc_tpu_torch`` imports no JAX, and its default device is
  the card.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from ebcc_tpu import cli as jax_cli
from ebcc_tpu.wrappers import hdf5 as jax_hdf5

import ebcc_tpu_torch
from ebcc_tpu_torch import cli
from ebcc_tpu_torch.codec import container
from ebcc_tpu_torch.codec.config import EBCCConfig, ResidualMode
from ebcc_tpu_torch.runtime import cpu_encoder
from ebcc_tpu_torch.wrappers import hdf5

N, H, W = 2, 64, 96
ERROR = 0.5


@pytest.fixture(scope="module")
def npy(tmp_path_factory):
    """Two smooth frames with N(0, 0.05) noise: at MAX_ERROR 0.5 every
    frame is pure-base, where the JAX package's bytes are the port's."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:H, 0:W]
    base = 260 + 25 * np.sin(y / H * np.pi) * np.cos(x / W * 2 * np.pi)
    data = (base + rng.normal(0, 0.05, (N, H, W))).astype(np.float32)
    path = tmp_path_factory.mktemp("cli") / "in.npy"
    np.save(path, data)
    return str(path), data


def _run(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


def _json_lines(out):
    return [json.loads(line) for line in out.splitlines() if line.strip()]


COMPRESS = ["--mode", "max_error", "--error", str(ERROR), "--base-cr", "100"]


def test_compress_bytes_equal_native_and_jax(npy, tmp_path, capsys):
    path, data = npy
    ours, theirs = tmp_path / "port.ebt", tmp_path / "jax.ebt"
    row = _json_lines(_run(cli.main, ["compress", path, str(ours), *COMPRESS,
                                      "--device", "cpu"], capsys))[0]
    jax_row = _json_lines(_run(jax_cli.main, ["compress", path, str(theirs),
                                              *COMPRESS], capsys))[0]
    assert row.keys() == jax_row.keys()
    blob = ours.read_bytes()
    assert row["bytes"] == len(blob)
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=ERROR, base_cr=100)
    assert blob == cpu_encoder.compress(data, cfg)
    assert blob == ebcc_tpu_torch.compress(data, cfg, device="cpu")
    flags = [container.unpack_frame(f)[0].flags
             for f in container.unpack_blob(blob)]
    assert not any(f & container.FLAG_RESID for f in flags)
    assert blob == theirs.read_bytes()


def test_decompress_and_info(npy, tmp_path, capsys):
    path, data = npy
    blob_path, rec_path = tmp_path / "x.ebt", tmp_path / "rec.npy"
    _run(cli.main, ["compress", path, str(blob_path), *COMPRESS, "--device",
                    "cpu"], capsys)
    row = _json_lines(_run(cli.main, ["decompress", str(blob_path),
                                      str(rec_path), "--device", "cpu"],
                           capsys))[0]
    rec = np.load(rec_path)
    assert row["shape"] == list(data.shape)
    np.testing.assert_array_equal(rec, ebcc_tpu_torch.decompress(
        blob_path.read_bytes(), device="cpu"))
    assert float(np.abs(rec - data).max()) <= ERROR
    info = _run(cli.main, ["info", str(blob_path)], capsys)
    assert json.loads(info)["frames"] == N
    assert json.loads(info) == json.loads(
        _run(jax_cli.main, ["info", str(blob_path)], capsys))


@pytest.mark.parametrize("args", [
    [],
    ["--mode", "relative_error", "--error", "0.01", "--height", "96",
     "--width", "160", "--data-dim", "3"],
    ["--mode", "pointwise_max_error", "--error", "1.5", "--data-dim", "4"],
    ["--mode", "sparsification_factor", "--error", "12", "--base-cr", "40"],
])
def test_filter_string_equals_jax(args, capsys):
    ours = json.loads(_run(cli.main, ["filter-string", *args], capsys))
    theirs = json.loads(_run(jax_cli.main, ["filter-string", *args], capsys))
    # each package points HDF5 at its own build of the same plugins: the
    # port's build directory, the JAX package's native/
    pdir, jdir = ours.pop("plugin_dir"), theirs.pop("plugin_dir")
    assert pdir == hdf5._plugin_dir() and jdir == jax_hdf5._plugin_dir()
    assert ours.pop("cdo_usage") == theirs.pop("cdo_usage").replace(jdir,
                                                                    pdir)
    assert ours == theirs
    if not args:  # the defaults: 721x1440, max_error 1e-2, base_cr 100
        params = hdf5.EBCCFilterParams(residual_opt=("max_error", 1e-2))
        assert ours["cd_values"] == list(params.cd_values())


def test_sweep_rows(npy, capsys):
    path, _ = npy
    rows = _json_lines(_run(cli.main, ["sweep", path, "--errors", "0.1",
                                       str(ERROR), "--device", "cpu"],
                            capsys))
    jax_rows = _json_lines(_run(jax_cli.main, ["sweep", path, "--errors",
                                               str(ERROR)], capsys))
    assert [r["error_target"] for r in rows] == [0.1, ERROR]
    for r in rows:
        assert r.keys() == jax_rows[0].keys()
        assert r["within_bound"] == 1.0
        assert r["max_error"] <= r["error_target"]
    assert rows[1]["cr"] == jax_rows[0]["cr"]


def test_module_entry_point_imports_no_jax(npy, tmp_path):
    path, _ = npy
    blob_path = tmp_path / "x.ebt"
    cli.main(["compress", path, str(blob_path), *COMPRESS, "--device",
              "cpu"])
    # -X importtime lists every module the process imports on stderr
    r = subprocess.run([sys.executable, "-X", "importtime", "-m",
                        "ebcc_tpu_torch", "info", str(blob_path)],
                       capture_output=True, text=True, timeout=120,
                       check=True)
    assert json.loads(r.stdout)["frames"] == N
    imported = {line.rsplit("|", 1)[-1].strip().split(".")[0]
                for line in r.stderr.splitlines() if "|" in line}
    assert "ebcc_tpu_torch" in imported
    assert not imported & {"jax", "ebcc_tpu", "flax", "optax"}


def test_default_device_is_the_card(npy, tmp_path, monkeypatch):
    path, _ = npy
    blob_path = tmp_path / "x.ebt"
    cli.main(["compress", path, str(blob_path), *COMPRESS, "--device",
              "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["compress", path, str(tmp_path / "y.ebt"), *COMPRESS])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["decompress", str(blob_path), str(tmp_path / "r.npy")])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["sweep", path, "--errors", str(ERROR)])
