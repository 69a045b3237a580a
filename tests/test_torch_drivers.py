"""The port's user and experiment drivers (``ebcc_tpu_torch/scripts/``) on
the CPU at 96x160 frames, against the JAX scripts, the JAX package and the
native codec.

* every driver's JSON keys and CSV columns are its JAX script's (read from
  the script's source);
* the DirectCompressor drivers (simple_example, pressure_levels_example,
  delta_compression_test, pointwise_sweep, run_predictive): no point past
  the bound, and on pure-base frames (bench recipe, N(0, 0.05) noise) the
  same sizes and printed rows as the JAX scripts or the JAX package;
* compression_sweep: the lossless rows are the JAX script's, the EBCC rows'
  CR is ``ebcc_tpu.compress``'s and the native encoder's, and ``--resume``
  skips the rows already written;
* scan_cratio: each fixed quantile's CR is the native encoder's at that
  quantile, and the optimiser picks the JAX package's quantile;
* compare_codecs: every row's bytes and the verdict are the JAX script's at
  ``tests/test_compare.py``'s frame and error 0.1, the EBCC row's the
  native encoder's; the exit code follows the verdict;
* era5_video_compress: ``_load_frames`` is the JAX script's; without ffmpeg
  the script exits 2; the EBCC row is the native encoder's;
* nc_to_ebcc_h5: a netCDF-like file (dimension scales, so DIMENSION_LIST
  object-reference attributes) converted by the JAX script and by the port
  on both its routes gives the same datasets, attributes and chunks, and
  the port's file reads in ``ebcc_tpu.wrappers.hdf5``;
* plot_error_map: the PNG is written, the error field is decompress - data;
* stripe_adaptive_study: ``measure`` against the JAX script's arithmetic on
  ``ebcc_tpu``'s ``FrameCodec`` and ``bitplane``;
* every driver asks for a card by default and raises without one, and the
  module entry point imports no jax.

Tolerances: every comparison is exact (bytes, CR floats, integer
selections, keys, printed text) but one: compare_codecs' EBCC row keeps a
residual layer at its frame, where the JAX package's decode and the
port's (the native decoder's arithmetic) are not bit-equal, so its RMSE
is held to a relative 1e-6 (its bytes and max error exactly).  The timing
fields and columns (``encode_s``, ``decode_s``, ``seconds``, ``mbps``, the
delta driver's "(N.Ns)") are left out of the comparisons.

One intra-op thread for the module (small torch ops; see SKILL.md).
"""

import ast
import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import ebcc_tpu
from ebcc_tpu import models as jax_models
from ebcc_tpu.codec import pipeline as jax_pipeline
from ebcc_tpu.models.direct import DirectCompressor as JaxDirect
from ebcc_tpu.ops import bitplane as jax_bp

from ebcc_tpu_torch import api
from ebcc_tpu_torch.codec.config import EBCCConfig, ResidualMode
from ebcc_tpu_torch.runtime import cpu_encoder
from ebcc_tpu_torch.scripts import (common, compare_codecs,
                                    compression_sweep,
                                    delta_compression_test,
                                    era5_video_compress, nc_to_ebcc_h5,
                                    plot_error_map, pointwise_sweep,
                                    pressure_levels_example, run_predictive,
                                    scan_cratio, simple_example,
                                    stripe_adaptive_study)
from test_torch_scripts import _jax_keys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, N = 96, 160, 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_reference_frame(monkeypatch):
    monkeypatch.delenv(common.REFERENCE_FRAME_ENV, raising=False)


@pytest.fixture(scope="module")
def frames():
    """Pure-base frames: the bench recipe at 96x160."""
    return common.bench_frames(N, H, W)


@pytest.fixture(scope="module")
def paths(frames, tmp_path_factory):
    d = tmp_path_factory.mktemp("drivers")
    out = {"stack": str(d / "stack.npy"), "frame": str(d / "frame.npy")}
    np.save(out["stack"], frames)
    np.save(out["frame"], frames[0])
    return out


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def _run(main, argv, capsys):
    """(exit code, stdout) of ``main(argv)``."""
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


def _run_jax(name, argv, monkeypatch, capsys):
    """(exit code, stdout) of the JAX script ``name``'s ``main()`` on the
    command line ``argv``."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    m = _jax_script(name)
    capsys.readouterr()
    try:
        rc = m.main()
    except SystemExit as e:
        rc = e.code
    return rc or 0, capsys.readouterr().out


def _json_lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _csv_header(path):
    with open(path) as f:
        return f.readline().strip().split(",")


def _jax_list(script, name):
    """The string list assigned to ``name`` in a JAX script."""
    with open(os.path.join(REPO, "scripts", script)) as f:
        tree = ast.parse(f.read())
    for n in ast.walk(tree):
        if isinstance(n, ast.Assign) and \
                getattr(n.targets[0], "id", None) == name:
            return [e.value for e in n.value.elts]
    for n in ast.walk(tree):  # csv.DictWriter(..., fieldnames=[...])
        if isinstance(n, ast.keyword) and n.arg == name and \
                isinstance(n.value, ast.List):
            return [e.value for e in n.value.elts]
    raise AssertionError(f"no list {name} in scripts/{script}")


def _jax_fixture():
    """The fixture path the JAX drivers read when it exists (the string
    constant of ``scripts/simple_example.py`` that names an .npy)."""
    with open(os.path.join(REPO, "scripts", "simple_example.py")) as f:
        tree = ast.parse(f.read())
    return next(n.value for n in ast.walk(tree)
                if isinstance(n, ast.Constant) and isinstance(n.value, str)
                and n.value.endswith(".npy"))


def _pure_base(blob):
    from ebcc_tpu_torch.codec import container
    return not any(container.unpack_frame(f)[0].flags & container.FLAG_RESID
                   for f in container.unpack_blob(blob))


# ---------------- keys ----------------

# the keys each JAX script prints, read from its source
KEYS = {
    "pointwise_sweep": _jax_keys("scripts/pointwise_sweep.py", "main",
                                 "call"),
    "compression_sweep": _jax_keys("scripts/compression_sweep.py",
                                   "ebcc_sweep", "call"),
    "lossless": _jax_keys("scripts/compression_sweep.py",
                          "lossless_baselines", "call"),
    "scan_cratio": _jax_keys("scripts/scan_cratio.py", "main", "call"),
    "compare_codecs": _jax_keys("scripts/compare_codecs.py", "run", "call"),
    # main's dict literals, less the forecast map's keys
    "run_predictive": _jax_keys("scripts/run_predictive.py", "main",
                                "dict") - {"persistence", "linear"},
    "video_row": _jax_keys("scripts/era5_video_compress.py", "video_row",
                           "dict"),
    "ebcc_row": _jax_keys("scripts/era5_video_compress.py", "ebcc_row",
                          "dict"),
    "nc_dataset": _jax_keys("scripts/nc_to_ebcc_h5.py", "main", "call"),
    # main's dict literals, less the mode-name map's keys
    "nc_total": _jax_keys("scripts/nc_to_ebcc_h5.py", "main", "dict") -
    {"max_error", "relative_error"},
}


def test_jax_keys_are_read():
    assert KEYS["pointwise_sweep"] == {"base_cr", "scale", "bound", "cr",
                                       "violations", "encode_s"}
    assert KEYS["compression_sweep"] == KEYS["lossless"] == set(
        _jax_list("compression_sweep.py", "fields"))
    assert KEYS["scan_cratio"] == {"method", "cr", "max_error", "mbps"}
    assert KEYS["compare_codecs"] == {"method", "bytes", "cr", "rmse",
                                      "max_error", "seconds"}
    assert {"trained", "predictive_cr", "direct_cr", "violations"} <= \
        KEYS["run_predictive"]
    assert KEYS["video_row"] == KEYS["ebcc_row"]
    assert "raw_bytes" in KEYS["nc_dataset"]
    assert KEYS["nc_total"] == {"datasets", "total_cr", "output_bytes"}
    assert compression_sweep.FIELDS == _jax_list("compression_sweep.py",
                                                 "fields")


# ---------------- the DirectCompressor drivers ----------------


@pytest.fixture(scope="module")
def jax_direct():
    return JaxDirect(base_cr=100)


def test_simple_example_sizes_equal_jax(paths, frames, jax_direct,
                                        monkeypatch, capsys):
    monkeypatch.setenv(common.REFERENCE_FRAME_ENV, paths["frame"])
    rc, out = _run(simple_example.main, ["--device", "cpu"], capsys)
    assert rc == 0
    frame = frames[0]
    eb = np.full_like(frame, 0.01 * (frame.max() - frame.min()))
    size = len(jax_direct.compress(frame, eb))
    assert f"original: {frame.nbytes} B, compressed: {size} B" in out
    assert out.rstrip().endswith("violations: 0")


def test_pressure_levels_rows_equal_jax(paths, monkeypatch, capsys):
    rc, out = _run(pressure_levels_example.main,
                   [paths["stack"], "--device", "cpu"], capsys)
    jrc, jout = _run_jax("pressure_levels_example", [paths["stack"]],
                         monkeypatch, capsys)
    assert rc == jrc == 0
    assert out == jout
    assert out.count("violations=0") == N


def _untimed(out):
    return re.sub(r"\(\d+\.\ds\)", "(-)", out)


def test_delta_compression_test_rows_equal_jax(paths, monkeypatch, capsys):
    rc, out = _run(delta_compression_test.main,
                   [paths["stack"], "--device", "cpu"], capsys)
    jrc, jout = _run_jax("delta_compression_test", [paths["stack"]],
                         monkeypatch, capsys)
    assert rc == jrc == 0
    assert _untimed(out) == _untimed(jout)
    assert out.count("violations=0") == 2 and out.count("PASS") == 2


def test_delta_compression_test_exits_1_on_a_violation(paths, monkeypatch,
                                                      capsys):
    """A decode past the bound fails the run with exit code 1, as the JAX
    script's ``sys.exit(1)``."""
    from ebcc_tpu_torch.models.direct import DirectCompressor
    real = DirectCompressor.decompress
    monkeypatch.setattr(DirectCompressor, "decompress",
                        lambda self, blob: real(self, blob) + 1.0)
    rc, out = _run(delta_compression_test.main,
                   [paths["stack"], "--device", "cpu"], capsys)
    assert rc == 1 and out.count("FAIL") == 2


def test_pointwise_sweep_rows_equal_jax(paths, tmp_path, monkeypatch,
                                        capsys):
    csv_path = str(tmp_path / "pw.csv")
    rc, out = _run(pointwise_sweep.main,
                   [paths["stack"], "--out", csv_path, "--device", "cpu"],
                   capsys)
    assert rc == 0
    rows = _json_lines(out)
    assert [(r["base_cr"], r["scale"]) for r in rows] == [
        (b, s) for b in (50, 100) for s in (0.5, 1.0, 2.0)]
    assert all(set(r) == KEYS["pointwise_sweep"] for r in rows)
    assert all(r["violations"] == 0 for r in rows)
    assert _csv_header(csv_path) == list(rows[0])
    jrc, jout = _run_jax("pointwise_sweep",
                         [paths["stack"], "--base-crs", "100", "--out",
                          str(tmp_path / "jax.csv")], monkeypatch, capsys)
    assert jrc == 0

    def untimed(r):
        return {k: v for k, v in r.items() if k != "encode_s"}
    assert [untimed(r) for r in rows[3:]] == [untimed(r)
                                              for r in _json_lines(jout)]


# ---------------- compression_sweep ----------------


def test_compression_sweep_rows_and_resume(paths, frames, tmp_path, capsys):
    csv_path = str(tmp_path / "sweep.csv")
    rc, out = _run(compression_sweep.main,
                   [paths["stack"], "--errors", "0.5", "--out", csv_path,
                    "--device", "cpu"], capsys)
    assert rc == 0
    [row] = _json_lines(out)
    assert set(row) == KEYS["compression_sweep"]
    assert row["max_error"] <= 0.5
    jcfg = ebcc_tpu.EBCCConfig(mode=ebcc_tpu.ResidualMode.MAX_ERROR,
                               error=0.5, base_cr=100.0)
    cfg = EBCCConfig(**dataclasses.asdict(jcfg))
    blob = api.compress(frames, cfg, device="cpu")
    assert _pure_base(blob)
    assert row["cr"] == frames.nbytes / len(ebcc_tpu.compress(frames, jcfg))
    assert row["cr"] == frames.nbytes / len(cpu_encoder.compress(frames,
                                                                 cfg))
    # resumed with a second bound: only the new row is computed
    rc, out = _run(compression_sweep.main,
                   [paths["stack"], "--errors", "0.5", "1.0", "--out",
                    csv_path, "--resume", "--device", "cpu"], capsys)
    assert rc == 0
    assert [r["error_target"] for r in _json_lines(out)] == [1.0]
    with open(csv_path) as f:
        lines = f.read().splitlines()
    assert lines[0].split(",") == compression_sweep.FIELDS
    keys = [tuple(ln.split(",")[:2]) for ln in lines[1:]]
    assert len(keys) == len(set(keys))
    assert ("ebcc-max_error", "0.5") in keys and \
        ("ebcc-max_error", "1.0") in keys


def test_lossless_rows_equal_jax(frames):
    jax_rows = _jax_script("compression_sweep").lossless_baselines(frames)
    rows = compression_sweep.lossless_baselines(frames)

    def untimed(r):
        return {k: v for k, v in r.items() if k != "encode_s"}
    assert [untimed(r) for r in rows] == [untimed(r) for r in jax_rows]
    assert all(set(r) == KEYS["lossless"] for r in rows)


# ---------------- scan_cratio ----------------


def test_scan_cratio_equals_native_and_jax_optimiser(paths, frames,
                                                     tmp_path, capsys):
    csv_path = str(tmp_path / "scan.csv")
    rc, out = _run(scan_cratio.main, [paths["frame"], "--out", csv_path,
                                      "--device", "cpu"], capsys)
    assert rc == 0
    rows = _json_lines(out)
    assert all(set(r) == KEYS["scan_cratio"] for r in rows)
    assert _csv_header(csv_path) == list(rows[0])
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5)
    frame = frames[0]
    for q, r in zip(scan_cratio.FIXED_QS, rows):
        assert r["method"] == f"fixed_q={q:g}"
        assert r["max_error"] <= 0.5
        assert r["cr"] == frame.nbytes / len(cpu_encoder.compress(
            frame, cfg, qbase=q))
    _, jinfo = jax_models.RateOptimizedCompressor(ebcc_tpu.EBCCConfig(
        mode=ebcc_tpu.ResidualMode.MAX_ERROR, error=0.5)).compress(frame)
    assert rows[-1]["method"] == f"optimized(q={jinfo['best_quantile']:g})"
    assert rows[-1]["cr"] == jinfo["cr"]


# ---------------- compare_codecs ----------------


def test_compare_codecs_rows_equal_jax(small_frame, capsys):
    """At ``tests/test_compare.py``'s frame and error 0.1 every row's bytes
    and the verdict are the JAX script's; the EBCC row is the native
    encoder's.  (That frame is conftest's synthetic stand-in for the ERA5
    fixture, N(0, 0.5) noise over the field: both packages' EBCC is larger
    than the Lorenzo baseline there, so the verdict is FAIL for both.)"""
    error = 0.1
    jax_cc = _jax_script("compare_codecs")
    rows, verdict = compare_codecs.run(small_frame, error, "cpu")
    jrows, jverdict = jax_cc.run(small_frame, error)

    def untimed(r):
        return {k: v for k, v in r.items() if k not in ("seconds", "rmse")}
    assert [untimed(r) for r in rows] == [untimed(r) for r in jrows]
    assert verdict == jverdict
    # the frame keeps a residual layer, so the two decodes differ by ulps
    assert rows[0]["rmse"] == pytest.approx(jrows[0]["rmse"], rel=1e-6)
    assert [r["rmse"] for r in rows[1:]] == [r["rmse"] for r in jrows[1:]]
    assert all(set(r) == KEYS["compare_codecs"] for r in rows)
    by = {r["method"]: r for r in rows}
    for name, ours, theirs in (
            ("quant-zstd", compare_codecs.quant_zstd, jax_cc.quant_zstd),
            ("lorenzo-zstd", compare_codecs.lorenzo_zstd,
             jax_cc.lorenzo_zstd)):
        size, rec = ours(small_frame, error)
        jsize, jrec = theirs(small_frame, error)
        assert size == jsize == by[name]["bytes"]
        np.testing.assert_array_equal(rec, jrec)
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=error, base_cr=100,
                     max_batch=1)
    assert by["ebcc_tpu"]["bytes"] == len(cpu_encoder.compress(small_frame,
                                                               cfg))
    assert by["ebcc_tpu"]["max_error"] <= error
    raw = small_frame.tobytes()
    assert compare_codecs.zstd_unpack(compare_codecs.zstd_pack(raw),
                                      len(raw)) == raw
    assert compare_codecs.zstd_pack(raw) == jax_cc.zstd_pack(raw)
    assert f"EBCC-TPU vs best error-bounded baseline: {verdict}" in \
        capsys.readouterr().out


def test_compare_codecs_main_exit_code(paths, capsys):
    """PASS exits 0 (the bench frame at the JAX script's default error
    0.5), FAIL exits 1 (the same frame at 0.1, where Lorenzo is smaller)."""
    rc, out = _run(compare_codecs.main, [paths["frame"], "--device", "cpu"],
                   capsys)
    assert rc == 0 and ": PASS (" in out
    rc, out = _run(compare_codecs.main,
                   [paths["frame"], "--error", "0.1", "--device", "cpu"],
                   capsys)
    assert rc == 1 and ": FAIL (" in out
    with pytest.raises(SystemExit):  # no input: the run stops
        compare_codecs.main(["--device", "cpu"])


# ---------------- run_predictive ----------------


@pytest.mark.parametrize("model", ["persistence", "linear"])
def test_run_predictive_crs_equal_jax(paths, model, monkeypatch, capsys):
    rc, out = _run(run_predictive.main, [paths["stack"], "--model", model,
                                         "--device", "cpu"], capsys)
    jrc, jout = _run_jax("run_predictive", [paths["stack"], "--model",
                                            model], monkeypatch, capsys)
    [row], [jrow] = _json_lines(out), _json_lines(jout)
    assert rc == jrc == 0
    assert set(row) == set(jrow)
    for k in ("steps", "model", "predictive_cr", "direct_cr", "violations"):
        assert row[k] == jrow[k], k
    assert row["violations"] == 0


def test_run_predictive_trained_forecaster(paths, tmp_path, capsys):
    csv_path = str(tmp_path / "steps.csv")
    rc, out = _run(run_predictive.main,
                   [paths["stack"], "--model", "trained", "--train-steps",
                    "5", "--out", csv_path, "--device", "cpu"], capsys)
    trained, row = _json_lines(out)
    assert rc == 0 and trained["trained"] and trained["frames"] == 3
    assert np.isfinite(trained["final_loss"])
    assert set(trained) | set(row) == KEYS["run_predictive"]
    assert row["violations"] == 0 and row["model"] == "trained"
    assert _csv_header(csv_path) == _jax_list("run_predictive.py",
                                              "fieldnames")


def test_run_predictive_model_module(paths, tmp_path, monkeypatch, capsys):
    (tmp_path / "my_forecast.py").write_text(
        "def forecast(history):\n    return history[-1]\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    rc, out = _run(run_predictive.main,
                   [paths["stack"], "--model-module", "my_forecast",
                    "--device", "cpu"], capsys)
    [row] = _json_lines(out)
    rc_p, out_p = _run(run_predictive.main,
                       [paths["stack"], "--device", "cpu"], capsys)
    [row_p] = _json_lines(out_p)
    assert rc == rc_p == 0 and row["model"] == "my_forecast"
    assert row["predictive_cr"] == row_p["predictive_cr"]


# ---------------- era5_video_compress ----------------


def test_era5_load_frames_equal_jax(paths, frames, monkeypatch):
    jax_evc = _jax_script("era5_video_compress")
    if os.path.exists(_jax_fixture()):  # read the frame the JAX one reads
        monkeypatch.setenv(common.REFERENCE_FRAME_ENV, _jax_fixture())
    np.testing.assert_array_equal(era5_video_compress._load_frames(None, 2),
                                  jax_evc._load_frames(None, 2))
    np.testing.assert_array_equal(
        era5_video_compress._load_frames(paths["stack"], 2),
        jax_evc._load_frames(paths["stack"], 2))
    np.testing.assert_array_equal(
        era5_video_compress._load_frames(paths["stack"], 2), frames[:2])


def test_era5_video_without_ffmpeg_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(era5_video_compress.video, "available",
                        lambda: False)
    capsys.readouterr()
    assert era5_video_compress.main(["--device", "cpu"]) == 2
    assert "ffmpeg not found" in capsys.readouterr().err


def test_era5_ebcc_row_equals_native(frames):
    row = era5_video_compress.ebcc_row(frames, 0.3, "cpu")
    assert set(row) == KEYS["ebcc_row"]
    assert row["max_abs_error"] <= 0.3
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.3, base_cr=100,
                     max_batch=N)
    assert row["compressed_bytes"] == len(cpu_encoder.compress(frames, cfg))


# ---------------- nc_to_ebcc_h5 ----------------


def _netcdf_like(path, frames):
    """An HDF5 file laid out as netCDF4 writes one: dimension scales
    attached to a float variable (DIMENSION_LIST / REFERENCE_LIST object
    references), attributes on the file, a group and the variables."""
    import h5py
    with h5py.File(path, "w") as f:
        f.attrs["Conventions"] = "CF-1.6"
        t = f.create_dataset("time", data=np.arange(len(frames), dtype="i4"))
        lat = f.create_dataset("lat", data=np.linspace(90, -90, H))
        lon = f.create_dataset("lon", data=np.linspace(0, 360, W,
                                                       endpoint=False))
        for s in (t, lat, lon):
            s.make_scale(s.name.strip("/"))
        v = f.create_dataset("t2m", data=frames)
        v.attrs["units"] = "K"
        for i, s in enumerate((t, lat, lon)):
            v.dims[i].attach_scale(s)
        g = f.create_group("meta")
        g.attrs["source"] = "test"
        g.create_dataset("mask", data=(frames[0] > 260).astype("i1"))


def _has_ref(dtype):
    """Whether values of ``dtype`` hold HDF5 object references (a
    reference, or a compound with one, as netCDF's REFERENCE_LIST)."""
    import h5py
    if dtype.names:
        return any(_has_ref(dtype.fields[n][0]) for n in dtype.names)
    return h5py.check_ref_dtype(dtype) is not None


def _h5_tree(path):
    """{name: (kind, shape, attrs without object references)}."""
    import h5py
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            attrs = {k: np.asarray(obj.attrs[k]).tolist() for k in obj.attrs
                     if not _has_ref(obj.attrs.get_id(k).dtype)}
            out[name] = (type(obj).__name__, getattr(obj, "shape", None),
                         attrs)
        f.visititems(visit)
        out["/"] = ({k: np.asarray(v).tolist() for k, v in f.attrs.items()},)
    return out


def _chunks(path, name, n):
    import h5py
    with h5py.File(path, "r") as f:
        return [bytes(f[name].id.read_direct_chunk((i, 0, 0))[1])
                for i in range(n)]


def test_nc_to_ebcc_h5_routes_equal_jax(frames, tmp_path, monkeypatch,
                                        capsys):
    import h5py
    src = str(tmp_path / "in.nc")
    _netcdf_like(src, frames)
    outs = {r: str(tmp_path / f"{r}.h5") for r in ("jax", "cpu", "plugin")}
    jrc, jout = _run_jax("nc_to_ebcc_h5", [src, outs["jax"]], monkeypatch,
                         capsys)
    assert jrc == 0
    for route in ("cpu", "plugin"):
        if route == "plugin":  # the plugin route needs no card
            monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        rc, out = _run(nc_to_ebcc_h5.main,
                       [src, outs[route], "--device", route], capsys)
        ds, total = _json_lines(out)
        jds, jtotal = _json_lines(jout)
        assert rc == 0 and set(ds) == KEYS["nc_dataset"]
        assert set(total) == KEYS["nc_total"]
        assert {k: ds[k] for k in ("name", "bytes", "raw_bytes", "cr")} == \
            {k: jds[k] for k in ("name", "bytes", "raw_bytes", "cr")}
        assert total == jtotal
    trees = {r: _h5_tree(p) for r, p in outs.items()}
    assert trees["cpu"] == trees["plugin"] == trees["jax"]
    assert "DIMENSION_LIST" not in trees["cpu"]["t2m"][2]
    assert trees["cpu"]["t2m"][2]["units"] == "K"
    chunks = {r: _chunks(p, "t2m", N) for r, p in outs.items()}
    assert chunks["cpu"] == chunks["plugin"] == chunks["jax"]
    # the port's file reads in the JAX package through its plugin
    from ebcc_tpu.wrappers import hdf5 as jax_hdf5
    jax_hdf5.register_plugin_path()
    with h5py.File(outs["cpu"], "r") as f:
        back = f["t2m"][...]
        np.testing.assert_array_equal(f["lat"][...],
                                      np.linspace(90, -90, H))
    bound = 0.009 * (frames.max(axis=(1, 2)) - frames.min(axis=(1, 2)))
    assert (np.abs(back - frames).max(axis=(1, 2)) <= bound).all()


# ---------------- plot_error_map ----------------


def test_plot_error_map(paths, frames, tmp_path, capsys):
    png = tmp_path / "map.png"
    rc, out = _run(plot_error_map.main,
                   [paths["frame"], "--out", str(png), "--device", "cpu"],
                   capsys)
    assert rc == 0 and png.stat().st_size > 0
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    err, cr = plot_error_map.error_map(frames[0], 0.5, "cpu")
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5, base_cr=100,
                     max_batch=1)
    blob = api.compress(frames[0], cfg, device="cpu")
    np.testing.assert_array_equal(
        err, api.decompress(blob, cfg, device="cpu")[0] - frames[0])
    assert cr == frames[0].nbytes / len(blob)
    assert np.abs(err).max() <= 0.5
    assert f"(max |err| = {np.abs(err).max():.4f})" in out


# ---------------- stripe_adaptive_study ----------------


def _jax_measure(frame, mode, err):
    """``scripts/stripe_adaptive_study.py``'s ``measure``, on the JAX
    package, returning its numbers instead of printing them."""
    import jax
    import jax.numpy as jnp
    cfg = ebcc_tpu.EBCCConfig(mode=mode, error=err, base_cr=100, max_batch=1)
    codec = jax_pipeline.FrameCodec(*frame.shape, cfg)
    tgt = (err * (frame.max() - frame.min())
           if mode == ebcc_tpu.ResidualMode.RELATIVE_ERROR else err)
    res = codec.encode_error_bounded(
        jnp.asarray(frame[None]), jnp.full((1,), tgt, jnp.float32), 1e-6)
    an = jax_bp.analyze(jnp.asarray(np.asarray(res.base_coef), jnp.int32),
                        codec.base.spec)
    cand = np.asarray(jax_bp.candidate_bits(
        jax_bp.segment_counts(an, codec.base.spec), codec.base.spec))[0]
    P, K2 = cand.shape
    J = K2 // 2
    bs, ks = int(res.bs_pure[0]), int(res.ks_pure[0])
    pidx = P - 1 - bs
    chosen = int(cand[pidx, ks])
    full_prev = int(cand[pidx - 1, K2 - 1]) if pidx >= 1 else 0
    inc = np.diff(np.concatenate([[full_prev], cand[pidx]]))
    ci = np.asarray(res.base_coef).astype(np.int64)[0]
    stripe = (np.arange(ci.shape[0]) * J) // ci.shape[0]
    recon = jax.jit(lambda r: codec._base_recon(r, res.mn, res.mx, res.dc_b))

    def err_at(depths):
        d = np.asarray(depths)[stripe][:, None]
        mag = np.abs(ci)
        kept = (mag >> d) << d
        half = np.where((kept > 0) & (d > 0), (2.0 ** d - 1.0) * 0.5, 0.0)
        rec = np.where(kept > 0, kept + half, 0.0) * np.sign(ci)
        out = np.asarray(recon(jnp.asarray(rec[None], jnp.float32)))[0]
        return float(np.abs(out - frame).max())

    depths = [bs] * J
    for j in range(J):
        t = depths.copy()
        t[j] = bs + 1
        if err_at(t) <= tgt:
            depths[j] = bs + 1
    keep = [j for j in range(J) if depths[j] == bs]
    masked = None
    if err_at(depths) <= tgt:
        masked = full_prev + sum(int(inc[j]) + int(inc[J + j])
                                 for j in keep)
    return dict(bs=bs, ks=ks, chosen=chosen, full_prev=full_prev, keep=keep,
                masked=masked)


def test_stripe_study_measure_equals_jax(frames):
    frame = frames[0]
    got = stripe_adaptive_study.measure(frame, ResidualMode.MAX_ERROR, 0.5,
                                        "cpu")
    want = _jax_measure(frame, ebcc_tpu.ResidualMode.MAX_ERROR, 0.5)
    assert got == want
    assert got["masked"] is not None and got["masked"] <= got["chosen"]


def test_stripe_study_main(paths, capsys):
    rc, out = _run(stripe_adaptive_study.main,
                   [paths["frame"], "--device", "cpu"], capsys)
    lines = out.splitlines()
    assert rc == 0 and [ln.split(":")[0] for ln in lines] == [
        "clean max-0.5", "noisy max-0.5", "clean rel-0.009"]
    m = stripe_adaptive_study.measure(np.load(paths["frame"]),
                                      ResidualMode.MAX_ERROR, 0.5, "cpu")
    assert lines[0].startswith(f"clean max-0.5: chosen {m['chosen']} "
                               f"masked {m['masked']} ")
    with pytest.raises(SystemExit):  # no input: the run stops
        stripe_adaptive_study.main(["--device", "cpu"])


# ---------------- the device rule ----------------

DRIVERS = {
    "simple_example": (simple_example, []),
    "pressure_levels_example": (pressure_levels_example, []),
    "delta_compression_test": (delta_compression_test, []),
    "pointwise_sweep": (pointwise_sweep, []),
    "compression_sweep": (compression_sweep, ["in.npy"]),
    "scan_cratio": (scan_cratio, []),
    "compare_codecs": (compare_codecs, ["in.npy"]),
    "run_predictive": (run_predictive, []),
    "era5_video_compress": (era5_video_compress, []),
    "nc_to_ebcc_h5": (nc_to_ebcc_h5, ["in.nc", "out.h5"]),
    "plot_error_map": (plot_error_map, ["in.npy"]),
    "stripe_adaptive_study": (stripe_adaptive_study, ["in.npy"]),
}


# ``--device`` alone is nc_to_ebcc_h5's device route on the card (the JAX
# script's switch)
DRIVERS["nc_to_ebcc_h5 --device"] = (nc_to_ebcc_h5,
                                     ["in.nc", "out.h5", "--device"])


@pytest.mark.parametrize("name", list(DRIVERS))
def test_drivers_need_a_card_by_default(name, monkeypatch):
    module, argv = DRIVERS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)


def test_module_entry_point_imports_no_jax(paths):
    # -X importtime lists every module the process imports on stderr
    r = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "ebcc_tpu_torch.scripts.simple_example", "--device", "cpu"],
        capture_output=True, text=True, timeout=240, cwd=REPO, check=True,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             common.REFERENCE_FRAME_ENV: paths["frame"]})
    assert "violations: 0" in r.stdout
    imported = {line.rsplit("|", 1)[-1].strip().split(".")[0]
                for line in r.stderr.splitlines() if "|" in line}
    assert "ebcc_tpu_torch" in imported
    assert not imported & {"jax", "ebcc_tpu", "flax", "optax"}
