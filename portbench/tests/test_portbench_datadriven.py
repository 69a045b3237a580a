"""A cell made only of new files (a configuration, a traffic mix, a
generator and a per-layer metric, and the manifest's entries) is found and
run by name, with no file of the harness edited."""

import json
import os
import shutil

from portbench_small import ROOT, small_cell

from portbench import core


def test_new_cell_from_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    man = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench = root / "portbench"
    cfg = json.load(open(bench / "configs" / "era5_z500_maxerr.json"))
    cfg.update(name="flat_maxerr", generator="flat", error=1.0,
               guarantee={"kind": "abs", "bound": 1.0})
    (bench / "configs" / "flat_maxerr.json").write_text(json.dumps(cfg))
    (bench / "generators" / "flat.py").write_text(
        "import numpy as np\n"
        "def make(seed, n, h, w, params):\n"
        "    g = np.random.default_rng(seed)\n"
        "    return {'frames': (100 + g.standard_normal((n, h, w)))"
        ".astype(np.float32)}\n")
    tr = json.load(open(bench / "traffic" / "archive.json"))
    tr.update(frames_per_request=2, writers=1)
    (bench / "traffic" / "pairs.json").write_text(json.dumps(tr))
    (bench / "metrics" / "requests_done.write.py").write_text(
        "def read(ctx):\n    return float(len(ctx.window.requests))\n")
    man["configs"].append({"name": "flat_maxerr", "source": "https://x",
                           "file": "portbench/configs/flat_maxerr.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "flat.pairs", "config": "flat_maxerr",
                             "traffic": "pairs", "chips": 1,
                             "why": "a test"})
    man["per_layer"].append({"name": "requests_done.write",
                             "unit": "requests", "better": "higher",
                             "source": "host_clock", "layer": "API",
                             "moves": "write_mpts_per_s",
                             "workloads": ["flat.pairs"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    cell = core.load_cell("flat.pairs", str(root))
    assert cell.config["generator"] == "flat" and cell.traffic["writers"] \
        == 1
    assert [m["name"] for m in cell.per_layer][-1] == "requests_done.write"
    small = small_cell("flat.pairs", str(root))
    small.traffic.update(writers=1, frames_per_request=2)
    out = core.run(small, 5, 0.5, True, device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["requests_done.write"]["value"] >= 1
    # the old cells are untouched and no file of the harness changed
    assert core.load_cell("z500_maxerr.archive", str(root)).config == \
        core.load_cell("z500_maxerr.archive").config
    for p, data in before.items():
        assert p.read_bytes() == data, p
