"""Without the CUDA devices a cell asks for, a run exits non-zero and
prints no result; so does a checkout that holds only the benchmark."""

import json
import os
import shutil
import subprocess
import sys

import torch

from portbench_small import ROOT

ARGS = ["--workload", "z500_maxerr.archive", "--seed", "2147483659",
        "--seconds", "1", "--trace", "0"]


def _run(root):
    return subprocess.run(
        [sys.executable, "portbench/run.py", *ARGS], cwd=root,
        capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "HOME": str(root),
             "OMP_NUM_THREADS": "1"})


def _no_result(out):
    for line in out.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(obj, dict) and "metrics" in obj)


def test_no_card_no_result():
    assert not torch.cuda.is_available()
    out = _run(ROOT)
    assert out.returncode != 0
    _no_result(out)
    assert "needs 1 CUDA device" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    _no_result(out)
