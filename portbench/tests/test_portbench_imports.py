"""No module that a run or the reference loads is JAX or the JAX package,
compared by whole top-level names (the port's name begins with the JAX
package's), and the reference loads nothing of the program."""

import json
import subprocess
import sys

from portbench_small import ROOT

from portbench import core


def _modules(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ROOT,
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _tops(mods) -> set:
    return {m.split(".", 1)[0] for m in mods}


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "ebcc_tpu_torch_like", sys)
    assert "ebcc_tpu_torch_like" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ebcc_tpu.codec", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    bad = core.forbidden_modules()
    assert "ebcc_tpu.codec" in bad and "jaxlib" in bad


def test_a_run_loads_no_jax():
    mods = _modules(
        "import sys; sys.path.insert(0, 'portbench/tests')\n"
        "from portbench_small import small_cell\n"
        "from portbench import core\n"
        "out = core.run(small_cell('t2m_pointwise.archive'), 3, 0.5, True,"
        " device='cpu')\n"
        "assert out['correct'], out['checks']")
    assert not _tops(mods) & set(core.FORBIDDEN)
    assert "ebcc_tpu_torch" in _tops(mods)


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules("from portbench.reference import check, decode")
    assert not _tops(mods) & (set(core.FORBIDDEN) | {"ebcc_tpu_torch"})
