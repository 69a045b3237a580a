"""The port's inverse-DWT probes against the JAX package's TPU probes.

``scripts/pallas_idwt_probe.py`` and ``scripts/pallas_idwt_probe2.py`` are
loaded as they are, at a small frame, with their device check stubbed and
``pallas_call`` replaced by a recorder whose calls raise: each script
reports the error per probe and goes on, so ``main()`` hands over every
kernel body and its call arguments without timing anything.  The bodies of
k0-k3 and q1 are then run through the real ``pallas_call`` in interpret
mode on seeded numpy frames and held against the port's plain versions
(``ops/idwt_probe.py``), which must be bit-equal.  k4/k5 and q2/q3 are the
inverse DWT, held against the JAX package in tests/test_torch_ops.py.

tests/test_torch_cuda.py compares each CUDA kernel with its plain version
on a card.
"""

import contextlib
import ctypes
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ebcc_tpu.utils import health
from ebcc_tpu_torch.ops import idwt_probe as ip
from ebcc_tpu_torch.runtime import build, cuda
from ebcc_tpu_torch.scripts import idwt_probe as cli

SCRIPTS = os.path.join(build.REPO_DIR, "scripts")
HP, WP = 64, 96
# the TPU probe each port replaces: (script, kernel body's name)
TPU = {"probe_elementwise": ("pallas_idwt_probe", "k0"),
       "probe_row_interleave": ("pallas_idwt_probe", "k1"),
       "probe_lane_interleave": ("pallas_idwt_probe", "k2"),
       "probe_transpose": ("pallas_idwt_probe", "k3"),
       "probe_row_pairs": ("pallas_idwt_probe2", "q1")}


@pytest.fixture(scope="module")
def captured():
    """{script: (module, {body name: (body, pallas_call kwargs)}, main()'s
    return code, its stdout lines)}
    from each script's unchanged ``main()`` at HP x WP."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(health, "probe_backend", lambda *a, **k: True)
        mp.setattr(health, "enable_compile_cache", lambda *a, **k: None)
        for script in ("pallas_idwt_probe", "pallas_idwt_probe2"):
            spec = importlib.util.spec_from_file_location(
                f"_tpu_{script}", os.path.join(SCRIPTS, f"{script}.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mod.HP, mod.WP, mod.NIT = HP, WP, 2
            calls = {}

            def record(kernel, **kwargs):
                calls[kernel.__name__] = (kernel, kwargs)

                def refuse(*a, **k):
                    raise RuntimeError("recorded, not run")
                return refuse

            buf = io.StringIO()
            with pytest.MonkeyPatch.context() as recording, \
                    contextlib.redirect_stdout(buf):
                recording.setattr(pl, "pallas_call", record)
                rc = mod.main()
            out[script] = (mod, calls, rc, buf.getvalue().splitlines())
    return out


def test_scripts_hand_over_every_kernel(captured):
    """main() returns 0 having recorded every probe, and reports each as
    an error: no timing loop ran a recorded call."""
    want = {"pallas_idwt_probe": ["k0", "k1", "k2", "k3", "k4", "k5"],
            "pallas_idwt_probe2": ["q1", "q2", "q3"]}
    for script, names in want.items():
        _, calls, rc, lines = captured[script]
        assert rc == 0
        assert list(calls) == names
        rows = [json.loads(s) for s in lines]
        assert all("error" in r for r in rows if r["probe"][:2] != "xl")
        assert len([r for r in rows if "error" in r]) == len(names)


def _pallas(captured, name, frame, monkeypatch):
    """The TPU probe of port kernel ``name`` on one [h, w] frame, in
    interpret mode, with the script's shape globals set to the frame's."""
    script, body = TPU[name]
    mod, calls, _, _ = captured[script]
    kernel, kwargs = calls[body]
    h, w = frame.shape
    monkeypatch.setattr(mod, "HP", h)
    monkeypatch.setattr(mod, "WP", w)
    kwargs = dict(kwargs, out_shape=jax.ShapeDtypeStruct((h, w), jnp.float32))
    if kwargs.get("scratch_shapes"):
        kwargs["scratch_shapes"] = [pltpu.VMEM((w, h), jnp.float32)]
    return np.asarray(pl.pallas_call(kernel, interpret=True, **kwargs)(
        jnp.asarray(frame)))


@pytest.mark.parametrize("name", list(TPU))
@pytest.mark.parametrize("batch,h,w", [(1, HP, WP), (3, HP, WP),
                                       (1, 32, 160), (3, 32, 160),
                                       (1, 66, 130), (3, 66, 130)])
def test_plain_matches_pallas(captured, name, batch, h, w, monkeypatch):
    """Bit-equal to the TPU kernel, frame by frame (tolerance 0; k0's fma
    through the float64 emulation of ops/frame.py)."""
    x = np.random.default_rng(batch * 7 + h).standard_normal(
        (batch, h, w)).astype(np.float32)
    ours = ip.probe(name, torch.from_numpy(x)).numpy()
    assert ours.shape == x.shape and ours.dtype == np.float32
    for b in range(batch):
        want = _pallas(captured, name, x[b], monkeypatch)
        np.testing.assert_array_equal(ours[b].view(np.uint32),
                                      want.view(np.uint32))


def test_elementwise_is_one_fma():
    """k0 rounds once: it differs from f32 multiply-then-add somewhere."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, HP, WP)).astype(np.float32))
    two_roundings = x * ip.SCALE + 0.5
    assert not torch.equal(ip.elementwise_ref(x), two_roundings)
    assert float((ip.elementwise_ref(x) - two_roundings).abs().max()) < 1e-6


@pytest.mark.parametrize("name", list(TPU))
def test_cuda_wrappers_reject_bad_tensors(name):
    """On a CPU tensor, an odd H or W, or a tensor not [B, H, W], the CUDA
    wrapper raises before any launch."""
    k = ip.KERNELS[name]
    k.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        ip.probe_cuda(name, torch.zeros((1, 8, 12)))
    for shape in ((1, 7, 12), (1, 8, 11), (8, 12)):
        with pytest.raises(ValueError, match="even"):
            ip.probe_cuda(name, torch.zeros(shape))
    assert k.launches == 0


def test_probe_kernels_share_one_library():
    """The five entries build one library from csrc/idwt_probe.cu, keyed on
    it and the header it includes."""
    libs = {k.library for k in ip.KERNELS.values()}
    assert libs == {"idwt_probe"}
    names = [os.path.basename(s) for s in ip.KERNELS["probe_transpose"]
             .sources]
    assert names == ["idwt_probe.cu", "lifting.cuh"]
    src = open(ip.KERNELS["probe_elementwise"].source).read()
    for k in ip.KERNELS.values():
        assert f"int {k.entry}(" in src
    assert cuda.Kernel("idwt", "ebcc_idwt", []).library == "idwt"


def test_every_entry_takes_the_same_arguments():
    """No entry takes a workspace: k3's scratch lives in shared memory, so
    its argtypes are every other probe's (device, x, out, B, H, W,
    stream)."""
    want = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for k in ip.KERNELS.values():
        assert k.argtypes == want, k.name


def test_transpose_entry_signature_has_no_workspace():
    """The C entry of k3 is (device, x, out, B, H, W, stream): no ``work``
    pointer in its signature."""
    src = open(ip.KERNELS["probe_transpose"].source).read()
    head = "int ebcc_probe_transpose("
    assert src.count(head) == 1
    sig = src[src.index(head):src.index(")", src.index(head))]
    assert "work" not in sig
    assert [a.split()[-1].lstrip("*") for a in
            sig[len(head):].split(",")] == ["device", "x", "out", "B", "H",
                                            "W", "stream"]


def test_entry_point_on_cpu(capsys):
    """On the CPU: one JSON line per probe row and batch, every kernel row
    equal to its plain version."""
    rows = cli.run(torch.device("cpu"), batches=(1, 2), height=HP,
                   width=WP, reps=1)
    assert [json.loads(s) for s in capsys.readouterr().out.splitlines()] \
        == rows
    names = [r[0] for r in cli.ROWS] + ["torch_idwt2d_multi"]
    assert [r["probe"] for r in rows] == names * 2
    assert [r["batch"] for r in rows] == [1] * 10 + [2] * 10
    for r in rows:
        assert r["per_pass_s"] > 0 and r["device"] == "cpu"
        assert r["card"] is None and r["reads"] is None
        assert r.get("maxdiff", 0.0) == 0.0
        assert ("maxdiff" in r) == (r["kernel"] is not None)


def test_entry_point_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([]) == 2
    assert capsys.readouterr().out == ""
