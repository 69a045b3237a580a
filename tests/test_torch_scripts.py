"""The port's measuring entry points (``ebcc_tpu_torch/scripts/``) on the
CPU at small frames, against the JAX scripts, the JAX package and the
native codec.

* every entry point's output has the keys of its JAX script (read from the
  script's source), and only the port's listed extra keys beside them;
* bench: the bound held, and its CR equal to the JAX package's
  ``compress`` and to the native encoder's on the same frames (pure-base
  frames, where the port's and JAX's containers agree);
* profile_stages: its stage-by-stage container is ``compress``'s, and its
  decode is within the bound;
* mask_ab: both rules' containers equal the native encoder's;
* scaling_bench: the mesh mode on 1 and 2 logical CPU shards writes the
  same containers, and the process mode runs the launcher;
* roofline, profile_transforms: finite, positive values;
* every entry point asks for a card by default, and raises without one.

One intra-op thread for the module (small torch ops; see SKILL.md).
"""

import ast
import dataclasses
import math
import os

import pytest
import torch

import ebcc_tpu

import ebcc_tpu_torch
from ebcc_tpu_torch.codec import container
from ebcc_tpu_torch.runtime import cpu_encoder
from ebcc_tpu_torch.scripts import (bench, common, mask_ab, profile_stages,
                                    profile_transforms, roofline,
                                    scaling_bench)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, FPB = 48, 64, 2  # 2 batches of 2 frames of 48x64
RESID_ERROR = 2e-3  # relative: a bound under the noise keeps a residual


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return common.bench_frames(2 * FPB, H, W)


# ---------------- the JAX scripts' keys ----------------


def _keys_in(node, kinds) -> set:
    """String keys a function writes, of the ``kinds`` asked for: "dict"
    (dict literals' constant keys), "call" (``dict(k=...)`` keywords),
    "store" (constant subscripts assigned to its result dicts ``t`` and
    ``out``)."""
    keys = set()
    for n in ast.walk(node):
        if "dict" in kinds and isinstance(n, ast.Dict):
            keys |= {k.value for k in n.keys
                     if isinstance(k, ast.Constant) and
                     isinstance(k.value, str)}
        elif "call" in kinds and isinstance(n, ast.Call) and \
                getattr(n.func, "id", None) == "dict":
            keys |= {k.arg for k in n.keywords if k.arg}
        elif "store" in kinds and isinstance(n, ast.Subscript) and \
                isinstance(n.ctx, ast.Store) and \
                getattr(n.value, "id", None) in ("t", "out") and \
                isinstance(n.slice, ast.Constant):
            keys.add(n.slice.value)
    return keys


def _jax_keys(script: str, function: str, *kinds: str) -> set:
    with open(os.path.join(REPO, script)) as f:
        tree = ast.parse(f.read())
    [fn] = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name == function]
    return _keys_in(fn, kinds)


def _stage_names() -> list:
    """profile_stages.py's device stage names (its ``names`` list)."""
    with open(os.path.join(REPO, "scripts/profile_stages.py")) as f:
        tree = ast.parse(f.read())
    for n in ast.walk(tree):
        if isinstance(n, ast.Assign) and \
                getattr(n.targets[0], "id", None) == "names":
            return [e.value for e in n.value.elts]
    raise AssertionError("no names list in scripts/profile_stages.py")


# per script: (the JAX keys, the JAX keys the port does not print, the
# port's own keys)
KEYS = {
    "bench": (_jax_keys("bench.py", "run_bench", "dict"), set(),
              {"maxerr", "frames", "device", "card"}),
    "profile_stages": (
        _jax_keys("scripts/profile_stages.py", "main", "store") |
        {f"{p}_{n}" for n in _stage_names() for p in ("cum", "stage")},
        # the JAX script recorded a failed breakdown; the port raises
        {"device_stage_breakdown_error"},
        {"0a_h2d_upload", "0a_h2d_upload_bytes", "0a_h2d_upload_gbps",
         "1a_encode_enqueue", "1c_encode_capture",
         "1c_capture_reserved_bytes", "1c_capture_held_bytes",
         "1e_encode_eager", "1e_encode_eager_enqueue", "9c_recon_capture",
         "2_meta_bytes", "3a_arena_d2h", "3a_arena_d2h_bytes",
         "3a_coef_int32_bytes", "3a_arena_d2h_gbps", "3b_host_pack",
         "3_packed_on", "9a_h2d_upload",
         "9b_d2h_frames", "batch", "device", "card", "timing"}),
    "profile_transforms": (
        _jax_keys("scripts/profile_transforms.py", "main", "store"), set(),
        {"base_transform", "resid_transform", "candidate_bits", "batch",
         "shape", "device", "card", "timing"}),
    "roofline": (_jax_keys("scripts/roofline.py", "main", "dict", "store"),
                 set(), {"card", "timing"}),
    "mask_ab_rule": (_jax_keys("scripts/mask_ab.py", "main", "call"), set(),
                     {"device", "card"}),
    "mask_ab_summary": (_jax_keys("scripts/mask_ab.py", "main", "dict"),
                        set(), set()),
    "scaling_bench": (_jax_keys("scripts/scaling_bench.py", "main", "call"),
                      set(), {"bytes", "logical_shards", "device", "card"}),
}


def test_jax_keys_are_read():
    assert {"metric", "value", "unit", "vs_baseline",
            "device_encode_pts_per_s", "wall_encode_s", "wall_decode_s",
            "cr"} == KEYS["bench"][0]
    assert "stage_mask_greedy_scans" in KEYS["profile_stages"][0]
    assert "3_coef_fetch_plus_native_pack" in KEYS["profile_stages"][0]
    assert {"stream_gbps", "recon_eval_headroom_x", "device_kind"} <= \
        KEYS["roofline"][0]
    assert KEYS["mask_ab_rule"][0] == {"rule", "device_encode_s",
                                       "pts_per_s", "cr", "maxerr"}
    assert "efficiency" in KEYS["scaling_bench"][0]


def _assert_keys(name, got):
    jax_keys, dropped, extra = KEYS[name]
    assert set(got) == (jax_keys - dropped) | extra, name


# ---------------- the runs ----------------


@pytest.fixture(scope="module")
def bench_run(data):
    return bench.run_bench(data, FPB, "cpu")


def test_bench_bound_and_cr_equal_jax_and_native(bench_run, data):
    _assert_keys("bench", bench_run)
    assert bench_run["maxerr"] <= 0.5
    assert bench_run["frames"] == len(data) and bench_run["device"] == "cpu"
    assert bench_run["value"] > 0 and bench_run["device_encode_pts_per_s"] > 0
    cfg = bench.bench_config(FPB, H, W)
    blob = ebcc_tpu_torch.compress(data, cfg, device="cpu")
    # pure-base frames: the port's containers equal the JAX package's
    assert not any(container.unpack_frame(f)[0].flags &
                   container.FLAG_RESID for f in container.unpack_blob(blob))
    jcfg = ebcc_tpu.EBCCConfig(**{**dataclasses.asdict(cfg),
                                  "use_pallas_eval": False})
    assert bench_run["cr"] == data.nbytes / len(ebcc_tpu.compress(data, jcfg))
    assert bench_run["cr"] == data.nbytes / len(cpu_encoder.compress(data,
                                                                     cfg))


def test_bench_cpu_leg_and_device_only(bench_run, data):
    native = bench.run_bench(data, FPB, fallback_cpu=True)
    _assert_keys("bench", native)
    assert native["cr"] == bench_run["cr"] and native["maxerr"] <= 0.5
    assert native["device_encode_pts_per_s"] == 0.0
    assert native["device"] == "native"
    dev = bench.run_device_only(data[:FPB], "cpu")
    assert set(dev) <= set(bench_run) and dev["value"] > 0


def test_profile_stages_container_is_compress(data):
    t, blob = profile_stages.profile_stages(data[:FPB], "cpu")
    _assert_keys("profile_stages", t)
    cfg = bench.bench_config(FPB, H, W)
    assert blob == ebcc_tpu_torch.compress(data[:FPB], cfg, device="cpu")
    assert t["max_err"] <= 0.5
    assert t["3_coef_fetch_plus_native_pack"] == pytest.approx(
        t["3a_arena_d2h"] + t["3b_host_pack"])
    # only the base layer is packed (pure-base frames: no residual), by
    # the host off a card: nothing crosses
    assert t["3a_coef_int32_bytes"] == FPB * 64 * 64 * 4
    assert (t["3_packed_on"], t["3a_arena_d2h_bytes"]) == ("host", 0)
    stages = [t[f"stage_{n}"] for n in profile_stages.DEVICE_STAGES]
    assert all(s > 0 for s in stages)
    assert t["cum_residual_and_packings"] == pytest.approx(sum(stages))
    assert t["total_enc"] >= t["1_device_encode_search"] > 0


def test_profile_stages_with_a_residual_layer(monkeypatch):
    """A batch that keeps a residual layer (RELATIVE_ERROR, pure-base
    fallback off, base quantile 1e-3): the residual planes cross too, and
    the container is still ``compress``'s and the native encoder's."""
    monkeypatch.setenv("EBCC_DISABLE_PURE_JP2_FALLBACK", "1")
    frames = common.bench_frames(2, H, W, seed=3)
    cfg = dataclasses.replace(bench.bench_config(2, H, W),
                              mode=ebcc_tpu_torch.ResidualMode.RELATIVE_ERROR,
                              error=RESID_ERROR)
    t, blob = profile_stages.profile_stages(frames, "cpu", config=cfg,
                                            qbase=1e-3, reps=1)
    assert blob == ebcc_tpu_torch.compress(frames, cfg, device="cpu",
                                           qbase=1e-3)
    assert blob == cpu_encoder.compress(frames, cfg, qbase=1e-3)
    assert all(container.unpack_frame(f)[0].flags & container.FLAG_RESID
               for f in container.unpack_blob(blob))
    # both layers are packed, by the host off a card
    assert t["3a_coef_int32_bytes"] > 2 * 64 * 64 * 4
    assert t["3_packed_on"] == "host"
    assert t["8_native_resid_decode"] > 0


def test_mask_ab_rules_equal_native(data):
    rows, summary, blobs = mask_ab.mask_ab(data[:FPB], "cpu", reps=1)
    for rule in mask_ab.RULES:
        _assert_keys("mask_ab_rule", rows[rule])
        cfg = dataclasses.replace(bench.bench_config(FPB, H, W),
                                  mask_search=rule)
        assert blobs[rule] == cpu_encoder.compress(data[:FPB], cfg)
        assert rows[rule]["maxerr"] <= 0.5
        assert rows[rule]["cr"] == data[:FPB].nbytes / len(blobs[rule])
    _assert_keys("mask_ab_summary", summary)
    assert summary["speedup_union_vs_greedy"] > 0


def test_scaling_bench_shards_write_the_same_containers():
    rows, blobs = scaling_bench.run_mesh_mode([1, 2], 1, H, W,
                                              device="cpu", logical=True,
                                              reps=1)
    for row in rows:
        _assert_keys("scaling_bench", row)
    assert [r["devices"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0
    two = container.unpack_blob(blobs[2])
    assert container.unpack_blob(blobs[1]) == two[:1]
    assert blobs[2] == ebcc_tpu_torch.compress(
        common.bench_frames(2, H, W), bench.bench_config(2, H, W),
        device="cpu")


def test_scaling_bench_process_mode(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rows = scaling_bench.run_procs_mode([1], 1, 96, 160, device="cpu",
                                        timeout=240)
    assert len(rows) == 1 and "error" not in rows[0], rows
    assert rows[0]["processes"] == 1 and rows[0]["grid_points_per_s"] > 0


def test_roofline_values_finite_positive():
    out = roofline.roofline(2, H, W, "cpu", reps=1)
    _assert_keys("roofline", out)
    assert (out["hp"], out["wp"]) == (64, 64)
    nums = [v for k, v in out.items() if k not in ("device_kind", "card",
                                                   "timing")]
    assert all(math.isfinite(v) and v > 0 for v in nums), out


def test_profile_transforms_values_finite_positive():
    out = profile_transforms.profile_transforms(2, 64, 128, "cpu", reps=1)
    _assert_keys("profile_transforms", out)
    nums = [v for k, v in out.items()
            if k not in ("shape", "device", "card", "timing")]
    assert all(math.isfinite(v) and v > 0 for v in nums), out


@pytest.mark.parametrize("script", [bench, profile_stages,
                                    profile_transforms, roofline, mask_ab,
                                    scaling_bench],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_entry_points_need_a_card_by_default(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("EBCC_BENCH_MODE", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        script.main([])
