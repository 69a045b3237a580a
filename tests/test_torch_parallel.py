"""The port's parallel layer on the CPU: meshes of logical shards and two
gloo processes, against the port's dense codec, the JAX package and the
native encoder.

* the halo DWT (``ops/dwt_sharded.py``) on a ``space = 4`` and a 2 x 4
  mesh is bit-equal to the port's dense transform up to the layout, and
  within 1e-5 of its largest value of the JAX package's sharded
  transform on conftest's 8 virtual CPU devices; the row maps are
  integer-equal to the JAX package's;
* ``ShardedCodec`` and ``SpatialShardedCodec`` on a 4 x 2 mesh give the
  dense codec's coefficients and selections, and ``compress(codec=...)``
  and ``compress_sharded`` the native encoder's containers;
* the refusals: an unshardable geometry, levels that would need clamping
  with ``codec=``, ``codec=`` with ``encode_backend="cpu"``;
* ``init_distributed`` without an address is a standalone run; without
  a card the default mesh and the default rank raise (no CPU fallback);
* two gloo processes (this file's ``__main__``) form 2 x 2 meshes across
  the process boundary, the data axis on one, the space axis on the
  other: both encodes equal the dense codec's, and ``compress_sharded``
  gives both ranks ``compress``'s blob;
* the launcher runs two CPU workers and prints one JSON line.

Every multi-process test joins with a 60 s timeout and waits at most 240 s
for its workers, killing them on expiry.
"""

import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ebcc_tpu_torch import api
from ebcc_tpu_torch.codec.config import EBCCConfig, ResidualMode
from ebcc_tpu_torch.codec.pipeline import FrameCodec
from ebcc_tpu_torch.ops import dwt
from ebcc_tpu_torch.ops import dwt_sharded as ds
from ebcc_tpu_torch.parallel import mesh as pmesh
from ebcc_tpu_torch.parallel.batch import ShardedCodec, compress_sharded
from ebcc_tpu_torch.parallel.spatial import (SpatialFrameCodec,
                                             SpatialShardedCodec,
                                             _canonical_maps)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVELS = 3
H, W, B = 256, 160, 4   # tests/test_spatial.py's stack
JOIN_S, WAIT_S = 60, 240


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread a process: these tests run many small torch
    ops, which under several test workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(n_data, n_space):
    return pmesh.make_mesh(n_data, n_space, devices=["cpu"] * (n_data *
                                                               n_space))


def _frames(n, h, w, seed=0, noise=0.05):
    y, x = np.mgrid[0:h, 0:w]
    base = (260 + 25 * np.sin(y / h * np.pi) *
            np.cos(x / w * 2 * np.pi)).astype(np.float32)
    rng = np.random.default_rng(seed)
    return np.stack([base + rng.normal(0, noise, (h, w)).astype(np.float32)
                     for _ in range(n)])


def _assert_results_equal(ours, ref):
    """Every field equal (the spatial codec's too)."""
    for f in ref._fields:
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


# ---------------- the halo DWT ----------------


@pytest.fixture(scope="module")
def field():
    return np.random.default_rng(5).normal(0, 1, (2, 128, 64)).astype(
        np.float32)


@pytest.mark.parametrize("n_data,n_space", [(1, 4), (2, 4)],
                         ids=["space4", "2x4"])
def test_sharded_dwt_bit_equal_to_dense(field, n_data, n_space):
    x = torch.from_numpy(field)
    fwd, inv = ds.make_sharded_dwt2d(_cpu_mesh(n_data, n_space), LEVELS)
    per_shard = fwd(x)
    ref = dwt.dwt2d_multi(x, LEVELS)
    out = ds.to_canonical(per_shard, n_space, LEVELS)
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  ref.numpy().view(np.uint32))
    assert torch.equal(ds.from_canonical(out, n_space, LEVELS), per_shard)
    back = inv(per_shard)
    np.testing.assert_array_equal(
        back.numpy().view(np.uint32),
        dwt.idwt2d_multi_ref(ref, LEVELS).numpy().view(np.uint32))
    np.testing.assert_allclose(back.numpy(), field, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n_data,n_space", [(1, 4), (2, 4)],
                         ids=["space4", "2x4"])
def test_sharded_dwt_near_jax(field, n_data, n_space):
    """Within 1e-5 of the largest value of the JAX package's halo DWT on
    conftest's virtual CPU devices (XLA contracts other multiply-adds)."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ebcc_tpu.ops import dwt_sharded as jds

    devs = jax.devices()
    if len(devs) < n_data * n_space:
        pytest.skip(f"needs {n_data * n_space} JAX devices")
    mesh = Mesh(np.asarray(devs[:n_data * n_space]).reshape(n_data,
                                                             n_space),
                axis_names=("data", "space"))
    spec = P("data", "space", None)
    jfwd = jax.jit(jax.shard_map(
        lambda v: jds.dwt2d_multi_sharded(v, LEVELS, "space"), mesh=mesh,
        in_specs=spec, out_specs=spec))
    theirs = np.asarray(jfwd(jax.device_put(field, NamedSharding(mesh,
                                                                 spec))))
    fwd, _ = ds.make_sharded_dwt2d(_cpu_mesh(n_data, n_space), LEVELS)
    ours = fwd(torch.from_numpy(field)).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=1e-5 * np.abs(theirs).max())


def test_row_maps_integer_equal_to_jax():
    from ebcc_tpu.ops import dwt_sharded as jds
    from ebcc_tpu.parallel import spatial as jspatial

    for hp, wp, lv, n in ((768, 1472, 5, 4), (736, 1440, 3, 4),
                          (128, 64, 3, 4), (96, 160, 3, 2)):
        for ours, theirs in zip(_canonical_maps(hp, wp, lv, n),
                                jspatial._canonical_maps(hp, wp, lv, n)):
            assert ours.dtype == theirs.dtype
            np.testing.assert_array_equal(ours, theirs)
        iota = np.arange(2 * hp * wp).reshape(2, hp, wp)
        np.testing.assert_array_equal(
            ds.to_canonical(torch.from_numpy(iota), n, lv).numpy(),
            jds.to_canonical(iota, n, lv))


def test_single_shard_degenerates_to_dense(field):
    x = torch.from_numpy(field)
    fwd, inv = ds.make_sharded_dwt2d(_cpu_mesh(1, 1), LEVELS)
    out = fwd(x)
    assert torch.equal(out, dwt.dwt2d_multi(x, LEVELS))
    assert torch.equal(inv(out), dwt.idwt2d_multi_ref(out, LEVELS))


def test_unshardable_geometry_raises():
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5)
    # 96 padded rows cannot give every one of 8 shards >= 4 rows at the
    # deepest of 5 levels
    with pytest.raises(ValueError, match="cannot shard over 8 devices"):
        SpatialFrameCodec(96, 160, cfg, _cpu_mesh(1, 8))
    with pytest.raises(ValueError, match="cannot form"):
        pmesh.make_mesh(3, 2, devices=["cpu"] * 4)


# ---------------- the sharded codecs ----------------


@pytest.fixture(scope="module")
def stack(era5_frame):
    rng = np.random.default_rng(3)
    base = era5_frame[:H, :W]
    return np.stack([base + rng.normal(0, 0.3, base.shape)
                     for _ in range(B)]).astype(np.float32)


@pytest.fixture(scope="module")
def mesh42():
    return _cpu_mesh(4, 2)


MODES = {"max_error": EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5,
                                 max_batch=B),
         "pointwise": EBCCConfig(mode=ResidualMode.POINTWISE_MAX_ERROR,
                                 max_batch=B)}


def _targets(stack, mode):
    if mode == "max_error":
        return None, torch.full((B,), 0.5)
    eb = np.random.default_rng(9).uniform(0.1, 0.6, stack.shape).astype(
        np.float32)
    return eb, torch.from_numpy(eb)


@pytest.fixture(scope="module")
def dense(stack):
    out = {}
    for mode, cfg in MODES.items():
        _, tgt = _targets(stack, mode)
        out[mode] = FrameCodec(H, W, cfg, "cpu").encode_error_bounded(
            torch.from_numpy(stack), tgt, 1e-6)
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("cls", [ShardedCodec, SpatialShardedCodec])
def test_sharded_codecs_equal_dense_and_native(stack, mesh42, dense, cls,
                                               mode):
    from ebcc_tpu_torch.runtime import cpu_encoder

    cfg = MODES[mode]
    eb, tgt = _targets(stack, mode)
    sc = cls(H, W, cfg, mesh42)
    res = sc.encode_error_bounded(torch.from_numpy(stack), tgt, 1e-6)
    _assert_results_equal(res, dense[mode])
    if mode == "max_error":  # the stack exercises the chunk-mask path
        assert (res.km_q >= 0).any()
    blob = api.compress(stack, cfg, error_bound=eb, codec=sc)
    assert blob == cpu_encoder.compress(stack, cfg, error_bound=eb)


def test_compress_sharded_equals_compress(stack, mesh42):
    cfg = MODES["max_error"]
    assert compress_sharded(stack, cfg, mesh42) == api.compress(
        stack, cfg, device="cpu")


def test_sharded_decode_equals_dense_decode(stack, mesh42, dense):
    """``ShardedCodec.decode`` (the torch packer's structural decode, then
    recon, per data row) equals the dense codec's on the selections'
    streams."""
    from ebcc_tpu_torch.ops import bitplane as bp

    res = dense["max_error"]
    codec = FrameCodec(H, W, MODES["max_error"], "cpu")
    args = []
    for layer, bits in (("base", res.base_bits_q), ("resid",
                                                    res.resid_bits)):
        spec = getattr(codec, layer).spec
        cap = int(bits.max()) // 32 + 1
        words, _, _ = bp.encode_batch(getattr(res, f"{layer}_coef"), bits,
                                      spec, cap)
        args.append((words, bits))
    has_r = ~res.skip_residual
    full = ((args[0][0], args[0][1], res.max_step_b, res.mn, res.mx,
             res.dc_b, has_r, args[1][0], args[1][1], res.max_step_r,
             res.rmin, res.rmax, res.dc_r))
    ours = ShardedCodec(H, W, MODES["max_error"], mesh42).decode(*full)
    np.testing.assert_array_equal(ours.numpy(), codec.decode(*full).numpy())
    assert float((ours - torch.from_numpy(stack)).abs().max()) <= 0.5


def test_compress_codec_refusals(stack, mesh42):
    cfg = MODES["max_error"]
    sc = ShardedCodec(H, W, cfg, mesh42)
    with pytest.raises(ValueError, match="encode_backend='cpu'"):
        api.compress(stack, EBCCConfig(mode=ResidualMode.MAX_ERROR,
                                       error=0.5, encode_backend="cpu"),
                     codec=sc)
    small = stack[:, :24, :24]  # 24x24 supports 3 levels, not 5
    with pytest.raises(ValueError, match="at most 3 DWT levels"):
        api.compress(small, cfg, codec=FrameCodec(24, 24, cfg, "cpu"))
    # without a codec the levels are clamped
    assert api.compress(small, cfg, device="cpu")


def test_init_distributed_standalone(monkeypatch):
    """Without an address the run is standalone; without a card neither
    the default mesh nor a default rank falls to the CPU: the CPU is asked
    for by name."""
    for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    assert pmesh.init_distributed() is False
    assert pmesh.world_size() == 1 and pmesh.rank() == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmesh.init_distributed("localhost:1", 1, 0)
    mesh = pmesh.make_mesh(devices=["cpu"])
    assert mesh.shape == {"data": 1, "space": 1}
    assert mesh.devices == [[torch.device("cpu")]]


# ---------------- two processes ----------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_all(cmds):
    """Run ``cmds`` as process groups, each with its output; kill them all
    if any outlives WAIT_S."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=REPO, start_new_session=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WAIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def test_two_process_gloo_meshes():
    port = _free_port()
    runs = _run_all([[sys.executable, os.path.abspath(__file__), str(i),
                      "2", str(port)] for i in range(2)])
    for i, (rc, out) in enumerate(runs):
        assert rc == 0, f"worker {i} failed:\n{out}"
        assert f"OK rank {i}/2" in out, out


def test_launcher_local_cpu():
    [(rc, out)] = _run_all([[sys.executable, "-m",
                             "ebcc_tpu_torch.scripts.launch_multihost",
                             "--local", "2", "--device", "cpu", "--frames",
                             "4", "--size", "96", "160",
                             "--timeout", str(JOIN_S)]])
    assert rc == 0, out
    lines = [json.loads(s) for s in out.splitlines() if s.startswith("{")]
    assert len(lines) == 1, out
    rec = lines[0]
    assert rec["processes"] == 2 and rec["devices"] == 4
    assert rec["frames"] == 4 and rec["grid_points_per_s"] > 0


def _worker(rank: int, world: int, port: int) -> None:
    """One rank of :func:`test_two_process_gloo_meshes`: 2 ranks x 2
    logical CPU shards."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    assert pmesh.init_distributed(f"localhost:{port}", world, rank,
                                  device="cpu", timeout=JOIN_S)
    try:
        h, w, b = 96, 160, 4
        data = _frames(b, h, w)
        # shallow transforms: 2 row blocks of 48 rows need 48 % 2**L == 0
        # and 48 >> L >= 4
        cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5,
                         max_batch=b, base_levels=3, residual_levels=2)
        tgt = torch.full((b,), 0.5)
        dense = FrameCodec(h, w, cfg, "cpu").encode_error_bounded(
            torch.from_numpy(data), tgt, 1e-6)
        # rank-ordered: the data axis crosses the process boundary
        rows = pmesh.make_mesh(2, 2, devices=["cpu", "cpu"])
        assert [s.rank for s in rows.shards[rank]] == [rank, rank]
        _assert_results_equal(ShardedCodec(h, w, cfg, rows)
                              .encode_error_bounded(torch.from_numpy(data),
                                                    tgt, 1e-6), dense)
        # transposed: each space pair spans the two processes, so every
        # halo row of the DWT crosses it
        cols = pmesh.make_mesh(2, 2, devices=[
            pmesh.Shard(r, torch.device("cpu")) for _ in range(2)
            for r in range(world)])
        assert [s.rank for s in cols.shards[0]] == [0, 1]
        _assert_results_equal(SpatialShardedCodec(h, w, cfg, cols)
                              .encode_error_bounded(torch.from_numpy(data),
                                                    tgt, 1e-6), dense)
        blob = compress_sharded(data, cfg, rows)
        assert blob == api.compress(data, cfg, device="cpu")
        blobs = [None] * world
        dist.all_gather_object(blobs, blob)
        assert all(x == blob for x in blobs)
        print(f"OK rank {rank}/{world}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
