"""The port's CUDA-graph dispatch on the CPU: the capture key, the codec
cache, the static batch, the launch bookkeeping and the cache's lock.

A CUDA graph cannot be captured here, so :class:`_EagerCache` stands in
for the card: its "graph" reruns the stage on the static inputs and writes
into the captured outputs, which :class:`..runtime.graphs.StageGraph`
then copies out as it does after a real replay.  The replays on the card
are held bit-equal to the eager stages in ``tests/test_torch_cuda.py``
and by ``chip_smoke.py``.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import ebcc_tpu_torch
from ebcc_tpu_torch import api
from ebcc_tpu_torch.codec import container
from ebcc_tpu_torch.codec.config import EBCCConfig, ResidualMode
from ebcc_tpu_torch.codec.pipeline import FrameCodec
from ebcc_tpu_torch.runtime import cpu_decoder, cpu_encoder, cuda, graphs

H, W = 32, 48
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    base = (260 + 25 * np.sin(y / H * np.pi) *
            np.cos(x / W * 2 * np.pi)).astype(np.float32)
    return np.stack([base + rng.normal(0, 0.3, base.shape)
                     .astype(np.float32) for _ in range(n)])


class _EagerGraph:
    """A stand-in for a captured CUDA graph: ``replay()`` runs ``fn`` on
    the static inputs and copies its outputs into the captured ones,
    reading the inputs ``pause`` seconds after the call (a window for
    another thread, as a replay enqueued behind other work leaves
    one)."""

    def __init__(self, fn, inputs, outputs, pause=0.0):
        self.fn, self.inputs, self.outputs = fn, inputs, outputs
        self.pause = pause

    def replay(self):
        time.sleep(self.pause)
        _, leaves = graphs.flatten(self.fn(*self.inputs))
        for out, new in zip(self.outputs, leaves):
            out.copy_(new)


class _EagerCache(graphs.GraphCache):
    """:class:`..runtime.graphs.GraphCache` with :class:`_EagerGraph`
    captures, so its keys, LRU and replays run on CPU tensors."""

    pause = 0.0

    def _capture(self, fn, args, device):
        inputs = [graphs._static(a) for a in args]
        out, launches = cuda.count_launches(lambda: fn(*inputs))
        spec, leaves = graphs.flatten(out)
        return graphs.StageGraph(
            _EagerGraph(fn, inputs, leaves, self.pause), inputs, leaves,
            spec, launches)


@pytest.fixture
def staged(monkeypatch):
    """Every FrameCodec stage through an :class:`_EagerCache`."""
    cache = _EagerCache()

    def stage(self, name, fn, *args):
        return cache.run(self._graph_owner, name, fn, args, self.device)

    monkeypatch.setattr(FrameCodec, "_stage", stage)
    return cache


def _inputs(data, target=None):
    u, mn, mx, maxq = api._scale_u16_host(data)
    if target is None:
        target = np.full(len(data), 0.25, np.float32) - maxq
    return (api._upload_u16(u, CPU), torch.from_numpy(mn),
            torch.from_numpy(mx), torch.from_numpy(target))


def test_stage_key_holds_every_tensor_signature_and_refuses_scalars():
    u = torch.zeros((2, H, W), dtype=torch.int32)
    r = torch.zeros(2)
    q = torch.tensor([1e-6])
    key = graphs.stage_key
    assert key("eb", (u, r, q)) == key("eb", (u + 1, r + 1, q + 1))
    assert key("eb", (u, r, q)) != key("eb", (u, r, torch.zeros(2)))
    assert key("eb", (u, r, q)) != key("eb", (u, torch.zeros((2, H, W)), q))
    assert key("eb", (u, r)) != key("eb", (u.long(), r))
    assert key("eb", (u, r)) != key("eb", (u, r.to("meta")))
    assert key("eb", (u, r)) != key("rate", (u, r))
    assert key("rate", (u, None)) != key("rate", (u, r))
    for scalar in (1e-6, 100, (1e-6,), np.float32(1e-6)):
        with pytest.raises(TypeError, match="pass it as a tensor"):
            key("eb", (u, scalar))


def test_codec_stages_take_quantiles_and_budgets_as_inputs(staged):
    """Through the codec's public stages: a key's first call runs eagerly
    and captures nothing, its second captures; another base quantile or
    other budgets replay the same graph (they are tensor inputs) and equal
    their own eager runs; another number of quantiles and a per-point
    target field are other keys."""
    codec = FrameCodec(H, W, EBCCConfig(max_batch=2), CPU)
    u, mn, mx, tgt = _inputs(_data(2))
    field = tgt[:, None, None].expand(2, H, W).contiguous()

    def graphs_of(stage):
        return sorted(e.replays for k, e in
                      staged.entries(codec._graph_owner).items()
                      if k[0] == stage)

    codec.encode_error_bounded_hostq(u, mn, mx, tgt, 1e-6)
    assert graphs_of("eb_multi_hostq") == []
    for q in (1e-6, 2e-2, 0.0):
        res, meta = codec.encode_error_bounded_hostq(u, mn, mx, tgt, q)
        eres, emetas = codec._eb_multi_hostq(u, mn, mx, tgt, (q,))
        assert torch.equal(meta, emetas[0])
        for name in res._fields:
            assert torch.equal(getattr(res, name), getattr(eres[0], name))
    assert graphs_of("eb_multi_hostq") == [3]
    for _ in range(2):
        codec.encode_error_bounded_hostq(u, mn, mx, field, 1e-3)
        codec.encode_error_bounded_multi_hostq(u, mn, mx, tgt, (0.0, 1e-3))
    codec.encode_error_bounded_multi_hostq(u, mn, mx, tgt, (1e-3, 0.0))
    assert graphs_of("eb_multi_hostq") == [1, 2, 3]
    for budgets in ((2000, 0), (2000, 0), (2000, 500), (3000, 500)):
        res, meta = codec.encode_rate_targeted_hostq(u, mn, mx, *budgets)
        eres, emeta = codec._rate_hostq(
            u, mn, mx, codec._stage_input(budgets, torch.int64))
        assert torch.equal(meta, emeta)
        for name in res._fields:
            assert torch.equal(getattr(res, name), getattr(eres, name))
    assert graphs_of("rate_hostq") == [3]


def test_feasibility_rule_is_the_same_for_a_float_and_a_tensor():
    """``_ok`` on a 0-d f32 tensor (a stage input) agrees with the Python
    float it holds, the f32 rounding of the quantile and q = 0 included."""
    from ebcc_tpu_torch.codec.pipeline import _ok
    viol = torch.tensor([0.0, 1e-6, 0.1, 0.1000001, 0.5], dtype=torch.float32)
    maxd = torch.tensor([0.0, -1.0, 0.5, 0.0, 2.0], dtype=torch.float32)
    for q in (0.0, 1e-6, 0.1, 0.5):
        assert torch.equal(_ok(maxd, viol, q), _ok(
            maxd, viol, torch.tensor(q, dtype=torch.float32)))


@pytest.mark.parametrize("pointwise", [False, True],
                         ids=["max_error", "pointwise"])
def test_replay_equals_eager_and_outlives_the_next(staged, pointwise):
    """A replayed stage returns the eager stage's fields, copies that a
    later replay does not overwrite, with tensors shared between the
    multi-q candidates shared in the copy too."""
    codec = FrameCodec(H, W, EBCCConfig(max_batch=2), CPU)
    batches = [_inputs(_data(2, seed=s)) for s in (1, 2)]
    if pointwise:
        rng = np.random.default_rng(3)
        batches = [(u, mn, mx, (t[:, None, None] * torch.from_numpy(
            rng.uniform(0.5, 1.5, (2, H, W)).astype(np.float32))))
            for u, mn, mx, t in batches]
    batches.append(batches[0])
    eager = [codec._eb_multi_hostq(*b, (0.0, 1e-3)) for b in batches]
    # the first call eager, the second a capture and a replay, the third
    # a replay
    outs = [codec.encode_error_bounded_multi_hostq(*b, (0.0, 1e-3))
            for b in batches]
    [entry] = staged.entries(codec._graph_owner).values()
    assert entry.replays == 2
    for (res, metas), (eres, emetas) in zip(outs, eager):
        for r, er, m, em in zip(res, eres, metas, emetas):
            assert torch.equal(m, em)
            for name in r._fields:
                assert torch.equal(getattr(r, name), getattr(er, name)), name
        assert res[0].base_coef is res[1].base_coef
    assert not torch.equal(outs[1][0][0].base_coef, outs[2][0][0].base_coef)


def test_recon_stages_replay_equal_to_eager(staged):
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.25, base_cr=100,
                     max_batch=2)
    blob = ebcc_tpu_torch.compress(_data(2, seed=4), cfg, device="cpu")
    codec = FrameCodec(H, W, api._clamp_levels(cfg, H, W), CPU)
    metas = [container.unpack_frame(f) for f in container.unpack_blob(blob)]
    recon, args = api._device_batch(codec, metas, [0, 1])
    assert recon.__name__ == "recon_packed"
    coef = [torch.from_numpy(np.asarray(a, np.float32)) for a in
            (np.ones((2, codec.base.hp, codec.base.wp)),
             np.ones((2, codec.resid.hp, codec.resid.wp)))]
    rargs = (coef[0], *args[2:6], coef[1], *args[8:])
    for _ in range(3):  # eager, capture and replay, replay
        np.testing.assert_array_equal(recon(*args).numpy(),
                                      codec._recon_packed(*args).numpy())
        np.testing.assert_array_equal(codec.recon(*rargs).numpy(),
                                      codec._recon(*rargs).numpy())
    entries = staged.entries(codec._graph_owner)
    assert {k[0] for k in entries} == {"recon_packed", "recon"}
    assert [e.replays for e in entries.values()] == [2, 2]


def test_codec_cache_normalises_the_backends_and_keys_the_device():
    cfg = EBCCConfig(max_batch=2)
    a = api._codec_for(H, W, cfg, CPU)
    assert api._codec_for(H, W, dataclasses.replace(
        cfg, decode_backend="cpu", encode_backend="device"), CPU) is a
    assert api._codec_for(H, W, dataclasses.replace(cfg, error=0.1),
                          CPU) is not a
    meta = api._codec_for(H, W, cfg, torch.device("meta"))
    assert meta is not a and meta.device.type == "meta"
    assert api._codec_for(H, W, cfg, torch.device("meta")) is meta


@pytest.mark.parametrize("pointwise", [False, True],
                         ids=["max_error", "pointwise"])
def test_static_batch_pads_the_last_batch(monkeypatch, pointwise):
    """20 frames at max_batch=8: three device batches of 8 (the last
    padded on the device by repeating frame 19's inputs, its per-point
    bounds included, after the host stages saw its 4 real frames), the
    same bytes as one unpadded batch of 20 and as the native encoder; the
    decode's last batch is padded the same way after the native decode of
    its real frames and decodes to the native decoder's bits."""
    data = _data(20, seed=5)
    if not pointwise:
        # a constant frame (in POINTWISE mode the native encoder flags one
        # pointwise and the JAX package and the port do not:
        # test_constant_pointwise_frame_flag_differs_from_native)
        data[7] = 3.5
    mode = (ResidualMode.POINTWISE_MAX_ERROR if pointwise
            else ResidualMode.MAX_ERROR)
    cfg = EBCCConfig(mode=mode, error=0.25, base_cr=100, max_batch=8)
    eb = (np.random.default_rng(6).uniform(0.1, 0.4, data.shape)
          .astype(np.float32) if pointwise else None)
    sizes = []
    real_inputs, real_batch = api._batch_inputs, api._device_batch
    real_scale, real_decode = (api._scale_u16_host,
                               api._native.coder_decode_batch_u16)
    monkeypatch.setattr(api, "_batch_inputs", lambda *a: sizes.append(
        ("enc", a[2] - a[1], a[-1])) or real_inputs(*a))
    monkeypatch.setattr(api, "_device_batch", lambda *a: sizes.append(
        ("dec", len(a[2]), a[-1])) or real_batch(*a))
    monkeypatch.setattr(api, "_scale_u16_host", lambda f: sizes.append(
        ("scale", len(f))) or real_scale(f))
    monkeypatch.setattr(api._native, "coder_decode_batch_u16",
                        lambda s, *a: sizes.append(("native", len(s))) or
                        real_decode(s, *a))
    staged = []
    real_stage = FrameCodec._stage
    monkeypatch.setattr(FrameCodec, "_stage", lambda self, name, fn, *a: (
        staged.append((name, len(a[0]))) or real_stage(self, name, fn, *a)))
    blob = ebcc_tpu_torch.compress(data, cfg, error_bound=eb, device="cpu")
    rec = ebcc_tpu_torch.decompress(blob, cfg, device="cpu")
    last = 4 if pointwise else 3
    assert sizes == [("enc", 8, 8), ("scale", 8), ("enc", 8, 8), ("scale", 8),
                     ("enc", 4, 8), ("scale", 4),
                     ("dec", 8, 8), ("native", 8), ("native", 8),
                     ("dec", 8, 8), ("native", 8), ("native", 8),
                     ("dec", last, 8), ("native", last), ("native", last)]
    assert staged == [("eb_multi_hostq", 8)] * 3 + [("recon_packed", 8)] * 3
    one = dataclasses.replace(cfg, max_batch=20)
    assert blob == ebcc_tpu_torch.compress(data, one, error_bound=eb,
                                           device="cpu")
    assert blob == cpu_encoder.compress(data, cfg, error_bound=eb)
    np.testing.assert_array_equal(rec, cpu_decoder.decompress(blob))
    np.testing.assert_array_equal(
        rec, ebcc_tpu_torch.decompress(blob, one, device="cpu"))


def _fake_kernel():
    return cuda.Kernel("fake_graph_kernel", "ebcc_fake", [])


class _NoopGraph:
    def replay(self):
        pass


def test_capture_records_launches_and_replays_add_them():
    """A capture calls the C entries without running them: the counts are
    put back and recorded; every replay adds the recorded launches."""
    k, other = _fake_kernel(), _fake_kernel()
    k.launches, other.launches = 5, 1

    def body():
        k.launches += 3
        other.launches += 0
        return "out"

    out, recorded = cuda.count_launches(body)
    assert out == "out" and recorded == {k: 3}
    assert (k.launches, other.launches) == (5, 1)
    cuda.add_launches(recorded)
    cuda.add_launches(recorded)
    assert (k.launches, other.launches) == (11, 1)

    class Cache(graphs.GraphCache):
        def _capture(self, fn, args, device):
            out, launches = cuda.count_launches(lambda: fn(*args))
            spec, leaves = graphs.flatten(out)
            return graphs.StageGraph(_NoopGraph(), list(args), leaves, spec,
                                     launches)

    def stage(x):
        k.launches += 2
        return (x + 1,)

    cache, x = Cache(), torch.zeros(3)
    k.launches = 0
    for _ in range(4):
        cache.run(0, "s", stage, (x,), CPU)
    # the eager first call 2, the capture none, 3 replays of 2
    assert k.launches == 8


def _stub_cache(maxsize=graphs.MAX_GRAPHS, calls=None):
    """A GraphCache whose captures are no-op graphs, recording each
    capture's argument lengths in ``calls``."""
    class Cache(graphs.GraphCache):
        def _capture(self, fn, args, device):
            if calls is not None:
                calls.append(("capture", len(args[0])))
            return graphs.StageGraph(_NoopGraph(), list(args), [],
                                     (tuple, []), {})
    return Cache(maxsize)


def test_a_key_runs_eagerly_once_then_captures_then_replays():
    """A key's first call runs the stage once and returns its outputs (a
    key used once costs the eager stage, nothing more); the second call
    captures; the later ones only replay."""
    calls = []
    cache = _stub_cache(calls=calls)

    def stage(x):
        calls.append(("eager", len(x)))
        return (x + 1,)

    x = torch.arange(3.0)
    out = cache.run(0, "s", stage, (x,), CPU)
    assert torch.equal(out[0], x + 1) and calls == [("eager", 3)]
    assert cache.entries(0) == {}
    cache.run(0, "s", stage, (x,), CPU)
    cache.run(0, "s", stage, (x,), CPU)
    assert calls == [("eager", 3), ("capture", 3)]
    [entry] = cache.entries(0).values()
    assert entry.replays == 2


def test_graph_cache_is_a_bounded_lru():
    cache = _stub_cache(maxsize=2)

    def run(owner, n):
        for _ in range(2):  # the key's first call is eager
            cache.run(owner, "s", lambda *a: (), (torch.zeros(n),), CPU)
        return [k[1][1][0][0][0] for k in cache.graphs]

    assert run(0, 1) == [1]
    assert run(0, 2) == [1, 2]
    assert run(0, 1) == [2, 1]  # a hit is the most recent
    assert run(0, 3) == [1, 3]  # the least recent leaves
    cache.drop_owner(0)
    assert run(1, 4) == [4]  # a dropped owner's graphs leave
    assert all(k[0] == 1 for k in cache._seen)


def test_threads_on_one_key_each_get_their_own_result(staged):
    """Threads that call one key at once (a numcodecs filter under dask)
    each get the result of their own inputs: the cache holds its lock from
    the copy-in to the clones, so no thread's copy-in lands between
    another's copy-in and replay (the stand-in's replay pauses between
    reading its inputs and writing its outputs to open that window)."""
    staged.pause = 0.02
    owner = 0

    def stage(x):
        return (x * 2,)

    for _ in range(2):  # the eager first call, then the capture
        staged.run(owner, "s", stage, (torch.zeros(4),), CPU)
    results, errors = {}, []
    start = threading.Barrier(4)

    def worker(i):
        try:
            start.wait()
            for r in range(3):
                x = torch.full((4,), float(10 * i + r))
                out = staged.run(owner, "s", stage, (x,), CPU)
                results[(i, r)] = torch.equal(out[0], x * 2)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(results) == 12 and all(results.values())
    [entry] = staged.entries(owner).values()
    assert entry.replays == 13


def test_constant_pointwise_frame_flag_differs_from_native():
    """ROADMAP C4, reproduced: in POINTWISE_MAX_ERROR the native encoder
    sets FLAG_POINTWISE on a constant frame and the port does not (nor
    the JAX package).  Every other byte of the container is equal and the
    frame decodes to its constant either way.  When the format question
    is settled and one side changes, this test changes with it."""
    data = _data(4, seed=7)
    data[2] = 3.5
    eb = (np.random.default_rng(6).uniform(0.1, 0.4, data.shape)
          .astype(np.float32))
    cfg = EBCCConfig(mode=ResidualMode.POINTWISE_MAX_ERROR, error=0.25,
                     base_cr=100, max_batch=4)
    ours = container.unpack_blob(ebcc_tpu_torch.compress(
        data, cfg, error_bound=eb, device="cpu"))
    native = container.unpack_blob(cpu_encoder.compress(data, cfg,
                                                        error_bound=eb))
    assert len(ours) == len(native) == 4
    for k, (a, b) in enumerate(zip(ours, native)):
        fa, fb = (container.unpack_frame(f)[0].flags for f in (a, b))
        if k != 2:
            assert a == b, k
            continue
        assert fa & container.FLAG_CONST and fb & container.FLAG_CONST
        assert fb == fa | container.FLAG_POINTWISE != fa
        assert len(a) == len(b) and sum(x != y for x, y in zip(a, b)) == 1
    for blob in (container.pack_blob(ours), container.pack_blob(native)):
        np.testing.assert_array_equal(
            cpu_decoder.decompress(blob)[2], np.full((H, W), 3.5, np.float32))


def test_a_device_without_graphs_starts_a_new_pool(monkeypatch):
    """The allocator releases a pool with its last graph and takes no
    capture into it after that, so the cache starts another pool once a
    device's graphs are all gone, and shares one pool while any lives."""
    pools = iter(range(100))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: next(pools))
    used = []

    def capture(fn, args, device, pool):
        used.append(pool)
        return graphs.StageGraph(_NoopGraph(), list(args), [], (tuple, []),
                                 {}, device=device)

    monkeypatch.setattr(graphs, "capture", capture)
    cache = graphs.GraphCache(maxsize=2)

    def run(owner, n):
        for _ in range(2):  # the key's first call is eager
            cache.run(owner, "s", lambda *a: (), (torch.zeros(n),), CPU)

    for owner, n in ((0, 1), (0, 2), (1, 3)):
        run(owner, n)
    cache.drop_owner(0)
    run(2, 4)  # owner 1's graph still lives
    cache.drop_owner(1)
    cache.drop_owner(2)
    run(3, 5)
    assert used == [0, 0, 0, 0, 1]
