"""POINTWISE_MAX_ERROR's per-point search targets on the codec's device,
on the CPU.

``api._device_targets`` (the torch ops the card runs, here on CPU tensors)
against the host route ``api.pointwise_targets`` less the u16
quantisation error, bit for bit: ratios 1.0 and 2.0, bounds under two u16
quanta (the half-bound floor), a constant frame (slack 0) and a short
last batch padded to the static size.  The containers of
``api.compress`` / ``compress_multi_q`` through that route against the
native encoder's, and the ``compress.targets`` / ``compress.select``
spans.  The card's run of a t2m day:
``tests/test_torch_cuda.py::test_cuda_t2m_day_pointwise``.
"""

import collections
import dataclasses
import time

import numpy as np
import pytest
import torch

from ebcc_tpu_torch import api
from ebcc_tpu_torch.codec import container
from ebcc_tpu_torch.codec.config import EBCCConfig, ResidualMode
from ebcc_tpu_torch.runtime import cpu_encoder
from ebcc_tpu_torch.utils import profiling

CPU = torch.device("cpu")
H, W = 65, 128
CFG = EBCCConfig(mode=ResidualMode.POINTWISE_MAX_ERROR, base_cr=100,
                 max_batch=3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stack(n, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    base = 260 + 25 * np.sin(y / H * np.pi) * np.cos(x / W * 2 * np.pi)
    return np.stack([base + rng.normal(0, 0.3 + 0.2 * k, base.shape)
                     for k in range(n)]).astype(np.float32)


def _bound(shape, seed, lo=0.05, hi=0.4):
    rng = np.random.default_rng(seed)
    return (lo + (hi - lo) * rng.random(shape)).astype(np.float32)


def _host_targets(frames, eb, ratio):
    _, _, _, maxq = api._scale_u16_host(frames)
    return api.pointwise_targets(frames, eb, ratio) - maxq[:, None, None]


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("ratio", [1.0, 2.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_targets_bit_equal_to_host(ratio, seed):
    frames = _stack(4, seed)
    frames[3] = np.float32(271.25)  # constant: slack 0
    eb = _bound(frames.shape, seed + 10)
    # under two u16 quanta of the frame's range: the half-bound floor
    quantum = (frames[0].max() - frames[0].min()) / 65535
    eb[0, :8] = np.float32(quantum * 0.7)
    eb[1, :, :16] = np.float32(quantum * 1.9)
    u, mn, mx, maxq = api._scale_u16_host(frames)
    got = api._device_targets(*(torch.from_numpy(a) for a in (eb, mn, mx,
                                                              maxq)), ratio)
    want = _host_targets(frames, eb, ratio)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the floor did bind where the bound is under two quanta
    t = eb[0, :8] * np.float32(ratio)
    np.testing.assert_array_equal(
        _bits(got.numpy()[0, :8]), _bits(t * np.float32(0.5) - maxq[0]))


def test_batch_inputs_targets_padded_to_the_static_batch():
    """The last batch of 2 frames at a static size of 3: its rows are the
    host's targets of its own frames, and the padded row repeats the last
    frame's (its bound and its scale)."""
    frames = _stack(5, 3)
    eb = _bound(frames.shape, 4)
    want = _host_targets(frames[3:], eb[3:], CFG.pointwise_max_error_ratio)
    bound = api._pointwise_bound(frames, CFG, eb)
    u, mn, mx, tgt = api._batch_inputs(frames, 3, 5, CFG, bound, CPU, 3)
    assert tgt.shape == (3, H, W) and len(u) == len(mn) == 3
    np.testing.assert_array_equal(_bits(tgt[:2].numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(tgt[2].numpy()), _bits(want[1]))
    assert mn[2] == mn[1] and mx[2] == mx[1]


def test_pointwise_bound_keeps_the_callers_float32_field():
    frames = _stack(2, 5)
    eb = _bound(frames.shape, 6)
    assert api._pointwise_bound(frames, CFG, eb) is not None
    assert np.shares_memory(api._pointwise_bound(frames, CFG, eb), eb)
    assert api._pointwise_bound(frames, EBCCConfig(), eb) is None
    with pytest.raises(ValueError):
        api._pointwise_bound(frames, CFG, None)


@pytest.fixture(scope="module")
def day():
    """Seven frames (batches of 3: a short last one), the fourth constant,
    under a bound partly below two quanta."""
    frames = _stack(7, 7)
    frames[3] = np.float32(250.5)
    eb = _bound(frames.shape, 8)
    eb[1, :4] = np.float32(1e-6)
    return frames, eb


def _frames_equal_but_const(ours, native, const=(3,)):
    """Frame by frame equal; a constant frame differs in FLAG_POINTWISE
    alone (the native encoder sets it, the port does not:
    ``tests/test_torch_graphs.py``)."""
    a, b = container.unpack_blob(ours), container.unpack_blob(native)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        if i in const:
            assert container.unpack_frame(x)[0].flags & \
                container.FLAG_CONST
        else:
            assert x == y, i


def test_compress_containers_equal_the_native_encoders(day):
    frames, eb = day
    ours = api.compress(frames, CFG, error_bound=eb, device="cpu")
    _frames_equal_but_const(ours, cpu_encoder.compress(frames, CFG,
                                                       error_bound=eb))
    # the same stack without its constant frame: every byte
    keep = [0, 1, 2, 4, 5, 6]
    assert api.compress(frames[keep], CFG, error_bound=eb[keep],
                        device="cpu") == \
        cpu_encoder.compress(frames[keep], CFG, error_bound=eb[keep])


def test_compress_multi_q_containers_equal_the_native_encoders(day):
    frames, eb = day
    keep = [0, 1, 2, 4, 5]
    qs = (0.0, 1e-4)
    blobs = api.compress_multi_q(frames[keep], qs, CFG, error_bound=eb[keep],
                                 device="cpu")
    assert blobs == [cpu_encoder.compress(frames[keep], CFG,
                                          error_bound=eb[keep], qbase=q)
                     for q in qs]


def _spans_of(run):
    t0 = time.perf_counter()
    out = run()
    recs = [r for r in profiling.records() if r.start >= t0]
    by = collections.defaultdict(list)
    for r in recs:
        by[r.name].append(r)
    return out, by


def _resid_frames(blob):
    return sum(bool(container.unpack_frame(f)[0].flags & container.FLAG_RESID)
               for f in container.unpack_blob(blob))


def test_targets_and_select_spans_of_a_pointwise_compress(day):
    frames, eb = day
    blob, by = _spans_of(lambda: api.compress(frames, CFG, error_bound=eb,
                                              device="cpu"))
    targets = by["compress.targets"]
    assert [r.attrs for r in targets] == [
        {"frames": 3, "where": "host"}, {"frames": 3, "where": "host"},
        {"frames": 1, "where": "host"}]
    (call,) = by["compress"]
    assert all(r.request == call.request for r in targets)
    sel = by["compress.select"]
    assert [r.attrs["frames"] for r in sel] == [3, 3, 1]
    for r in sel:
        assert r.attrs.keys() == {"frames", "resid_kept", *api.SELECTIONS}
        assert sum(r.attrs[k] for k in api.SELECTIONS) == r.attrs["frames"]
    assert sum(r.attrs["const"] for r in sel) == 1
    assert sum(r.attrs["resid_kept"] for r in sel) == _resid_frames(blob)
    drains = {r.id for r in by["compress.drain"]}
    assert all(r.parent in drains for r in sel)


def test_select_counts_every_candidate_and_the_native_route_host_targets(day):
    frames, eb = day
    qs = (0.0, 1e-4, 1e-3)
    _, by = _spans_of(lambda: api.compress_multi_q(
        frames[:3], qs, CFG, error_bound=eb[:3], device="cpu"))
    (sel,) = by["compress.select"]
    assert sel.attrs["frames"] == 9
    assert sum(sel.attrs[k] for k in api.SELECTIONS) == 9
    native = dataclasses.replace(CFG, encode_backend="cpu")
    _, by = _spans_of(lambda: api.compress(frames[:2], native,
                                           error_bound=eb[:2], device="cpu"))
    assert [r.attrs for r in by["compress.targets"]] == [
        {"where": "host", "frames": 2}]
    assert not by["compress.select"]


@pytest.mark.parametrize("fallback", ["on", "off"])
def test_max_error_compress_records_select_and_no_targets(fallback,
                                                          monkeypatch):
    """MAX_ERROR at a 1 % base quantile, where every frame keeps a
    residual layer: with the pure fallback on each frame is compared;
    off, each holds the combined variant alone.  ``resid_kept`` counts
    the containers with a residual layer."""
    if fallback == "off":
        monkeypatch.setenv("EBCC_DISABLE_PURE_JP2_FALLBACK", "1")
    frames = _stack(4, 9)
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.05, max_batch=2)
    blob, by = _spans_of(lambda: api.compress(frames, cfg, device="cpu",
                                              qbase=1e-2))
    assert not by["compress.targets"]
    sel = by["compress.select"]
    assert [r.attrs["frames"] for r in sel] == [2, 2]
    for r in sel:
        assert sum(r.attrs[k] for k in api.SELECTIONS) == 2
    assert sum(r.attrs["resid_kept"] for r in sel) == \
        _resid_frames(blob) == 4
    way = "combined" if fallback == "off" else "pure_compared"
    assert sum(r.attrs[way] for r in sel) == 4


@pytest.mark.parametrize("dtype", [np.int16, np.float32, np.float64])
def test_upload_pinned_gives_a_copy_of_its_own(dtype):
    rows = np.arange(24, dtype=dtype).reshape(2, 3, 4)[:, 1:]
    t = api._upload_pinned(rows, CPU)
    assert t.dtype == torch.from_numpy(rows[:0]).dtype
    np.testing.assert_array_equal(t.numpy(), rows)
    assert not np.shares_memory(t.numpy(), rows)


def test_base_streams_through_zstd_in_one_native_call_a_batch(day,
                                                              monkeypatch):
    """Each batch's base streams, every variant a container is chosen
    from, go through one native zstd call (at the base level, 10); a
    constant frame sends none, a compared frame two.  The containers
    stay the native encoder's
    (``test_compress_containers_equal_the_native_encoders``)."""
    frames, eb = day
    calls, real = [], api._native.zstd_compress_batch

    def record(bufs, level):
        calls.append((level, len(bufs)))
        return real(bufs, level)

    monkeypatch.setattr(api._native, "zstd_compress_batch", record)
    _, by = _spans_of(lambda: api.compress(frames, CFG, error_bound=eb,
                                           device="cpu"))
    base = [k for level, k in calls if level == min(CFG.zstd_level, 10)]
    sel = by["compress.select"]
    assert len(base) == len(sel) == 3
    for k, r in zip(base, sel):
        a = r.attrs
        assert k == a["frames"] - a["const"] + a["pure_compared"]
