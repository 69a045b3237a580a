"""The device-to-host transfer and the batch pipelining of
``ebcc_tpu_torch`` on the CPU, against the JAX package and the native codec.

* the packed metadata: ``_unpack_meta(_pack_meta(res))`` is every small
  field of ``res``, and after ``_decide_pure`` equals the JAX package's
  ``_unpack_meta`` dict on the same frames, field for field (the fields
  both packages have);
* the containers the host's native coder packs equal those the codec's
  device packer route gives (``FrameCodec.packs_streams``, here the plain
  torch packer) and the native encoder's, on encodes that keep a base
  layer alone, residual layers and several quantiles; and ``compress`` /
  ``decompress`` give the same bytes and frames at ``prefetch_batches``
  0, 1 and 2;
* the sharded codecs' containers stay the dense ones.

Every comparison is exact.  One intra-op thread for the module (small
torch ops; see SKILL.md).
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import ebcc_tpu
import ebcc_tpu.api as jax_api
import ebcc_tpu_torch
from ebcc_tpu.codec.pipeline import FrameCodec as JaxCodec
from ebcc_tpu_torch import EBCCConfig, ResidualMode, api
from ebcc_tpu_torch.codec.pipeline import FrameCodec
from ebcc_tpu_torch.parallel import mesh as pmesh
from ebcc_tpu_torch.parallel.batch import ShardedCodec, compress_sharded
from ebcc_tpu_torch.parallel.spatial import SpatialShardedCodec
from ebcc_tpu_torch.runtime import cpu_encoder
from ebcc_tpu_torch.scripts import common
from ebcc_tpu_torch.utils import profiling

H, W = 96, 160
QS = (1e-6, 1e-3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(**kw):
    """The same configuration for the port and the JAX package."""
    kw = dict(mode=ResidualMode.MAX_ERROR, error=0.5, base_cr=100,
              max_batch=2, **kw)
    return EBCCConfig(**kw), ebcc_tpu.EBCCConfig(**kw)


@pytest.fixture(scope="module")
def frames():
    return common.bench_frames(2, H, W)


def _smooth(seed, h=128, w=256):
    y, x = np.mgrid[0:h, 0:w]
    return (260 + 25 * np.sin(y / h * np.pi) *
            np.cos(x / w * 2 * np.pi)).astype(np.float32)


@pytest.fixture(scope="module")
def noisy():
    """``tests/test_sparse_transfer.py``'s noisy fixture: a smooth field
    with 40 spikes a frame."""
    base = _smooth(0)
    rng = np.random.default_rng(7)
    out = np.stack([base, base * 1.001]).astype(np.float32)
    for b in range(2):
        ys = rng.integers(0, 128, 40)
        xs = rng.integers(0, 256, 40)
        out[b, ys, xs] += rng.choice([-2.0, 2.0], 40).astype(np.float32)
    return out


def _hostq(frames, cfg):
    """One batch's host-quantised inputs: (port tensors, JAX arrays)."""
    u, mn, mx, maxq = api._scale_u16_host(frames)
    tgt = np.float32(cfg.error) - maxq
    return ((api._upload_u16(u, "cpu"), torch.from_numpy(mn),
             torch.from_numpy(mx), torch.from_numpy(tgt)),
            (u, mn, mx, tgt))


@pytest.fixture(scope="module")
def encodes(frames):
    """The error-bounded encode of the same two frames by both packages:
    {"error_bounded": ([port (res, meta)], [JAX (res, meta)])}."""
    cfg, jcfg = _configs()
    ours, theirs = FrameCodec(H, W, cfg, "cpu"), JaxCodec(H, W, jcfg)
    t_in, j_in = _hostq(frames, cfg)
    return {"error_bounded": (
        [ours.encode_error_bounded_hostq(*t_in, 1e-6)],
        [theirs.encode_error_bounded_hostq(*j_in, 1e-6)])}


# ---------------- the small fields and the flags ----------------

# the small fields the port holds equal to the JAX package's on these
# frames: the base layer's selections and masks, and the decision
JAX_EQUAL = (
    "mn", "mx", "const", "dc_b", "max_step_b", "base_bits_q",
    "base_bits_pure", "base_feasible_pure", "bs_q", "ks_q", "bs_pure",
    "ks_pure", "km_q", "km_pure", "mbits_q", "mbits_pure", "segs_q",
    "segs_pure", "skip_residual", "decided_pure")


def test_packed_metadata_round_trips_and_equals_jax(encodes):
    (res, meta), = encodes["error_bounded"][0]
    (jres, jmeta), = encodes["error_bounded"][1]
    cfg, _ = _configs()
    got = api._unpack_meta(meta.numpy(), cfg.nchunks)
    small = [f for f in res._fields if f not in
             ebcc_tpu_torch.codec.pipeline.DEFERRED_FIELDS]
    assert list(got) == small
    for name in small:
        v = getattr(res, name).numpy()
        assert got[name].dtype == (v.dtype if v.dtype in (np.float32, bool)
                                   else np.int32), name
        np.testing.assert_array_equal(got[name], v, name)
    got["decided_pure"] = api._decide_pure(got, cfg.mode)
    theirs = jax_api._unpack_meta(jmeta, cfg.nchunks)
    theirs["decided_pure"] = jax_api._decide_pure(theirs, cfg.mode)
    # the JAX package's also carries its transfer forms' flags
    assert set(got) <= set(theirs)
    for name in JAX_EQUAL:
        np.testing.assert_array_equal(got[name], theirs[name], name)


# ---------------- the containers ----------------


def _packed_where(run):
    """``run()`` and the (layer, where) of every ``coder.pack`` span it
    records."""
    since = time.perf_counter()
    out = run()
    return out, {(r.attrs["layer"], r.attrs["where"])
                 for r in profiling.records()
                 if r.name == "coder.pack" and r.start >= since}


@pytest.mark.parametrize("case", ["sparse_base", "u16_base_sparse_resid",
                                  "int32_base_u8_resid", "multi_q"])
def test_blobs_equal_forced_int32_and_native(case, noisy, monkeypatch):
    """Encodes whose coefficient planes the JAX package's transfer forms
    took by each rung of their ladder (a sparse base, a u16 base with a
    sparse residual, an int32 base with a u8 residual, multi-q): the
    containers of the host's native coder on the int32 planes equal those
    of the codec's device packer route and the native encoder's."""
    if case in ("sparse_base", "multi_q"):
        data, qbase = _smooth(0)[None].repeat(2, 0), 1e-6
        data = data + np.random.default_rng(3).normal(
            0, 0.02, data.shape).astype(np.float32)
        cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=2.0,
                         base_cr=100, max_batch=2)
        layers = {"base", "resid"} if case == "multi_q" else {"base"}
    else:
        # the residual layer carries the spikes: no pure fallback
        monkeypatch.setenv("EBCC_DISABLE_PURE_JP2_FALLBACK", "1")
        data = noisy
        qbase, error = ((1e-2, 0.25) if case == "u16_base_sparse_resid"
                        else (0.02, 0.1))
        cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=error,
                         base_cr=150, max_batch=2)
        layers = {"base", "resid"}

    def run(codec=None):
        if case == "multi_q":
            return ebcc_tpu_torch.compress_multi_q(data, QS, cfg,
                                                   device="cpu")
        return [ebcc_tpu_torch.compress(data, cfg, device="cpu",
                                        qbase=qbase, codec=codec)]

    blobs, packed = _packed_where(run)
    assert packed == {(layer, "host") for layer in layers}
    for q, blob in zip(QS if case == "multi_q" else (qbase,), blobs):
        assert blob == cpu_encoder.compress(data, cfg, qbase=q)
    if case != "multi_q":
        codec = FrameCodec(*data.shape[1:], cfg, "cpu")
        codec.packs_streams = True
        got, packed = _packed_where(lambda: run(codec))
        assert got == blobs
        assert packed == {(layer, "card") for layer in layers}
    rec = ebcc_tpu_torch.decompress(blobs[0], device="cpu")
    assert np.abs(rec - data).max() <= cfg.error


@pytest.fixture(scope="module")
def five():
    """5 frames in batches of 2 (a partial last batch): the blob, equal to
    the native encoder's, and its frames."""
    cfg, _ = _configs()
    data = common.bench_frames(5, H, W, seed=4)
    blob = ebcc_tpu_torch.compress(data, cfg, device="cpu")
    assert blob == cpu_encoder.compress(data, cfg)
    return cfg, data, blob, ebcc_tpu_torch.decompress(blob, device="cpu")


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_prefetch_batches_give_the_same_bytes_and_frames(five, prefetch):
    cfg, data, blob, rec = five
    pcfg = dataclasses.replace(cfg, prefetch_batches=prefetch)
    assert ebcc_tpu_torch.compress(data, pcfg, device="cpu") == blob
    np.testing.assert_array_equal(
        ebcc_tpu_torch.decompress(blob, pcfg, device="cpu").view(np.uint32),
        rec.view(np.uint32))
    assert ebcc_tpu_torch.compress_multi_q(data, QS[:1], pcfg,
                                           device="cpu") == [blob]


def test_sharded_blobs_unchanged_and_spatial_never_sparse(frames):
    """The sharded codecs' containers are the dense codec's, through the
    host's coder and through the codecs' packer route (each row's arenas
    gathered in frame order).  No layer crosses as coefficients, sparse
    or dense, on any codec of the card route."""
    # shallow transforms: 2 row blocks of 48 rows need 48 % 2**L == 0
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=1.0, max_batch=2,
                     base_levels=3, residual_levels=2)
    dense = ebcc_tpu_torch.compress(frames, cfg, device="cpu")
    assert dense == cpu_encoder.compress(frames, cfg)
    mesh = pmesh.make_mesh(2, 1, devices=["cpu"] * 2)
    assert compress_sharded(frames, cfg, mesh) == dense
    for packs in (False, True):
        for sc in (ShardedCodec(H, W, cfg, mesh), SpatialShardedCodec(
                H, W, cfg, pmesh.make_mesh(1, 2, devices=["cpu"] * 2))):
            for row in sc.codecs.values():
                row.packs_streams = packs
            got, packed = _packed_where(lambda: ebcc_tpu_torch.compress(
                frames, cfg, codec=sc))
            assert got == dense
            assert {w for _, w in packed} == {"card" if packs else "host"}
