"""The port's rate-targeted modes, multi-quantile encode and union chunk
mask on the CPU, against the JAX package and the native CPU codec.

* NONE: containers byte-identical to ``ebcc_tpu.compress`` and to the
  native encoder; SPARSIFICATION_FACTOR: byte-identical to the native
  encoder, with the base and residual selections of the JAX package;
* the rate pick (the last candidate within the budget) agrees with both
  formulations, on a budget that falls inside a plane;
* ``mask_search="union"``: byte-identical to the native encoder's union
  rule (``mask_rule`` 2), the bound held; the rule's single-drop fallback
  on a scripted evaluator;
* ``compress_multi_q``: every blob equals the port's ``compress`` at that
  quantile, the native encoder's, and the JAX package's
  ``compress_multi_q`` where no frame keeps a residual.
"""

import dataclasses

import numpy as np
import pytest
import torch

import ebcc_tpu
from ebcc_tpu.codec.pipeline import FrameCodec as JaxCodec

import ebcc_tpu_torch
from ebcc_tpu_torch import api
from ebcc_tpu_torch.codec import container
from ebcc_tpu_torch.codec.config import EBCCConfig, ResidualMode
from ebcc_tpu_torch.codec.pipeline import FrameCodec
from ebcc_tpu_torch.ops import bitplane as bp
from ebcc_tpu_torch.runtime import cpu_decoder, cpu_encoder

B, H, W = 2, 96, 160
# tests/test_torch_codec.py's JAX config (the same compiled programs)
JAX_CFG = ebcc_tpu.EBCCConfig(
    mode=ebcc_tpu.ResidualMode.MAX_ERROR, error=0.25, base_cr=200,
    max_batch=B, use_pallas_eval=False, encode_backend="device",
    decode_backend="device")
# base_cr 45 puts both frames' base budget inside a plane (fine index 3
# and 2 of 16), not on a plane's end
RATE_CR = 45.0


def _data(n=B, seed=0, noise=0.3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    base = (260 + 25 * np.sin(y / H * np.pi) *
            np.cos(x / W * 2 * np.pi)).astype(np.float32)
    return np.stack([base + rng.normal(0, noise, base.shape)
                     .astype(np.float32) for _ in range(n)])


def _configs(**kw):
    jcfg = dataclasses.replace(JAX_CFG, **kw)
    return EBCCConfig(**dataclasses.asdict(jcfg)), jcfg


def _headers(blob):
    return [container.unpack_frame(f)[0] for f in container.unpack_blob(blob)]


def _rate_configs(mode):
    return _configs(mode=ebcc_tpu.ResidualMode(int(mode)), base_cr=RATE_CR,
                    residual_cr=10.0)


def test_none_byte_identical_to_jax_and_native():
    data = _data()
    cfg, jcfg = _rate_configs(ResidualMode.NONE)
    blob = ebcc_tpu_torch.compress(data, cfg, device="cpu")
    assert blob == ebcc_tpu.compress(data, jcfg)
    assert blob == cpu_encoder.compress(data, cfg)
    assert not any(h.flags & container.FLAG_RESID for h in _headers(blob))
    rec = ebcc_tpu_torch.decompress(blob, device="cpu")
    np.testing.assert_array_equal(rec, cpu_decoder.decompress(blob))
    assert rec.shape == data.shape and np.isfinite(rec).all()


def _selections(codec, data, budgets, jax_codec=False):
    """The rate encode's selections of one batch: {field: int array}."""
    u, mn, mx, _ = api._scale_u16_host(data)
    if jax_codec:
        res, _ = codec.encode_rate_targeted_hostq(
            u, mn, mx, *(np.full(len(data), b, np.int32) for b in budgets))
    else:
        res, _ = codec.encode_rate_targeted_hostq(
            api._upload_u16(u, "cpu"), torch.from_numpy(mn),
            torch.from_numpy(mx), *budgets)
    return {f: np.asarray(getattr(res, f)).astype(np.int64)
            for f in ("bs_q", "ks_q", "base_bits_q", "bs_r", "ks_r",
                      "resid_bits", "mbits_r")}


def test_sparsification_byte_identical_to_native_selections_of_jax():
    """SPARSIFICATION_FACTOR keeps a rate-budgeted residual layer in every
    frame.  The port equals the native encoder byte for byte, and its base
    and residual selections are the JAX package's.  (Standing fact: JAX's
    residual stream can differ from native's where XLA fuses the base
    reconstruction with other fma choices; the port follows native.)"""
    data = _data()
    cfg, jcfg = _rate_configs(ResidualMode.SPARSIFICATION_FACTOR)
    blob = ebcc_tpu_torch.compress(data, cfg, device="cpu")
    assert blob == cpu_encoder.compress(data, cfg)
    assert all(h.flags & container.FLAG_RESID for h in _headers(blob))
    rec = ebcc_tpu_torch.decompress(blob, device="cpu")
    np.testing.assert_array_equal(rec, cpu_decoder.decompress(blob))
    budgets = (int(32 * H * W / RATE_CR), int(8 * H * W / 10.0))
    ours = _selections(FrameCodec(H, W, cfg, "cpu"), data, budgets)
    theirs = _selections(JaxCodec(H, W, jcfg), data, budgets, True)
    for field, value in ours.items():
        np.testing.assert_array_equal(value, theirs[field], err_msg=field)
    assert (ours["mbits_r"] > 0).all()
    assert rec.shape == data.shape and np.isfinite(rec).all()


@pytest.mark.parametrize("entry", ["hostq", "f32"])
def test_rate_budgets_by_keyword_in_both_packages(entry):
    """Both packages' ``FrameCodec.encode_rate_targeted(_hostq)`` name the
    budgets ``base_budget_bits`` / ``resid_budget_bits``: the same keyword
    call gives the same selections in each."""
    data = _data()
    cfg, jcfg = _rate_configs(ResidualMode.SPARSIFICATION_FACTOR)
    budgets = dict(base_budget_bits=int(32 * H * W / RATE_CR),
                   resid_budget_bits=int(8 * H * W / 10.0))
    jbudgets = {k: np.full(len(data), v, np.int32) for k, v in
                budgets.items()}
    ours, theirs = FrameCodec(H, W, cfg, "cpu"), JaxCodec(H, W, jcfg)
    if entry == "hostq":
        u, mn, mx, _ = api._scale_u16_host(data)
        res, _ = ours.encode_rate_targeted_hostq(
            api._upload_u16(u, "cpu"), torch.from_numpy(mn),
            torch.from_numpy(mx), **budgets)
        jres, _ = theirs.encode_rate_targeted_hostq(u, mn, mx, **jbudgets)
    else:
        res = ours.encode_rate_targeted(torch.from_numpy(data), **budgets)
        jres = theirs.encode_rate_targeted(data, **jbudgets)
    for f in ("bs_q", "ks_q", "base_bits_q", "bs_r", "ks_r", "resid_bits"):
        np.testing.assert_array_equal(
            np.asarray(getattr(res, f)).astype(np.int64),
            np.asarray(getattr(jres, f)).astype(np.int64), err_msg=f)


def test_rate_pick_agrees_with_both_formulations():
    """The JAX package takes the number of candidates within the budget,
    less one; the native encoder stops at the first candidate over it.
    They agree while candidate bits never decrease in stream order, which
    the table shows; the port's pick is that candidate, and the frame's
    header carries its bits."""
    data = _data()
    cfg = EBCCConfig(mode=ResidualMode.NONE, base_cr=RATE_CR, max_batch=B)
    codec = FrameCodec(H, W, cfg, "cpu")
    u, mn, mx, _ = api._scale_u16_host(data)
    _, _, _, ci = codec._hostq_prelude(api._upload_u16(u, "cpu"),
                                       torch.from_numpy(mn),
                                       torch.from_numpy(mx))
    an = bp.analyze(ci, codec.base.spec)
    counts = bp.segment_counts(an, codec.base.spec)
    cand = bp.candidate_bits(counts, codec.base.spec).flatten(1).numpy()
    assert (np.diff(cand, axis=-1) >= 0).all()
    budget = int(32 * H * W / RATE_CR)
    by_count = (cand <= budget).sum(-1) - 1
    by_scan = np.array([next(i for i, c in enumerate(row) if c > budget) - 1
                        for row in cand])
    np.testing.assert_array_equal(by_count, by_scan)
    nk = 2 * cfg.nchunks
    assert (by_count % nk != nk - 1).all()  # inside a plane
    bits, bs, ks = codec._rate_pick(codec.base, counts, budget)
    np.testing.assert_array_equal(bs.numpy(),
                                  cfg.base_nplanes - 1 - by_count // nk)
    np.testing.assert_array_equal(ks.numpy(), by_count % nk)
    np.testing.assert_array_equal(bits.numpy(), cand[[0, 1], by_count])
    hdrs = _headers(ebcc_tpu_torch.compress(data, cfg, device="cpu"))
    assert [h.base_nbits for h in hdrs] == bits.tolist()


# pure-base fallback off and a base quantile, so frames keep a residual
# and both layers search masks; (error, quantile) pairs whose frames take
# a union of drops and a single-drop fallback between them
UNION_CASES = [(0.5, 1e-3), (0.25, 1e-2), (0.5, 0.0)]


@pytest.mark.parametrize("err,q", UNION_CASES, ids=str)
def test_union_mask_byte_identical_to_native(monkeypatch, err, q):
    monkeypatch.setenv("EBCC_DISABLE_PURE_JP2_FALLBACK", "1")
    data = _data(3, seed=1, noise=0.05)
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=err, base_cr=100,
                     max_batch=2, mask_search="union")
    blob = ebcc_tpu_torch.compress(data, cfg, device="cpu", qbase=q)
    assert blob == cpu_encoder.compress(data, cfg, qbase=q)
    hdrs = _headers(blob)
    assert any(h.base_mask_plane != container.MASK_NONE or
               h.resid_mask_plane != container.MASK_NONE for h in hdrs)
    for rec in (ebcc_tpu_torch.decompress(blob, device="cpu"),
                cpu_decoder.decompress(blob)):
        assert np.abs(rec - data).max() <= err


class _ScriptedEval:
    """A candidate evaluator whose masked stats are scripted per frame:
    a drop set is feasible (max excess -1) iff it is one of the frame's
    ``ok_sets`` (sets of chunk indices), else infeasible (+1)."""

    def __init__(self, ok_sets):
        self.ok_sets = ok_sets
        self.calls = 0

    def masked(self, b, drop):
        self.calls += 1
        ok = torch.tensor([set(torch.nonzero(d).flatten().tolist()) in sets
                           for d, sets in zip(drop, self.ok_sets)])
        return torch.where(ok, -1.0, 1.0), (~ok).float()


def test_union_rule_falls_back_to_the_best_single():
    """Frame 0: chunks 1 and 2 are each feasible alone, not together: the
    single saving more plane bits wins; frame 1 the same with a tie, which
    goes to the lower chunk.  Frame 2: chunk 5 has no sign or refine bit
    at the plane, so it counts as feasible unevaluated (its scripted
    single is not), and the union of chunks 0, 3 and 5 is feasible.
    Frame 3's selection is not feasible: nothing drops."""
    j, g, p = 8, 3, 4
    spec = bp.CoderSpec(height=32, width=32, group_levels=g, nplanes=p,
                        nchunks=j)
    ok_sets = [[{1}, {2}], [{1}, {2}], [{0}, {3}, {0, 3, 5}], [{0}]]
    save = torch.tensor([[5, 7, 9, 1, 1, 1, 1, 1]] * 4, dtype=torch.int64)
    save[1, 2] = 7
    bstar = torch.tensor([2, 2, 1, 2], dtype=torch.int32)
    counts = torch.ones((4, p, g + 3 * j), dtype=torch.int64)
    counts[2, p - 1 - 1, g + 2 * 5 + 1] = 0    # chunk 5's sign bits
    counts[2, p - 1 - 1, g + 2 * j + 5] = 0    # and refine bits
    feasible = torch.tensor([True, True, True, False])
    ev = _ScriptedEval(ok_sets)
    drop, maxd = FrameCodec._union_drop(spec, ev, 0.0, bstar, feasible,
                                        counts, save)
    assert ev.calls == j + 1  # J singles, then the union
    chosen = [set(torch.nonzero(d).flatten().tolist()) for d in drop]
    assert chosen == [{2}, {1}, {0, 3, 5}, set()]
    assert maxd.tolist()[:3] == [-1.0, -1.0, -1.0]


def test_compress_multi_q_equals_per_q_native_and_jax(monkeypatch):
    """Quantiles 0 and 1e-6 keep no residual on these frames, so the
    JAX package's blobs equal the port's too.  Then, with the pure-base
    fallback off, candidates whose frames keep a residual, over a partial
    last batch."""
    data = _data(3, seed=2)
    cfg, jcfg = _configs()
    qs = (0.0, 1e-6)
    blobs = ebcc_tpu_torch.compress_multi_q(data[:B], qs, cfg, device="cpu")
    assert blobs == ebcc_tpu.compress_multi_q(data[:B], qs, jcfg)
    assert not any(h.flags & container.FLAG_RESID
                   for b in blobs for h in _headers(b))
    monkeypatch.setenv("EBCC_DISABLE_PURE_JP2_FALLBACK", "1")
    qs = (0.0, 1e-6, 1e-3, 1e-2)
    blobs = ebcc_tpu_torch.compress_multi_q(data, qs, cfg, device="cpu")
    assert any(h.flags & container.FLAG_RESID for h in _headers(blobs[-1]))
    for q, blob in zip(qs, blobs):
        assert blob == ebcc_tpu_torch.compress(data, cfg, device="cpu",
                                               qbase=q)
        assert blob == cpu_encoder.compress(data, cfg, qbase=q)
    assert blobs == ebcc_tpu_torch.compress_multi_q(
        data, qs, dataclasses.replace(cfg, encode_backend="cpu"))


def test_compress_multi_q_pointwise_masked_arena(monkeypatch):
    """A shared base arena under masked selections: POINTWISE frames with
    the pure-base fallback off, so every candidate emits its own
    (masked) q-selection out of the one arena."""
    monkeypatch.setenv("EBCC_DISABLE_PURE_JP2_FALLBACK", "1")
    data = _data(2, seed=3, noise=0.05)
    eb = (0.2 + 0.3 * np.random.default_rng(4).random(data.shape)).astype(
        np.float32)
    cfg = EBCCConfig(mode=ResidualMode.POINTWISE_MAX_ERROR, base_cr=100,
                     max_batch=2)
    qs = (1e-6, 1e-3, 1e-2)
    blobs = ebcc_tpu_torch.compress_multi_q(data, qs, cfg, error_bound=eb,
                                            device="cpu")
    assert any(h.base_mask_plane != container.MASK_NONE
               for b in blobs for h in _headers(b))
    for q, blob in zip(qs, blobs):
        assert blob == cpu_encoder.compress(data, cfg, error_bound=eb,
                                            qbase=q)
        rec = ebcc_tpu_torch.decompress(blob, device="cpu")
        assert np.all(np.abs(rec - data) <= eb)
