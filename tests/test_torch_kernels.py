"""The port's two kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain torch version, which is held here
against the Pallas kernel in interpret mode on the same inputs (numpy
seeds, both packages fed identical arrays):

* level-0 counts: integer-equal (``ops/level0_counts.py`` vs
  ``ebcc_tpu/ops/pallas_kernels.py``), and the assembled segment counts
  equal to ``ebcc_tpu.ops.bitplane.segment_counts``;
* candidate evaluation: the tolerances and feasibility-decision checks of
  tests/test_pallas_eval.py, for the four scalar-target variants and the
  four per-point target-field variants;
* every kernel library's build key covers each header its source
  includes, so a header edit rebuilds it;
* the per-level quadrant weights the candidate-evaluation kernel divides
  by, painted level by level, are the weight array of the plain version.

tests/test_torch_cuda.py compares each CUDA kernel with its plain version
on a card.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ebcc_tpu.ops import bitplane as jbp
from ebcc_tpu.ops import pallas_eval as pe
from ebcc_tpu.ops import pallas_kernels as pk

from ebcc_tpu_torch.codec.config import EBCCConfig, ResidualMode
from ebcc_tpu_torch.codec.pipeline import FrameCodec, _Eval
from ebcc_tpu_torch.ops import bitplane as bp
from ebcc_tpu_torch.ops import fused_eval as fe
from ebcc_tpu_torch.ops import idwt
from ebcc_tpu_torch.ops import level0_counts as l0
from ebcc_tpu_torch.ops import weights
from ebcc_tpu_torch.runtime import build, cuda, native

B, H, W = 2, 96, 160


def _random_coefs(h, w, b=3, seed=0, scale=2000):
    rng = np.random.default_rng(seed)
    coefs = rng.integers(-scale, scale, (b, h, w)).astype(np.int32)
    coefs[:, ::2] = 0      # whole subtrees insignificant
    coefs[0] = 0           # all-zero frame: msb == -1 everywhere
    return coefs


@pytest.mark.parametrize("h,w,g,j,p", [(64, 96, 4, 8, 13), (32, 32, 3, 4, 9),
                                       (128, 192, 6, 8, 22),
                                       (96, 160, 4, 8, 14)])
def test_level0_counts_ref_matches_pallas(h, w, g, j, p):
    spec = bp.CoderSpec(height=h, width=w, group_levels=g, nplanes=p,
                        nchunks=j)
    coefs = _random_coefs(h, w)
    an = bp.analyze(torch.from_numpy(coefs), spec)
    ours = l0.level0_counts(an.msb, an.smax[1], p, j)
    jan = jbp.analyze(jnp.asarray(coefs), spec)
    par = jnp.repeat(jnp.repeat(jan.smax[1], 2, -1), 2, -2)
    ref = pk.level0_counts(jan.msb, par, p, j, interpret=True)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("h,w,g,j", [(64, 96, 4, 8), (48, 80, 2, 8),
                                     (36, 64, 2, 8)])
def test_segment_counts_match_jax(h, w, g, j):
    """Assembled [B, P, S] counts, including the uneven-stripe geometry
    (36 rows, 8 stripes) that takes the per-plane mask formulation."""
    spec = bp.CoderSpec(height=h, width=w, group_levels=g, nplanes=13,
                        nchunks=j)
    coefs = _random_coefs(h, w, seed=1)
    ours = bp.segment_counts(bp.analyze(torch.from_numpy(coefs), spec), spec)
    ref = jbp.segment_counts(jbp.analyze(jnp.asarray(coefs), spec), spec)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_level0_supported_gate():
    assert l0.level0_supported(768, 1472, 6, 8)
    assert l0.level0_supported(736, 1440, 4, 8)
    assert not l0.level0_supported(36, 64, 2, 8)   # uneven stripes
    assert not l0.level0_supported(40, 64, 2, 8)   # odd half-stripes
    assert not l0.level0_supported(64, 64, 0, 8)   # no quadtree
    # a stripe of any length (the kernel bins in rounds)
    assert l0.level0_supported(8 * 4096, 16386, 2, 8)


@pytest.mark.parametrize("kernel", [l0.KERNEL, fe.KERNEL, idwt.KERNEL],
                         ids=lambda k: k.name)
def test_kernel_build_keyed_on_every_included_header(kernel, tmp_path):
    """The build key covers the .cu file and every header it includes: an
    edit of a copy of any of them changes the key."""
    srcs = kernel.sources
    assert srcs[0].endswith(f"{kernel.name}.cu")
    names = [os.path.basename(s) for s in srcs]
    assert ("lifting.cuh" in names) == (kernel.name != "level0_counts")
    for s in srcs:
        (tmp_path / os.path.basename(s)).write_bytes(open(s, "rb").read())
    copy = cuda.included_sources(str(tmp_path / names[0]))
    assert [os.path.basename(s) for s in copy] == names
    key = build.source_key(copy, cuda.NVCC_FLAGS)
    for s in copy:
        with open(s, "a") as f:
            f.write("\n// edit\n")
        new_key = build.source_key(cuda.included_sources(copy[0]),
                                   cuda.NVCC_FLAGS)
        assert new_key != key
        key = new_key


def test_level0_entry_signature_has_no_hist():
    """The C entry of K2 is (device, msb, smax1, B, hp, wp, P, J, out,
    stream): one launch with its histograms in shared memory, no ``hist``
    scratch in its signature or its argtypes."""
    src = open(l0.KERNEL.source).read()
    head = "int ebcc_level0_counts("
    assert src.count(head) == 1
    sig = src[src.index(head):src.index(")", src.index(head))]
    assert "hist" not in sig
    assert [a.split()[-1].lstrip("*") for a in sig[len(head):].split(",")] \
        == ["device", "msb", "smax1", "B", "hp", "wp", "P", "J", "out",
            "stream"]
    assert len(l0.KERNEL.argtypes) == 10
    assert "cudaMemsetAsync" not in src


@pytest.mark.parametrize("hp,wp,levels", [(768, 1472, 5), (736, 1440, 3),
                                          (96, 160, 3), (64, 96, 1),
                                          (64, 96, 0)])
def test_level_weights_paint_the_weight_array(hp, wp, levels):
    """The column passes divide each coefficient by its quadrant's weight
    at the level where it is composed: painting ``level_weights`` quadrant
    by quadrant from the deepest level up covers every coefficient exactly
    once and gives ``weight_array`` bit for bit."""
    lw = fe.level_weights(levels)
    assert lw.dtype == np.float32 and lw.shape == (max(levels, 1), 4)
    painted = np.zeros((hp, wp), np.float32)
    times = np.zeros((hp, wp), np.int32)
    for i in range(max(levels, 1) - 1, -1, -1):
        hh, ww = hp >> i, wp >> i
        h2, w2 = hh // 2, ww // 2
        quads = [(slice(0, h2), slice(w2, ww)), (slice(h2, hh), slice(0, w2)),
                 (slice(h2, hh), slice(w2, ww))]
        if i == max(levels, 1) - 1:  # the deepest level composes all four
            quads.insert(0, (slice(0, h2), slice(0, w2)))
        for (rs, cs), wt in zip(quads, lw[i] if len(quads) == 4 else lw[i, 1:]):
            painted[rs, cs] = wt
            times[rs, cs] += 1
    assert (times == 1).all()
    want = weights.weight_array(hp, wp, levels)
    np.testing.assert_array_equal(painted.view(np.uint32),
                                  want.view(np.uint32))


def test_idwt_wrapper_rejects_cpu_tensors():
    """The CUDA wrapper takes CUDA tensors only (CPU tensors go through
    ``dwt.idwt2d_multi`` to the plain version)."""
    x = torch.zeros((1, 16, 32))
    with pytest.raises(ValueError):
        idwt.idwt2d_multi_cuda(x, 2)
    with pytest.raises(ValueError):
        idwt.idwt2d_multi_cuda(x, 2, out=x)


def _make_layers(pointwise: bool):
    """Both layers' evaluation inputs for a 2-frame 96x160 batch (the
    geometry and config of tests/test_pallas_eval.py), made by the port:
    the base layer, and the residual against base@(plane 8, chunk 3).
    ``pointwise``: per-point targets of 0.2-0.4 (the target field of
    tests/test_pallas_eval.py's pointwise test) instead of one per
    frame."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:H, 0:W]
    base = (260 + 25 * np.sin(y / H * np.pi) *
            np.cos(x / W * 2 * np.pi)).astype(np.float32)
    data = np.stack([base + rng.normal(0, 0.3, base.shape)
                     .astype(np.float32) for _ in range(B)])
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.25, base_cr=200,
                     max_batch=B)
    c = FrameCodec(H, W, cfg, torch.device("cpu"))
    u, mn, mx, maxq = native.scale_u16_batch(data)
    mn, mx = torch.from_numpy(mn), torch.from_numpy(mx)
    dataq, _, dc, ci = c._hostq_prelude(
        torch.from_numpy(u.astype(np.int32)), mn, mx)
    if pointwise:
        tgt = (0.2 + 0.2 * np.random.default_rng(9).random((B, H, W)))
        target = torch.from_numpy(tgt.astype(np.float32) -
                                  maxq[:, None, None])
    else:
        target = torch.from_numpy(np.full(B, 0.25, np.float32) - maxq)
    ev_b = _Eval(c.base, H, W, ci, dataq, target, "base", dc, mn, mx)
    an = bp.analyze(ci, c.base.spec)
    coef = c._recon_at(an, c.base, torch.full((B,), 8, dtype=torch.int32),
                       torch.full((B,), 3, dtype=torch.int32))
    base_rec = c._base_recon(coef, mn, mx, dc)
    rmin, rmax, dcr, cir = c._resid_transform(dataq - base_rec)
    ev_r = _Eval(c.resid, H, W, cir, dataq, target, "resid", dcr, rmin,
                 rmax, base_rec=base_rec)
    return c, ev_b, ev_r


@pytest.fixture(scope="module")
def layers():
    return _make_layers(pointwise=False)


@pytest.fixture(scope="module")
def pw_layers():
    return _make_layers(pointwise=True)


def _both(ev, mode, b, **cand):
    """(port plain stats, Pallas interpret stats) of one candidate."""
    a = dict(ev.args)
    ci, ref = a.pop("ci"), a.pop("ref")
    ours = fe.eval_stats(ci, ref, b, mode=mode, **a, **cand)

    def j(v):
        return None if v is None else jnp.asarray(v.numpy())

    theirs = pe.eval_stats(
        j(ci), j(ref), j(b), kind=a["kind"], mode=mode, levels=a["levels"],
        nchunks=a["nchunks"], h=a["h"], w=a["w"],
        **{k: j(v) for k, v in cand.items()}, dc=j(a["dc"]), lo=j(a["lo"]),
        hi=j(a["hi"]), tgt=j(a["tgt"]), base_rec=j(a["base_rec"]),
        tgt_field=j(a["tgt_field"]), interpret=True)
    return ours, theirs


def _assert_parity(ours, theirs, inv_n):
    """tests/test_pallas_eval.py's contract: stats to last-ulp tolerance,
    every feasibility decision identical."""
    mk, ck = (v.numpy() for v in ours)
    mj, cj = (np.asarray(v) for v in theirs)
    vk = ck.astype(np.float32) * np.float32(inv_n)
    vj = cj.astype(np.float32) * np.float32(inv_n)
    np.testing.assert_allclose(mk, mj, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(vk, vj, rtol=1e-4, atol=2e-5)
    np.testing.assert_array_equal(mk <= 0, mj <= 0)
    for qa in (0.0, 1e-6, 1e-3):
        np.testing.assert_array_equal(vk <= qa, vj <= qa)


def _vec(v):
    return torch.full((B,), v, dtype=torch.int32)


@pytest.mark.parametrize("kind", ["base", "resid"])
def test_eval_stats_trunc_matches_pallas(layers, kind):
    c, ev_b, ev_r = layers
    ev, geom = (ev_b, c.base) if kind == "base" else (ev_r, c.resid)
    j = geom.spec.nchunks
    cands = [(b, j, j) for b in range(0, geom.spec.nplanes, 5)]
    cands += [(5, 2, 0), (5, j, 1), (5, j, j - 1)]
    for b, js, jr in cands:
        ours, theirs = _both(ev, "trunc", _vec(b), js=_vec(js), jr=_vec(jr))
        _assert_parity(ours, theirs, ev.inv_n)


@pytest.mark.parametrize("kind", ["base", "resid"])
def test_eval_stats_masked_matches_pallas(layers, kind):
    c, ev_b, ev_r = layers
    ev, geom = (ev_b, c.base) if kind == "base" else (ev_r, c.resid)
    rng = np.random.default_rng(3)
    for b in (2, 6):
        dm = torch.from_numpy(rng.integers(0, 1 << geom.spec.nchunks, B)
                              .astype(np.int32))
        ours, theirs = _both(ev, "masked", _vec(b), dropmask=dm)
        _assert_parity(ours, theirs, ev.inv_n)


@pytest.mark.parametrize("mode", ["trunc", "masked"])
@pytest.mark.parametrize("kind", ["base", "resid"])
def test_eval_stats_target_field_matches_pallas(pw_layers, kind, mode):
    """The per-point target-field variant (POINTWISE_MAX_ERROR) against
    the Pallas kernel's ``tgt_field`` variant in interpret mode."""
    c, ev_b, ev_r = pw_layers
    ev, geom = (ev_b, c.base) if kind == "base" else (ev_r, c.resid)
    assert ev.args["tgt"] is None
    assert tuple(ev.args["tgt_field"].shape) == (B, geom.hp, geom.wp)
    j = geom.spec.nchunks
    rng = np.random.default_rng(5)
    if mode == "trunc":
        cands = [dict(js=_vec(j), jr=_vec(j), b=b)
                 for b in range(0, geom.spec.nplanes, 4)]
        cands += [dict(js=_vec(3), jr=_vec(0), b=6),
                  dict(js=_vec(j), jr=_vec(5), b=6)]
    else:
        cands = [dict(dropmask=torch.from_numpy(
            rng.integers(0, 1 << j, B).astype(np.int32)), b=b)
            for b in (2, 6, 9)]
    for cand in cands:
        b = _vec(cand.pop("b"))
        ours, theirs = _both(ev, mode, b, **cand)
        _assert_parity(ours, theirs, ev.inv_n)


def test_wrappers_reject_bad_variants(layers):
    _, ev_b, _ = layers
    a = dict(ev_b.args)
    ci, ref = a.pop("ci"), a.pop("ref")
    with pytest.raises(ValueError):
        fe.eval_stats(ci, ref, _vec(3), mode="union", **a)
    with pytest.raises(ValueError):  # both a scalar and a field target
        fe.eval_stats(ci, ref, _vec(3), mode="trunc",
                      **{**a, "tgt_field": ref})
    a["kind"] = "resid"
    with pytest.raises(ValueError):  # resid needs base_rec
        fe.eval_stats(ci, ref, _vec(3), mode="trunc", **a)
