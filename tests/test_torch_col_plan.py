"""The tile of K1's column pass (``ops/fused_eval.py`` ``col_plan``) on the
CPU.

The CUDA kernel (``csrc/fused_eval.cu`` ``eval_lift_cols``) takes each
level's tile as integers and walks (frame, band, strip) items.  Here, in
plain numpy and torch, for the benchmark cells' layers, the card tests'
geometries and others:

* the items cover every stored row of every column of every frame once;
* each band's window stays inside the level, within its halo;
* a band that starts its chunk walk mid-column (``Candidate::seek``)
  finds the chunk ``Candidate::row`` reaches by walking from row 0;
* a banded column lifting with that window, stale window rows set to NaN,
  equals ``dwt.idwt1d`` on the columns bit for bit.

tests/test_torch_cuda.py holds the kernel itself against its plain
version on a card.
"""

import numpy as np
import pytest
import torch

from ebcc_tpu_torch.ops import dwt
from ebcc_tpu_torch.ops import fused_eval as fe
from ebcc_tpu_torch.ops.frame import fma

SMS = 132  # an H100 SXM's streaming multiprocessors

# (hp, wp, levels, h, frames): the cells' base and residual layers at
# their batch of 8, at 16 and at 3, and the card tests' geometries
GEOMS = [
    pytest.param(768, 1472, 5, 721, 8, id="base-B8"),
    pytest.param(768, 1472, 5, 721, 16, id="base-B16"),
    pytest.param(768, 1472, 5, 721, 3, id="base-B3"),
    pytest.param(736, 1440, 3, 721, 8, id="resid-B8"),
    pytest.param(736, 1440, 3, 721, 3, id="resid-B3"),
    pytest.param(96, 160, 5, 90, 3, id="96x160"),
    pytest.param(520, 200, 2, 515, 2, id="520x200"),
    pytest.param(40, 64, 1, 37, 64, id="40x64-B64"),
    pytest.param(64, 98, 1, 61, 3, id="64x98"),
]


def _levels(hp, wp, levels, h):
    """(level, hh, ww, hstore) of each level of a layer."""
    for i in range(levels):
        hh = hp >> i
        yield i, hh, wp >> i, h if i == 0 else hh


def _items(plan, hstore, batch):
    """The kernel's items in its order (``eval_lift_cols``' ``item``):
    frame, first pair, pairs and first column of each."""
    npairs = (hstore + 1) // 2
    it = np.arange(batch * plan.nstrips * plan.nbands)
    rest = it // plan.nstrips
    p0 = rest % plan.nbands * plan.band
    return (rest // plan.nbands, p0, np.minimum(plan.band, npairs - p0),
            it % plan.nstrips * plan.strip)


@pytest.mark.parametrize("hp,wp,levels,h,batch", GEOMS)
def test_col_plan_covers_every_stored_row_once(hp, wp, levels, h, batch):
    for _, hh, ww, hstore in _levels(hp, wp, levels, h):
        plan = fe.col_plan(hh, ww, hstore, batch, SMS)
        assert plan.strip in fe.COL_STRIPS and plan.halo == fe.COL_HALO
        assert plan.band % fe.COL_RUN == 0
        assert fe.col_smem(plan.strip, plan.band) <= fe.COL_SMEM
        items = batch * plan.nstrips * plan.nbands
        assert 1 <= plan.grid <= min(items, fe.COL_CTAS_PER_SM * SMS)
        seen = np.zeros((batch, hstore, ww), np.uint8)
        for fb, p0, nb, c0 in zip(*_items(plan, hstore, batch)):
            assert nb >= 1
            seen[fb, 2 * p0:min(2 * (p0 + nb), hstore),
                 c0:c0 + plan.strip] += 1
        assert (seen == 1).all(), (hh, ww, hstore, plan)


@pytest.mark.parametrize("hp,wp,levels,h,batch", GEOMS)
def test_col_plan_windows_stay_inside_the_level(hp, wp, levels, h, batch):
    """Each window's s rows [p0 - 1, p0 + nb + 2) and d rows [p0 - 2,
    p0 + nb + 2), clamped as the kernel clamps them, lie in the level's
    halves, reach at most the halo past the band, and fit the stage."""
    for _, hh, ww, hstore in _levels(hp, wp, levels, h):
        plan = fe.col_plan(hh, ww, hstore, batch, SMS)
        n2, halo = hh // 2, plan.halo
        _, p0s, nbs, _ = _items(plan, hstore, 1)
        for p0, nb in zip(p0s, nbs):
            ks, kd = np.arange(nb + 2 * halo - 1), np.arange(nb + 2 * halo)
            s_rows = np.clip(p0 - halo + 1 + ks, 0, n2 - 1)
            d_rows = n2 + np.clip(p0 - halo + kd, 0, n2 - 1)
            assert 0 <= s_rows.min() and s_rows.max() < n2
            assert n2 <= d_rows.min() and d_rows.max() < hh
            assert p0 - (p0 - halo + 1 + ks[0]) <= halo
            assert (p0 - halo + kd[-1]) - (p0 + nb - 1) <= halo
            assert len(ks) + len(kd) <= fe.col_window_rows(plan.band)


class _Walk:
    """``Candidate``'s chunk walk (csrc/fused_eval.cu): ``row`` steps over
    chunk boundaries, ``seek`` starts at any row."""

    def __init__(self, hp, nchunks):
        self.hp, self.nchunks = hp, max(nchunks, 1)
        self.chunk, self.next = -1, 0

    def row(self, r):
        while r >= self.next:
            self.chunk += 1
            self.next = -(-(self.chunk + 1) * self.hp // self.nchunks)
        return self.chunk

    def seek(self, r):
        self.chunk = r * self.nchunks // self.hp - 1
        self.next = -(-(self.chunk + 1) * self.hp // self.nchunks)
        return self.row(r)


@pytest.mark.parametrize("hp,wp,levels,h,batch", GEOMS)
@pytest.mark.parametrize("nchunks", [8, 3, 1])
def test_band_start_chunk_is_the_walked_chunk(hp, wp, levels, h, batch,
                                              nchunks):
    """For every band start of every level's plan, in s and in d, and the
    rows after it: seek's chunk equals the walk from row 0."""
    walk = _Walk(hp, nchunks)
    walked = [walk.row(r) for r in range(hp)]
    assert walked == [r * max(nchunks, 1) // hp for r in range(hp)]
    for _, hh, ww, hstore in _levels(hp, wp, levels, h):
        plan = fe.col_plan(hh, ww, hstore, batch, SMS)
        n2 = hh // 2
        _, p0s, nbs, _ = _items(plan, hstore, 1)
        for p0, nb in zip(p0s, nbs):
            for r0, rows in ((0, np.clip(p0 - 1 + np.arange(nb + 3), 0,
                                         n2 - 1)),
                             (n2, np.clip(p0 - 2 + np.arange(nb + 4), 0,
                                          n2 - 1))):
                band = _Walk(hp, nchunks)
                got = [band.seek(r0 + rows[0])]
                got += [band.row(r0 + r) for r in rows[1:]]
                assert got == [walked[r0 + r] for r in rows]


def _lift_run(sw, dw, i0, n2):
    """csrc/lifting.cuh ``lift_run`` on columns: the output pairs
    [i0, i0 + COL_RUN) from sw[k] = s[i0 + k - 1], dw[k] = d[i0 + k - 2]."""
    run = fe.COL_RUN
    sw = [v * dwt.RECIP_XI for v in sw]
    dw = [v * dwt.XI for v in dw]
    for k in range(run + 3):
        prev = dw[3] if k == 1 and i0 == 0 else dw[k]
        sw[k] = fma(dw[k + 1] + prev, -dwt.DELTA, sw[k])
    for k in range(1, run + 3):
        nxt = sw[k - 2] if k >= 2 and i0 + k - 1 >= n2 else sw[k]
        dw[k] = fma(sw[k - 1] + nxt, -dwt.GAMMA, dw[k])
    for k in range(1, run + 2):
        prev = dw[3] if k == 1 and i0 == 0 else dw[k]
        sw[k] = fma(dw[k + 1] + prev, -dwt.BETA, sw[k])
    for k in range(2, run + 2):
        nxt = sw[k] if i0 + k - 1 < n2 else sw[k - 1]
        dw[k] = fma(sw[k - 1] + nxt, -dwt.ALPHA, dw[k])
    return [v for j in range(run) for v in (sw[j + 1], dw[j + 2])]


def _banded_cols(x, band, hstore):
    """The column pass's banded lifting of x [hh, columns] in plain torch:
    each band's window clamped into the level as the kernel loads it, the
    stage rows it does not load NaN, each run of COL_RUN pairs lifted
    from its window, rows < hstore kept."""
    hh = x.shape[0]
    n2, run, halo = hh // 2, fe.COL_RUN, fe.COL_HALO
    npairs = (hstore + 1) // 2
    out = torch.full((2 * npairs, x.shape[1]), float("nan"))
    stale = torch.full((band + 2 * halo, x.shape[1]), float("nan"))
    for p0 in range(0, npairs, band):
        nb = min(band, npairs - p0)
        s_idx = np.clip(p0 - halo + 1 + np.arange(nb + 2 * halo - 1), 0,
                        n2 - 1)
        d_idx = n2 + np.clip(p0 - halo + np.arange(nb + 2 * halo), 0, n2 - 1)
        s = torch.cat([x[s_idx], stale[:band + 2 * halo - 1 - len(s_idx)]])
        d = torch.cat([x[d_idx], stale[:band + 2 * halo - len(d_idx)]])
        for k0 in range(0, nb, run):
            o = _lift_run(list(s[k0:k0 + run + 3]),
                          list(d[k0:k0 + run + 4]), p0 + k0, n2)
            last = min(run, nb - k0)  # pairs of this run in the band
            out[2 * (p0 + k0):2 * (p0 + k0 + last)] = torch.stack(
                o[:2 * last])
    return out[:hstore]


COL_HEIGHTS = [8, 10, 12, 14, 16, 18, 20, 22, 24, 26, 30, 46, 48, 90, 92,
               96, 180, 184, 192, 368, 384, 720, 736, 768]


@pytest.mark.parametrize("hh", COL_HEIGHTS)
def test_banded_column_lifting_equals_idwt1d(hh):
    """Bands of every size the plans take at the cells' levels (and a
    run, two runs, one band), all rows or one row less stored: bit-equal
    to the whole-column inverse lifting."""
    x = torch.from_numpy(np.random.default_rng(hh).normal(
        0, 100, (hh, 5)).astype(np.float32))
    want = dwt.idwt1d(x.T).T
    bands = {fe.COL_RUN, 2 * fe.COL_RUN, -(-hh // 2 // fe.COL_RUN) *
             fe.COL_RUN}
    bands |= {fe.col_plan(hh, ww, hh, batch, SMS).band
              for ww in (92, 368, 1472) for batch in (3, 8)}
    for band in sorted(bands):
        for hstore in (hh, hh - 1):
            got = _banded_cols(x, band, hstore)
            assert torch.equal(got, want[:hstore]), (band, hstore)


def test_col_plans_and_workspace_as_the_kernel_reads_them():
    plans = fe._col_plans(768, 1472, 5, 721, 8, SMS)
    assert plans.dtype == np.int32 and plans.shape == (5, 6)
    assert not plans.flags.writeable
    for i, hh, ww, hstore in _levels(768, 1472, 5, 721):
        assert tuple(plans[i]) == tuple(fe.col_plan(hh, ww, hstore, 8, SMS))
    assert fe._col_plans(33, 50, 0, 30, 3, SMS).shape == (1, 6)
    assert fe.workspace_size(8, 768, 1472) == 8 * 768 * 1472 + 8 * 384 * 736


def test_card_tests_take_uneven_and_single_bands():
    """The card tests' geometries (tests/test_torch_cuda.py
    EVAL_LEVEL_CASES) include a level split into bands of unequal height
    and a level taken in one band, on an H100's SMs."""
    uneven = single = False
    for hp, wp, levels, h, batch in [(768, 1472, 5, 721, 3),
                                     (520, 200, 2, 515, 2),
                                     (40, 64, 1, 37, 64)]:
        for _, hh, ww, hstore in _levels(hp, wp, levels, h):
            plan = fe.col_plan(hh, ww, hstore, batch, SMS)
            npairs = (hstore + 1) // 2
            single |= plan.nbands == 1 and plan.band > fe.COL_RUN
            uneven |= npairs % plan.band != 0
    assert uneven and single


def test_col_constants_are_the_kernels():
    """The plan's constants are csrc/lifting.cuh's: the CTAs an SM, the
    halo and the run of pairs a thread lifts (the kernel checks a plan's
    halo and band; its residency and window are these)."""
    import re

    src = open(fe.KERNEL.sources[1]).read()
    assert fe.KERNEL.sources[1].endswith("lifting.cuh")

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kColCtasPerSm") == fe.COL_CTAS_PER_SM
    assert const("kColHalo") == fe.COL_HALO
    assert const("kRun") == fe.COL_RUN
    # every CTA's stages fit one SM's shared memory at that residency
    assert fe.COL_CTAS_PER_SM * (fe.COL_SMEM + 1024) <= 228 * 1024
