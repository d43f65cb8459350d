"""The division-free screen of the unphased f32 prefilter
(ld_kernels.unphased_screen_cells, the plain statement of
csrc/prefilter.cuh's unphased_screen) against the prefilter itself
(unphased_prefilter_cells): wherever the screen decides a table, it
decides as the prefilter does. Checked on every 3x3 table of at most 12
samples, on 10**6 tables drawn at 2,504 and 32,470 samples from the
unphased benchmark cell's spectrum, and on tables built within 1e-3 of the
r2 bounds in both halves (fold: no double heterozygote; EM: some), each
under three r2 ranges, with D' bounds and without. On the drawn tables
the screen must also leave almost nothing to the exact statement."""

import functools

import numpy as np
import pytest
import torch

from tomahawk_tpu_torch.compute import sweeps
from tomahawk_tpu_torch.ops import ld_kernels as K
from tomahawk_tpu_torch.ops import tiles
from tomahawk_tpu_torch import workloads

#: (min_r2, max_r2): the benchmark cell's, a closed range, and no floor
R2 = [(0.1, 100.0), (0.3, 0.5), (0.0, 1.0)]
DPRIME = [K.DPRIME_OFF, (0.5, 0.95)]
TAU = float(np.float32(1e-4))


def _cells(T):
    return tuple(torch.from_numpy(np.ascontiguousarray(T[:, c],
                                                       dtype=np.int32))
                 for c in range(9))


def _agrees(T, r2, dp, n_samples):
    """The screen's answers on tables T [k, 9] in a launch over pairs of
    at most `n_samples` samples, after asserting that each decided one is
    the prefilter's decision."""
    cells = _cells(T)
    want = K.unphased_prefilter_cells(
        cells, torch.ones(len(T), dtype=torch.bool), *r2, *dp)
    s = K.unphased_screen_cells(cells, n_samples, *r2, *dp)
    decided = s != K.SCREEN_UNDECIDED
    wrong = decided & ((s == K.SCREEN_KEEP) != want)
    assert not wrong.any(), T[wrong.numpy()][:5]
    return s


def _small_tables(total):
    """Every table of 9 non-negative cells summing to at most `total`."""
    out = []

    def rec(prefix, left, k):
        if k == 0:
            out.append(prefix)
            return
        for v in range(left + 1):
            rec(prefix + [v], left - v, k - 1)

    rec([], total, 9)
    return np.array(out, np.int32)


@pytest.mark.parametrize("dp", DPRIME, ids=["dprime_off", "dprime_on"])
@pytest.mark.parametrize("r2", R2, ids=lambda r: f"{r[0]}-{r[1]}")
def test_every_small_table(r2, dp):
    T = _small_tables(12)
    assert len(T) == 293930
    s = _agrees(T, r2, dp, 12)
    assert (s != K.SCREEN_UNDECIDED).float().mean() > 0.95


@functools.lru_cache(maxsize=1)
def draw_tables(k, n_samples, seed, maf_scale=0.5, maf_floor=0.001,
                miss_frac=0.02, miss_rows=0.5):
    """k tables of pairs of independent variants as the unphased cell
    draws them (ldbench/traffic/genotype.py with the cell's traffic): alt
    allele frequencies Beta(0.5, 2) x maf_scale + maf_floor, capped at
    0.5, each haplotype independent; a `miss_rows` share of the variants
    miss a sample's genotype with probability `miss_frac`. A sample's two
    genotypes are independent, so a table is a multinomial draw over the
    9 cells of the samples both variants call."""
    rng = np.random.default_rng(seed)
    f = np.minimum(rng.beta(0.5, 2.0, size=(2, k)) * maf_scale + maf_floor,
                   0.5)
    g = np.stack([(1 - f) ** 2, 2 * f * (1 - f), f ** 2], -1)
    miss = np.where(rng.random((2, k)) < miss_rows, miss_frac, 0.0)
    called = (1 - miss[0]) * (1 - miss[1])
    p = (g[0][:, :, None] * g[1][:, None, :]).reshape(k, 9) * called[:, None]
    p = np.concatenate([p, 1 - p.sum(1, keepdims=True)], 1).clip(0)
    return rng.multinomial(n_samples, p / p.sum(1, keepdims=True))[:, :9]


@pytest.mark.parametrize("r2", R2, ids=lambda r: f"{r[0]}-{r[1]}")
@pytest.mark.parametrize("n_samples", [2504, 32470, 488377])
def test_drawn_tables(n_samples, r2):
    T = draw_tables(10 ** 6, n_samples, seed=n_samples)
    # the ac rule of the candidate mask, on the called samples
    ac_a = T[:, 3:6].sum(1) + 2 * T[:, 6:9].sum(1)
    ac_b = T[:, [1, 4, 7]].sum(1) + 2 * T[:, [2, 5, 8]].sum(1)
    cand = torch.from_numpy(ac_a + ac_b > 2)
    for dp in DPRIME:
        s = _agrees(T, r2, dp, n_samples)
        undecided = (s == K.SCREEN_UNDECIDED) & cand
        assert int(undecided.sum()) < 1e-3 * int(cand.sum())


def _product(*xs, wide=False):
    """The product of integer arrays, left to right: in int64, or in
    float64 for tables of up to 2**19 samples, whose products of four
    allele counts overflow int64."""
    out = xs[0].astype(float) if wide else xs[0]
    for x in xs[1:]:
        out = out * x
    return out


def fold_tables(k, target, seed, n_max=5000):
    """Tables of 5 to `n_max` samples with no double heterozygote whose
    exact r2 lies near `target`: even marginals G0, H0 of t = 2n
    alleles, the even refref that brings d_num = refref t - G0 H0 nearest
    +-sqrt(target M), the homozygous cells that give that phased table,
    then random pairs of homozygotes traded for single heterozygotes
    (the table unchanged)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(5, n_max, k)
    t = 2 * n
    G0 = 2 * rng.integers(1, n)
    H0 = 2 * rng.integers(1, n)
    M = _product(G0, t - G0, H0, t - H0, wide=n_max > 5000)
    dn = rng.choice([-1, 1], k) * np.sqrt(target * M.astype(float))
    rr = 2 * np.round((G0 * H0 + dn) / t / 2).astype(np.int64)
    rr = np.clip(rr, np.maximum(0, G0 + H0 - t), np.minimum(G0, H0))
    ra, ar = G0 - rr, H0 - rr
    aa = t - G0 - H0 + rr
    T = np.zeros((k, 9), np.int64)
    T[:, 0], T[:, 2], T[:, 6], T[:, 8] = rr // 2, ra // 2, ar // 2, aa // 2
    # (from, from, to): T00 + T02 -> 2 T01, T00 + T20 -> 2 T10,
    # T02 + T22 -> 2 T12, T20 + T22 -> 2 T21
    for a, b, c in ((0, 2, 1), (0, 6, 3), (2, 8, 5), (6, 8, 7)):
        x = (rng.random(k) * (np.minimum(T[:, a], T[:, b]) + 1)).astype(int)
        T[:, a] -= x
        T[:, b] -= x
        T[:, c] += 2 * x
    exact = (rr * aa - ar * ra).astype(float) ** 2 / M
    return T, exact


def em_tables(k, target, seed, side, n_max=None):
    """Tables with double heterozygotes whose exact EM r2 bound (r2_max
    for side "lo", r2_min for "hi", with the prefilter's tol) lies near
    `target`. For "lo": multinomial genotype tables of n samples from
    haplotypes in LD around the target, allele frequencies log-uniform on
    [0.002, 0.5] (rare ones make tol a large share of dmax). For "hi",
    where r2_min must reach
    the target: fold_tables a little above it, with 1-3 pairs of double
    homozygotes (T00, T22) made double heterozygotes, which narrows the
    EM interval to a few alleles. `n_max`: the most samples of a table
    (3000 for "lo", fold_tables' 5000 for "hi" when None)."""
    rng = np.random.default_rng(seed)
    wide = n_max is not None and n_max > 5000
    if side == "hi":
        T, _ = fold_tables(k, target * 1.05, seed,
                           **({} if n_max is None else dict(n_max=n_max)))
        x = np.minimum(rng.integers(1, 4, k), np.minimum(T[:, 0], T[:, 8]))
        T[:, 0] -= x
        T[:, 8] -= x
        T[:, 4] += 2 * x
        n = T.sum(1)
    else:
        n = rng.integers(50, n_max or 3000, k)
        pa, pb = np.exp(rng.uniform(np.log(0.002), np.log(0.5), (2, k)))
        r2 = rng.uniform(0.3, 1.5, k) * target
        D = np.minimum(np.sqrt(r2 * pa * (1 - pa) * pb * (1 - pb)),
                       np.minimum(pa * (1 - pb), pb * (1 - pa)))
        h = np.stack([(1 - pa) * (1 - pb) + D, (1 - pa) * pb - D,
                      pa * (1 - pb) - D, pa * pb + D], 1).clip(0)
        h /= h.sum(1, keepdims=True)
        # a sample's alt counts (gA, gB) from haplotypes (a1 b1), (a2 b2)
        p = np.zeros((k, 3, 3))
        for x in range(4):
            for y in range(4):
                p[:, x // 2 + y // 2, x % 2 + y % 2] += h[:, x] * h[:, y]
        p = p.reshape(k, 9)
        T = rng.multinomial(n, p / p.sum(1, keepdims=True)).astype(np.int64)
    X = 2 * n
    Np = 2 * T[:, 0:3].sum(1) + T[:, 3:6].sum(1)
    Nq = 2 * T[:, [0, 3, 6]].sum(1) + T[:, [1, 4, 7]].sum(1)
    n11 = 2 * T[:, 0] + T[:, 1] + T[:, 3]
    nh = n11 + T[:, 4]
    A = (n11 * X - Np * Nq) / X.astype(float) ** 2
    Bv = (Np * Nq - nh * X) / X.astype(float) ** 2
    denom = _product(Np, X - Np, Nq, X - Nq, wide=wide).astype(float) \
        / X ** 4.0
    d = np.maximum(-A, -Bv) + TAU if side == "lo" else \
        np.maximum(np.maximum(A, Bv) - TAU, 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        exact = d ** 2 / denom
    keep = (T[:, 4] > 0) & (denom > 0)
    return T[keep], exact[keep]


@pytest.mark.parametrize("dp", DPRIME, ids=["dprime_off", "dprime_on"])
@pytest.mark.parametrize("r2", R2, ids=lambda r: f"{r[0]}-{r[1]}")
def test_tables_at_the_bounds(r2, dp):
    """Within 1e-3 of a bound every table is inside the screen's margin;
    within 5% of it the margin's edges are crossed, so both answers
    occur."""
    lo, hi = (float(b) for b in K.unphased_bounds(*r2))
    for seed, (side, bound) in enumerate((("lo", lo), ("hi", hi))):
        if not 0.0 < bound < 1.0:
            continue
        for half, build in (
                ("fold", lambda: fold_tables(200_000, bound, seed)),
                ("em", lambda: em_tables(200_000, bound, seed + 10, side))):
            T, exact = build()
            gap = np.abs(exact - bound)
            sel = gap <= 0.05 * bound
            s = _agrees(T[sel], r2, dp, 5000).numpy()
            und = s == K.SCREEN_UNDECIDED
            close = gap[sel] <= 1e-3
            assert close.sum() > 100, (side, half)
            assert und.any() and not und.all(), (side, half)


@pytest.mark.parametrize("dp", DPRIME, ids=["dprime_off", "dprime_on"])
@pytest.mark.parametrize("r2", R2, ids=lambda r: f"{r[0]}-{r[1]}")
def test_tables_at_the_bounds_at_biobank_width(r2, dp):
    """The same at UK Biobank's 488,377 samples, tables of up to that
    many: the screen's margin there (0.249 of a bound) leaves every table
    within 1e-3 of a bound to the statement, and within half a bound both
    answers occur."""
    n_samples = 488377
    lo, hi = (float(b) for b in K.unphased_bounds(*r2))
    for seed, (side, bound) in enumerate((("lo", lo), ("hi", hi))):
        if not 0.0 < bound < 1.0:
            continue
        for half, build in (
                ("fold", lambda: fold_tables(200_000, bound, seed,
                                             n_max=n_samples)),
                ("em", lambda: em_tables(200_000, bound, seed + 10, side,
                                         n_max=n_samples))):
            T, exact = build()
            assert T.sum(1).max() <= n_samples
            gap = np.abs(exact - bound)
            sel = gap <= 0.5 * bound
            s = _agrees(T[sel], r2, dp, n_samples).numpy()
            und = s == K.SCREEN_UNDECIDED
            close = gap[sel] <= 1e-3
            assert close.sum() > 100, (side, half)
            assert und[close].all(), (side, half)
            assert und.any() and not und.all(), (side, half)


def test_screen_counts_of_a_tile():
    """tiles.tile_prefilter adds the plain screen counts of an unphased
    tile (candidates screened, undecided) to `screen`, on the CPU as the
    kernel does on the card; a near-threshold tile leaves some undecided
    and keeps the prefilter's mask; a phased tile refuses a screen."""
    B, n_samples = 256, 600
    dev = sweeps.planes_to_device(
        workloads.threshold_planes(1, B, n_samples, group=32), "cpu")
    for miss in (False, True):
        cfg = sweeps.make_cfg("unphased", miss, "all", B, n_samples, 0,
                              0.1, 100.0)
        screen = torch.zeros(2, dtype=torch.int64)
        for diag in (False, True):
            mask, parts = tiles.tile_prefilter(dev, 0, 0, diag, cfg,
                                               screen=screen)
            want = tiles.tile_prefilter_plain(dev, 0, 0, diag, cfg)[0]
            assert torch.equal(mask, want)
        cand = sum(int((tiles.tile_prefilter_plain(dev, 0, 0, d, cfg)[0]
                        != 0).sum()) for d in (False, True))
        assert int(screen[0]) == cand
        assert 0 < int(screen[1]) < cand // 100
    cfg = sweeps.make_cfg("phased", True, "all", B, n_samples, 0, 0.1,
                          100.0)
    with pytest.raises(ValueError, match="unphased"):
        tiles.tile_prefilter(dev, 0, 0, True, cfg,
                             screen=torch.zeros(2, dtype=torch.int64))


def test_screen_declines():
    """The screen leaves every pair to the exact statement where its
    proof does not hold: a pair of more samples than the launch's
    n_samples, a launch over more than 2**19 samples, a bound outside
    what it takes (hi above 2**40); and nothing else changes."""
    T = draw_tables(10 ** 6, 2504, seed=2504)[:20000]
    cells = _cells(T)
    undecided = lambda s: bool((s == K.SCREEN_UNDECIDED).all())
    n = T.sum(1)
    n_max = int(np.median(n))
    s = K.unphased_screen_cells(cells, n_max, 0.1, 100.0)
    assert undecided(s[torch.from_numpy(n > n_max)])
    assert not undecided(s[torch.from_numpy(n <= n_max)])
    assert undecided(K.unphased_screen_cells(cells, (1 << 19) + 1, 0.1,
                                             100.0))
    assert undecided(K.unphased_screen_cells(cells, 2504, 0.1, 1e13))
    assert K.screen_margin(*K.unphased_bounds(0.1, 1e13), 2504)[2] == 0
