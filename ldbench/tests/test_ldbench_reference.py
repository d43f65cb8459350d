"""The plain reference against a brute-force computation pair by pair,
and the traffic generators' shapes, at small sizes on the CPU."""

import numpy as np
import pytest
import torch
from scipy.stats import fisher_exact

from ldbench.reference import ld
from ldbench.traffic import _pack, genotype, phased_grouped, \
    phased_independent

N = 40          # samples


def _planes(draw, sizes, seed, **kw):
    st = draw(sizes, 128, N, seed, "cpu", **kw)
    out = []
    for b, n in enumerate(sizes):
        out.append({k: torch.from_numpy(st[k][b][:n].view(np.int32))
                    for k in ("alt_bits", "valid_bits")})
    return st, out


def _haplotype_stats(rr, ra, ar, aa):
    t = rr + ra + ar + aa
    D = rr / t * aa / t - ar / t * ra / t
    g0, g1, h0, h1 = (rr + ra) / t, (ar + aa) / t, (rr + ar) / t, \
        (ra + aa) / t
    r2 = D * D / (g0 * g1 * h0 * h1)
    dmax = min(g0 * h1, h0 * g1) if D >= 0 else -min(g0 * g1, h0 * h1)
    return D, D / dmax, r2


@pytest.mark.parametrize("diag", [False, True])
def test_phased_tile_against_pair_by_pair(diag):
    st, pl = _planes(phased_independent.draw, [50, 60], 7)
    i, j = (0, 0) if diag else (0, 1)
    got = ld.tile(pl[i], pl[j], diag, "phased", N, 0.1)
    A = ld.unpack(pl[i]["alt_bits"], 2 * N).numpy().astype(int)
    B = ld.unpack(pl[j]["alt_bits"], 2 * N).numpy().astype(int)
    want = {}
    for k in range(len(A)):
        for m in range(k + 1 if diag else 0, len(B)):
            aa = int((A[k] & B[m]).sum())
            ar = int(A[k].sum()) - aa
            ra = int(B[m].sum()) - aa
            rr = 2 * N - aa - ar - ra
            guard = ra + ar + rr if rr < aa else aa + ra + ar
            if guard < 5 or rr * aa == ar * ra:
                continue
            if min(rr + ra, ar + aa, rr + ar, ra + aa) == 0:
                continue
            D, dp, r2 = _haplotype_stats(rr, ra, ar, aa)
            if r2 >= 0.1:
                P = fisher_exact([[rr, ra], [ar, aa]])[1]
                want[k * len(B) + m] = (D, dp, r2, P, (rr, ar, ra, aa))
    assert sorted(got["idx"].tolist()) == sorted(want)
    assert len(want) > 5
    for x, idx in enumerate(got["idx"].tolist()):
        D, dp, r2, P, cnt = want[idx]
        assert got["D"][x].item() == pytest.approx(D, rel=1e-12)
        assert got["Dprime"][x].item() == pytest.approx(dp, rel=1e-12)
        assert got["R2"][x].item() == pytest.approx(r2, rel=1e-12)
        assert got["P"][x].item() == pytest.approx(P, rel=1e-6)
        assert tuple(got["cnt"][x].tolist()) == cnt


def _ml_f11(T):
    """The cubic's admissible root with the least chi-squared, the roots
    from numpy.roots (a companion-matrix eigenproblem)."""
    T = T.astype(float)
    n = T.sum()
    rows, cols = T.sum(1), T.sum(0)
    p = (2 * rows[0] + rows[1]) / (2 * n)
    q = (2 * cols[0] + cols[1]) / (2 * n)
    n11 = 2 * T[0, 0] + T[0, 1] + T[1, 0]
    ndh = T[1, 1]
    a = 4 * n
    b = 2 * n * (1 - 2 * p - 2 * q) - 2 * n11 - ndh
    c = -n11 * (1 - 2 * p - 2 * q) - ndh * (1 - p - q) + 2 * n * p * q
    d = -n11 * p * q
    best, f11 = np.inf, None
    for r in np.roots([a, b, c, d]):
        if abs(r.imag) > 1e-9:
            continue
        f = r.real
        if not n11 / (2 * n) - 1e-5 <= f <= (n11 + ndh) / (2 * n) + 1e-5:
            continue
        f12, f21 = p - f, q - f
        f22 = 1 - f - f12 - f21
        e = np.array([[n * f * f, 2 * n * f * f12, n * f12 * f12],
                      [2 * n * f * f21, 2 * n * (f12 * f21 + f * f22),
                       2 * n * f12 * f22],
                      [n * f21 * f21, 2 * n * f21 * f22, n * f22 * f22]])
        chi = np.where(e > 0, (T - e) ** 2 / np.where(e > 0, e, 1), 0).sum()
        if chi < best:
            best, f11 = chi, f
    return f11, p, q


def test_unphased_tile_against_pair_by_pair():
    st, pl = _planes(genotype.draw, [70, 70], 11, miss_frac=0.1,
                     miss_rows=0.5)
    got = ld.tile(pl[0], pl[1], False, "unphased", N, 0.1)
    ties = set(got["tie"].tolist())
    A = ld.unpack(pl[0]["alt_bits"], 2 * N).numpy().astype(int)
    B = ld.unpack(pl[1]["alt_bits"], 2 * N).numpy().astype(int)
    VA = ld.unpack(pl[0]["valid_bits"], N).numpy().astype(bool)
    VB = ld.unpack(pl[1]["valid_bits"], N).numpy().astype(bool)
    gA, gB = A[:, 0::2] + A[:, 1::2], B[:, 0::2] + B[:, 1::2]
    kept = {}
    n_em = 0
    for k in range(len(A)):
        for m in range(len(B)):
            both = VA[k] & VB[m]
            T = np.zeros((3, 3), int)
            np.add.at(T, (gA[k][both], gB[m][both]), 1)
            if T.sum() < 5 or k * len(B) + m in ties:
                continue
            if T[1, 1] == 0:
                rr = 2 * T[0, 0] + T[0, 1] + T[1, 0]
                ra = 2 * T[0, 2] + T[0, 1] + T[1, 2]
                ar = 2 * T[2, 0] + T[1, 0] + T[2, 1]
                aa = 2 * T[2, 2] + T[2, 1] + T[1, 2]
                guard = ra + ar + rr if rr < aa else aa + ra + ar
                if guard < 5 or rr * aa == ar * ra or \
                        min(rr + ra, ar + aa, rr + ar, ra + aa) == 0:
                    continue
                D, dp, r2 = _haplotype_stats(rr, ra, ar, aa)
            else:
                n_em += 1
                f11, p, q = _ml_f11(T)
                if f11 is None:
                    continue
                f12, f21 = p - f11, q - f11
                f22 = 1 - f11 - f12 - f21
                D = f11 * f22 - f12 * f21
                r2 = D * D / (p * (1 - p) * q * (1 - q))
                c = 2 * T.sum() * np.array([f11, f12, f21, f22])
                guard = c[1] + c[2] + c[0] if c[0] < c[3] else \
                    c[3] + c[1] + c[2]
                if guard < 5:
                    continue
            if r2 >= 0.1:
                kept[k * len(B) + m] = r2
    assert n_em > 100
    idx = [i for i in got["idx"].tolist() if i not in ties]
    assert sorted(idx) == sorted(kept)
    assert len(kept) > 5
    for x, i in enumerate(got["idx"].tolist()):
        if i in kept:
            assert got["R2"][x].item() == pytest.approx(kept[i], rel=1e-8)


def test_fisher_matches_scipy():
    rng = np.random.default_rng(5)
    tabs = rng.integers(0, 60, (300, 4))
    got = ld.fisher(*torch.from_numpy(tabs).T).numpy()
    want = [fisher_exact([[a, b], [c, d]])[1] for a, b, c, d in tabs]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_grouped_generator_partners():
    """At the configuration's width, every variant of a group of 94 has
    r2 >= 0.1 with its 93 partners and with no other variant; in the
    remainder group, with its size less one."""
    n_samples = 2504
    sizes = [300]
    st = phased_grouped.draw(sizes, 320, n_samples, 21, "cpu", group=94,
                             flip=0.02)
    X = ld.unpack(torch.from_numpy(st["alt_bits"][0][:300].view(np.int32)),
                  2 * n_samples).double()
    n = 2 * n_samples
    p = X.mean(1)
    cov = X @ X.T / n - p[:, None] * p[None, :]
    r2 = cov ** 2 / (p * (1 - p))[:, None] / (p * (1 - p))[None, :]
    r2.fill_diagonal_(0)
    partners = (r2 >= 0.1).sum(1).numpy()
    want = [93] * 282 + [17] * 18
    assert partners.tolist() == want


def test_generators_pack_the_port_layout():
    st = genotype.draw([50], 64, N, 2, "cpu", miss_frac=0.2, miss_rows=1.0)
    alt = ld.unpack(torch.from_numpy(st["alt_bits"][0].view(np.int32)),
                    2 * N).numpy()
    called = ld.unpack(torch.from_numpy(st["valid_bits"][0].view(np.int32)),
                       N).numpy().astype(bool)
    assert (alt[:50].sum(1) == st["ac"][0][:50]).all()
    assert (st["an"][0][:50] == 2 * (~called[:50]).sum(1)).all()
    # padding bits of the missing plane are ones, padding rows invalid
    miss = np.unpackbits(st["miss_bits"][0].view(np.uint8), axis=1,
                         bitorder="little")
    assert miss[:, 2 * N:].all() and not st["valid"][0][50:].any()
    assert _pack.words_for(2 * 2504) == 160 and _pack.words_for(2504) == 80
