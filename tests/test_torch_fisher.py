"""The port's in-sweep Fisher bracket (ops/fisher_dev.py, the fused sweep's
Fisher column and the engine's host side) against the JAX package's and
against the exact native Fisher test, on the CPU.

Tolerances: P from a bracket is within 1e-5 of the native kernel's (the
reference's TWK_ALLOWED_ROUNDING_ERROR contract) or flagged for the host;
the port walks in f64 and the JAX package in double-single f32 (~1e-6
relative), so their unflagged brackets agree within 2e-6 relative; every
other record field is equal."""

import functools
import math
from decimal import Decimal, getcontext

import numpy as np
import pytest
import torch

import tomahawk_tpu_torch  # noqa: F401  (binds libzstd where needed)

jnp = pytest.importorskip("jax.numpy")

from tomahawk_tpu.compute import sweeps as jsweeps
from tomahawk_tpu.compute.engine import CalcSettings as JaxCalcSettings
from tomahawk_tpu.compute.engine import LdEngine as JaxLdEngine
from tomahawk_tpu.ops import fisher_dev as JF
from tomahawk_tpu.ops.ld_math import LdFilters as JaxLdFilters

from tomahawk_tpu_torch.compute import sweeps
from tomahawk_tpu_torch.compute.engine import CalcSettings, LdEngine
from tomahawk_tpu_torch.native import fisher_exact
from tomahawk_tpu_torch.ops import _build
from tomahawk_tpu_torch.ops import fisher_dev as F
from tomahawk_tpu_torch.ops.ld_math import LdFilters

from test_fisher_dev import _tables
from test_torch_groups import group_planes
from test_torch_sweeps import grouped_planes


def _walk(C, **kw):
    return F.fisher_bracket(*(torch.from_numpy(C[:, k]) for k in range(4)),
                         **kw)


def _trivial(C):
    n1, m1, n = C[:, 0] + C[:, 1], C[:, 0] + C[:, 2], C.sum(axis=1)
    return (n <= 0) | (np.minimum(n1, m1) <= np.maximum(0, n1 + m1 - n))


@pytest.mark.parametrize("tot,seed", [(1000, 0), (400, 1), (5008, 2)])
def test_plain_bracket_matches_jax_and_native(tot, seed):
    """The cases of tests/test_fisher_dev.py (random, symmetric with exact
    ties, tiny, degenerate), and at 1000 Genomes' 5,008 haplotypes."""
    C = _tables(np.random.default_rng(seed), tot)
    br, log2_pb, steps = (x.numpy() for x in _walk(C))
    lf = F.log_factorial_table(int(C.sum(axis=1).max()) + 1)
    P = F.host_p_from_bracket(C, br, lf)
    Pn = fisher_exact(*(C[:, k] for k in range(4)))
    unc = np.isnan(P)
    assert unc.mean() < 0.02
    assert np.abs(P[~unc] - Pn[~unc]).max() <= 1e-5
    jb, _ = JF.fisher_bracket(*(jnp.asarray(C[:, k], jnp.int32)
                                for k in range(4)))
    jb = np.asarray(jb)
    both = (br >= 0) & (jb >= 0)
    assert both.mean() > 0.97
    np.testing.assert_allclose(br[both], jb[both], rtol=2e-6)
    # the bf16 gate's bound holds on every lane that walked
    ok = ~unc & (Pn > 0) & ~_trivial(C)
    assert (log2_pb[ok] >= np.log2(Pn[ok]) - 1e-3).all()
    assert steps[_trivial(C)].sum() == 0 and steps.sum() > len(C)


def test_min_p_guard_is_relative_to_min_p():
    """At min_p = 0.5 every P the bracket returns makes the native
    kernel's keep decision: the guard band scales with min_p (the JAX
    package's absolute 1e-7 band does not cover an f32 or bf16 bracket's
    error there)."""
    C = _tables(np.random.default_rng(3), 400, n_rand=3000, n_sym=200,
                n_small=200)
    Pn = fisher_exact(*(C[:, k] for k in range(4)))
    br = _walk(C)[0].numpy()
    lf = F.log_factorial_table(int(C.sum(axis=1).max()) + 1)
    near = np.abs(Pn - 0.5) < 0.05
    assert near.sum() > 20
    for bits in (br, br.astype(jnp.bfloat16).astype(np.float32)):
        P = F.host_p_from_bracket(C, bits, lf, min_p=0.5)
        sure = ~np.isnan(P)
        assert ((P[sure] <= 0.5) == (Pn[sure] <= 0.5)).all()
        assert (np.abs(P[sure] - 0.5) >= F.MIN_P_GUARD * 0.5).all()
        assert sure[near].any()


def test_trivial_lanes_and_the_step_cap():
    C = np.array([(0, 0, 0, 0), (0, 0, 0, 9), (7, 0, 0, 0), (0, 3, 4, 0),
                  (14000, 1000, 1000, 24000)], np.int64)
    br, log2_pb, _ = _walk(C, max_steps=1024)
    assert br[:3].tolist() == [1.0] * 3 and (log2_pb[:3] == 0).all()
    # a wide support whose crossing lies past the cap: flagged, never a
    # partial sum; with room for the walk it resolves
    assert float(br[4]) == -1.0
    br = _walk(C[4:])[0].numpy()
    P = F.host_p_from_bracket(C[4:], br, F.log_factorial_table(40001))
    Pn = fisher_exact(*(C[4:, k] for k in range(4)))
    assert abs(P[0] - Pn[0]) <= 1e-5
    # packed lanes: flagged, trivial or P possibly >= 1e-4 carry bf16 NaN
    bits = F.packed_bits(*_walk(C)[:2])
    assert bits[:3].tolist() == [F.BF16_NAN] * 3


def _engine_records(planes, n_samples, has_missing, monkeypatch, device_on,
                    jax=False, fused_cap=1 << 14, min_rows=1):
    monkeypatch.setattr(sweeps, "FISHER_MIN_ROWS", min_rows)
    monkeypatch.setattr(jsweeps, "FISHER_MIN_ROWS", min_rows)
    monkeypatch.setenv("TWK_DEVICE_FISHER", "1" if device_on else "0")
    nb = planes["alt_bits"].shape[0]
    pairs = [(i, j, i == j) for i in range(nb) for j in range(i, nb)]
    if jax:
        e = JaxLdEngine(planes, n_samples, JaxCalcSettings(min_r2=0.05))
        filt = JaxLdFilters(min_r2=0.05)
    else:
        e = LdEngine(planes, n_samples, CalcSettings(min_r2=0.05), "cpu")
        filt = LdFilters(min_r2=0.05)
    if jax:
        e._fused_cap = fused_cap
    else:
        e.caps["fused_cap"] = fused_cap
    out = []
    try:
        e.run_phased_pairs(pairs, has_missing, filt,
                           lambda r, rev=None: out.append(r.copy()))
    finally:
        e.stage_close()
    recs = np.concatenate(out)
    order = [f for f in recs.dtype.names if f != "P"]
    return np.sort(recs, order=order), order


@pytest.mark.parametrize("layout", ["packed", "column"])
def test_engine_bracket_records_match_host_fisher(monkeypatch, layout):
    """The gate forced open in both packages: the port's records with the
    bracket equal those with TWK_DEVICE_FISHER=0 and the JAX engine's with
    its bracket, P within 1e-5, in the bf16-packed layout (phased, no
    missing data) and the f32 column (with missing data); also with a
    fused cap of 8, where repaired tiles' rows take the host's Fisher (a
    cap that holds every tile elsewhere, so that rows carry brackets)."""
    has_missing = layout == "column"
    n_samples = 96
    planes = (group_planes(5, 2, 128, n_samples) if has_missing
              else grouped_planes(5, 2, 128, n_samples, group=8))
    _build.reset_counts()
    got, order = _engine_records(planes, n_samples, has_missing,
                                 monkeypatch, True)
    assert _build.PLAIN_CALLS["fisher_bracket"] > 0
    host, _ = _engine_records(planes, n_samples, has_missing, monkeypatch,
                              False)
    jax, _ = _engine_records(planes, n_samples, has_missing, monkeypatch,
                             True, jax=True)
    capped, _ = _engine_records(planes, n_samples, has_missing,
                                monkeypatch, True, fused_cap=8)
    assert len(got) > 200
    for other in (host, jax, capped):
        assert len(other) == len(got)
        for f in order:
            np.testing.assert_array_equal(got[f], other[f], err_msg=f)
        assert np.abs(got["P"] - other["P"]).max() <= 1e-5
    # the bracket, not the host kernel, gave the P of many records
    assert (got["P"] != host["P"]).mean() > 0.1


@pytest.mark.parametrize("layout", ["packed", "column"])
def test_volume_gate_on_both_sides(monkeypatch, layout):
    """FISHER_MIN_ROWS at the segment's survivors and one above: the fused
    sweep writes brackets exactly when the gate is open, and the engine's
    host mirror reads them exactly then, from the same integer counts."""
    has_missing = layout == "column"
    n_samples = 96
    planes = (group_planes(7, 2, 128, n_samples) if has_missing
              else grouped_planes(7, 2, 128, n_samples, group=8))
    cfg = sweeps.make_cfg("phased", has_missing, "all", 128, n_samples, 0,
                          0.05, 100.0, fisher=True)
    dev = sweeps.planes_to_device(planes, "cpu")
    tl = (np.array([0, 0, 1], np.int32), np.array([0, 1, 1], np.int32),
          np.array([True, False, True]), np.ones(3, bool))
    cap, outcap = 1 << 14, 1 << 16
    monkeypatch.setattr(sweeps, "FISHER_MIN_ROWS", 1 << 30)
    n_pass, _, closed = sweeps.fused_sweep(dev, *tl, cfg=cfg, cap=cap,
                                           outcap=outcap)
    total = int(n_pass.sum())
    assert total > 100
    engine = LdEngine(planes, n_samples, CalcSettings(min_r2=0.05), "cpu")
    n_host = n_pass.numpy().astype(np.int64)
    for min_rows, opened in ((total, True), (total + 1, False)):
        monkeypatch.setattr(sweeps, "FISHER_MIN_ROWS", min_rows)
        _, _, buf = sweeps.fused_sweep(dev, *tl, cfg=cfg, cap=cap,
                                       outcap=outcap)
        rows = buf.numpy()[:total]
        if layout == "packed":
            bracket = rows[:, 1] >> 16
            assert (rows[:, 1] & 0xFFFF == closed.numpy()[:total, 1]).all()
        else:
            bracket = rows[:, sweeps.buf_cols(cfg)]
        assert bool((bracket != 0).all()) == opened
        assert bool((bracket != 0).any()) == opened
        data = np.zeros((total, 4), np.int64) + 1
        p = engine._fisher_p(cfg, rows, data, n_host,
                             np.zeros(total, np.int64), np.array([], int),
                             LdFilters())
        assert (p is not None) == opened
    engine.stage_close()


# --- the search (fisher_bracket_search, csrc/fisher_bracket.cu's plain
# version) against the walk, the JAX package and the native Fisher test.
# Tolerances: the search's bracket differs from the walk's only by its
# seed exp(d) (d within table_error of exact, <= 5e-10) and the walk's
# drift; the JAX package's by its double-single f32 walk (~1e-7 on these
# tables): 1e-6 relative against both, the kernel's contract against the
# walk.


def _ld_tables(rng, n_hap, k):
    """k tables of n_hap haplotypes in strong LD: allele frequencies
    0.05-0.5, r2 0.1-1, cells drawn from the multinomial."""
    out = []
    while len(out) < k:
        p, q = rng.uniform(0.05, 0.5, 2)
        r2 = rng.uniform(0.1, 1.0)
        D = min(np.sqrt(r2 * p * (1 - p) * q * (1 - q)),
                p * (1 - q), q * (1 - p))
        cells = np.array([(1 - p) * (1 - q) + D, (1 - p) * q - D,
                          p * (1 - q) - D, p * q + D]).clip(0)
        out.append(rng.multinomial(n_hap, cells / cells.sum()))
    return np.array(out, np.int64)


def _edge_tables(rng, n_hap, k):
    """Symmetric tables (n1 = m1: the mirrored cell ties exactly), the
    observed cell at kmin and at kmax, runs that reach the support's end
    (n1 = m1 = n / 2, a at either end), tiny and trivial tables."""
    out = [(0, 0, 0, 0), (0, 0, 0, 9), (7, 0, 0, 0), (0, 3, 4, 0),
           (1, 0, 0, 1), (5, 0, 0, 5), (0, 5, 5, 0), (10, 10, 10, 10),
           (n_hap // 2, 0, 0, n_hap // 2), (0, n_hap // 2, n_hap // 2, 0)]
    for _ in range(k):
        n1 = int(rng.integers(1, n_hap))
        m1 = n1 if rng.random() < 0.5 else int(rng.integers(1, n_hap))
        kmin, kmax = max(0, n1 + m1 - n_hap), min(n1, m1)
        a = (kmin, kmax, int(rng.integers(kmin, kmax + 1)))[_ % 3]
        out.append((a, n1 - a, m1 - a, n_hap - n1 - m1 + a))
    return np.array(out, np.int64)


def _search(C, n_hap=None, **kw):
    cols = [torch.from_numpy(C[:, k]) for k in range(4)]
    return F.fisher_bracket_search(
        *cols, n_hap or int(C.sum(axis=1).max()), **kw)


def _hold_search_to_walk(C, sb, ss, wb, ws):
    """The search's flags a subset of the walk's; where neither flags the
    brackets within 1e-6 relative and the steps equal. Returns the lanes
    neither flags."""
    sf, wf = sb < 0, wb < 0
    assert not bool((sf & ~wf).any())
    both = ~sf & ~wf
    np.testing.assert_allclose(sb[both].numpy(), wb[both].numpy(),
                               rtol=1e-6)
    assert torch.equal(ss[both], ws[both])
    return both


@pytest.mark.parametrize("n_hap,kind,seed", [
    (5008, "ld", 10), (5008, "edge", 11), (32768, "ld", 12),
    (32768, "edge", 13)])
def test_search_matches_walk_jax_and_native(n_hap, kind, seed):
    rng = np.random.default_rng(seed)
    k = 400 if n_hap == 5008 else 100
    C = (_ld_tables if kind == "ld" else _edge_tables)(rng, n_hap, k)
    sb, sl, ss, sw = _search(C, n_hap)
    wb, wl, ws = _walk(C)
    both = _hold_search_to_walk(C, sb, ss, wb, ws)
    assert both.float().mean() > 0.97
    # the search's work: a few probes and tail steps where the walk
    # crossed the bulk cell by cell
    live = ~torch.from_numpy(_trivial(C))
    assert int(sw[live].sum()) < int(ws[live].sum())
    jb, _ = JF.fisher_bracket(*(jnp.asarray(C[:, q], jnp.int32)
                                for q in range(4)))
    jb = np.asarray(jb)
    sure = (sb.numpy() >= 0) & (jb >= 0)
    assert sure.mean() > 0.97
    np.testing.assert_allclose(sb.numpy()[sure], jb[sure], rtol=1e-6)
    lf = F.log_factorial_table(n_hap + 1)
    P = F.host_p_from_bracket(C, sb.numpy(), lf)
    Pn = fisher_exact(*(C[:, q] for q in range(4)))
    unc = np.isnan(P)
    assert np.abs(P[~unc] - Pn[~unc]).max() <= 1e-5
    ok = ~unc & (Pn > 0) & ~_trivial(C)
    assert (sl.numpy()[ok] >= np.log2(Pn[ok]) - 1e-3).all()
    assert ss[torch.from_numpy(_trivial(C))].sum() == 0


@pytest.mark.parametrize("max_steps", [64, 1024])
def test_search_step_cap_as_the_walk(max_steps):
    """Tables whose run or tail outruns the step cap: flagged exactly
    where the walk flags, and the walk's step count on every lane."""
    rng = np.random.default_rng(14)
    C = np.concatenate([_ld_tables(rng, 5008, 200),
                        np.array([(14000, 1000, 1000, 24000)], np.int64)])
    sb, _, ss, _ = _search(C, 40000, max_steps=max_steps)
    wb, _, ws = _walk(C, max_steps=max_steps)
    assert torch.equal(sb < 0, wb < 0)
    assert int((sb < 0).sum()) > (0 if max_steps == 1024 else 50)
    assert torch.equal(ss, ws)
    _hold_search_to_walk(C, sb, ss, wb, ws)


@functools.lru_cache(maxsize=None)
def _exact_log_factorials(n):
    """log k! for k in [0, n] as 45-digit decimals."""
    getcontext().prec = 45
    out, acc = [Decimal(0)], Decimal(0)
    for k in range(1, n + 1):
        acc += Decimal(k).ln()
        out.append(acc)
    return out


@pytest.mark.parametrize("n_hap", [5008, 32768])
def test_search_table_and_d_error(n_hap):
    """The search table within TABLE_ULPS ulps of lf[n_hap] of log k!, and
    d(k) from the table's f64 sums within `table_error` of the exact
    log(pmf(k) / q) (math.fsum of the logs of the ratios from a to k) on
    the cells of LD tables, where the search decides; the guard's margin
    holds at both sizes."""
    lf = F.search_table(n_hap)
    exact = _exact_log_factorials(n_hap + 1)
    top = float(np.spacing(lf[n_hap]))
    err = max(abs(float(Decimal(float(v)) - e)) for v, e in zip(lf, exact))
    assert err <= F.TABLE_ULPS * top
    eps = F.table_error(n_hap)
    cut_lo, cut_hi, g = F.search_cuts(n_hap)
    assert g > eps and g + eps + F.EPS_WALK <= F.GUARD
    assert cut_lo == math.log1p(-F.BAND) and cut_hi == math.log1p(F.BAND)
    rng = np.random.default_rng(15)
    worst = 0.0
    for rr, ra, ar, aa in _ld_tables(rng, n_hap, 40):
        a, n1, m1 = rr, rr + ra, rr + ar
        nm = ra + aa - m1 + rr  # n2 - m1
        kmin, kmax = max(0, m1 - (ar + aa)), min(n1, m1)
        for k in rng.integers(kmin, kmax + 1, 5):
            k = int(k)
            d = ((lf[a] - lf[k]) + (lf[n1 - a] - lf[n1 - k])) \
                + ((lf[m1 - a] - lf[m1 - k]) + (lf[nm + a] - lf[nm + k]))
            step = 1 if k > a else -1
            terms = []
            for j in range(a, k, step):
                if step > 0:
                    num, den = (n1 - j) * (m1 - j), (j + 1) * (nm + j + 1)
                else:
                    num, den = j * (nm + j), (n1 - j + 1) * (m1 - j + 1)
                terms += [math.log(num), -math.log(den)]
            worst = max(worst, abs(d - math.fsum(terms)))
    assert worst <= eps


def test_search_exp_within_ulps():
    """The seed's exp within 4 ulps of math.exp down to the subnormals,
    and 0 below."""
    x = torch.cat([torch.linspace(-745.0, 1e-8, 20001, dtype=torch.float64),
                   torch.tensor([-1e-8, 0.0, -5e-324, -1080.0, -1e5],
                                dtype=torch.float64)])
    got = F._exp(x)
    want = torch.tensor([math.exp(v) for v in x.tolist()],
                        dtype=torch.float64)
    normal = want > 2.3e-308
    ulps = ((got - want).abs() / torch.tensor(
        np.spacing(want.numpy())))[normal]
    assert float(ulps.max()) <= 4
    assert float((got - want).abs()[~normal].max()) <= 4 * 5e-324
    assert F._exp(torch.tensor([-1e5], dtype=torch.float64)).item() == 0.0


def test_wide_buffer_through_the_plain_wrapper(monkeypatch):
    """chip_smoke.py's tables at 2N = 32,768 (workloads.fisher_tables) as
    one tile's survivor rows (workloads.fisher_buffer): the sweep's
    decode gives the tables back, and the wrapper's plain version writes
    the search's brackets into the f32 column and returns its steps and
    work."""
    from tomahawk_tpu_torch import workloads
    n_samples = 16384
    C = workloads.fisher_tables(2 * n_samples, 300, seed=18)
    K = len(C)
    cfg = sweeps.make_cfg("phased", True, "all", 128, n_samples, 0, 0.1,
                          100.0, fisher=True)
    buf = torch.from_numpy(workloads.fisher_buffer(C, sweeps.out_cols(cfg)))
    n_pass = torch.tensor([K], dtype=torch.int32)
    dev = {"ac": torch.zeros((1, 128), dtype=torch.int32)}
    zero = np.zeros(1, np.int32)
    monkeypatch.setattr(sweeps, "FISHER_MIN_ROWS", K)
    rows, t = sweeps.fisher_rows(n_pass, K, buf.shape[0])
    cells = torch.stack(sweeps.fisher_cells(dev, buf, rows, t, zero, zero,
                                            cfg), 1)
    assert torch.equal(cells, torch.from_numpy(C))
    br, _, steps, work = _search(C, 2 * n_samples)
    _build.reset_counts()
    got = sweeps.append_fisher_col(dev, n_pass, buf, zero, zero, cfg, K)
    assert _build.PLAIN_CALLS["fisher_bracket"] == 1
    assert got == (int(steps.sum()), int(work.sum()))
    col = buf[:K, sweeps.buf_cols(cfg)].view(torch.float32)
    assert torch.equal(col, br)
    assert (buf[K:] == 0).all()
