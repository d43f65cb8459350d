"""The in-sweep Fisher bracket: its plain PyTorch version and host side.

Counterpart of tomahawk_tpu/ops/fisher_dev.py. The device computes, per
survivor, the scale-free BRACKET = P / q of the two-sided Fisher exact
test, q = pmf(observed cell): the sum over the included cells k of
pmf(k) / q. The host multiplies by q, computed exactly in f64 from its
log-factorial table (`host_p_from_bracket`), so P keeps f64 range. The
tail semantics are the reference's kt_fisher_exact (reference:
lib/fisher_math.cpp:231-267; the port's native/twk_native.cpp
twk_fisher1): cells with pmf < 0.99999999 q are summed, a stopping cell
with pmf < 1.00000001 q is included.

The walk (`fisher_bracket`): from the observed cell, where pmf / q is 1
exactly, each side steps outward with the hypergeometric ratio
recurrence, skipping cells whose next cell lies at or above the band
(pmf >= 0.99999999 q), deciding the stopping cell, then summing the tail
until a term falls under 1e-18 of the side's sum. The H100 has native
f64, so the walk runs in f64 with an explicit power-of-two exponent (the
skipped stretch crosses the distribution's bulk, where pmf / q reaches
e^+3000 at 2,504 samples), where the TPU ran double-single f32: ~2^-52
drift a step, ~1e-12 after 10^4 steps, far inside GUARD. A lane whose
stopping decision lies within GUARD of a band edge, or whose walk outruns
`max_steps`, returns -1: the host recomputes it with the exact native
kernel. Trivial lanes (empty support) return 1.

The search (`fisher_bracket_search`), the plain version of
csrc/fisher_bracket.cu: the same bracket, the same flags or fewer, and
the walk's step count, without walking the bulk. With L(k) = -lf[k] -
lf[n1-k] - lf[m1-k] - lf[nm+k] from an f64 log-factorial table
(`search_table`), d(k) = L(k) - L(a) is log(pmf(k) / q). pmf is
unimodal, so on each side the cells the walk skips form one run from
the observed cell, the cells whose value stays at or above 1 - BAND: a
bisection of the table finds the run's far end in ceil(log2(support))
probes. The stopping decision and the walk's three guard tests are made
on d against the thresholds `search_cuts` computes once; the stopping
cell's term and the tail's seed are exp(d) (`_exp`, the same operations
as the kernel's), the tail is the walk's recurrence. Every operation is
an IEEE f64 addition, multiplication or division (the kernel is built
with -fmad=false), so the kernel reproduces this version bit for bit
but for log2 in log2_pbound. On the CPU the wrapper and the engine take
this version; `fisher_bracket` stays the reference it is held against.
"""

import functools
import math
import threading

import numpy as np
import torch

# the reference's tie band around q, on (pmf / q - 1)
BAND = 1e-8
# lanes whose stopping decision lands within this of a band edge go to
# the exact host kernel
GUARD = 1.2e-9
# bf16 packing gate: a log2 bound under which P < 1e-4 is certain
LOG2_P_GATE = np.float32(-13.28)
# the walk's step cap a side
MAX_STEPS = 1 << 14
# a configured min_p: rows whose P lies within this fraction of min_p go
# to the exact host kernel. Relative, as the bracket's error is: a packed
# bf16 bracket is within 2**-9 of its value, an f32 one within 2**-24
MIN_P_GUARD = 1e-2
# the bf16 NaN a packed lane carries when the host must recompute it
BF16_NAN = 0x7FC0


def log_factorial_table(nmax: int) -> np.ndarray:
    """f64 lgamma(k+1) for k in [0, nmax] (HOST side: the exact q)."""
    from math import lgamma
    out = np.empty(nmax + 1, np.float64)
    for k in range(nmax + 1):
        out[k] = lgamma(k + 1.0)
    return out


def _ldexp(m, e):
    """m * 2**e in f64 for an int64 exponent tensor (torch.ldexp would
    raise 2 to it in the default float type): exact, or inf / 0 out of
    range, as C's ldexp but at e = 1024 (never a value the walk uses)."""
    return m * torch.pow(2.0, e.to(torch.float64))


def _ratio(k, side: int, n1, m1, nm):
    """pmf(k + side) / pmf(k), f64: integer products (exact below 2**53)
    and one IEEE division; 0 where the next cell is off the support."""
    if side > 0:
        num, den = (n1 - k) * (m1 - k), (k + 1) * (nm + k + 1)
    else:
        num, den = k * (nm + k), (n1 - k + 1) * (m1 - k + 1)
    dz = den == 0
    return torch.where(dz, 0.0, num.double()
                       / torch.where(dz, 1, den).double())


def fisher_bracket(rr, ra, ar, aa, live=None, max_steps: int = MAX_STEPS):
    """(bracket f32 [K], log2_pbound f32 [K], steps int64 [K]) for 2x2
    tables (REFREF, REFALT, ALTREF, ALTALT), integers [K].

    bracket is P / q, -1 for a lane the host must recompute (a stopping
    decision within GUARD of a band edge, or more than `max_steps` steps
    on a side) and 1 for a trivial lane (empty support, or `live` False).
    log2_pbound bounds log2(P) from above: P = bracket * q and q times
    the largest pmf / q the walk passed is a pmf, at most 1. steps: the
    lane's steps, both sides; csrc/fisher_bracket.cu reports the same
    count as its first counter without taking those steps (it searches,
    see fisher_bracket_search). The first two are the JAX package's
    fisher_bracket contract."""
    a, ra, ar, aa = (torch.clamp(x.to(torch.int64), min=0)
                     for x in (rr, ra, ar, aa))
    n1 = a + ra
    m1 = a + ar
    n = n1 + ar + aa
    n2 = n - n1
    nm = n2 - m1
    kmin = torch.clamp(m1 - n2, min=0)
    kmax = torch.minimum(n1, m1)
    trivial = (n <= 0) | (kmax <= kmin)
    if live is not None:
        trivial |= ~live.to(torch.bool)
    K = a.shape[0]
    f64 = dict(dtype=torch.float64, device=a.device)
    total = torch.zeros(K, **f64)
    unc = torch.zeros(K, dtype=torch.bool, device=a.device)
    steps = torch.zeros(K, dtype=torch.int64, device=a.device)
    # the largest pmf / q passed, pm * 2**pe; pmf(a) / q = 0.5 * 2**1
    pm = torch.full((K,), 0.5, **f64)
    pe = torch.ones(K, dtype=torch.int64, device=a.device)
    for side in (1, -1):
        end = kmax if side > 0 else kmin
        k = a.clone()
        m = torch.full((K,), 0.5, **f64)
        e = torch.ones(K, dtype=torch.int64, device=a.device)
        skip = ~trivial
        tail = torch.zeros_like(skip)
        acc = torch.zeros(K, **f64)
        pp = torch.zeros(K, **f64)
        for _ in range(max_steps):
            act = skip | tail
            if not bool(act.any()):
                break
            steps += act.to(torch.int64)
            r = _ratio(k, side, n1, m1, nm)
            # skip phase: the next cell's pmf / q, renormalised
            fm, fe = torch.frexp(m * r)
            ne = e + fe.to(torch.int64)
            nxt = _ldexp(fm, ne)
            at_end = k == end
            stop = skip & (at_end | (nxt - 1.0 < -BAND))
            adv = skip & ~stop
            here = _ldexp(m, e)
            vh = here - 1.0
            near = ((vh + BAND).abs() < GUARD) | ((vh - BAND).abs() < GUARD) \
                | (~at_end & ((nxt - 1.0 + BAND).abs() < GUARD))
            unc |= stop & near
            acc = torch.where(stop & (vh < BAND), here, acc)
            start = stop & ~at_end
            pp = torch.where(start, nxt, pp)
            # tail phase: sum until a term is negligible or the support ends
            inside = k <= end if side > 0 else k >= end
            cont = tail & (pp > 0) & (pp > acc * 1e-18) & inside
            acc = torch.where(cont, acc + pp, acc)
            pp = torch.where(cont, pp * r, pp)
            k = torch.where(adv | start | cont, k + side, k)
            up = adv & ((ne > pe) | ((ne == pe) & (fm > pm)))
            pm = torch.where(up, fm, pm)
            pe = torch.where(up, ne, pe)
            m = torch.where(adv, fm, m)
            e = torch.where(adv, ne, e)
            tail = (tail & cont) | start
            skip = adv
        unc |= skip | tail
        total += acc
    log2_pb = torch.where(trivial, 0.0, torch.log2(
        torch.clamp(total, min=1e-30)) - (torch.log2(pm) + pe.double()))
    log2_pb = log2_pb.float()
    bracket = torch.where(trivial, 1.0,
                          torch.where(unc, -1.0, total)).float()
    return bracket, log2_pb, steps


#: the search table's entries lie within this many ulps of lf[n_hap]
#: of log k! (measured against 45-digit decimal sums up to 2**15 + 1:
#: 0.5043 at 5,009 entries, 0.5006 at 32,769; tests/test_torch_fisher.py)
TABLE_ULPS = 0.55
#: the walk's own drift: two roundings a step (a product, a quotient)
#: over its step cap
EPS_WALK = 2 * MAX_STEPS * 2.0 ** -53
# exp's constants: 1 / ln 2, ln 2 in two parts (the high part's 32
# bits make n * LN2_HI exact) and the Taylor coefficients 1 / k!
_INV_LN2 = 1.4426950408889634
_LN2_HI = 0.6931471803691238
_LN2_LO = 1.9082149292705877e-10
_EXP_COEF = (1.0, 1.0, 0.5, 0.16666666666666666, 0.041666666666666664,
             0.008333333333333333, 0.001388888888888889,
             0.0001984126984126984, 2.48015873015873e-05,
             2.7557319223985893e-06, 2.755731922398589e-07,
             2.505210838544172e-08, 2.08767569878681e-09,
             1.6059043836821613e-10)
# below this exp(x) is 0 in f64
_EXP_MIN = -1080.0
_lock = threading.Lock()
_tables = {}
_device_tables = {}


def search_table(n_hap: int) -> np.ndarray:
    """f64 log k! for k in [0, n_hap + 1], the search's table: a running
    double-double sum of math.log(k), rounded once, so every entry lies
    within TABLE_ULPS ulps of lf[n_hap] of the exact value (lgamma's
    `log_factorial_table`, which the host keeps for q, is off by up to
    1.4 of them at 32,768, too far for the guard there). Cached."""
    with _lock:
        if n_hap not in _tables:
            out = np.empty(n_hap + 2, np.float64)
            hi = lo = 0.0
            out[0] = 0.0
            for k in range(1, n_hap + 2):
                x = math.log(k)
                s = hi + x
                b = s - hi
                lo += (hi - (s - b)) + (x - b)
                hi = s + lo
                lo -= hi - s
                out[k] = hi
            _tables[n_hap] = out
        return _tables[n_hap]


def device_table(n_hap: int, device) -> torch.Tensor:
    """`search_table(n_hap)` on `device`, uploaded once a (device,
    n_hap)."""
    key = (str(torch.device(device)), n_hap)
    with _lock:
        t = _device_tables.get(key)
    if t is None:
        t = torch.from_numpy(search_table(n_hap)).to(device)
        if t.is_cuda:  # in place before a launch on any stream reads it
            torch.cuda.synchronize(t.device)
        with _lock:
            t = _device_tables.setdefault(key, t)
    return t


def table_error(n_hap: int) -> float:
    """A bound on |d(k) - log(pmf(k) / q)| for tables of up to n_hap
    haplotypes: eight entries, each within TABLE_ULPS ulps of lf[n_hap],
    and seven roundings of half an ulp in d's sum (5.7e-11 at 5,008
    haplotypes, 4.6e-10 at 32,768)."""
    return (8 * TABLE_ULPS + 3.5) * float(
        np.spacing(search_table(n_hap)[n_hap]))


@functools.lru_cache(maxsize=None)
def search_cuts(n_hap: int):
    """(cut_lo, cut_hi, g): the search's thresholds on d. A cell is
    skipped while d >= cut_lo = log1p(-BAND), the stopping cell is
    included while d < cut_hi = log1p(BAND), and a decision within g of
    either cut flags the lane. g = GUARD - table_error - EPS_WALK, so a
    lane the search flags lies within GUARD of a band edge by the walk's
    arithmetic too, and g > table_error makes every decision the search
    leaves unflagged exact."""
    eps = table_error(n_hap)
    g = GUARD - eps - EPS_WALK
    if g <= eps:
        raise ValueError(f"the search's guard does not hold at {n_hap} "
                         f"haplotypes: table error {eps:.3g} against "
                         f"GUARD {GUARD}")
    return math.log1p(-BAND), math.log1p(BAND), g


def _pow2(e):
    """2**e in f64 from its bits, for int64 e in [-1022, 1023]."""
    return ((e + 1023) << 52).view(torch.float64)


def _exp(x):
    """exp(x) for f64 x <= 1, as csrc/fisher_bracket.cu computes it: x =
    n ln 2 + r, a Taylor polynomial of degree 13 in r (|r| <= 0.35), then
    2**n in two normal factors, so the result rounds once where it is
    subnormal. Within a few ulps of exp; bit for bit the kernel's."""
    x = torch.clamp(x, min=_EXP_MIN)
    n = torch.round(x * _INV_LN2)
    r = (x - n * _LN2_HI) - n * _LN2_LO
    p = torch.full_like(x, _EXP_COEF[-1])
    for c in _EXP_COEF[-2::-1]:
        p = p * r + c
    n = n.to(torch.int64)
    h = torch.div(n, 2, rounding_mode="trunc")
    return p * _pow2(h) * _pow2(n - h)


def fisher_bracket_search(rr, ra, ar, aa, n_hap: int,
                          max_steps: int = MAX_STEPS):
    """(bracket f32 [K], log2_pbound f32 [K], steps int64 [K], work int64
    [K]) for 2x2 tables (REFREF, REFALT, ALTREF, ALTALT) of at most n_hap
    haplotypes: `fisher_bracket`'s contract, by a search of
    `search_table(n_hap)` (the module's docstring). steps: the walk's
    steps for the same lane (a side whose run and tail outrun max_steps
    counts max_steps and flags the lane, as the walk's does); work: the
    probes and tail steps the search made. A lane of more than n_hap
    haplotypes is flagged."""
    a, ra, ar, aa = (torch.clamp(x.to(torch.int64), min=0)
                     for x in (rr, ra, ar, aa))
    n1 = a + ra
    m1 = a + ar
    n = n1 + ar + aa
    n2 = n - n1
    nm = n2 - m1
    kmin = torch.clamp(m1 - n2, min=0)
    kmax = torch.minimum(n1, m1)
    trivial = (n <= 0) | (kmax <= kmin)
    over = ~trivial & (n > n_hap)
    act = ~trivial & ~over
    lf = device_table(n_hap, a.device)
    cut_lo, cut_hi, g = search_cuts(n_hap)
    # clamp the cells of lanes that do not search into the table
    n1, m1, nm, a = (torch.where(act, x, 0) for x in (n1, m1, nm, a))
    la = (lf[a], lf[n1 - a], lf[m1 - a], lf[nm + a])

    def d(k):
        return ((la[0] - lf[k]) + (la[1] - lf[n1 - k])) \
            + ((la[2] - lf[m1 - k]) + (la[3] - lf[nm + k]))

    K = a.shape[0]
    i64 = dict(dtype=torch.int64, device=a.device)
    total = torch.zeros(K, dtype=torch.float64, device=a.device)
    unc = over.clone()
    steps = torch.zeros(K, **i64)
    work = torch.zeros(K, **i64)
    for side in (1, -1):
        end = torch.where(act, kmax if side > 0 else kmin, a)
        # the run's far end, as a distance from a: lo's cell is in the
        # run (d(a) = 0), hi's is not or lies past the support's end
        lo = torch.zeros(K, **i64)
        hi = (end - a) * side + 1
        d_lo = torch.zeros(K, dtype=torch.float64, device=a.device)
        d_hi = torch.zeros_like(d_lo)
        while True:
            probe = hi - lo > 1
            if not bool(probe.any()):
                break
            mid = torch.div(lo + hi, 2, rounding_mode="floor")
            dm = d(torch.where(probe, a + side * mid, a))
            inside = probe & (dm >= cut_lo)
            outside = probe & ~inside
            lo = torch.where(inside, mid, lo)
            d_lo = torch.where(inside, dm, d_lo)
            hi = torch.where(outside, mid, hi)
            d_hi = torch.where(outside, dm, d_hi)
            work += probe.to(torch.int64)
        at_end = hi == (end - a) * side + 1
        unc |= act & (((d_lo - cut_lo).abs() < g)
                      | ((d_lo - cut_hi).abs() < g)
                      | (~at_end & ((d_hi - cut_lo).abs() < g)))
        acc = torch.where(d_lo < cut_hi, _exp(d_lo), 0.0)
        capped = act & (lo + 1 > max_steps)
        steps += torch.where(act, torch.clamp(lo + 1, max=max_steps), 0)
        # the tail: the walk's recurrence from the first cell past the run
        rem = torch.where(capped | at_end | ~act, 0, max_steps - lo - 1)
        tail = act & ~capped & ~at_end
        pp = torch.where(tail, _exp(d_hi), 0.0)
        k = a + side * (lo + 1)
        unc |= tail & (rem == 0)
        tail &= rem > 0
        used = torch.zeros(K, **i64)
        while bool(tail.any()):
            r = _ratio(k, side, n1, m1, nm)
            inside = k <= end if side > 0 else k >= end
            cont = tail & (pp > 0) & (pp > acc * 1e-18) & inside
            used += tail.to(torch.int64)
            acc = torch.where(cont, acc + pp, acc)
            pp = torch.where(cont, pp * r, pp)
            k = torch.where(cont, k + side, k)
            tail = cont & (used < rem)
            unc |= cont & (used >= rem)
        steps += used
        work += used
        unc |= capped
        total += torch.where(act, acc, 0.0)
    # the walk's largest pmf / q passed: that of the mode, which every
    # run reaches (the cells from a to the mode lie at or above 1)
    mode = torch.div((n1 + 1) * (m1 + 1), n + 2, rounding_mode="floor")
    l2pm = torch.clamp(d(torch.where(act, mode, a)), min=0.0) * _INV_LN2
    log2_pb = torch.where(act, torch.log2(torch.clamp(total, min=1e-30))
                          - l2pm, 0.0).float()
    bracket = torch.where(trivial, 1.0,
                          torch.where(unc, -1.0, total)).float()
    return bracket, log2_pb, steps, work


def packed_bits(bracket, log2_pb):
    """The bf16 bits (int32, 0..0xFFFF) of a packed bracket: the bracket
    rounded to bf16, or BF16_NAN where the host must recompute the lane:
    flagged, or P possibly >= 1e-4, where bf16's 2**-9 relative error
    could reach the 1e-5 contract."""
    bits = bracket.to(torch.bfloat16).view(torch.int16).to(torch.int32) \
        & 0xFFFF
    bad = (log2_pb > float(LOG2_P_GATE)) | (bracket < 0)
    return torch.where(bad, BF16_NAN, bits)


def host_p_from_bracket(counts: np.ndarray, bracket: np.ndarray,
                        lf: np.ndarray, min_p: float = 1.0):
    """Combine the device bracket with the exact f64 q on host:
    P = min(q * bracket, 1). counts: [K, 4] int64
    (REFREF, REFALT, ALTREF, ALTALT). Returns f64 [K] with NaN for
    rows the native kernel must recompute (flagged lanes, and with a
    min_p below 1 the rows whose P lies within MIN_P_GUARD * min_p of
    it, where the keep decision must be the exact kernel's)."""
    a = counts[:, 0]
    n1 = a + counts[:, 1]
    m1 = a + counts[:, 2]
    n = n1 + counts[:, 2] + counts[:, 3]
    n2 = n - n1
    kmin = np.maximum(0, m1 - n2)
    kmax = np.minimum(n1, m1)
    trivial = (n <= 0) | (kmax <= kmin)
    with np.errstate(over="ignore", invalid="ignore"):
        logq = (lf[n1] - lf[a] - lf[n1 - a]) \
            + (lf[n2] - lf[m1 - a] - lf[n2 - m1 + a]) \
            - (lf[n] - lf[m1] - lf[n - m1])
        br = bracket.astype(np.float64)
        P = np.minimum(np.exp(logq) * br, 1.0)
    P = np.where(trivial, 1.0, P)
    P = np.where((br < 0) | ~np.isfinite(P), np.nan, P)
    if min_p < 1.0:
        P = np.where(np.abs(P - min_p) < MIN_P_GUARD * min_p, np.nan, P)
    return P
