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

csrc/fisher_bracket.cu runs the same walk, one thread a survivor row,
step for step (its division of the ratio's integers may round one ulp
apart from this version's); this module's version serves CPU tensors and
the on-card comparison (compute/sweeps.py `append_fisher_col`).
"""

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
    lane's steps, both sides (the work csrc/fisher_bracket.cu does). The
    first two are the JAX package's fisher_bracket contract."""
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
