"""The plain reference: every pair of a tile, from the packed planes the
benchmark drew, to the records the port's `calc` must write for it.

Plain PyTorch (it runs on the card or on the CPU). It imports nothing of
the port and takes nothing the port made: it unpacks the benchmark's own
planes, counts every pair's contingency table with float32 matrix
products of 0/1 matrices (exact: every count is below 2**24, and TF32 is
off), and works the statistics out in `dtype`. The statistics follow the
reference tool's per-pair math as documented there (tomahawk
lib/ld/ld_engine.cpp: PhasedMath 1162-1259, UnphasedMath and its cubic
estimate 1312-1740; the two-sided Fisher test of lib/fisher_math.cpp
231-267): the minimum-allele gate, the rarer-corner guard, D, D', r2
(r2 >= min_r2 kept), R = sqrt(r2), chi-squared = total x r2, and Fisher
P from the counts (unphased: from the estimated counts rounded half up).

Besides the kept pairs it returns the pairs whose keep decision or whose
numbers sit on a rounding edge ("ties"): a value within `TIE` (relative)
of a threshold or of a case boundary of the cubic, where two correct
float64 programs may decide apart. The comparison leaves those out.
"""

import math

import torch

#: relative distance to a threshold or case boundary that counts as a tie
TIE = 1e-9
#: the same for what the cubic estimate gives (r2, the rarer-corner
#: guard; counts rounded for Fisher, absolute): near a double root, which
#: a rare variant makes common, a float64 root is good to ~sqrt(2**-52) =
#: 1.5e-8 only, and two sound programs' estimated counts differ by ~2e-8
TIE_EM = 1e-6
#: smallest variants a table must hold (the tool's MINIMUM_ALLOWED_ALLELES)
MIN_ALLELES = 5
#: the cubic's admissibility slack (the tool's ALLOWED_ROUNDING_ERROR)
ROOT_SLACK = 1e-5
#: rows of a tile worked at once
ROWS = 1024


def unpack(words, n_bits: int) -> torch.Tensor:
    """uint32 words (any integer tensor) [n, W] -> float32 0/1 [n, n_bits]."""
    w = torch.as_tensor(words).to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, device=w.device, dtype=torch.int64)
    bits = (w.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(w.shape[0], -1)[:, :n_bits].to(torch.float32)


def _mm(a, b):
    """Exact 0/1 count products: float32, TF32 off."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _lbinom(n, k):
    return torch.lgamma(n + 1) - torch.lgamma(k + 1) - torch.lgamma(n - k + 1)


def fisher(n11, n12, n21, n22, dtype=torch.float64, chunk=1 << 24):
    """Two-sided Fisher exact P of 2x2 tables (integer tensors): the
    htslib kt_fisher_exact tails. The left tail sums the probabilities
    from the lowest table up while each is below 0.99999999 of the
    observed one's, and takes the first one past that if it is below
    1.00000001 of it; the right tail does the same from the highest
    table down; P = min(left + right, 1)."""
    n11, n12, n21, n22 = (torch.as_tensor(x).to(torch.int64)
                          for x in (n11, n12, n21, n22))
    n1_, n_1 = n11 + n12, n11 + n21
    n = n1_ + n21 + n22
    kmin = torch.clamp(n1_ + n_1 - n, min=0)
    kmax = torch.minimum(n1_, n_1)
    out = torch.ones(n11.shape, dtype=dtype, device=n11.device)
    width = kmax - kmin + 1
    todo = torch.nonzero(width > 1).flatten()
    if len(todo) == 0:
        return out
    order = todo[torch.argsort(width[todo])]
    wo = width[order].cpu().tolist()
    start = 0
    while start < len(order):
        stop = start + 1
        while stop < len(order) and (stop + 1 - start) * wo[stop] <= chunk:
            stop += 1
        sel = order[start:stop]
        w = wo[stop - 1]
        k = kmin[sel, None] + torch.arange(w, device=n11.device)
        in_range = k <= kmax[sel, None]
        kc = torch.minimum(k, kmax[sel, None]).to(dtype)
        a, b, c = (x[sel, None].to(dtype) for x in (n1_, n_1, n))
        pmf = torch.exp(_lbinom(a, kc) + _lbinom(c - a, b - kc)
                        - _lbinom(c, b))
        pmf = torch.where(in_range, pmf, torch.zeros_like(pmf))
        q = torch.gather(pmf, 1, (n11[sel] - kmin[sel])[:, None])
        lo, hi = 0.99999999 * q, 1.00000001 * q
        below = pmf < lo
        prefix = torch.cumprod(below.to(torch.int32), 1).bool()
        left = torch.where(prefix, pmf, torch.zeros_like(pmf)).sum(1)
        first = prefix.sum(1)
        fs = torch.clamp(first, max=w - 1)[:, None]
        spmf = torch.gather(pmf, 1, fs)[:, 0]
        sin = torch.gather(in_range, 1, fs)[:, 0]
        left = left + torch.where((first < w) & sin & (spmf < hi[:, 0]),
                                  spmf, torch.zeros_like(spmf))
        rbelow = torch.where(in_range, below, torch.ones_like(below))
        suffix = torch.flip(torch.cumprod(torch.flip(rbelow, [1]).to(
            torch.int32), 1), [1]).bool()
        right = torch.where(suffix & in_range, pmf,
                            torch.zeros_like(pmf)).sum(1)
        last = w - 1 - suffix.sum(1)
        ls = torch.clamp(last, min=0)[:, None]
        rpmf = torch.gather(pmf, 1, ls)[:, 0]
        rin = torch.gather(in_range, 1, ls)[:, 0]
        right = right + torch.where((last >= 0) & rin & (rpmf < hi[:, 0]),
                                    rpmf, torch.zeros_like(rpmf))
        out[sel] = torch.clamp(left + right, max=1.0)
        start = stop
    return out


def _near(x, edge, tol=TIE):
    return (x - edge).abs() <= tol * abs(edge)


def _haplotype_stats(rr, ra, ar, aa, min_r2):
    """Statistics of 2x2 haplotype tables (REFREF, REFALT, ALTREF,
    ALTALT; float tensors of one dtype): (keep, tie, D, D', r2, t)."""
    t = rr + ra + ar + aa
    keep = t >= MIN_ALLELES
    guard = torch.where(rr < aa, ra + ar + rr, aa + ra + ar)
    keep &= guard >= 5
    ts = torch.where(t > 0, t, torch.ones_like(t))
    D = (rr / ts) * (aa / ts) - (ar / ts) * (ra / ts)
    keep &= D != 0
    g0, g1 = (rr + ra) / ts, (ar + aa) / ts
    h0, h1 = (rr + ar) / ts, (ra + aa) / ts
    den = g0 * g1 * h0 * h1
    r2 = torch.where(den > 0, D * D / torch.where(den > 0, den,
                                                  torch.ones_like(den)),
                     torch.full_like(den, math.inf))
    keep &= r2 >= min_r2
    tie = _near(r2, min_r2)
    dmax = torch.where(D >= 0, torch.minimum(g0 * h1, h0 * g1),
                       -torch.minimum(g0 * g1, h0 * h1))
    dp = torch.where(dmax != 0, D / torch.where(dmax != 0, dmax,
                                                torch.ones_like(dmax)),
                     torch.zeros_like(D))
    keep &= dp >= 0
    return keep, tie, D, dp, r2, t


def _cbrt(x):
    return torch.sign(x) * x.abs() ** (1.0 / 3.0)


def _roots(xN, yN, a_s, a, d2, h2, diff, m1, m2, m3, clamp=False):
    """The cubic's roots [K, 3] (NaN where absent) by the tool's cases:
    three real roots where m1, one where m2, the degenerate case where
    m3. `clamp` keeps acos's argument in [-1, 1] (the tool does not)."""
    nan = torch.full_like(xN, math.nan)
    roots = torch.stack([nan, nan, nan], 1)
    h = torch.sqrt(torch.where(m1, h2, torch.ones_like(h2)))
    ratio = -yN / torch.where(h != 0, h, torch.ones_like(h))
    if clamp:
        ratio = torch.clamp(ratio, -1.0, 1.0)
    theta = torch.acos(ratio) / 3.0
    delta = torch.sqrt(torch.where(m1, torch.clamp(d2, min=0),
                                   torch.zeros_like(d2)))
    for r, shift in enumerate((0.0, 2.0 * math.pi / 3.0,
                               4.0 * math.pi / 3.0)):
        roots[:, r] = torch.where(m1, xN + 2.0 * delta * torch.cos(
            shift + theta), roots[:, r])
    s = torch.sqrt(torch.where(m2, torch.clamp(diff, min=0),
                               torch.zeros_like(diff)))
    u = (-yN + s) / (2.0 * a_s)
    v = (-yN - s) / (2.0 * a_s)
    roots[:, 0] = torch.where(m2, xN + _cbrt(u) + _cbrt(v), roots[:, 0])
    op = yN / 2.0 * a
    dl = torch.where(op >= 0, torch.clamp(op, min=0) ** (1.0 / 3.0), nan)
    roots[:, 0] = torch.where(m3, xN + dl, roots[:, 0])
    roots[:, 2] = torch.where(m3, xN - 2.0 * dl, roots[:, 2])
    return roots, ratio


def _pick(roots, lo, hi, T, p, q, n):
    """The admissible root with the least goodness-of-fit chi-squared:
    (f11, valid, chi [K, 3], admissible [K, 3])."""
    ok = torch.isfinite(roots) & (roots >= lo) & (roots <= hi)
    f = torch.where(ok, roots, torch.zeros_like(roots))
    P_, Q_, N_ = p[:, None], q[:, None], n[:, None]
    f12, f21 = P_ - f, Q_ - f
    f22 = 1.0 - (f + f12 + f21)
    expect = (N_ * f ** 2, 2 * N_ * f * f12, N_ * f12 ** 2,
              2 * N_ * f * f21, 2 * N_ * f12 * f21 + 2 * N_ * f * f22,
              2 * N_ * f12 * f22, N_ * f21 ** 2, 2 * N_ * f21 * f22,
              N_ * f22 ** 2)
    obs = T.reshape(-1, 9)
    chi = torch.zeros_like(roots)
    for cell, e in enumerate(expect):
        es = torch.where(e > 0, e, torch.ones_like(e))
        chi += torch.where(e > 0, (obs[:, cell, None] - e) ** 2 / es,
                           torch.zeros_like(e))
    chi = torch.where(ok, chi, torch.full_like(chi, math.inf))
    best = torch.argmin(chi, 1)
    return (torch.gather(roots, 1, best[:, None])[:, 0], ok.any(1), chi,
            ok)


def _cubic_f11(T, dtype):
    """The tool's cubic maximum-likelihood estimate of the (ref, ref)
    haplotype frequency from 3x3 genotype tables T [K, 3, 3] (rows: the
    A variant's alt alleles 0, 1, 2), with its case analysis (including
    the degenerate case's `yN / 2 * a`). Returns (f11, p, q, n, valid,
    tie).

    A table whose cubic sits within TIE of the boundary between one and
    three real roots (a near double root: common where one variant is
    rare) is evaluated by both cases, and by the three-root case with
    acos's argument clamped; it is a tie only where they choose
    differently."""
    T = T.to(dtype)
    n = T.sum((1, 2))
    ns = torch.where(n > 0, n, torch.ones_like(n))
    rows, cols = T.sum(2), T.sum(1)
    p = (2 * rows[:, 0] + rows[:, 1]) / (2 * ns)
    q = (2 * cols[:, 0] + cols[:, 1]) / (2 * ns)
    n11 = 2 * T[:, 0, 0] + T[:, 0, 1] + T[:, 1, 0]
    ndh = T[:, 1, 1]
    minhap, maxhap = n11 / (2 * ns), (n11 + ndh) / (2 * ns)
    a = 4.0 * n
    b = 2.0 * n * (1.0 - 2.0 * p - 2.0 * q) - 2.0 * n11 - ndh
    c = -n11 * (1.0 - 2.0 * p - 2.0 * q) - ndh * (1.0 - p - q) \
        + 2.0 * n * p * q
    dee = -n11 * p * q
    a_s = torch.where(a != 0, a, torch.ones_like(a))
    xN = -b / (3.0 * a_s)
    d2 = (b ** 2 - 3.0 * a_s * c) / (9.0 * a_s ** 2)
    yN = a * xN ** 3 + b * xN ** 2 + c * xN + dee
    yN2 = yN ** 2
    h2 = 4.0 * a ** 2 * d2 ** 3
    diff = yN2 - h2
    m1, m2, m3 = diff < 0, diff > 0, diff == 0
    args = (xN, yN, a_s, a, d2, h2, diff)
    lo = (minhap - ROOT_SLACK)[:, None]
    hi = (maxhap + ROOT_SLACK)[:, None]
    roots, ratio = _roots(*args, m1, m2, m3)
    f11, valid, chi, ok = _pick(roots, lo, hi, T, p, q, n)

    # ties: a root on an admissibility edge; two admissible roots that
    # fit alike; a near double root where the cases choose apart
    tie = ((((roots - lo).abs() <= TIE) | ((roots - hi).abs() <= TIE))
           & torch.isfinite(roots)).any(1)
    cs = torch.sort(chi, 1).values
    far = (roots[:, :, None] - roots[:, None, :]).abs().nan_to_num(1.0)
    distinct = (far + torch.eye(3, dtype=dtype, device=T.device)).amin(
        (1, 2)) > TIE
    tie |= torch.isfinite(cs[:, 1]) & distinct & (
        (cs[:, 1] - cs[:, 0]).abs() <= TIE * cs[:, 1].abs())
    near = (diff.abs() <= TIE * torch.maximum(yN2, h2.abs())) \
        | (m1 & ((ratio.abs() - 1.0).abs() <= TIE))
    if near.any():
        for m in ((near | m1) & ~m3, (near | m2) & ~m3):
            r_alt, _ = _roots(*args, m, ~m & ~m3, m3, clamp=True)
            f_alt, v_alt, _, _ = _pick(r_alt, lo, hi, T, p, q, n)
            tie |= near & ((v_alt != valid) | (
                valid & ((f_alt - f11).abs() > 1e-6)))
    return f11, p, q, n, valid, tie


def _assemble(sel, keep, tie, cnt, D, dp, r2, t, counts_for_p, dtype):
    """The kept pairs' fields, in the tool's record order, and the tied
    pairs' indices. `cnt` [K, 4] is REFREF, REFALT, ALTREF, ALTALT."""
    kept = torch.nonzero(keep).flatten()
    c = counts_for_p[kept]
    P = fisher(c[:, 0], c[:, 1], c[:, 2], c[:, 3], dtype=dtype)
    k = cnt[kept]
    return dict(
        idx=sel[kept],
        cnt=torch.stack([k[:, 0], k[:, 2], k[:, 1], k[:, 3]], 1),
        D=D[kept], Dprime=dp[kept], R2=r2[kept],
        R=torch.sqrt(torch.clamp(r2[kept], min=0)),
        ChiSqFisher=t[kept] * r2[kept], P=P, tie=sel[tie])


def phased_pairs(aa, ac_a, ac_b, n_hap, sel, min_r2, dtype):
    """Pairs `sel` (flat indices into [n_a, n_b]) of exact ALTALT counts
    `aa` (flat) and alt counts: the kept pairs' fields and the ties."""
    ia, ib = sel // len(ac_b), sel % len(ac_b)
    a = aa.to(dtype)
    ar = ac_a[ia].to(dtype) - a
    ra = ac_b[ib].to(dtype) - a
    rr = n_hap - ac_a[ia].to(dtype) - ac_b[ib].to(dtype) + a
    keep, tie, D, dp, r2, t = _haplotype_stats(rr, ra, ar, a, min_r2)
    cnt = torch.stack([rr, ra, ar, a], 1)
    return _assemble(sel, keep, tie, cnt, D, dp, r2, t,
                     cnt.round().to(torch.int64), dtype)


def unphased_pairs(T, sel, min_r2, dtype):
    """Pairs `sel` with genotype tables T [K, 3, 3] (integer): the tool's
    unphased math, the fold for tables without a double heterozygote,
    the cubic estimate for the others."""
    Tf = T.to(dtype)
    n = Tf.sum((1, 2))
    enough = n >= MIN_ALLELES
    fold = (T[:, 1, 1] == 0) & enough
    rr = 2 * Tf[:, 0, 0] + Tf[:, 0, 1] + Tf[:, 1, 0]
    ra = 2 * Tf[:, 0, 2] + Tf[:, 0, 1] + Tf[:, 1, 2]
    ar = 2 * Tf[:, 2, 0] + Tf[:, 1, 0] + Tf[:, 2, 1]
    aa = 2 * Tf[:, 2, 2] + Tf[:, 2, 1] + Tf[:, 1, 2]
    keep_f, tie_f, D_f, dp_f, r2_f, t_f = _haplotype_stats(rr, ra, ar, aa,
                                                           min_r2)
    cnt_f = torch.stack([rr, ra, ar, aa], 1)

    f11, p, q, ne, valid, tie_e = _cubic_f11(T, dtype)
    f12, f21 = p - f11, q - f11
    f22 = 1.0 - (f11 + f12 + f21)
    D_e = f11 * f22 - f12 * f21
    den = p * (1 - p) * q * (1 - q)
    r2_e = torch.where(den > 0, D_e * D_e / torch.where(
        den > 0, den, torch.ones_like(den)), torch.full_like(den, math.inf))
    keep_e = valid & (r2_e >= min_r2)
    tie_e |= _near(r2_e, min_r2, TIE_EM)
    two_n = 2.0 * ne
    cnt_e = torch.stack([f11 * two_n, f12 * two_n, f21 * two_n,
                         f22 * two_n], 1)
    guard = torch.where(cnt_e[:, 0] < cnt_e[:, 3],
                        cnt_e[:, 1] + cnt_e[:, 2] + cnt_e[:, 0],
                        cnt_e[:, 3] + cnt_e[:, 1] + cnt_e[:, 2])
    keep_e &= guard >= 5
    tie_e |= _near(guard, 5.0, TIE_EM)
    dmax = torch.where(D_e >= 0, torch.minimum(p * (1 - q), q * (1 - p)),
                       -torch.minimum(p * q, (1 - p) * (1 - q)))
    dp_e = torch.where(dmax != 0, D_e / torch.where(
        dmax != 0, dmax, torch.ones_like(dmax)), torch.zeros_like(D_e))
    keep_e &= dp_e >= 0
    # the estimated counts round half up for Fisher: a half is a tie
    frac = cnt_e - torch.floor(cnt_e)
    tie_e |= ((frac - 0.5).abs() <= TIE_EM).any(1)
    t_e = cnt_e.sum(1)

    em = (~fold) & enough
    pick = lambda x, y: torch.where(fold if x.dim() == 1 else fold[:, None],
                                    x, y)
    keep = (fold & keep_f) | (em & keep_e)
    tie = (fold & tie_f) | (em & tie_e)
    cnt = pick(cnt_f, cnt_e)
    for_p = pick(cnt_f, torch.floor(cnt_e + 0.5)).to(torch.int64)
    return _assemble(sel, keep, tie, cnt, pick(D_f, D_e), pick(dp_f, dp_e),
                     pick(r2_f, r2_e), pick(t_f, t_e), for_p, dtype)


def genotype_indicators(alt, valid_s):
    """0/1 float32 [n, N] of each genotype (0, 1, 2 alt alleles) among the
    called samples, from haplotype bits alt [n, 2N] and called [n, N]."""
    g = alt[:, 0::2] + alt[:, 1::2]
    return [((g == x) & (valid_s > 0)).to(torch.float32) for x in range(3)]


def tile(planes_i: dict, planes_j: dict, diag: bool, table: str,
         n_samples: int, min_r2: float, dtype=torch.float64) -> dict:
    """Every pair of one tile: rows of block i against rows of block j
    (only i < j on a diagonal tile). `planes_*` hold the block's words
    `alt_bits` (and for the unphased table `valid_bits`) as tensors on
    the device to work on, cut to the block's variants. Returns the kept
    pairs' fields (`idx`: row_i * n_j + row_j) and the tied pairs."""
    n_hap = 2 * n_samples
    A = unpack(planes_i["alt_bits"], n_hap)
    Bm = unpack(planes_j["alt_bits"], n_hap)
    n_i, n_j = len(A), len(Bm)
    if table == "unphased":
        IA = genotype_indicators(A, unpack(planes_i["valid_bits"], n_samples))
        IB = genotype_indicators(Bm, unpack(planes_j["valid_bits"],
                                            n_samples))
    ac_a, ac_b = A.sum(1), Bm.sum(1)
    dev = A.device
    parts = []
    for r0 in range(0, n_i, ROWS):
        r1 = min(n_i, r0 + ROWS)
        rows = torch.arange(r0, r1, device=dev)[:, None]
        cols = torch.arange(n_j, device=dev)[None, :]
        cand = (cols > rows) if diag else torch.ones(
            (r1 - r0, n_j), dtype=torch.bool, device=dev)
        sel = torch.nonzero(cand.flatten()).flatten()
        idx = r0 * n_j + sel
        if table == "phased":
            aa = _mm(A[r0:r1], Bm).flatten()[sel]
            parts.append(phased_pairs(aa.round().to(torch.int64), ac_a,
                                      ac_b, float(n_hap), idx, min_r2,
                                      dtype))
        else:
            T = torch.stack([_mm(IA[x][r0:r1], IB[y]).flatten()[sel]
                             for x in range(3) for y in range(3)], 1)
            parts.append(unphased_pairs(
                T.round().to(torch.int64).reshape(-1, 3, 3), idx, min_r2,
                dtype))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
