"""Exact LD statistics from integer contingency counts (host, float64).

Vectorized numpy reimplementation of the reference per-pair math:
- phased 2x2 haplotype table -> D, D', r2, Fisher P, flags
  (reference: lib/ld/ld_engine.cpp:1162-1259 PhasedMath)
- unphased 3x3 genotype table -> cubic-EM f11 estimate -> same stats
  (reference: lib/ld/ld_engine.cpp:1312-1740 UnphasedMath /
   ChiSquaredUnphasedTable / ChooseF11Calculate)

The device kernels produce exact integer counts; this module turns the
(already compacted) survivors into TWO records, applying the reference's
filters in the reference's order so outputs match within 1e-5.
"""

import os
import threading
from dataclasses import dataclass

import numpy as np

from .fisher import fisher_exact_two_sided
from ..io.constants import (
    ALLOWED_ROUNDING_ERROR, FLAG_COMPLETE_LD, FLAG_INVALID_HWE_A,
    FLAG_INVALID_HWE_B, FLAG_LONG_RANGE, FLAG_LOW_AC_A, FLAG_LOW_AC_B,
    FLAG_MISSING_A, FLAG_MISSING_B, FLAG_MULTIPLE_ROOTS, FLAG_PERFECT_LD,
    FLAG_SAME_CONTIG, FLAG_USED_PHASED_MATH, INVALID_HWE_THRESHOLD,
    LONG_RANGE_THRESHOLD, LOW_AC_THRESHOLD, MINIMUM_ALLOWED_ALLELES,
)
from ..io.two import TWO_DTYPE, concat_records


@dataclass
class LdFilters:
    min_p: float = 1.0
    min_r2: float = 0.1
    max_r2: float = 100.0
    min_dprime: float = 0.0
    max_dprime: float = 100.0


@dataclass
class PairMeta:
    """Per-pair variant metadata (arrays of length K)."""
    pos_a: np.ndarray
    pos_b: np.ndarray
    rid_a: np.ndarray
    rid_b: np.ndarray
    ac_a: np.ndarray
    ac_b: np.ndarray
    an_a: np.ndarray      # missing-allele counts
    an_b: np.ndarray
    hwe_a: np.ndarray
    hwe_b: np.ndarray


def _common_flags(meta: PairMeta, r2, cnt, used_phased) -> np.ndarray:
    flags = np.zeros(len(r2), np.uint16)
    flags |= np.where(used_phased, FLAG_USED_PHASED_MATH, 0).astype(np.uint16)
    same = meta.rid_a == meta.rid_b
    flags |= np.where(same, FLAG_SAME_CONTIG, 0).astype(np.uint16)
    diff = np.abs(meta.pos_a.astype(np.int64) - meta.pos_b.astype(np.int64))
    flags |= np.where(same & (diff > LONG_RANGE_THRESHOLD),
                      FLAG_LONG_RANGE, 0).astype(np.uint16)
    flags |= np.where((cnt < 1).any(axis=1),
                      FLAG_COMPLETE_LD, 0).astype(np.uint16)
    flags |= np.where(r2 > 0.99, FLAG_PERFECT_LD, 0).astype(np.uint16)
    flags |= np.where(meta.an_a > 0, FLAG_MISSING_A, 0).astype(np.uint16)
    flags |= np.where(meta.an_b > 0, FLAG_MISSING_B, 0).astype(np.uint16)
    flags |= np.where(meta.ac_a < LOW_AC_THRESHOLD,
                      FLAG_LOW_AC_A, 0).astype(np.uint16)
    flags |= np.where(meta.ac_b < LOW_AC_THRESHOLD,
                      FLAG_LOW_AC_B, 0).astype(np.uint16)
    flags |= np.where(meta.hwe_a < INVALID_HWE_THRESHOLD,
                      FLAG_INVALID_HWE_A, 0).astype(np.uint16)
    flags |= np.where(meta.hwe_b < INVALID_HWE_THRESHOLD,
                      FLAG_INVALID_HWE_B, 0).astype(np.uint16)
    return flags


def _assemble(keep, meta, flags, cnt, D, Dprime, R, R2, P, chisq_fisher,
              chisq_model=None):
    idx = np.flatnonzero(keep)
    recs = np.zeros(len(idx), TWO_DTYPE)
    recs["controller"] = flags[idx]
    recs["ridA"] = meta.rid_a[idx]
    recs["ridB"] = meta.rid_b[idx]
    recs["packA"] = meta.pos_a[idx].astype(np.uint32) << 2
    recs["packB"] = meta.pos_b[idx].astype(np.uint32) << 2
    recs["cnt"] = cnt[idx]
    recs["D"] = D[idx]
    recs["Dprime"] = Dprime[idx]
    recs["R"] = R[idx]
    recs["R2"] = R2[idx]
    recs["P"] = P[idx]
    recs["ChiSqFisher"] = chisq_fisher[idx]
    # the chosen EM root's goodness-of-fit chi-squared for unphased
    # records; 0 for phased/folded ones. The reference COMPUTES this
    # (ld_engine.cpp:1462-1532) but then dead-stores 0 over it in
    # ChooseF11Calculate (ld_engine.cpp:1670), so its emitted field is
    # always 0; we deliberately emit the documented value instead.
    recs["ChiSqModel"] = 0.0 if chisq_model is None else chisq_model[idx]
    return recs, idx


# reusable per-thread output scratch for the native record pipeline:
# fresh multi-hundred-MB numpy allocations page-fault pathologically on
# this class of host (see io/two.concat_records notes), and TwoWriter
# retains no reference to what emit() hands it
_scratch = threading.local()


def _record_scratch(K: int):
    bufs = getattr(_scratch, "bufs", None)
    if bufs is None or len(bufs[2]) < K:
        cap = 1 << 14
        while cap < K:
            cap *= 2
        bufs = (np.empty(cap, TWO_DTYPE), np.empty(cap, TWO_DTYPE),
                np.empty(cap, np.int64))
        _scratch.bufs = bufs
    return bufs


def native_params(filt: LdFilters) -> np.ndarray:
    """The TwkLdParams float64 vector the native kernels consume:
    filters + flag thresholds, so io/constants.py stays the single
    source of truth (layout: native/twk_native.cpp TwkLdParams)."""
    return np.array([filt.min_p, filt.min_r2, filt.max_r2,
                     filt.min_dprime, filt.max_dprime,
                     LONG_RANGE_THRESHOLD, INVALID_HWE_THRESHOLD,
                     LOW_AC_THRESHOLD, MINIMUM_ALLOWED_ALLELES],
                    np.float64)


def ld_records(table: str, data: np.ndarray, meta: PairMeta,
               filt: LdFilters, n_threads: int = 0, p_pre=None):
    """The whole survivor -> record pipeline (filters, Fisher, flags,
    fwd + reverse-orientation assembly) in ONE native batch call.
    `table` is "phased" (data [K, 4] haplotype counts) or "unphased"
    (data [K, 9] or [K, 3, 3] genotype tables). `p_pre` (f64 [K],
    optional) carries in-sweep Fisher P values from the device bracket
    epilogue (ops/fisher_dev.py); NaN rows fall back to the exact
    native scan. Returns (fwd, rev, kept_idx) -- views into reusable
    per-thread scratch, valid until the next call on this thread -- or
    None when the native library is unavailable (callers fall back to
    phased_math / unphased_math)."""
    from ..native import ld_records as native_ld_records
    K = len(data)
    fwd, rev, idx = _record_scratch(K)
    params = native_params(filt)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    n = native_ld_records(0 if table == "phased" else 1,
                          np.ascontiguousarray(data, np.int64),
                          meta, params, fwd, rev, idx, n_threads,
                          p_pre=p_pre)
    if n is None:
        return None
    return fwd[:n], rev[:n], idx[:n]


def phased_math(counts: np.ndarray, meta: PairMeta, filt: LdFilters):
    """Phased LD from 2x2 haplotype counts.

    counts: [K, 4] int64 in order (REFREF, REFALT, ALTREF, ALTALT) --
    the natural (hapA, hapB) table order. Returns (records, kept_idx).
    Dispatches to the native batched pipeline; the body below is the
    always-available numpy fallback."""
    out = ld_records("phased", np.asarray(counts, np.int64), meta, filt)
    if out is not None:
        return out[0].copy(), out[2].copy()
    return _phased_math_numpy(counts, meta, filt)


def _phased_math_numpy(counts: np.ndarray, meta: PairMeta,
                       filt: LdFilters):
    c = counts.astype(np.float64)
    refref, refalt, altref, altalt = c[:, 0], c[:, 1], c[:, 2], c[:, 3]
    t = refref + refalt + altref + altalt
    keep = t >= MINIMUM_ALLOWED_ALLELES

    # rarer-corner guard (reference: ld_engine.cpp:1174-1186)
    lo_rr = refref < altalt
    guard = np.where(lo_rr, refalt + altref + refref, altalt + refalt + altref)
    keep &= guard >= 5

    with np.errstate(divide="ignore", invalid="ignore"):
        ts = np.where(t > 0, t, 1.0)
        pA = refref / ts
        qA = altref / ts
        pB = refalt / ts
        qB = altalt / ts
        D = pA * qB - qA * pB
        keep &= D != 0.0

        g0 = (refref + refalt) / ts   # freq(ref) at A
        g1 = (altref + altalt) / ts
        h0 = (refref + altref) / ts   # freq(ref) at B
        h1 = (refalt + altalt) / ts
        denom = g0 * g1 * h0 * h1
        R2 = np.where(denom > 0, D * D / np.where(denom > 0, denom, 1.0),
                      np.inf)
        keep &= (R2 >= filt.min_r2) & (R2 <= filt.max_r2)

        dmax = np.where(D >= 0, np.minimum(g0 * h1, h0 * g1),
                        -np.minimum(g0 * g1, h0 * h1))
        Dprime = np.where(dmax != 0, D / np.where(dmax != 0, dmax, 1.0), 0.0)
        keep &= (Dprime >= filt.min_dprime) & (Dprime <= filt.max_dprime)

    # Fisher exact only for pairs still alive (it is the expensive part)
    P = np.ones(len(t), np.float64)
    alive = np.flatnonzero(keep)
    if len(alive):
        P[alive] = fisher_exact_two_sided(
            counts[alive, 0], counts[alive, 1],
            counts[alive, 2], counts[alive, 3])
    keep &= P <= filt.min_p

    R = np.sqrt(np.maximum(R2, 0.0))
    chisq_fisher = t * R2
    # output cnt order is (REFREF, ALTREF, REFALT, ALTALT)
    # (reference: TWK_LD_SIMD_* accessor order, ld_engine.cpp:1239-1242)
    cnt_out = np.stack([refref, altref, refalt, altalt], axis=1)

    flags = _common_flags(meta, R2, cnt_out, used_phased=np.ones(len(t), bool))
    return _assemble(keep, meta, flags, cnt_out, D, Dprime, R, R2, P,
                     chisq_fisher)


def _chisq_unphased_table(T: np.ndarray, n: np.ndarray, f11, p, q):
    """Goodness-of-fit chi-square of the 3x3 observed table against the
    expected table implied by haplotype frequency f11, accumulated cell
    by cell in the reference's order
    (reference: ld_engine.cpp:1562-1588)."""
    f12 = p - f11
    f21 = q - f11
    f22 = 1.0 - (f11 + f12 + f21)
    cells = (
        (T[..., 0, 0], n * f11 ** 2),                        # 1111
        (T[..., 0, 1], 2 * n * f11 * f12),                   # 1112
        (T[..., 0, 2], n * f12 ** 2),                        # 1122
        (T[..., 1, 0], 2 * n * f11 * f21),                   # 1211
        (T[..., 1, 1], 2 * n * f12 * f21 + 2 * n * f11 * f22),  # 1212
        (T[..., 1, 2], 2 * n * f12 * f22),                   # 1222
        (T[..., 2, 0], n * f21 ** 2),                        # 2211
        (T[..., 2, 1], 2 * n * f21 * f22),                   # 2212
        (T[..., 2, 2], n * f22 ** 2),                        # 2222
    )
    chi = np.zeros(np.shape(f11), np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        for obs, e in cells:
            chi += np.where(e > 0, (obs - e) ** 2 / np.where(e > 0, e, 1.0),
                            0.0)
    return chi


def solve_unphased_f11(T: np.ndarray):
    """Cubic-equation ML estimate of the (ref_A, ref_B) haplotype
    frequency from a 3x3 genotype table (rows = A genotype 0/1/2 alt
    alleles, cols = B genotype). Returns (f11, p, q, n, valid,
    multiple_roots) with n = number of fully-called samples.

    Mirrors the reference case analysis exactly, including its
    C-operator-precedence quirk in the degenerate (yN2 == h2) case
    (reference: ld_engine.cpp:1363-1558). Dispatches to the native
    batched solver (twk_native.cpp twk_unphased_em, ~130x this numpy
    path; same expression order with fp contraction off, but libm vs
    numpy-SIMD differences still leave a ~0.0005% rate of last-ulp
    chi ties / boundary flips between the two -- the authoritative
    parity contract is the golden suite against the reference binary,
    not native==numpy bit identity). This body is the always-available
    fallback."""
    from ..native import unphased_em as native_em
    out = native_em(np.asarray(T, np.int64))
    if out is not None:
        return out
    return _solve_unphased_f11_numpy(T)


def _solve_unphased_f11_numpy(T: np.ndarray):
    T = T.astype(np.float64)
    n = T.sum(axis=(1, 2))
    ns = np.where(n > 0, n, 1.0)
    rowsum = T.sum(axis=2)   # [K,3] per A-genotype
    colsum = T.sum(axis=1)
    p = (2 * rowsum[:, 0] + rowsum[:, 1]) / (2 * ns)   # freq ref at A
    q = (2 * colsum[:, 0] + colsum[:, 1]) / (2 * ns)
    n11 = 2 * T[:, 0, 0] + T[:, 0, 1] + T[:, 1, 0]
    ndh = T[:, 1, 1]                                   # double hets
    minhap = n11 / (2 * ns)
    maxhap = (n11 + ndh) / (2 * ns)

    a = 4.0 * n
    b = 2.0 * n * (1.0 - 2.0 * p - 2.0 * q) - 2.0 * n11 - ndh
    c = -n11 * (1.0 - 2.0 * p - 2.0 * q) - ndh * (1.0 - p - q) \
        + 2.0 * n * p * q
    dee = -n11 * p * q

    with np.errstate(divide="ignore", invalid="ignore"):
        a_s = np.where(a != 0, a, 1.0)
        xN = -b / (3.0 * a_s)
        d2 = (b ** 2 - 3.0 * a_s * c) / (9.0 * a_s ** 2)
        yN = a * xN ** 3 + b * xN ** 2 + c * xN + dee
        yN2 = yN ** 2
        h2 = 4.0 * a ** 2 * d2 ** 3
        diff = yN2 - h2

        K = len(n)
        roots = np.full((K, 3), np.nan)

        # case 1: three real roots (diff < 0)
        m1 = diff < 0
        if m1.any():
            h = np.sqrt(np.where(m1, h2, 1.0))
            # NO clamp: when rounding pushes |yN/h| past 1 the
            # reference gets acos(>1) = NaN roots and DROPS the pair
            # (ld_engine.cpp:1444); clipping would emit an extra record
            theta = np.arccos(-yN / np.where(h != 0, h, 1.0)) / 3.0
            delta = np.sqrt(np.where(m1, np.maximum(d2, 0.0), 0.0))
            roots[m1, 0] = (xN + 2.0 * delta * np.cos(theta))[m1]
            roots[m1, 1] = (xN + 2.0 * delta *
                            np.cos(2.0 * np.pi / 3.0 + theta))[m1]
            roots[m1, 2] = (xN + 2.0 * delta *
                            np.cos(4.0 * np.pi / 3.0 + theta))[m1]

        # case 2: one real root (diff > 0)
        m2 = diff > 0
        if m2.any():
            s = np.sqrt(np.where(m2, diff, 0.0))
            u = (1.0 / (2.0 * a_s)) * (-yN + s)
            v = (1.0 / (2.0 * a_s)) * (-yN - s)
            number1 = np.sign(u) * np.abs(u) ** (1.0 / 3.0)
            number2 = np.sign(v) * np.abs(v) ** (1.0 / 3.0)
            roots[m2, 0] = (xN + number1 + number2)[m2]

        # case 3: degenerate (diff == 0); reference computes
        # pow(yN/2*a, 1/3) which is (yN*a/2)^(1/3) due to precedence and
        # yields NaN for negative operands -> pair dropped, mirrored here.
        m3 = diff == 0
        if m3.any():
            operand = yN / 2.0 * a
            delta = np.where(operand >= 0, operand ** (1.0 / 3.0), np.nan)
            roots[m3, 0] = (xN + delta)[m3]
            roots[m3, 2] = (xN - 2.0 * delta)[m3]

    lo = minhap - ALLOWED_ROUNDING_ERROR
    hi = maxhap + ALLOWED_ROUNDING_ERROR
    possible = (~np.isnan(roots)) & (roots >= lo[:, None]) & \
        (roots <= hi[:, None])
    n_possible = possible.sum(axis=1)

    # score every admissible (pair, root) entry in one flat gathered
    # pass: no [K,3,3] boolean-subset copies, one chi accumulation
    chis = np.full((K, 3), np.inf)
    idx, rno = np.nonzero(possible)
    if len(idx):
        chis[idx, rno] = _chisq_unphased_table(
            T[idx], n[idx], roots[idx, rno], p[idx], q[idx])
    best = np.argmin(chis, axis=1)
    f11 = roots[np.arange(K), best]
    chi_model = chis[np.arange(K), best]
    chi_model = np.where(np.isfinite(chi_model), chi_model, 0.0)
    valid = n_possible > 0
    # the reference flags MultipleRoots only in the three-real-root and
    # (vacuously) single-root cases; its degenerate yN2 == h2 branch
    # never sets it even when both alpha and gamma are admissible
    # (ld_engine.cpp:1523-1558 lacks the SetMultipleRoots call the
    # diff < 0 branch has at :1492-1493)
    multiple = (n_possible > 1) & ~m3
    return f11, p, q, n, valid, multiple, chi_model


def unphased_math(T: np.ndarray, meta: PairMeta, filt: LdFilters):
    """Unphased LD from 3x3 genotype tables [K, 3, 3] (rows: A genotype
    ref/het/alt; cols: B). Dispatches pairs without double-hets through
    the phased fold (reference: ld_engine.cpp:1334-1348). Records come
    back in input row order. Dispatches to the native batched pipeline;
    _unphased_math_numpy is the always-available fallback."""
    T = np.asarray(T, np.int64)
    out = ld_records("unphased", T, meta, filt)
    if out is not None:
        return out[0].copy()
    return _unphased_math_numpy(T, meta, filt)


def _unphased_math_numpy(T: np.ndarray, meta: PairMeta,
                         filt: LdFilters):
    n = T.sum(axis=(1, 2))
    ndh = T[:, 1, 1]

    # minimum-sample gate applies before the fold
    # (reference: ld_engine.cpp:1321-1324)
    enough = n >= MINIMUM_ALLOWED_ALLELES
    # fold: no phase uncertainty
    fold = (ndh == 0) & enough
    rec_parts = []
    row_parts = []
    if fold.any():
        Tf = T[fold].astype(np.int64)
        refref = 2 * Tf[:, 0, 0] + Tf[:, 0, 1] + Tf[:, 1, 0]
        refalt = 2 * Tf[:, 0, 2] + Tf[:, 0, 1] + Tf[:, 1, 2]
        altref = 2 * Tf[:, 2, 0] + Tf[:, 1, 0] + Tf[:, 2, 1]
        altalt = 2 * Tf[:, 2, 2] + Tf[:, 2, 1] + Tf[:, 1, 2]
        counts = np.stack([refref, refalt, altref, altalt], axis=1)
        meta_f = _meta_subset(meta, fold)
        recs, idx = _phased_math_numpy(counts, meta_f, filt)
        rec_parts.append(recs)
        row_parts.append(np.flatnonzero(fold)[idx])

    em = (ndh != 0) & enough
    if em.any():
        Te = T[em]
        meta_e = _meta_subset(meta, em)
        (f11, p, q, ne, valid, multiple,
         chi_model) = solve_unphased_f11(Te)
        recs, idx = _choose_f11_records(Te, meta_e, filt, f11, p, q, ne,
                                        valid, multiple, chi_model)
        rec_parts.append(recs)
        row_parts.append(np.flatnonzero(em)[idx])

    if not rec_parts:
        return np.zeros(0, TWO_DTYPE)
    # restore input row order (= the native pipeline's output order)
    recs = concat_records(rec_parts)
    order = np.argsort(np.concatenate(row_parts), kind="stable")
    return recs[order]


def _meta_subset(meta: PairMeta, mask) -> PairMeta:
    return PairMeta(**{k: getattr(meta, k)[mask]
                       for k in PairMeta.__dataclass_fields__})


def _choose_f11_records(T, meta, filt, f11, p, q, n, valid, multiple,
                        chi_model=None):
    """Statistics from the chosen root
    (reference: ld_engine.cpp:1590-1740 ChooseF11Calculate)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        f12 = p - f11
        f21 = q - f11
        f22 = 1.0 - (f11 + f12 + f21)
        D = f11 * f22 - f12 * f21
        denom = p * (1 - p) * q * (1 - q)
        R2 = np.where(denom > 0, D * D / np.where(denom > 0, denom, 1.0),
                      np.inf)
        keep = valid & (R2 >= filt.min_r2) & (R2 <= filt.max_r2)

        two_n = 2.0 * n
        cnt = np.stack([f11 * two_n, f12 * two_n,
                        f21 * two_n, f22 * two_n], axis=1)
        # rarer-corner guard on estimated haplotype counts
        lo_rr = cnt[:, 0] < cnt[:, 3]
        guard = np.where(lo_rr, cnt[:, 1] + cnt[:, 2] + cnt[:, 0],
                         cnt[:, 3] + cnt[:, 1] + cnt[:, 2])
        keep &= guard >= 5

        dmax = np.where(D >= 0, np.minimum(p * (1 - q), q * (1 - p)),
                        -np.minimum(p * q, (1 - p) * (1 - q)))
        Dprime = np.where(dmax != 0, D / np.where(dmax != 0, dmax, 1.0), 0.0)
        keep &= (Dprime >= filt.min_dprime) & (Dprime <= filt.max_dprime)

    P = np.ones(len(n), np.float64)
    alive = np.flatnonzero(keep)
    if len(alive):
        # C round() semantics: half away from zero (counts are >= 0)
        rc = np.floor(cnt[alive] + 0.5).astype(np.int64)
        P[alive] = fisher_exact_two_sided(rc[:, 0], rc[:, 1],
                                          rc[:, 2], rc[:, 3])
    keep &= P <= filt.min_p

    R = np.sqrt(np.maximum(R2, 0.0))
    chisq_fisher = cnt.sum(axis=1) * R2
    # cnt output order (REFREF, ALTREF, REFALT, ALTALT): SIMD accessor
    # order maps f12 (REFALT) to slot 2 and f21 (ALTREF) to slot 1
    cnt_out = np.stack([cnt[:, 0], cnt[:, 2], cnt[:, 1], cnt[:, 3]], axis=1)

    flags = _common_flags(meta, R2, cnt_out,
                          used_phased=np.zeros(len(n), bool))
    flags |= np.where(multiple, FLAG_MULTIPLE_ROOTS, 0).astype(np.uint16)
    return _assemble(keep, meta, flags, cnt_out, D, Dprime, R, R2, P,
                     chisq_fisher, chisq_model=chi_model)
