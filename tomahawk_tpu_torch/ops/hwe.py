"""Exact test of Hardy-Weinberg equilibrium (Wigginton et al. 2005).

Semantically equivalent to the reference's per-site implementation
(reference: lib/core.cpp:103-201 twk1_t::calculateHardyWeinberg), but
vectorized across sites: instead of the sequential recurrence over het
counts we evaluate the conditional distribution of heterozygote counts
in log-space and normalize, which is algebraically the same
distribution.

P(h hets | n genotypes, r rare copies) ∝ n! / (homr! h! homc!) * 2^h
with homr = (r - h)/2, homc = n - h - homr, over h with h ≡ r (mod 2).

Log-factorials come from a cached lookup table (one gammaln evaluation
per integer, ever) and sites are processed in rare-count-sorted chunks
so the [sites, het-support] work matrix is dense — a naive max-rare
sized matrix with per-element gammaln is ~100x slower at biobank
sample counts.
"""

import numpy as np
from scipy.special import gammaln

_LOG2 = np.log(2.0)
_LF = np.zeros(1, np.float64)          # _LF[k] = log(k!)


def _logfact(n_max: int) -> np.ndarray:
    global _LF
    if len(_LF) <= n_max:
        size = max(n_max + 1, 2 * len(_LF), 1024)
        _LF = gammaln(np.arange(size + 1, dtype=np.float64) + 1.0)
    return _LF


def hwe_exact(n_het, n_hom1, n_hom2, chunk_elements: int = 1 << 22
              ) -> np.ndarray:
    """Two-sided exact HWE p-value for each site.

    Args:
      n_het: observed heterozygote counts, shape [S]
      n_hom1, n_hom2: observed homozygote counts (either order), shape [S]
    Returns:
      p-values, shape [S], float64
    """
    n_het = np.atleast_1d(np.asarray(n_het, np.int64))
    n_hom1 = np.atleast_1d(np.asarray(n_hom1, np.int64))
    n_hom2 = np.atleast_1d(np.asarray(n_hom2, np.int64))

    # native O(rare)-recurrence fast path (twk_native.cpp twk_hwe_exact)
    from ..native import hwe_exact as native_hwe
    res = native_hwe(n_het, n_hom1, n_hom2)
    if res is not None:
        return res

    out = np.ones(n_het.shape, np.float64)
    homc = np.maximum(n_hom1, n_hom2)
    homr = np.minimum(n_hom1, n_hom2)
    rare = 2 * homr + n_het
    genot = n_het + homc + homr

    idx = np.flatnonzero(genot > 0)
    if len(idx) == 0:
        return out
    lf = _logfact(int(2 * genot.max()) + 2)
    # sort by rare-copy count so each chunk's support width matches its
    # sites; chunk size adapts to keep the work matrix bounded
    order = idx[np.argsort(rare[idx], kind="stable")]
    pos = 0
    while pos < len(order):
        rows = max(1, chunk_elements // (int(rare[order[pos]]) + 1))
        sel = order[pos:pos + rows]
        # the last (largest) rare count sets the actual support width;
        # shrink the block if that width blows the element budget (no
        # row floor: at biobank rare counts even a handful of rows is
        # hundreds of MB of [rows, rare+1] work matrix)
        rows = max(1, chunk_elements // (int(rare[sel[-1]]) + 1))
        sel = sel[:rows]
        out[sel] = _hwe_chunk(n_het[sel], rare[sel], genot[sel], lf)
        pos += len(sel)
    return out


def _hwe_chunk(obs_het, rare, genot, lf):
    smax = int(rare.max()) if len(rare) else 0
    # candidate het counts 0..rare with matching parity
    h = np.arange(smax + 1, dtype=np.int64)[None, :]        # [1, H]
    rare_c = rare[:, None].astype(np.int64)
    genot_c = genot[:, None].astype(np.int64)
    homr = (rare_c - h) // 2
    homc = genot_c - h - homr
    ok = (h <= rare_c) & ((h & 1) == (rare_c & 1)) & (homc >= 0)
    hs = np.where(ok, h, 0)
    homr_s = np.where(ok, homr, 0)
    homc_s = np.where(ok, homc, 0)
    logp = (lf[genot_c] - lf[hs] - lf[homr_s] - lf[homc_s] + hs * _LOG2)
    logp = np.where(ok, logp, -np.inf)
    # normalize per site
    m = logp.max(axis=1, keepdims=True)
    p = np.exp(logp - m)
    p /= p.sum(axis=1, keepdims=True)
    p_obs = np.take_along_axis(p, obs_het[:, None].astype(np.int64),
                               axis=1)
    # two-sided: sum of all outcomes no more probable than the observed
    # (reference: lib/core.cpp:186-195, het_probs[i] > het_probs[obs] skip)
    tail = np.where(p <= p_obs, p, 0.0).sum(axis=1)
    return np.minimum(tail, 1.0)
