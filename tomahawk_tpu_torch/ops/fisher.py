"""Two-sided Fisher's exact test for 2x2 tables, vectorized.

Reproduces the tail semantics of the reference's kt_fisher_exact
(reference: lib/fisher_math.cpp:231-267, htslib-derived): the left tail
accumulates pmf(k) from kmin upward while pmf(k) < 0.99999999*q, then
includes the stopping point if pmf < 1.00000001*q; the right tail
mirrors this from kmax downward; two = min(left + right, 1). Because the
hypergeometric pmf is unimodal in k these scans are prefix/suffix sums,
which we evaluate with cumulative masks in log-space (gammaln), fully
vectorized across tables.
"""

import numpy as np
from scipy.special import gammaln


def _lbinom(n, k):
    return gammaln(n + 1.0) - gammaln(k + 1.0) - gammaln(n - k + 1.0)


def fisher_exact_two_sided(n11, n12, n21, n22,
                           max_chunk_elems: int = 8_000_000) -> np.ndarray:
    """Two-sided Fisher exact p for each table. Inputs are integer arrays
    of identical shape; returns float64 p-values."""
    n11 = np.atleast_1d(np.asarray(n11, np.int64))
    n12 = np.atleast_1d(np.asarray(n12, np.int64))
    n21 = np.atleast_1d(np.asarray(n21, np.int64))
    n22 = np.atleast_1d(np.asarray(n22, np.int64))

    # native O(range)-scan fast path (twk_native.cpp twk_fisher_exact)
    from ..native import fisher_exact as native_fisher
    res = native_fisher(n11, n12, n21, n22)
    if res is not None:
        return res

    n1_ = n11 + n12
    n_1 = n11 + n21
    n = n11 + n12 + n21 + n22
    kmin = np.maximum(0, n1_ + n_1 - n)
    kmax = np.minimum(n1_, n_1)
    rng = kmax - kmin

    out = np.ones(n11.shape, np.float64)
    todo = np.flatnonzero(rng > 0)
    if len(todo) == 0:
        return out

    # group tables by range so the padded grid stays small
    order = todo[np.argsort(rng[todo], kind="stable")]
    start = 0
    while start < len(order):
        width = int(rng[order[start]]) + 1
        # grow chunk while total padded size is acceptable
        stop = start
        while stop < len(order):
            width = int(rng[order[stop]]) + 1
            if (stop - start + 1) * width > max_chunk_elems and stop > start:
                break
            stop += 1
        sel = order[start:stop]
        out[sel] = _fisher_chunk(n11[sel], n1_[sel], n_1[sel], n[sel],
                                 kmin[sel], kmax[sel])
        start = stop
    return out


def _fisher_chunk(n11, n1_, n_1, n, kmin, kmax):
    width = int((kmax - kmin).max()) + 1
    k = kmin[:, None] + np.arange(width, dtype=np.int64)[None, :]
    in_range = k <= kmax[:, None]
    kc = np.minimum(k, kmax[:, None])
    logpmf = (_lbinom(n1_[:, None], kc)
              + _lbinom((n - n1_)[:, None], n_1[:, None] - kc)
              - _lbinom(n[:, None], n_1[:, None]))
    pmf = np.where(in_range, np.exp(logpmf), 0.0)

    obs_col = (n11 - kmin)[:, None]
    q = np.take_along_axis(pmf, obs_col, axis=1)

    lo, hi = 0.99999999 * q, 1.00000001 * q

    # left prefix: strictly below lo until first violation
    below = pmf < lo
    prefix = np.cumprod(below, axis=1).astype(bool)
    left = np.where(prefix, pmf, 0.0).sum(axis=1)
    # boundary term: first non-prefix position, include if pmf < hi
    first_stop = prefix.sum(axis=1)
    has_stop = first_stop < width
    fs = np.minimum(first_stop, width - 1)[:, None]
    stop_pmf = np.take_along_axis(pmf, fs, axis=1)[:, 0]
    stop_in = np.take_along_axis(in_range, fs, axis=1)[:, 0]
    add = has_stop & stop_in & (stop_pmf < hi[:, 0])
    left = left + np.where(add, stop_pmf, 0.0)

    # right suffix: same from the top end
    rbelow = np.where(in_range, below, True)
    suffix = np.cumprod(rbelow[:, ::-1], axis=1)[:, ::-1].astype(bool)
    right = np.where(suffix & in_range, pmf, 0.0).sum(axis=1)
    last_stop = width - 1 - suffix[:, ::-1].sum(axis=1)
    # position of the first violation scanning downward
    has_stop_r = last_stop >= 0
    ls = np.maximum(last_stop, 0)[:, None]
    stop_pmf_r = np.take_along_axis(pmf, ls, axis=1)[:, 0]
    stop_in_r = np.take_along_axis(in_range, ls, axis=1)[:, 0]
    add_r = has_stop_r & stop_in_r & (stop_pmf_r < hi[:, 0])
    right = right + np.where(add_r, stop_pmf_r, 0.0)

    return np.minimum(left + right, 1.0)
