"""Record-level filter chain for .two records.

Reimplements the reference's twk_two_filter predicate surface
(reference: include/two_reader.h:39-189): range filters on every
statistic, flag include/exclude masks, and the upper/lower triangular
selectors. Filters operate vectorized on structured record arrays.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class TwoFilter:
    # ranges [lo, hi] inclusive
    rid_a: Optional[tuple] = None
    rid_b: Optional[tuple] = None
    pos_a: Optional[tuple] = None
    pos_b: Optional[tuple] = None
    d: Optional[tuple] = None
    dprime: Optional[tuple] = None
    r: Optional[tuple] = None
    r2: Optional[tuple] = None
    p: Optional[tuple] = None
    chisq_fisher: Optional[tuple] = None
    chisq_model: Optional[tuple] = None
    # per-cell haplotype count ranges
    refref: Optional[tuple] = None
    refalt: Optional[tuple] = None
    altref: Optional[tuple] = None
    altalt: Optional[tuple] = None
    hap_min: float = 0.0          # minimum of any cell
    # non-major haplotype count: sum of all cells except the largest
    # (-a/-A minMHC/maxMHC; reference: two_reader.h:162-170 FilterMHC)
    mhc: Optional[tuple] = None
    # flag masks
    flag_include: int = 0
    flag_exclude: int = 0
    # triangular selectors
    upper_only: bool = False
    lower_only: bool = False

    def active(self) -> bool:
        return any(getattr(self, f) is not None for f in (
            "rid_a", "rid_b", "pos_a", "pos_b", "d", "dprime", "r", "r2",
            "p", "chisq_fisher", "chisq_model", "refref", "refalt",
            "altref", "altalt", "mhc")) or self.flag_include or \
            self.flag_exclude or self.upper_only or self.lower_only or \
            self.hap_min > 0

    def mask(self, recs: np.ndarray) -> np.ndarray:
        m = np.ones(len(recs), bool)

        def rng(series, bounds):
            nonlocal m
            if bounds is not None:
                lo, hi = bounds
                if lo is not None:
                    m &= series >= lo
                if hi is not None:
                    m &= series <= hi

        rng(recs["ridA"], self.rid_a)
        rng(recs["ridB"], self.rid_b)
        rng(recs["packA"] >> 2, self.pos_a)
        rng(recs["packB"] >> 2, self.pos_b)
        rng(recs["D"], self.d)
        rng(recs["Dprime"], self.dprime)
        rng(recs["R"], self.r)
        rng(recs["R2"], self.r2)
        rng(recs["P"], self.p)
        rng(recs["ChiSqFisher"], self.chisq_fisher)
        rng(recs["ChiSqModel"], self.chisq_model)
        rng(recs["cnt"][:, 0], self.refref)
        rng(recs["cnt"][:, 1], self.altref)
        rng(recs["cnt"][:, 2], self.refalt)
        rng(recs["cnt"][:, 3], self.altalt)
        if self.hap_min > 0:
            m &= recs["cnt"].min(axis=1) >= self.hap_min
        if self.mhc is not None:
            cnt = recs["cnt"]
            # major cell with the reference's exact tie-breaking
            # (two_reader.h:164-166): cnt[1] wins a 0-vs-1 tie, later
            # cells must strictly exceed the running max
            mi = np.where(cnt[:, 1] >= cnt[:, 0], 1, 0)
            cur = cnt[np.arange(len(cnt)), mi]
            mi = np.where(cnt[:, 2] > cur, 2, mi)
            cur = cnt[np.arange(len(cnt)), mi]
            mi = np.where(cnt[:, 3] > cur, 3, mi)
            nonmajor = cnt.sum(axis=1) - cnt[np.arange(len(cnt)), mi]
            rng(nonmajor, self.mhc)
        if self.flag_include:
            m &= (recs["controller"] & self.flag_include) != 0
        if self.flag_exclude:
            m &= (recs["controller"] & self.flag_exclude) == 0
        if self.upper_only:
            m &= (recs["ridA"] < recs["ridB"]) | \
                 ((recs["ridA"] == recs["ridB"]) &
                  ((recs["packA"] >> 2) <= (recs["packB"] >> 2)))
        if self.lower_only:
            m &= (recs["ridA"] > recs["ridB"]) | \
                 ((recs["ridA"] == recs["ridB"]) &
                  ((recs["packA"] >> 2) >= (recs["packB"] >> 2)))
        return m
