"""Genomic interval parsing and filtering.

Reimplements the reference interval surface (reference:
include/intervals.h, lib/intervals.cpp): interval strings of the forms
  contig | contig:pos | contig:from-to
optionally linked pairwise as "ivalA;ivalB" to constrain both sides of
a .two record. Positions may use scientific notation (e.g. 1e6) and are
1-based inclusive on input, converted to 0-based internally.
"""

import re
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

_NUM = r"[0-9]+(?:\.[0-9]+)?(?:[eE][0-9]+)?"
_RE_CONTIG = re.compile(r"^[A-Za-z0-9\-_\.]+$")
_RE_POS = re.compile(rf"^([A-Za-z0-9\-_\.]+):({_NUM})$")
_RE_RANGE = re.compile(rf"^([A-Za-z0-9\-_\.]+):({_NUM})-({_NUM})$")


@dataclass
class Interval:
    rid: int
    start: int   # 0-based inclusive
    end: int     # 0-based inclusive
    linked: Optional["Interval"] = None


def _parse_one(s: str, header) -> Interval:
    m = _RE_RANGE.match(s)
    if m:
        rid = header.contig_rid(m.group(1))
        if rid < 0:
            raise ValueError(f"unknown contig in interval: {m.group(1)}")
        start = int(float(m.group(2))) - 1
        end = int(float(m.group(3))) - 1
        if end < start:
            raise ValueError(f"interval end < start: {s}")
        return Interval(rid, max(start, 0), end)
    m = _RE_POS.match(s)
    if m:
        rid = header.contig_rid(m.group(1))
        if rid < 0:
            raise ValueError(f"unknown contig in interval: {m.group(1)}")
        p = int(float(m.group(2))) - 1
        return Interval(rid, max(p, 0), max(p, 0))
    if _RE_CONTIG.match(s):
        rid = header.contig_rid(s)
        if rid < 0:
            raise ValueError(f"unknown contig in interval: {s}")
        return Interval(rid, 0, 2**30 - 1)
    raise ValueError(f"cannot parse interval: {s}")


_RID_SHIFT = 40   # positions < 2^40; rid-tagged keys sort by (rid, pos)


class IntervalSet(list):
    """Parsed intervals plus a sorted merged lookup index.

    The TPU-native replacement for the reference's per-contig interval
    trees + dedupe-by-extension (reference: include/intervalTree.h,
    lib/intervals.cpp): unlinked intervals merge into disjoint sorted
    (rid << 40 | pos) key ranges, so point containment is ONE
    vectorized searchsorted regardless of how many intervals were
    given, and block-overlap queries exploit that merged-disjoint
    ranges have co-sorted starts and ends. Linked pairs (usually few)
    keep per-pair vectorized checks. Behaves as a plain list of
    Interval for existing callers."""

    def __init__(self, ivals):
        super().__init__(ivals)
        self.linked_pairs = [iv for iv in ivals if iv.linked is not None]
        plain = [iv for iv in ivals if iv.linked is None]
        starts = sorted((iv.rid << _RID_SHIFT) | iv.start for iv in plain)
        ends = [((iv.rid << _RID_SHIFT) | iv.end)
                for iv in sorted(plain,
                                 key=lambda v: (v.rid << _RID_SHIFT)
                                 | v.start)]
        # dedupe-by-extension: merge overlapping/adjacent ranges
        ms, me = [], []
        for s, e in zip(starts, ends):
            if ms and s <= me[-1] + 1 and (s >> _RID_SHIFT) == \
                    (me[-1] >> _RID_SHIFT):
                me[-1] = max(me[-1], e)
            else:
                ms.append(s)
                me.append(e)
        self._starts = np.array(ms, np.int64)
        self._ends = np.array(me, np.int64)

    def contains(self, rid, pos) -> np.ndarray:
        """Vectorized point containment in the merged unlinked set."""
        if len(self._starts) == 0:
            return np.zeros(np.shape(pos), bool)
        key = (np.asarray(rid, np.int64) << _RID_SHIFT) \
            | np.asarray(pos, np.int64)
        idx = np.searchsorted(self._starts, key, "right") - 1
        safe = np.maximum(idx, 0)
        return (idx >= 0) & (key <= self._ends[safe])

    def overlaps_range(self, rid, lo, hi) -> np.ndarray:
        """Vectorized [lo, hi] range-overlap against the merged set.
        Merged ranges are disjoint and sorted, so starts and ends are
        co-sorted: the candidate with the largest start <= hi covers
        the query iff its end >= lo OR a later range starts within
        [lo, hi] — the latter is impossible for the largest such start,
        so one searchsorted suffices."""
        if len(self._starts) == 0:
            return np.zeros(np.shape(lo), bool)
        khi = (np.asarray(rid, np.int64) << _RID_SHIFT) \
            | np.asarray(hi, np.int64)
        klo = (np.asarray(rid, np.int64) << _RID_SHIFT) \
            | np.asarray(lo, np.int64)
        idx = np.searchsorted(self._starts, khi, "right") - 1
        safe = np.maximum(idx, 0)
        return (idx >= 0) & (self._ends[safe] >= klo) & \
            ((self._starts[safe] >> _RID_SHIFT)
             == (khi >> _RID_SHIFT))


def parse_intervals(strings, header) -> IntervalSet:
    out = []
    for s in strings or []:
        # linked two-sided interval: the reference separates with ','
        # (intervals.h:117-127); ';' is accepted as well
        sep = ";" if ";" in s else ("," if "," in s else None)
        if sep:
            a, b = s.split(sep, 1)
            iv = _parse_one(a.strip(), header)
            iv.linked = _parse_one(b.strip(), header)
            out.append(iv)
        else:
            out.append(_parse_one(s.strip(), header))
    return IntervalSet(out)


def interval_mask(recs: np.ndarray, ivals) -> np.ndarray:
    """True where a .two record matches any interval, with the
    reference's A-side-anchored semantics (reference:
    lib/intervals.cpp:381-403 FilterInterval): an unlinked interval
    matches on the A side only, and a linked pair requires A in the
    first interval AND B in its mate, in that orientation. Because the
    record stream carries both (A,B) and (B,A) orientations of every
    pair, anchoring on A selects each matching pair exactly once per
    listed orientation -- either-side matching would double-select."""
    if not ivals:
        return np.ones(len(recs), bool)
    if not isinstance(ivals, IntervalSet):
        ivals = IntervalSet(list(ivals))
    pos_a = (recs["packA"] >> 2).astype(np.int64)
    pos_b = (recs["packB"] >> 2).astype(np.int64)
    rid_a = recs["ridA"].astype(np.int64)
    rid_b = recs["ridB"].astype(np.int64)
    m = ivals.contains(rid_a, pos_a)
    for iv in ivals.linked_pairs:
        in_a = (rid_a == iv.rid) & (pos_a >= iv.start) & (pos_a <= iv.end)
        lv = iv.linked
        in_b2 = (rid_b == lv.rid) & (pos_b >= lv.start) & \
            (pos_b <= lv.end)
        m |= in_a & in_b2
    return m


def _entry_overlap_mask(ivals, rid, lo, hi, both_sides):
    """Shared block-overlap core: merged unlinked ranges via ONE
    vectorized query, plus per-pair checks for linked intervals
    (anchored on the first interval only for .two A-side semantics,
    or on both sides for .twk site blocks)."""
    m = ivals.overlaps_range(rid, np.maximum(lo, 0), np.maximum(hi, 0))
    for iv in ivals.linked_pairs:
        sides = (iv, iv.linked) if both_sides else (iv,)
        for v in sides:
            m |= (rid == v.rid) & (lo <= v.end) & (hi >= v.start)
    return m


def blocks_for_intervals(reader, strings) -> List[int]:
    """Block indices of a .twk archive overlapping any interval (one
    vectorized range query over the block index)."""
    ivals = parse_intervals(strings, reader.header)
    ents = reader.index.ent
    if not ents:
        return []
    rid = np.array([e.rid for e in ents], np.int64)
    # index positions are 1-based right-open (pos+1 convention)
    lo = np.array([e.minpos - 1 for e in ents], np.int64)
    hi = np.array([e.maxpos - 1 for e in ents], np.int64)
    m = _entry_overlap_mask(ivals, rid, lo, hi, both_sides=True)
    return [int(i) for i in np.flatnonzero(m)]


def interval_block_ids(reader, ivals):
    """Blocks to visit: on a SORTED .two whose index entries carry
    per-block (ridA, minpos, maxpos), an interval query touches only
    the overlapping blocks -- the reference's near-real-time ROI path
    (two_reader FindOverlap over IndexEntryOutput; README.md:9). The
    A-side anchor makes this a sound superset: unlinked intervals and
    the FIRST interval of each linked pair match on A, and the sorted
    stream carries both orientations of every pair. Unsorted files
    (rid = -1 entries) fall back to the full scan."""
    n = reader.index.n
    # an EMPTY interval set means "no constraint" here, matching
    # interval_mask's match-all semantics for the same value
    if not ivals or reader.index.state != 2 or n == 0:
        return range(n)
    ent = reader.index.ent
    rid = np.array([e.rid for e in ent], np.int64)
    lo = np.array([e.minpos for e in ent], np.int64)
    hi = np.array([e.maxpos for e in ent], np.int64)
    if (rid < 0).any():
        return range(n)
    keep = _entry_overlap_mask(ivals, rid, lo, hi, both_sides=False)
    return np.flatnonzero(keep).tolist()
