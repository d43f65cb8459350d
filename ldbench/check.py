"""What decides `correct`: the records the timed path wrote, against the
plain reference, on tiles drawn from the seed.

The records of a sampled tile are matched to the reference's kept pairs
by their positions (every variant's position is distinct). A pair the
reference marks as a tie (reference/ld.py) is left out. Every kept pair
is written twice, once reversed (A and B swapped, every other field
alike), and the reversed copy is held to the forward one.
"""

import numpy as np

#: the record fields held to the reference, relative to their own size;
#: the counts are held relative to the table's total
STAT_FIELDS = ("D", "Dprime", "R", "R2", "ChiSqFisher")
#: Fisher P below this is read as this (no user tells 1e-250 from 0)
P_FLOOR = 1e-250


def sample_tiles(tiles, seed: int, n_off: int, n_diag: int = 0):
    """`n_off` off-diagonal and `n_diag` diagonal tiles of the list,
    drawn from the seed (all of a kind when it has fewer)."""
    rng = np.random.default_rng([seed, 0x1d6b])
    out = []
    for want, diag in ((n_diag, True), (n_off, False)):
        pool = [t for t in tiles if bool(t[2]) == diag]
        pick = rng.choice(len(pool), min(want, len(pool)), replace=False)
        out += [pool[i] for i in sorted(pick)]
    return out


class Locator:
    """Position -> (super-block, row) over the valid rows of stacked
    planes."""

    def __init__(self, stacked):
        b, r = np.nonzero(stacked["valid"])
        pos = stacked["pos"][b, r].astype(np.int64)
        order = np.argsort(pos, kind="stable")
        self.pos, self.block, self.row = pos[order], b[order], r[order]
        if np.any(np.diff(self.pos) == 0):
            raise ValueError("variant positions repeat")

    def find(self, pos):
        pos = np.asarray(pos, np.int64)
        i = np.clip(np.searchsorted(self.pos, pos), 0, len(self.pos) - 1)
        ok = self.pos[i] == pos
        return np.where(ok, self.block[i], -1), np.where(ok, self.row[i], -1)


def _by_tile(recs, loc, n_rec):
    """({(direction, (bi, bj)): (pair index, records)}, records whose
    variants are unknown): forward records (position A below B) and
    reversed ones, by tile, bi <= bj, the pair index row_i * n_rec[bj] +
    row_j, sorted."""
    pa = (recs["packA"] >> 2).astype(np.int64)
    pb = (recs["packB"] >> 2).astype(np.int64)
    fwd = pa < pb
    bi, ri = loc.find(np.where(fwd, pa, pb))
    bj, rj = loc.find(np.where(fwd, pb, pa))
    known = (bi >= 0) & (bj >= 0)
    idx = ri.astype(np.int64) * n_rec[np.maximum(bj, 0)] + rj
    keys = bi.astype(np.int64) * (1 << 32) + bj
    out = {}
    for direction, sel in (("fwd", fwd & known), ("rev", ~fwd & known)):
        k, ix, rr = keys[sel], idx[sel], recs[sel]
        order = np.lexsort((ix, k))
        k, ix, rr = k[order], ix[order], rr[order]
        cuts = np.flatnonzero(np.diff(k)) + 1
        for g_k, g_ix, g_rec in zip(np.split(k, cuts), np.split(ix, cuts),
                                    np.split(rr, cuts)):
            if len(g_k):
                tile = (int(g_k[0] >> 32), int(g_k[0] & 0xFFFFFFFF))
                out[(direction, tile)] = (g_ix, g_rec)
    return out, int((~known).sum())


def _stat_gap(got, ref_sel):
    """Largest relative gap of the statistics and counts."""
    gap = 0.0
    for f in STAT_FIELDS:
        r = ref_sel[f]
        d = np.abs(got[f] - r) / np.maximum(np.abs(r), 1e-300)
        gap = max(gap, float(np.nan_to_num(d, nan=np.inf).max(initial=0.0)))
    cnt = ref_sel["cnt"]
    d = np.abs(got["cnt"] - cnt).max(axis=1) / np.maximum(cnt.sum(1), 1.0)
    return max(gap, float(np.nan_to_num(d, nan=np.inf).max(initial=0.0)))


def _p_gap(got, ref_p):
    d = np.abs(got["P"] - ref_p) / np.maximum(ref_p, P_FLOOR)
    return float(np.nan_to_num(d, nan=np.inf).max(initial=0.0))


def compare(recs, stacked, refs: dict) -> dict:
    """The numbers compared, from records `recs` (the tool's record
    layout) and the reference of each sampled tile, `refs` {(bi, bj,
    diag): reference/ld.tile result as numpy arrays}: pairs that one
    side keeps and the other does not, or that are written wrongly
    reversed (`pairs_differ`); the largest relative gap of D, D', R,
    r2, chi-squared and the counts (`stat_gap`) and of Fisher P
    (`p_gap`) over the pairs both keep, None where there are none; what
    was compared; and `diffs`, the first pairs kept by one side alone:
    (tile, pair index, which side)."""
    loc = Locator(stacked)
    n_rec = stacked["n_rec"].astype(np.int64)
    groups, unknown = _by_tile(recs, loc, n_rec)
    differ, stat_gap, p_gap, n_pairs, n_ties = unknown, 0.0, 0.0, 0, 0
    diffs = []
    for (bi, bj, _diag), ref in refs.items():
        f_ix, f_rec = groups.get(("fwd", (bi, bj)),
                                 (np.zeros(0, np.int64), recs[:0]))
        r_ix, r_rec = groups.get(("rev", (bi, bj)),
                                 (np.zeros(0, np.int64), recs[:0]))
        order = np.argsort(ref["idx"])
        ref = {k: (v if k == "tie" else v[order]) for k, v in ref.items()}
        tie = ref["tie"]
        n_ties += len(tie)
        # the reversed copies: the same pairs, every field alike but the
        # swapped variants
        if len(r_ix) != len(f_ix) or np.any(r_ix != f_ix):
            differ += len(np.setxor1d(r_ix, f_ix)) + abs(
                len(r_ix) - len(f_ix))
        elif len(f_ix):
            same = np.ones(len(f_ix), bool)
            for name in f_rec.dtype.names:
                if name in ("packA", "packB", "ridA", "ridB"):
                    continue
                a, b = f_rec[name], r_rec[name]
                eq = (a == b) | (np.isnan(a) & np.isnan(b)) \
                    if a.dtype.kind == "f" else a == b
                same &= eq.reshape(len(f_ix), -1).all(axis=1)
            same &= (f_rec["packA"] == r_rec["packB"]) \
                & (f_rec["packB"] == r_rec["packA"])
            differ += int((~same).sum())
        # duplicates on the forward side
        uniq, first = np.unique(f_ix, return_index=True)
        differ += len(f_ix) - len(uniq)
        f_rec = f_rec[first]
        want = ref["idx"]
        only_got = np.setdiff1d(uniq, want)
        only_ref = np.setdiff1d(want, uniq)
        for side, ix in (("written, not in the reference",
                          np.setdiff1d(only_got, tie)),
                         ("in the reference, not written",
                          np.setdiff1d(only_ref, tie))):
            differ += len(ix)
            diffs += [((bi, bj), int(i), side) for i in ix[:5]]
        both = np.intersect1d(np.intersect1d(uniq, want),
                              np.setdiff1d(want, tie))
        if not len(both):
            continue
        n_pairs += len(both)
        got = f_rec[np.searchsorted(uniq, both)]
        at = np.searchsorted(want, both)
        ref_sel = {k: v[at] for k, v in ref.items() if k != "tie"}
        stat_gap = max(stat_gap, _stat_gap(got, ref_sel))
        p_gap = max(p_gap, _p_gap(got, ref_sel["P"]))
    if not n_pairs:
        stat_gap = p_gap = None     # nothing to compare: no number
    return dict(pairs_differ=differ, stat_gap=stat_gap, p_gap=p_gap,
                pairs_compared=n_pairs, ties=n_ties, diffs=diffs[:10])
