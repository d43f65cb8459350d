"""Entry `engine_written`: the `engine` entry (set-up, unit, spans and
memory alike), whose check also holds every record the pass wrote to
the plain float64 reference.

A cell that keeps few pairs a pass (rare variants at a wide panel: tens
of records among tens of billions of pairs) leaves the sampled tiles of
`engine.common_numbers` without a kept pair on many seeds. So the rows
the written records name are gathered tile by tile, and the reference
runs on those rows alone: the written pairs it does not keep, the pairs
of those rows it keeps that were not written, and the statistics of the
pairs both keep are held by `check.compare`, as on a sampled tile. The
numbers it adds: `written_compared` (pairs compared on those rows),
`outside` (records of a tile not in the pass's list, counted in
`pairs_differ`), and `unproven`, 1 where neither check compared a pair.
"""

import numpy as np

from ldbench import check as chk
from ldbench.entries import engine as eng
from ldbench.entries.engine import (memory_peak, release, setup,  # noqa
                                    trace_spans, unit)
from ldbench.reference import ld as ref_ld


def written_rows(recs, stacked):
    """({(bi, bj): (rows of bi, rows of bj, records)} of the tiles whose
    pairs `recs` name, forward and reversed copies both; the count of
    records whose variants are unknown)."""
    loc = chk.Locator(stacked)
    pa = (recs["packA"] >> 2).astype(np.int64)
    pb = (recs["packB"] >> 2).astype(np.int64)
    bi, ri = loc.find(np.minimum(pa, pb))
    bj, rj = loc.find(np.maximum(pa, pb))
    known = (bi >= 0) & (bj >= 0)
    out = {}
    for tile in sorted(set(zip(bi[known].tolist(), bj[known].tolist()))):
        sel = known & (bi == tile[0]) & (bj == tile[1])
        out[tile] = (np.unique(ri[sel]), np.unique(rj[sel]), recs[sel])
    return out, int((~known).sum())


def sub_planes(stacked, tile, rows_i, rows_j):
    """(planes, reference key, {block: rows}) of the tile cut to those
    rows: two blocks off the diagonal, one block of both rows' union on
    it, holding the rows' words, positions and validity."""
    bi, bj = tile
    if bi == bj:
        parts, key = [(bi, np.union1d(rows_i, rows_j))], (0, 0, True)
    else:
        parts, key = [(bi, rows_i), (bj, rows_j)], (0, 1, False)
    B = max(len(r) for _, r in parts)
    sub = {"n_rec": np.array([len(r) for _, r in parts], np.int32)}
    for k in ("alt_bits", "valid_bits", "pos", "valid"):
        a = np.zeros((len(parts), B) + stacked[k].shape[2:],
                     stacked[k].dtype)
        for s, (b, r) in enumerate(parts):
            a[s, :len(r)] = stacked[k][b][r]
        sub[k] = a
    return sub, key


def written_numbers(run, recs, stacked, tiles, dtype=None) -> dict:
    """The comparison of the written records `recs` with the float64
    reference on the rows they name. With `dtype`, the records held to
    it are the reference's own in that dtype on the same rows instead
    (the precision control, ldbench/control_written.py)."""
    import torch
    from ldbench.control import records_from
    by_tile, unknown = written_rows(recs, stacked)
    in_pass = {(i, j) for i, j, _d in tiles}
    outside = sum(len(r) for t, (_, _, r) in by_tile.items()
                  if t not in in_pass)
    nums = dict(pairs_differ=unknown + outside, stat_gap=None, p_gap=None,
                written_compared=0, outside=outside)
    for tile, (rows_i, rows_j, got) in by_tile.items():
        if tile not in in_pass:
            continue
        sub, key = sub_planes(stacked, tile, rows_i, rows_j)
        want = eng.reference_tiles(run, sub, [key], torch.float64)
        if dtype is not None:
            got = records_from(eng.reference_tiles(run, sub, [key], dtype),
                               sub)
        n = chk.compare(got, sub, want)
        nums["pairs_differ"] += n["pairs_differ"]
        nums["written_compared"] += n["pairs_compared"]
        for k in ("stat_gap", "p_gap"):
            if n[k] is not None:
                nums[k] = max(nums[k] or 0.0, n[k])
    return nums


def merge(sampled: dict, written: dict) -> dict:
    """The sampled tiles' numbers and the written rows' as one: counts
    added, gaps the larger (0.0 where no pair was compared), and
    `unproven` 1 where neither compared a pair."""
    out = dict(sampled)
    out["pairs_differ"] = sampled["pairs_differ"] + written["pairs_differ"]
    for k in ("stat_gap", "p_gap"):
        out[k] = max(sampled[k] or 0.0, written[k] or 0.0)
    out["written_compared"] = written["written_compared"]
    out["outside"] = written["outside"]
    out["unproven"] = int(sampled["pairs_compared"]
                          + written["written_compared"] == 0)
    return out


def check(run, state, units) -> dict:
    from ldbench.run import say
    from ldbench.tworead import read_records
    recs = read_records(state["out"])
    sampled = eng.common_numbers(run, units, recs, state["stacked"],
                                 state["tiles"], state["candidates"])
    sampled["units_differ"] += int(len(recs) != units[-1]["records"])
    written = written_numbers(run, recs, state["stacked"], state["tiles"])
    numbers = merge(sampled, written)
    say(f"written records {len(recs)}: {written}")
    return numbers
