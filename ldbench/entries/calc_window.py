"""Entry `calc_window`: whole `calc -w` jobs, archive in, .two out.

The `calc` entry (its archive, its job as `calc` runs it, its spans and
counters) with the job's distance window set: `CalcSettings(window=True,
l_window=cell["window"])`, as `calc -w <bp>` sets it. A job then sweeps
only the tiles whose super-blocks lie within the window of each other
and keeps only pairs of one contig at most `window` bp apart
(|pos_a - pos_b| <= window).

The benchmark's own counts are taken from the positions it drew: the
pairs inside the window (a unit's `pairs`), the candidates among them
(`candidate_count`'s skip rule), and the tiles that hold such pairs, of
which the check holds `check["diagonal"]` diagonal and
`check["off_diagonal"]` off-diagonal ones, drawn from the seed, to the
plain reference cut to the pairs inside the window.
"""

import dataclasses
import json

import numpy as np

from ldbench import check as chk
from ldbench.entries import calc
from ldbench.entries import engine as eng
from ldbench.entries.calc import memory_peak, release, trace_spans  # noqa
from ldbench.entries.calc import unit  # noqa
from ldbench.run import say


def _variants(stacked):
    """(pos, ac) of the valid variants in block order (ascending
    positions: the generators draw them so)."""
    v = stacked["valid"]
    return stacked["pos"][v].astype(np.int64), stacked["ac"][v]


def window_pairs(stacked, window: int):
    """(pairs, candidates) inside the window: variant pairs at most
    `window` bp apart, and those of them whose alt alleles number more
    than 2 together (one contig)."""
    pos, ac = _variants(stacked)
    if np.any(np.diff(pos) <= 0):
        raise ValueError("positions must ascend")
    k = np.arange(len(pos))
    hi = np.searchsorted(pos, pos + window, side="right")
    pairs = int((hi - k - 1).sum())
    # partners m in (k, hi) with ac_k + ac_m <= 2: prefix sums of each
    # allele count
    low = np.zeros((3, len(pos) + 1), np.int64)
    for x in range(3):
        low[x, 1:] = np.cumsum(ac == x)
    count = lambda x: low[x, hi] - low[x, k + 1]
    skip = np.where(ac == 0, count(0) + count(1) + count(2),
                    np.where(ac == 1, count(0) + count(1),
                             np.where(ac == 2, count(0), 0)))
    return pairs, pairs - int(skip.sum())


def window_tiles(stacked, window: int):
    """The tiles (i, j, i == j), i <= j, whose super-blocks hold a pair
    inside the window."""
    lo, hi = [], []
    for b, n in enumerate(stacked["n_rec"]):
        p = stacked["pos"][b][:n].astype(np.int64)
        lo.append(p.min())
        hi.append(p.max())
    NB = len(lo)
    return [(i, j, i == j) for i in range(NB) for j in range(i, NB)
            if lo[j] - hi[i] <= window]


def setup(run):
    state = calc.setup(run)
    window = run.cell["window"]
    stacked = state["stacked"]
    state["settings"] = dataclasses.replace(state["settings"], window=True,
                                            l_window=window)
    state["tiles"] = window_tiles(stacked, window)
    state["pairs"], state["candidates"] = window_pairs(stacked, window)
    say(f"window {window} bp: {len(state['tiles'])} tiles, "
        f"{state['pairs']} pairs, {state['candidates']} candidates a job")
    return state


def cut_to_window(ref: dict, stacked, tile, window: int) -> dict:
    """A reference tile's kept pairs and ties cut to those inside the
    window."""
    bi, bj, _d = tile
    n_j = int(stacked["n_rec"][bj])
    pi = stacked["pos"][bi].astype(np.int64)
    pj = stacked["pos"][bj].astype(np.int64)
    inside = lambda idx: np.abs(pi[idx // n_j] - pj[idx % n_j]) <= window
    keep = inside(ref["idx"])
    out = {k: v[keep] for k, v in ref.items() if k != "tie"}
    out["tie"] = ref["tie"][inside(ref["tie"])]
    return out


def check(run, state, units) -> dict:
    import torch
    from ldbench.tworead import read_records
    recs = read_records(state["settings"].output)
    stacked, tiles = state["stacked"], state["tiles"]
    window = run.cell["window"]
    numbers = dict(
        pairs_gap=sum(abs(u["program_pairs"] - state["candidates"])
                      for u in units),
        units_differ=sum(u["records"] != units[-1]["records"]
                         for u in units)
        + int(len(recs) != units[-1]["records"]),
        host_route_jobs=sum(u["launches"] == 0 for u in units))
    c = run.cell["check"]
    pick = chk.sample_tiles(tiles, run.seed, c["off_diagonal"],
                            c.get("diagonal", 0))
    refs = {t: cut_to_window(r, stacked, t, window) for t, r in
            eng.reference_tiles(run, stacked, pick, torch.float64).items()}
    numbers.update(chk.compare(recs, stacked, refs))
    for (bi, bj), idx, side in numbers.pop("diffs"):
        n_j = stacked["n_rec"][bj]
        say(f"pair {side}: tile ({bi}, {bj}), rows {idx // n_j}, "
            f"{idx % n_j}")
    say(f"checked tiles {pick}: {json.dumps(numbers)}")
    for k in ("stat_gap", "p_gap"):
        numbers[k] = numbers[k] or 0.0
    return numbers
