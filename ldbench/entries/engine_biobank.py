"""Entry `engine_biobank`: the `engine` entry (set-up, unit, spans and
memory alike) at biobank width, unphased, whose check takes the plain
reference in blocks of samples (ldbench/reference/ld_blocked.py) on row
subsets of tiles and on every written record.

A whole tile of 4,096 x 4,096 pairs at 488,377 samples is tens of GB
unpacked, and at that width chance LD between far loci keeps about no
pair, so the generator plants one pair in LD in every tile
(traffic/genotype_planted.py). The check holds, to the float64
reference:

- `check["sub_tiles"]` tiles drawn from the seed, each cut to
  `check["sub_rows"]` rows of either side drawn from the seed, the
  tile's planted pair's two rows among them: every pair of the cut that
  either side keeps (the records of those rows' pairs against the
  reference's kept pairs, as `check.compare` holds a sampled tile);
- every written record, on the rows the records name
  (engine_written's rule, with this reference).

Set-up also runs the cell's `warm_passes` passes (none where it sets
none): at this width the card's pace under `parts_tile`'s load settles
only after ~20 s of it (on an H100 80GB HBM3 at 700 W, a window begun
after one warm pass saw its pass walls fall ~8%), and a deployment's
chunk runs for minutes.

Numbers: those of `engine_written` (`pairs_gap`, `units_differ`,
`pairs_differ`, `stat_gap`, `p_gap`, `written_compared`, `outside`,
`unproven`: 1 where neither check compared a pair), and
`pairs_compared`, the cut tiles' pairs both sides keep. The cell's
`check["off_diagonal"]` is 0: `ldbench.control_written`, which draws
whole tiles with the haplotype reference, then holds the float32
reference to the float64 one on the written rows alone.
"""

import json

import numpy as np

from ldbench import check as chk
from ldbench.entries import engine as eng
from ldbench.entries.engine import (memory_peak, release,  # noqa
                                    trace_spans, unit)
from ldbench.entries.engine_written import merge, written_rows  # noqa
from ldbench.reference import ld_blocked

#: the sample planes the reference reads
PLANES = ("het_bits", "hom_bits", "valid_bits")


def setup(run):
    state = eng.setup(run)
    for _ in range(run.cell.get("warm_passes", 0)):
        unit(run, state)
    return state


def sub_planes(stacked, tile, rows_i, rows_j):
    """(planes, reference key) of the tile cut to those rows: two blocks
    off the diagonal, one block of both rows' union on it, holding the
    rows' sample words, positions and validity."""
    bi, bj = tile
    if bi == bj:
        parts, key = [(bi, np.union1d(rows_i, rows_j))], (0, 0, True)
    else:
        parts, key = [(bi, rows_i), (bj, rows_j)], (0, 1, False)
    B = max(len(r) for _, r in parts)
    sub = {"n_rec": np.array([len(r) for _, r in parts], np.int32)}
    for k in PLANES + ("pos", "valid"):
        a = np.zeros((len(parts), B) + stacked[k].shape[2:],
                     stacked[k].dtype)
        for s, (b, r) in enumerate(parts):
            a[s, :len(r)] = stacked[k][b][r]
        sub[k] = a
    return sub, key


def reference(run, sub, key, dtype):
    """{key: the blocked reference of the cut tile, as numpy arrays},
    on the run's first card."""
    import torch
    dev = run.cards[0]
    si, sj, diag = key
    planes = [{k: torch.from_numpy(sub[k][s][:int(sub["n_rec"][s])].view(
        np.int32)).to(dev) for k in PLANES} for s in (si, sj)]
    res = ld_blocked.tile(planes[0], planes[1], diag,
                          run.config["n_samples"], run.config["min_r2"],
                          dtype=dtype)
    return {key: {k: v.cpu().numpy() for k, v in res.items()}}


def _in_rows(recs, stacked, tile, rows_i, rows_j):
    """The records of `recs` whose two variants are rows of the cut tile
    (either order)."""
    bi, bj = tile
    loc = chk.Locator(stacked)
    a = loc.find((recs["packA"] >> 2).astype(np.int64))
    b = loc.find((recs["packB"] >> 2).astype(np.int64))

    def on(side, blk, rows):
        return (side[0] == blk) & np.isin(side[1], rows)
    return recs[(on(a, bi, rows_i) & on(b, bj, rows_j))
                | (on(b, bi, rows_i) & on(a, bj, rows_j))]


def cut_tiles(run, stacked, tiles):
    """[(tile, rows_i, rows_j)]: the sampled tiles and their rows, drawn
    from the seed, each tile's planted rows among them."""
    c = run.cell["check"]
    pick = chk.sample_tiles(tiles, run.seed, c["sub_tiles"])
    rng = np.random.default_rng([run.seed, 0x5b1c])
    planted = stacked.get("planted", np.zeros((0, 4), np.int64))
    out = []
    for bi, bj, _d in pick:
        rows = []
        for b, col in ((bi, 1), (bj, 3)):
            n = int(stacked["n_rec"][b])
            mine = planted[(planted[:, 0] == bi) & (planted[:, 2] == bj)]
            r = rng.choice(n, min(n, c["sub_rows"]), replace=False)
            rows.append(np.union1d(r, mine[:, col]))
        out.append(((bi, bj), rows[0], rows[1]))
    return out


def sampled_numbers(run, recs, stacked, tiles, dtype=None) -> dict:
    """The comparison of the records with the float64 reference on the
    cut tiles (`check.compare`'s numbers, summed); with `dtype` the
    records held to it are the reference's own in that dtype instead."""
    import torch
    from ldbench.control import records_from
    nums = dict(pairs_differ=0, stat_gap=None, p_gap=None,
                pairs_compared=0, ties=0, diffs=[])
    for tile, rows_i, rows_j in cut_tiles(run, stacked, tiles):
        sub, key = sub_planes(stacked, tile, rows_i, rows_j)
        want = reference(run, sub, key, torch.float64)
        got = (records_from(reference(run, sub, key, dtype), sub)
               if dtype is not None
               else _in_rows(recs, stacked, tile, rows_i, rows_j))
        n = chk.compare(got, sub, want)
        for k in ("pairs_differ", "pairs_compared", "ties"):
            nums[k] += n[k]
        for k in ("stat_gap", "p_gap"):
            if n[k] is not None:
                nums[k] = max(nums[k] or 0.0, n[k])
        nums["diffs"] += [(tile, int(rows_i[i // len(rows_j)]),
                           int(rows_j[i % len(rows_j)]), side)
                          for _t, i, side in n["diffs"]]
    return nums


def written_numbers(run, recs, stacked, tiles, dtype=None) -> dict:
    """engine_written's comparison of the written records with the
    float64 reference on the rows they name, with the blocked reference.
    With `dtype`, the records held to it are the reference's own in that
    dtype on the same rows (the precision control,
    ldbench/control_written.py)."""
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
        want = reference(run, sub, key, torch.float64)
        if dtype is not None:
            got = records_from(reference(run, sub, key, dtype), sub)
        n = chk.compare(got, sub, want)
        nums["pairs_differ"] += n["pairs_differ"]
        nums["written_compared"] += n["pairs_compared"]
        for k in ("stat_gap", "p_gap"):
            if n[k] is not None:
                nums[k] = max(nums[k] or 0.0, n[k])
    return nums


def check(run, state, units) -> dict:
    from ldbench.run import say
    from ldbench.tworead import read_records
    recs = read_records(state["out"])
    stacked, tiles = state["stacked"], state["tiles"]
    sampled = dict(
        pairs_gap=sum(abs(u["program_pairs"] - state["candidates"])
                      for u in units),
        units_differ=sum(u["records"] != units[-1]["records"]
                         for u in units)
        + int(len(recs) != units[-1]["records"]))
    sampled.update(sampled_numbers(run, recs, stacked, tiles))
    for tile, ri, rj, side in sampled.pop("diffs")[:10]:
        say(f"pair {side}: tile {tile}, rows {ri}, {rj}")
    say(f"cut tiles: {json.dumps(sampled)}")
    written = written_numbers(run, recs, stacked, tiles)
    numbers = merge(sampled, written)
    say(f"written records {len(recs)}: {written}")
    return numbers
