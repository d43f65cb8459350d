"""The Haplotype Reference Consortium cell: its files, its traffic
(`phased_mac`), its roofline reader with the contraction counted, its
entry's check of every written record (`engine_written`), and a whole
run of it through the harness at a small size on the CPU."""

import os
import types

import numpy as np
import pytest

from ldbench import control_written
from ldbench import run as R
from ldbench.entries import engine as eng
from ldbench.entries import engine_written as ew
from ldbench.traffic import _pack, phased_mac

CELL = "hrc_phased.engine_far"
BENCH = R.load_json(os.path.join(R.ROOT, "BENCHMARK.json"))


def test_files_load_and_name_existing_modules():
    cell, cfg = R.load_cell(CELL)
    assert cfg["n_samples"] == 32470 and cfg["phased"]
    assert cfg["reduced"] == [] and len(cfg["source"]) <= 200
    for kind, name in (("entries", cell["entry"]),
                       ("traffic", cell["generator"])):
        assert os.path.exists(os.path.join(R.HERE, kind, f"{name}.py"))
    for group in ("end_to_end", "per_layer"):
        for m in R.cell_metrics(BENCH, CELL, group):
            assert R.load_module("metrics", m["name"]).read
    assert "phased_tile.mma_roofline_pct" in {
        m["name"] for m in R.cell_metrics(BENCH, CELL, "per_layer")}
    # 2 x 64 super-blocks of 4,096: 4,096 off-diagonal tiles
    sizes, ids = eng.block_sizes(cell["regions"], cell["tile_rows"])
    tiles = eng.tile_list(cell["layout"], ids)
    assert len(tiles) == 4096
    assert eng.pair_count(tiles, np.array(sizes)) == 68719476736


def _draw(seed, sizes=(256, 200), n_samples=100):
    return phased_mac.draw(list(sizes), 256, n_samples, seed, "cpu")


def test_same_seed_same_planes():
    a, b, c = _draw(2 ** 32 + 3), _draw(2 ** 32 + 3), _draw(2 ** 32 + 4)
    assert set(a) == set(_pack.KEYS) | {"n_rec"}
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert not np.array_equal(a["alt_bits"], c["alt_bits"])


def test_minor_counts_are_exact_and_at_least_the_floor():
    import torch
    n_samples = 100
    st = _draw(11, n_samples=n_samples)
    for b, n in enumerate(st["n_rec"]):
        bits = _pack.unpack(torch.from_numpy(st["alt_bits"][b].view(
            np.int32)), 2 * n_samples).sum(1).numpy()
        ac = st["ac"][b]
        assert np.array_equal(bits[:n], ac[:n])
        assert np.all(bits[n:] == 0) and not st["valid"][b, n:].any()
        assert np.all((ac[:n] >= 5) & (ac[:n] <= n_samples))
    assert np.all(np.diff(st["pos"][st["valid"]]) > 0)


def test_spectrum_is_one_over_k():
    ks, p = phased_mac.mac_spectrum(32470, 5)
    assert ks[0] == 5 and ks[-1] == 32470
    assert np.isclose(p.sum(), 1.0) and np.isclose(p[0] / p[5], 10 / 5)


def _reader():
    return R.load_module("metrics", "phased_tile.mma_roofline_pct")


def test_reader_reads_nothing_without_a_trace():
    run = types.SimpleNamespace(device_trace=None, shapes={})
    assert _reader().read(run, None) is None


@pytest.mark.parametrize("Wh,ms,want", [
    # 2,032 words: 64 x 4096^2 x 2032 operations at 10.5e15/s, 0.2077 ms,
    # above the bytes' 0.0449 ms
    (2032, 0.5, 100 * 64 * 4096 ** 2 * 2032 / 10.5e15 / 0.5e-3),
    # 160 words: the bytes bound it, as phased_tile.roofline_pct counts
    (160, 0.1, 100 * (5242880 + 73728 + 83886080 + 524288) / 3.35e12
     / 0.1e-3)])
def test_reader_takes_the_larger_bound(Wh, ms, want):
    trace = types.SimpleNamespace(
        kernel=lambda p: (7, 7 * ms * 1e-3) if p == "phased_tile_kernel"
        else (0, 0.0))
    run = types.SimpleNamespace(device_trace=trace,
                                shapes=dict(B=4096, Wh=Wh))
    got = _reader().read(run, None)
    assert 0 < got <= 100 and got == pytest.approx(want, rel=1e-12)


def _small():
    cell, cfg = R.load_cell(CELL)
    cell = dict(cell, name=CELL, regions=[600, 500], tile_rows=256,
                check={"off_diagonal": 6})
    return cell, dict(cfg, n_samples=300)


def test_small_run_is_correct():
    cell, cfg = _small()
    line, _ = R.run_cell(CELL, 2 ** 31 + 7, 0.2, 0, device="cpu", cell=cell,
                         config=cfg)
    assert line["correct"], line["checks"]
    assert line["checks"]["pairs_gap"]["value"] == 0
    assert line["checks"]["unproven"]["value"] == 0
    assert set(line["metrics"]) == {"pairs_per_s", "setup_s"}


def test_float32_control_is_not_correct():
    cell, cfg = _small()
    nums = control_written.control_numbers(CELL, 11, "cpu", cell, cfg)
    assert nums["written_compared"] > 0 and nums["records"] > 0
    assert [k for k, v in cell["limits"].items()
            if k in nums and nums[k] > v], nums


@pytest.fixture(scope="module")
def one_pass(tmp_path_factory):
    """A small pass of the cell's entry on the CPU: (run, state, records).
    At 80 samples the rare variants keep hundreds of pairs, and rows
    share them."""
    from ldbench.tworead import read_records
    cell, cfg = _small()
    cfg = dict(cfg, n_samples=80)
    run = R.Run(CELL, cell, cfg, 2 ** 33 + 5, 0, 0, "cpu",
                str(tmp_path_factory.mktemp("hrc_pass")))
    state = ew.setup(run)
    unit = ew.unit(run, state)
    ew.release(run, state)
    recs = read_records(state["out"])
    assert len(recs) == unit["records"] > 0
    return run, state, recs


def test_every_written_record_is_compared(one_pass):
    run, state, recs = one_pass
    nums = ew.written_numbers(run, recs, state["stacked"], state["tiles"])
    # every kept pair is written forward and reversed
    assert nums["written_compared"] == len(recs) // 2
    assert nums["pairs_differ"] == nums["outside"] == 0
    assert nums["stat_gap"] <= 1e-9 and nums["p_gap"] <= 1e-4


def test_written_faults_are_seen(one_pass):
    """A statistic off by 1e-8, a P off by 1e-3, a record moved onto
    another row, records of a tile outside the pass, a reversed copy
    missing, and a pair missing from rows that other records name."""
    run, state, recs = one_pass
    st, tiles = state["stacked"], state["tiles"]

    def nums(r, t=tiles):
        return ew.written_numbers(run, r, st, t)
    bad = recs.copy()
    bad["R2"] *= 1 + 1e-8
    assert nums(bad)["stat_gap"] > 1e-9
    bad = recs.copy()
    bad["P"] *= 1 + 1e-3
    assert nums(bad)["p_gap"] > 1e-4
    # the forward copy of a pair moved onto another row of its block
    fwd = (recs["packA"] >> 2) < (recs["packB"] >> 2)
    loc = eng.chk.Locator(st)
    b, r = loc.find((recs["packA"][fwd][:1] >> 2).astype(np.int64))
    moved = recs[fwd][:1].copy()
    moved["packA"] = np.uint32(st["pos"][b[0], (r[0] + 1) % 4]) << 2
    assert nums(np.concatenate([recs, moved]))["pairs_differ"] > 0
    # the records' tiles taken out of the list
    kept = {(int(i), int(j)) for i, j in zip(*[
        loc.find((recs[k][fwd] >> 2).astype(np.int64))[0]
        for k in ("packA", "packB")])}
    rest = [t for t in tiles if (t[0], t[1]) not in kept]
    n = nums(recs, rest)
    assert n["outside"] == len(recs) == n["pairs_differ"]
    # one reversed copy dropped
    rev = np.flatnonzero(~fwd)
    assert nums(np.delete(recs, rev[0]))["pairs_differ"] > 0
    # both copies of a pair whose two rows other records of its tile name
    key = lambda p: (p >> 2).astype(np.int64)
    a, c = key(recs["packA"]), key(recs["packB"])
    lo, hi = np.minimum(a, c), np.maximum(a, c)
    tile = loc.find(lo)[0] * (1 << 32) + loc.find(hi)[0]
    pick = next(x for x in np.flatnonzero(fwd)
                if ((lo == lo[x]) & (tile == tile[x])).sum() > 2
                and ((hi == hi[x]) & (tile == tile[x])).sum() > 2)
    drop = (lo == lo[pick]) & (hi == hi[pick])
    assert drop.sum() == 2
    assert nums(recs[~drop])["pairs_differ"] == 1


def test_a_pass_that_writes_nothing_is_unproven(one_pass):
    run, state, recs = one_pass
    st = state["stacked"]
    written = ew.written_numbers(run, recs[:0], st, state["tiles"])
    assert written["written_compared"] == 0 and written["pairs_differ"] == 0
    sampled = dict(pairs_differ=0, stat_gap=0.0, p_gap=0.0,
                   pairs_compared=0)
    assert ew.merge(sampled, written)["unproven"] == 1
    assert ew.merge(dict(sampled, pairs_compared=1), written)[
        "unproven"] == 0
