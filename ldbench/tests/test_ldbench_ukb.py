"""The UK Biobank cell and the windowed calc cell: their files, the
planted genotype traffic (`genotype_planted`), the reference in sample
blocks, the roofline with the contraction counted from parts_tile's
loop, the screen's counter, and small runs of both cells through the
harness on the CPU."""

import os
import types

import numpy as np
import pytest
import torch

from ldbench import control_written
from ldbench import run as R
from ldbench.entries import calc_window as cw
from ldbench.entries import engine as eng
from ldbench.entries import engine_biobank as eb
from ldbench.reference import ld as ref_ld
from ldbench.reference import ld_blocked
from ldbench.traffic import _pack, genotype, genotype_planted

UKB = "ukb_unphased.engine_far"
WIN = "kg3_phased.calc_window"
BENCH = R.load_json(os.path.join(R.ROOT, "BENCHMARK.json"))


def test_files_load_and_name_existing_modules():
    cell, cfg = R.load_cell(UKB)
    assert cfg["n_samples"] == 488377 and not cfg["phased"]
    assert cfg["reduced"] == ["region_variants"]
    assert len(cfg["source"]) <= 200
    for name in (UKB, WIN):
        c, _ = R.load_cell(name)
        for kind, mod in (("entries", c["entry"]),
                          ("traffic", c["generator"])):
            assert os.path.exists(os.path.join(R.HERE, kind, f"{mod}.py"))
        for group in ("end_to_end", "per_layer"):
            for m in R.cell_metrics(BENCH, name, group):
                assert R.load_module("metrics", m["name"]).read
    per_layer = {m["name"] for m in R.cell_metrics(BENCH, UKB, "per_layer")}
    assert {"parts_tile.mma_roofline_pct", "parts_tile.undecided_pct",
            "device_idle_pct"} <= per_layer
    assert "parts_tile.undecided_pct" in {
        m["name"] for m in R.cell_metrics(BENCH, "kg3_unphased.engine_far",
                                          "per_layer")}
    assert {m["name"] for m in R.cell_metrics(BENCH, WIN, "end_to_end")} \
        == {"calc_pairs_per_s", "setup_s"}


def test_pair_counts_of_both_cells():
    cell, _ = R.load_cell(UKB)
    sizes, ids = eng.block_sizes(cell["regions"], cell["tile_rows"])
    tiles = eng.tile_list(cell["layout"], ids)
    assert len(tiles) == 64
    assert eng.pair_count(tiles, np.array(sizes)) == 1073741824
    # the window cell: positions from the generator's host draw alone
    cell, cfg = R.load_cell(WIN)
    rng = np.random.default_rng(5)
    pos = np.cumsum(rng.integers(50, 500, cell["regions"][0]))
    B = cell["tile_rows"]
    stacked = dict(n_rec=np.full(len(pos) // B, B, np.int32),
                   pos=pos.reshape(-1, B), valid=np.ones((len(pos) // B, B),
                                                         bool),
                   ac=np.full((len(pos) // B, B), 3, np.int32))
    tiles = cw.window_tiles(stacked, cell["window"])
    pairs, cand = cw.window_pairs(stacked, cell["window"])
    assert 60 <= len(tiles) <= 80 and len(tiles) < 136
    assert pairs == cand and 7e8 < pairs < 1e9


def test_window_counts_brute_force():
    rng = np.random.default_rng(9)
    n, B, window = 700, 128, 9000
    pos = np.cumsum(rng.integers(50, 500, n))
    ac = rng.integers(0, 4, n)
    NB = -(-n // B)
    st = dict(n_rec=np.array([min(B, n - b * B) for b in range(NB)]),
              pos=np.zeros((NB, B), np.int64), ac=np.zeros((NB, B), int),
              valid=np.zeros((NB, B), bool))
    for b in range(NB):
        m = st["n_rec"][b]
        st["pos"][b, :m] = pos[b * B:b * B + m]
        st["ac"][b, :m] = ac[b * B:b * B + m]
        st["valid"][b, :m] = True
    d = np.abs(pos[:, None] - pos[None, :])
    upper = np.triu(np.ones((n, n), bool), 1)
    inside = upper & (d <= window)
    assert cw.window_pairs(st, window) == (
        int(inside.sum()), int((inside & (ac[:, None] + ac[None, :] > 2))
                               .sum()))
    blk = np.arange(n) // B
    want = {(int(blk[i]), int(blk[j])) for i, j in zip(*np.nonzero(inside))}
    got = {(i, j) for i, j, _ in cw.window_tiles(st, window)}
    assert want <= got and all(i <= j for i, j in got)


def _draw(seed, sizes=(256, 200, 256, 240), n_samples=300, **kw):
    return genotype_planted.draw(list(sizes), 256, n_samples, seed, "cpu",
                                 **kw)


def test_same_seed_same_planes():
    a, b, c = _draw(2 ** 32 + 3), _draw(2 ** 32 + 3), _draw(2 ** 32 + 4)
    assert set(a) == set(_pack.KEYS) | {"n_rec", "planted"}
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert not np.array_equal(a["het_bits"], c["het_bits"])


def test_planes_and_counts_agree():
    n_samples = 300
    st = _draw(11, n_samples=n_samples, miss_frac=0.05)
    for b, n in enumerate(st["n_rec"]):
        het, hom, called = (_pack.unpack(torch.from_numpy(
            st[k][b].view(np.int32)), n_samples).numpy()
            for k in ("het_bits", "hom_bits", "valid_bits"))
        assert not (het & hom).any() and not ((het | hom) & ~called).any()
        assert np.array_equal(het.sum(1)[:n], st["n_het"][b, :n])
        assert np.array_equal(hom.sum(1)[:n], st["n_hom"][b, :n])
        assert np.array_equal((het.sum(1) + 2 * hom.sum(1))[:n],
                              st["ac"][b, :n])
        assert np.array_equal(2 * (n_samples - called.sum(1))[:n],
                              st["an"][b, :n])
        assert not called[n:].any() and not st["valid"][b, n:].any()
        # the padding bits past the samples are 0
        words = st["valid_bits"][b][:n]
        assert np.all(words[:, -1] >> (n_samples % 32) == 0)
    assert st["alt_bits"].strides[0] == 0 and st["miss_bits"].strides[0] == 0
    assert np.all(np.diff(st["pos"][st["valid"]]) > 0)


def test_pack_words_matches_the_packer():
    bits = torch.rand((5, 77)) < 0.5
    got = genotype_planted.pack_words(bits, _pack.words_for(77))
    assert np.array_equal(got.numpy().view(np.uint32),
                          _pack.pack(bits, _pack.words_for(77), 5))


def test_planted_pairs_one_a_tile_in_ld():
    n_samples = 2000
    st = _draw(7, n_samples=n_samples, miss_frac=0.01,
               planted_r2=(0.5, 1.0))
    plan = st["planted"]
    assert sorted((int(a), int(b)) for a, _, b, _ in plan) == \
        [(0, 2), (0, 3), (1, 2), (1, 3)]
    for a, ra, b, rb in plan:
        planes = [{k: torch.from_numpy(st[k][blk][r:r + 1].view(np.int32))
                   for k in eb.PLANES} for blk, r in ((a, ra), (b, rb))]
        T = ld_blocked.genotype_tables(*planes, n_samples)[0, 0].numpy()
        # dosage correlation well above chance at r2 >= 0.5
        g = np.arange(3)
        n = T.sum()
        ma, mb = (T.sum(1) @ g) / n, (T.sum(0) @ g) / n
        cov = (g[:, None] * g[None, :] * T).sum() / n - ma * mb
        va = (T.sum(1) @ g ** 2) / n - ma ** 2
        vb = (T.sum(0) @ g ** 2) / n - mb ** 2
        assert cov / np.sqrt(va * vb) > 0.5


def _planes_of(st, b, rows, keys):
    return {k: torch.from_numpy(st[k][b][rows].view(np.int32))
            for k in keys}


@pytest.mark.parametrize("words", [1, 4, ld_blocked.WORDS])
def test_blocked_reference_is_ld_bit_for_bit(words):
    """On the unphased cell's planes, which hold haplotype and sample
    planes alike, the blocked reference gives ld.tile's unphased result
    bit for bit, whatever the block of sample words."""
    n_samples = 500
    st = genotype.draw([300, 260], 320, n_samples, 5, "cpu",
                       miss_frac=0.05, miss_rows=0.5, maf_scale=0.5,
                       maf_floor=0.001)
    keys = ("alt_bits", "het_bits", "hom_bits", "valid_bits")
    for bi, bj, diag in ((0, 1, False), (0, 0, True)):
        pi = _planes_of(st, bi, slice(0, st["n_rec"][bi]), keys)
        pj = _planes_of(st, bj, slice(0, st["n_rec"][bj]), keys)
        want = ref_ld.tile(pi, pj, diag, "unphased", n_samples, 0.002)
        got = ld_blocked.tile(pi, pj, diag, n_samples, 0.002, words=words)
        assert set(got) == set(want) and len(want["idx"]) > 10
        for k in want:
            assert torch.equal(got[k], want[k]), k


def _small(n_samples=300):
    cell, cfg = R.load_cell(UKB)
    cell = dict(cell, name=UKB, regions=[512, 480], tile_rows=256,
                check=dict(cell["check"], sub_tiles=3, sub_rows=40))
    return cell, dict(cfg, n_samples=n_samples)


def test_small_run_is_correct():
    cell, cfg = _small()
    line, _ = R.run_cell(UKB, 2 ** 31 + 7, 0.2, 0, device="cpu", cell=cell,
                         config=cfg)
    assert line["correct"], line["checks"]
    for k in ("pairs_gap", "unproven", "pairs_differ"):
        assert line["checks"][k]["value"] == 0
    assert set(line["metrics"]) == {"pairs_per_s", "setup_s"}


def test_float32_control_is_not_correct():
    cell, cfg = _small(n_samples=20000)
    nums = control_written.control_numbers(UKB, 13, "cpu", cell, cfg)
    assert nums["written_compared"] > 0 and nums["records"] > 0
    assert [k for k, v in cell["limits"].items()
            if k in nums and nums[k] > v], nums


@pytest.fixture(scope="module")
def one_pass(tmp_path_factory):
    """A small pass of the UKB entry on the CPU: (run, state, records)."""
    from ldbench.tworead import read_records
    cell, cfg = _small()
    run = R.Run(UKB, cell, cfg, 2 ** 33 + 5, 0, 0, "cpu",
                str(tmp_path_factory.mktemp("ukb_pass")))
    state = eb.setup(run)
    unit = eb.unit(run, state)
    eb.release(run, state)
    recs = read_records(state["out"])
    assert len(recs) == unit["records"] > 0
    return run, state, recs


def test_planted_pairs_are_written_and_compared(one_pass):
    run, state, recs = one_pass
    st = state["stacked"]
    loc = eng.chk.Locator(st)
    (ba, ra), (bb, rb) = (loc.find((recs[k] >> 2).astype(np.int64))
                          for k in ("packA", "packB"))
    written = set(zip(ba.tolist(), ra.tolist(), bb.tolist(), rb.tolist()))
    assert sum(tuple(p) in written for p in st["planted"].tolist()) > 0
    nums = eb.written_numbers(run, recs, st, state["tiles"])
    # a pair on a rounding edge (a tie) is left out
    assert 0 < nums["written_compared"] <= len(recs) // 2
    assert nums["pairs_differ"] == nums["outside"] == 0
    sampled = eb.sampled_numbers(run, recs, st, state["tiles"])
    assert sampled["pairs_differ"] == 0 and sampled["pairs_compared"] > 0
    # every cut tile holds its planted pair's rows
    for (bi, bj), ri, rj in eb.cut_tiles(run, st, state["tiles"]):
        mine = st["planted"][(st["planted"][:, 0] == bi)
                             & (st["planted"][:, 2] == bj)]
        assert set(mine[:, 1]) <= set(ri) and set(mine[:, 3]) <= set(rj)


def test_written_faults_are_seen(one_pass):
    run, state, recs = one_pass
    st, tiles = state["stacked"], state["tiles"]
    bad = recs.copy()
    bad["R2"] *= 1 + 1e-3
    assert eb.written_numbers(run, bad, st, tiles)["stat_gap"] > 1e-4
    bad = recs.copy()
    bad["P"] *= 1 + 1e-3
    assert eb.sampled_numbers(run, bad, st, tiles)["p_gap"] > 1e-4
    fwd = (recs["packA"] >> 2) < (recs["packB"] >> 2)
    drop = np.flatnonzero(fwd)[:1]
    assert eb.written_numbers(run, np.delete(recs, drop), st,
                              tiles)["pairs_differ"] > 0


def _reader(name):
    return R.load_module("metrics", name)


def test_mma_roofline_counts_the_loop():
    from ldbench.roofline import parts_tile, parts_tile_loop
    # 4096^2 pairs x 15,264 words x 9 products x 64 at 10.5e15/s
    assert parts_tile_loop.ops_per_call(4096, 15264) == \
        64 * 9 * 4096 ** 2 * 15264
    assert parts_tile_loop.ops_per_call(4096, 80) == \
        parts_tile.ops_per_call(4096, 80)
    # a ragged last step and partial blocks are contracted whole
    assert parts_tile_loop.pair_words(100, 13) == 9 * 128 * 128 * 16
    ms = 28.0
    trace = types.SimpleNamespace(
        kernel=lambda p: (4, 4 * ms * 1e-3) if p == "parts_tile_kernel<2>"
        else (0, 0.0))
    run = types.SimpleNamespace(device_trace=trace,
                                shapes=dict(B=4096, Ws=15264))
    got = _reader("parts_tile.mma_roofline_pct").read(run, None)
    want = 100 * 64 * 9 * 4096 ** 2 * 15264 / 10.5e15 / (ms * 1e-3)
    assert 0 < got <= 100 and got == pytest.approx(want, rel=1e-12)
    assert _reader("parts_tile.mma_roofline_pct").read(
        types.SimpleNamespace(device_trace=None, shapes={}), None) is None


def test_undecided_share_reads_the_engine_counter(monkeypatch):
    from tomahawk_tpu_torch.compute import engine
    reader = _reader("parts_tile.undecided_pct")
    run = types.SimpleNamespace(device_trace=object())
    monkeypatch.setattr(engine, "SCREEN_TOTALS",
                        dict(screened=4000, undecided=3))
    assert reader.read(run, None) == pytest.approx(0.075)
    monkeypatch.setattr(engine, "SCREEN_TOTALS",
                        dict(screened=0, undecided=0))
    assert reader.read(run, None) is None
    monkeypatch.delattr(engine, "SCREEN_TOTALS")
    assert reader.read(run, None) is None
    assert reader.read(types.SimpleNamespace(device_trace=None),
                       None) is None


def _small_window():
    cell, cfg = R.load_cell(WIN)
    cell = dict(cell, name=WIN, regions=[1280], tile_rows=256,
                window=60000, import_block=128)
    return cell, dict(cfg, n_samples=60)


def test_small_window_run_is_correct():
    cell, cfg = _small_window()
    line, _ = R.run_cell(WIN, 2 ** 31 + 9, 0.2, 0, device="cpu", cell=cell,
                         config=cfg)
    assert line["correct"], line["checks"]
    assert line["checks"]["pairs_gap"]["value"] == 0
    assert set(line["metrics"]) == {"calc_pairs_per_s", "setup_s"}
