"""The benchmark's files: every cell and configuration parses, names and
units keep to their characters, each cell's pair count is its tile
list's, and the harness finds a cell added as a file alone."""

import json
import os
import re
import shutil

import numpy as np
import pytest

from ldbench import run as R
from ldbench.entries import engine as eng
from ldbench.roofline import parts_tile, phased_tile

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = R.load_json(os.path.join(R.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_names_units_and_files():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(R.ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
        assert R.load_json(os.path.join(R.ROOT, c["file"]))["reduced"] \
            == c["reduced"]
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for name in names:
        assert os.path.exists(os.path.join(R.HERE, "metrics", f"{name}.py"))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parses(cell):
    c, cfg = R.load_cell(cell)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c["config"] == w["config"] and c["chips"] == w["chips"]
    assert os.path.exists(os.path.join(R.HERE, "entries", f"{c['entry']}.py"))
    assert os.path.exists(os.path.join(R.HERE, "traffic",
                                       f"{c['generator']}.py"))
    assert NAME.match(w["traffic"])
    for k, v in c["limits"].items():
        assert v >= 0, k
    assert R.cell_metrics(BENCH, cell, "end_to_end")
    assert R.cell_metrics(BENCH, cell, "per_layer")


#: every cell's pairs a unit, worked out by hand
PAIRS = {"kg3_phased.engine_far": 531500 ** 2,
         "kg3_phased.engine_far.x4": 531500 ** 2,
         "kg3_phased.calc_diag": 32768 * 32767 // 2,
         "kg3_unphased.engine_far": 262144 ** 2}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_pair_count(cell):
    c, _ = R.load_cell(cell)
    sizes, ids = eng.block_sizes(c["regions"], c["tile_rows"])
    tiles = eng.tile_list(c["layout"], ids)
    n_rec = np.array(sizes)
    assert eng.pair_count(tiles, n_rec) == PAIRS[cell]


@pytest.mark.parametrize("layout,regions", [("far", [700, 450]),
                                            ("all", [1100])])
def test_pair_count_brute_force(layout, regions):
    """The count from tile shapes equals the pairs a tile list holds,
    enumerated one by one; so does the candidate count against the skip
    rule applied pair by pair."""
    sizes, ids = eng.block_sizes(regions, 256)
    tiles = eng.tile_list(layout, ids)
    rng = np.random.default_rng(3)
    ac = np.zeros((len(sizes), 256), np.int64)
    valid = np.zeros((len(sizes), 256), bool)
    for b, n in enumerate(sizes):
        ac[b, :n] = rng.integers(0, 4, n)
        valid[b, :n] = True
    brute = cand = 0
    for i, j, d in tiles:
        for k in range(sizes[i]):
            for m in range(k + 1 if d else 0, sizes[j]):
                brute += 1
                cand += ac[i, k] + ac[j, m] > 2
    stacked = dict(n_rec=np.array(sizes), ac=ac, valid=valid)
    assert eng.pair_count(tiles, stacked["n_rec"]) == brute
    assert eng.candidate_count(tiles, stacked) == cand


def test_roofline_bytes_by_hand():
    # B = 4096, 160 words a haplotype plane: 2 x 4096 x 160 x 4 plane
    # bytes, 2 x 4096 x 9 of ac/an/valid, 4096^2 x (1 mask + 4 ALTALT),
    # 4096 x 32 x 4 of counts
    assert phased_tile.bytes_per_call(4096, 160) == \
        5242880 + 73728 + 83886080 + 524288
    # P = 9, 80 words a sample plane, 3 planes a side
    assert parts_tile.bytes_per_call(4096, 80) == \
        7864320 + 139264 + 620756992 + 524288
    assert phased_tile.ops_per_call(4096, 160) == 64 * 4096 * 4096 * 160


def test_discovery_of_a_cell_added_as_a_file(tmp_path):
    """A later change adds a cell by adding its file: the harness finds
    it, its configuration and its metrics without an edit elsewhere."""
    root = tmp_path / "checkout"
    shutil.copytree(R.HERE, root / "ldbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(R.ROOT, "BENCHMARK.json"), root)
    cell = dict(R.load_json(os.path.join(
        R.HERE, "cells", "kg3_phased.engine_far.json")), regions=[9000, 9000])
    (root / "ldbench" / "cells" / "dummy.engine_far.json").write_text(
        json.dumps(cell))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="dummy.engine_far",
                                   config="kg3_phased", traffic="x",
                                   chips=1, why="a test"))
    for m in bench["per_layer"]:
        if m["name"] == "device_idle_pct":
            m["workloads"].append("dummy.engine_far")
    got, cfg = R.load_cell("dummy.engine_far", root=str(root))
    assert got["regions"] == [9000, 9000] and cfg["n_samples"] == 2504
    assert [m["name"] for m in R.cell_metrics(bench, "dummy.engine_far",
                                              "per_layer")] \
        == ["device_idle_pct"]
    mod = R.load_module("metrics", "device_idle_pct", root=str(root))
    assert mod.read is not None
    assert R.load_module("entries", got["entry"], root=str(root)).unit


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "tomahawk_tpu_torch_fake",
                        types.ModuleType("tomahawk_tpu_torch_fake"))
    monkeypatch.setitem(sys.modules, "jaxlike", types.ModuleType("jaxlike"))
    for name in R.FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tomahawk_tpu.ops",
                        types.ModuleType("tomahawk_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert R.forbidden_modules() == ["jax", "tomahawk_tpu"]


def test_idle_time_by_host_annotation():
    from ldbench.trace import idle_by_host, union
    busy = [(1.0, 2.0), (4.0, 5.0)]
    notes = [("window", 0.0, 6.0), ("unit", 0.0, 6.0),
             ("calc.read", 2.5, 3.5), ("calc.write", 3.0, 4.5)]
    got = dict(idle_by_host(busy, notes, (0.0, 6.0)))
    # idle: 0-1, 2-4, 5-6; 2.5-3 read, 3-4 write (started last)
    assert got == {"host: unit": 2.5, "host: calc.read": 0.5,
                   "host: calc.write": 1.0}
    assert union([(0, 2), (1, 3), (5, 6)], 0.5, 5.5) == 3.0
