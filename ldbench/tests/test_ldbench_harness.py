"""A whole run of the harness on the CPU at a small size, past its look
for a card: correct as it stands, and not correct with the timed path
broken underneath in each way a cell can be, or with the float32 control
in the program's place."""

import numpy as np
import pytest

from ldbench import control
from ldbench import run as R

SMALL = dict(n_samples=64)


def _cell(name, **kw):
    cell, cfg = R.load_cell(name)
    return dict(cell, name=name, **kw), dict(cfg, **SMALL)


def _engine_cell(chips=1):
    cell, cfg = _cell("kg3_phased.engine_far", regions=[700, 500],
                      tile_rows=256, check={"off_diagonal": 100})
    if chips > 1:
        # 64-row tiles: a segment of 32 gives each pairs shard 16
        cell = dict(cell, chips=chips, mesh=[chips, 1], tile_rows=64)
    return cell, cfg


def _run(cell, cfg, seed=2 ** 31 + 7):
    line, _ = R.run_cell(cell["name"], seed, 0.2, 0, device="cpu",
                         cell=cell, config=cfg)
    return line


@pytest.mark.parametrize("chips", [1, 2])
def test_engine_run_is_correct(chips):
    line = _run(*_engine_cell(chips))
    assert line["correct"], line["checks"]
    assert line["checks"]["pairs_gap"]["value"] == 0
    assert line["metrics"]["pairs_per_s"]["value"] > 0
    assert list(line)[-1] == "checks"


def test_calc_run_is_correct():
    cell, cfg = _cell("kg3_phased.calc_diag", regions=[1300], tile_rows=512,
                      import_block=128,
                      check={"off_diagonal": 2, "diagonal": 2})
    line = _run(cell, cfg)
    assert line["correct"], line["checks"]


def test_unphased_run_is_correct():
    cell, cfg = _cell("kg3_unphased.engine_far", regions=[600, 500],
                      tile_rows=256, check={"off_diagonal": 100})
    line = _run(cell, cfg)
    assert line["correct"], line["checks"]


def _half_the_tiles(monkeypatch):
    from tomahawk_tpu_torch.compute import engine
    real = engine.LdEngine.run_group

    def half(self, tiles, *a, **kw):
        return real(self, tiles[:len(tiles) // 2], *a, **kw)
    monkeypatch.setattr(engine.LdEngine, "run_group", half)


def _answer_altered(monkeypatch):
    from tomahawk_tpu_torch.compute import engine
    real = engine.ld_records

    def altered(*a, **kw):
        out = real(*a, **kw)
        if out is not None and len(out[0]):
            out[0]["R2"][0] *= 1 + 1e-6
        return out
    monkeypatch.setattr(engine, "ld_records", altered)


def _nothing_written(monkeypatch):
    from tomahawk_tpu_torch.io.two import TwoWriter
    monkeypatch.setattr(TwoWriter, "add", lambda self, recs: None)


def _exchange_left_out(monkeypatch):
    """The host reads the survivors of the first pairs shard only: the
    other cards' part of each segment never reaches the records."""
    from tomahawk_tpu_torch.compute import engine
    real = engine.LdEngine._dispatch_fused

    def first_shard(self, tiles, cfg):
        st = real(self, tiles, cfg)
        for sh in st["shards"][1:]:
            sh["n_pass"] = sh["n_pass"] * 0
        return st
    monkeypatch.setattr(engine.LdEngine, "_dispatch_fused", first_shard)


@pytest.mark.parametrize("fault,chips", [
    (_half_the_tiles, 1), (_answer_altered, 1), (_nothing_written, 1),
    (_exchange_left_out, 2)])
def test_fault_is_not_correct(monkeypatch, fault, chips):
    fault(monkeypatch)
    line = _run(*_engine_cell(chips))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name,kw", [
    ("kg3_phased.engine_far", dict(regions=[900, 700], tile_rows=256,
                                   check={"off_diagonal": 6})),
    ("kg3_phased.calc_diag", dict(regions=[1000], tile_rows=256,
                                  check={"off_diagonal": 2, "diagonal": 2})),
    ("kg3_unphased.engine_far", dict(regions=[900, 700], tile_rows=256,
                                     check={"off_diagonal": 6}))])
def test_float32_control_is_not_correct(name, kw):
    cell, cfg = _cell(name, **kw)
    cfg = dict(cfg, n_samples=256)
    nums = control.control_numbers(name, 11, "cpu", cell, cfg)
    assert nums["pairs_compared"] > 0
    over = [k for k, v in cell["limits"].items()
            if k in nums and nums[k] > v]
    assert over, nums


def test_records_from_reference_round_trip():
    """The control's records, compared with the reference they came
    from, differ in nothing."""
    cell, cfg = _cell("kg3_phased.calc_diag", regions=[600], tile_rows=256,
                      check={"off_diagonal": 1, "diagonal": 1})
    import torch
    from ldbench import check as chk
    from ldbench.entries import engine as eng
    run = R.Run("t", cell, cfg, 5, 0, 0, "cpu", None)
    stacked, ids = eng.draw_planes(run)
    pick = chk.sample_tiles(eng.tile_list("all", ids), 5, 1, 1)
    refs = eng.reference_tiles(run, stacked, pick, torch.float64)
    got = chk.compare(control.records_from(refs, stacked), stacked, refs)
    assert got["pairs_differ"] == 0 and got["stat_gap"] == 0.0
    assert got["pairs_compared"] == sum(len(r["idx"]) for r in refs.values()
                                        ) - got["ties"] > 0
    assert np.isfinite(got["p_gap"])
