"""The readers of the program's spans (ldbench/program_spans.py): each of
the six gives a value in a traced run of the CPU's small cells, and the
move onto the trace's clock finds a known offset."""

import types

import pytest

from ldbench import program_spans as ps
from ldbench import run as R
from ldbench.tests.test_ldbench_harness import _cell, _engine_cell

ENGINE = ("engine.dispatch_idle_pct", "engine.wait_idle_pct")
CALC = ("calc.read_pct", "calc.inflate_wait_pct", "calc.segment_wait_pct",
        "calc.write_wait_pct")


def _traced(cell, cfg):
    line, run = R.run_cell(cell["name"], 2 ** 31 + 11, 0.5, 1, device="cpu",
                           cell=cell, config=cfg)
    assert line["correct"], line["checks"]
    return line, run


def _read(name, run):
    return R.load_module("metrics", name).read(run, None)


@pytest.mark.parametrize("cell", ["phased", "unphased"])
def test_engine_readers_read(cell):
    if cell == "phased":
        c, cfg = _engine_cell()
    else:
        c, cfg = _cell("kg3_unphased.engine_far", regions=[600, 500],
                       tile_rows=256, check={"off_diagonal": 100})
    line, run = _traced(c, cfg)
    for name in ENGINE:
        value = line["metrics"][name]["value"]
        assert 0 <= value <= 100, (name, value)
        assert _read(name, run) == value
    # no kernel runs on the CPU: the card is idle all the window, so the
    # main thread's dispatch shows whole
    assert line["metrics"]["engine.dispatch_idle_pct"]["value"] > 0
    assert not {n for n, _ in line["breakdown"]["device_ops"]} \
        & {s[0] for s in ps.spans(run)}


def test_calc_readers_read():
    cell, cfg = _cell("kg3_phased.calc_diag", regions=[1300], tile_rows=512,
                      import_block=128,
                      check={"off_diagonal": 2, "diagonal": 2})
    line, run = _traced(cell, cfg)
    for name in CALC:
        value = line["metrics"][name]["value"]
        assert 0 <= value <= 100, (name, value)
    assert line["metrics"]["calc.read_pct"]["value"] > 0
    assert line["metrics"]["calc.inflate_wait_pct"]["value"] > 0
    assert line["metrics"]["calc.write_wait_pct"]["value"] > 0
    # the spans are the window's: one calc.job a unit
    jobs = [s for s in ps.spans(run) if s[0] == "calc.job"]
    assert len(jobs) == line["attempted"]
    for (a, b), j in zip(run.walls, sorted(jobs, key=lambda s: s[1])):
        assert a <= j[1] < j[2] <= b


def _fake_run(units, walls, busy, names, chips=1):
    dt = types.SimpleNamespace(units=units, window=(units[0][0],
                                                    units[-1][1]),
                               busy={0: busy})
    dt.window_s = lambda: dt.window[1] - dt.window[0]
    run = types.SimpleNamespace(device_trace=dt, walls=walls,
                                cell=dict(chips=chips),
                                counters={ps.KEY: names})
    return run


def test_clock_offset_from_the_units():
    """Host walls at 10 + k s, the trace's units 1000 s later, their ends
    up to 30 us later still: offset 1000 s, spread 0; a span placed by
    it covers the trace's idle time it was open in."""
    walls = [(10.0 + k, 10.5 + k) for k in range(4)]
    units = [(a + 1000.0, b + 1000.0 + 1e-5 * k)
             for k, (a, b) in enumerate(walls)]
    # busy all but [1010.1, 1010.3) and [1012.0, 1012.5)
    busy = [(1010.0, 1010.1), (1010.3, 1012.0), (1012.5, 1013.5)]
    span = ("engine.dispatch", 10.2, 10.4, "MainThread", 1, None, 1)
    wait = ("engine.wait", 12.0, 12.2, "MainThread", 2, None, 1)
    run = _fake_run(units, walls, busy, [span, wait])
    off, spread = ps.trace_offset(run)
    assert off == pytest.approx(1000.0, abs=1e-9)
    assert spread == pytest.approx(0.0, abs=1e-9)
    win = units[-1][1] - units[0][0]
    assert ps.idle_share(run, ("engine.dispatch",)) == pytest.approx(
        100 * 0.1 / win)
    assert ps.idle_share(run, ("engine.wait",)) == pytest.approx(
        100 * 0.2 / win)
    assert ps.share(run, ("engine.dispatch", "engine.wait")) == \
        pytest.approx(100 * 0.4 / 2.0)


def test_no_recorder_reads_nothing(monkeypatch):
    """A checkout whose program records no spans (the parent of the
    recorder): every reader gives None and raises nothing."""
    import sys
    monkeypatch.setitem(sys.modules, "tomahawk_tpu_torch.spans", None)
    run = _fake_run([(0.0, 1.0)], [(0.0, 1.0)], [], None)
    run.counters = {}
    for name in ENGINE + CALC:
        assert _read(name, run) is None
