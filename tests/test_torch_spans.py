"""The port's span recorder (tomahawk_tpu_torch/spans.py) and its spans in
`compute_ld`, on the CPU.

- Nothing is recorded outside a torch profiler or `recording()`; a
  profiler turns recording on, on every thread, and off again after it.
- A `compute_ld` job under `recording()` (pipelined, serial, banded with
  the staging worker, and routed to the native CPU engine) records every
  span its path takes; each has a thread and a job id, each but the
  job's root a parent, and every child starts within its parent and,
  on its parent's thread or its caller's pool, ends within it; a
  segment's consume is the child of its dispatch, a pool's inflate of
  the caller's wait, a block's compression and its write of the add or
  close that queued it. One `write.compress` a block of the file, on the
  `twk-two-zstd` pool, with `inflight` between 1 and `threads`; one
  `write.block` a block, on `twk-two-write`.
- The job thread's child spans cover at least 90% of `calc.job`.
- The engine's `count_s`, `extract_s` and `math_s` are the summed
  seconds of their spans; the segments' `records` sum to half the job's
  records (each is written with its mirror).
- In library use each `run_group` is a job of its own.
- `calc --performance` logs the span table, with the attributes' sums
  (`inflight` over the count of `write.compress`: the mean concurrency);
  the bounded buffer counts what it drops and the table says so.
"""

import threading

import pytest

import tomahawk_tpu_torch  # noqa: F401  (binds libzstd where needed)

from tomahawk_tpu_torch import spans
from tomahawk_tpu_torch.compute import engine as E
from tomahawk_tpu_torch.compute.engine import (CalcSettings, LdEngine,
                                               compute_ld, dispatch_pairs)
from tomahawk_tpu_torch.io.importer import ImportSettings, import_vcf
from tomahawk_tpu_torch.io.two import TwoReader
from tomahawk_tpu_torch.ops.ld_math import LdFilters

from test_importer import make_vcf

#: 13 super-blocks of 32 rows, 91 tiles, at most 16 a segment
BASE = dict(force_phased=True, min_r2=0.0, tile_rows=32, sweep_segment=16,
            threads=2)
PIPELINE = ("calc.job", "calc.open", "calc.plan", "calc.read",
            "calc.inflate_wait", "calc.inflate", "engine.stage_wait",
            "engine.upload", "engine.group", "engine.dispatch",
            "engine.dispatch.tiles", "engine.dispatch.sweep",
            "engine.dispatch.readback", "engine.wait", "engine.consume",
            "engine.count", "engine.extract", "engine.repair", "engine.math",
            "engine.emit", "write.add", "write.compress", "write.block",
            "write.close")
#: the names each path takes; serial runs wait on nothing
PATHS = {
    "pipelined": (dict(), PIPELINE),
    "serial": (dict(), tuple(n for n in PIPELINE if n != "engine.wait")),
    "banded": (dict(memory_gb=2e-5), PIPELINE),
    "native": (dict(backend="cpu"),
               ("calc.job", "calc.open", "calc.plan", "calc.read",
                "calc.inflate_wait", "calc.inflate", "calc.native",
                "write.add", "write.compress", "write.block",
                "write.close")),
}


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_spans")
    vcf = str(d / "in.vcf")
    make_vcf(vcf, n_samples=40, n_sites=400, seed=3, miss_frac=0.0,
             contigs=("20",))
    twk = str(d / "in.twk")
    import_vcf(ImportSettings(input=vcf, output=twk, block_size=16))
    return twk


@pytest.fixture(autouse=True)
def _empty():
    spans.collect()
    yield
    spans.collect()


def _job(archive, tmp_path, monkeypatch, path):
    """(result, spans, engines) of one recorded job on `path`."""
    kw, _ = PATHS[path]
    engines = []
    real = E.LdEngine

    class Kept(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            if path == "serial":
                self._pipeline_enabled = False
                self._pipeline_retry_after = 1 << 30
            engines.append(self)
    monkeypatch.setattr(E, "LdEngine", Kept)
    settings = CalcSettings(input=archive, output=str(tmp_path / "o.two"),
                            **dict(BASE, **kw))
    with spans.recording():
        res = compute_ld(settings, device="cpu")
    return res, spans.collect(), engines


def test_nothing_recorded_when_off(archive, tmp_path):
    assert not spans.on()
    assert spans.span("x") is spans.NULL
    with spans.timed("y") as t:
        sum(range(1000))
    assert t.seconds > 0 and t.ctx is None
    compute_ld(CalcSettings(input=archive, output=str(tmp_path / "o.two"),
                            **BASE), device="cpu")
    assert spans.collect() == []


def test_profiler_turns_recording_on_and_off():
    from torch.profiler import ProfilerActivity, profile

    def other():
        with spans.span("other.thread"):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.on()
        with spans.span("main.thread"):
            t = threading.Thread(target=other, name="helper")
            t.start()
            t.join()
    assert not spans.on()
    with spans.span("after"):
        pass
    got = {s.name: s for s in spans.collect()}
    assert set(got) == {"main.thread", "other.thread"}
    assert got["other.thread"].thread == "helper"
    assert got["other.thread"].parent is None
    assert got["main.thread"].thread == threading.current_thread().name


def test_recording_nests_and_collect_by_job():
    with spans.recording():
        with spans.recording():
            with spans.span("a", job=True) as a:
                with spans.span("b", n=3) as b:
                    pass
        with spans.span("c", job=True) as c:
            pass
    assert not spans.on()
    assert a.job != c.job and b.job == a.job and b.parent == a.id
    mine = spans.collect(job=a.job)
    assert sorted(s.name for s in mine) == ["a", "b"]
    assert [s.attrs for s in mine if s.name == "b"] == [{"n": 3}]
    assert [s.name for s in spans.collect()] == ["c"]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_job_records_every_span_of_its_path(archive, tmp_path, monkeypatch,
                                            path):
    res, got, engines = _job(archive, tmp_path, monkeypatch, path)
    names = {s.name for s in got}
    assert set(PATHS[path][1]) <= names, set(PATHS[path][1]) - names
    by_id = {s.id: s for s in got}
    jobs = [s for s in got if s.name == "calc.job"]
    assert len(jobs) == 1 and jobs[0].parent is None
    job = jobs[0]
    for s in got:
        assert s.thread and s.job == job.job, s
        assert s.start <= s.end
        if s is job:
            continue
        parent = by_id[s.parent]
        assert parent.start <= s.start, (s, parent)
        if s.thread == parent.thread or s.name == "calc.inflate":
            # the caller waits for its pool
            assert s.end <= parent.end, (s, parent)
    kinds = {(s.name, by_id[s.parent].name) for s in got if s is not job}
    if path != "native":
        consumes = [s for s in got if s.name == "engine.consume"]
        assert consumes
        if path == "serial":
            assert ("engine.dispatch", "engine.count") in kinds
        else:
            assert {by_id[s.parent].name for s in consumes} \
                == {"engine.dispatch"}
            # one consume a dispatch, over the dispatch's tiles
            assert len({s.parent for s in consumes}) == len(consumes)
            for s in consumes:
                assert by_id[s.parent].attrs["tiles"] == s.attrs["tiles"]
                assert s.thread.startswith("twk-seg")
    assert {p for n, p in kinds if n == "calc.inflate"} \
        == {"calc.inflate_wait"}
    assert {p for n, p in kinds if n == "write.block"} \
        <= {"write.add", "write.close"}
    assert {s.thread for s in got if s.name == "write.block"} \
        == {"twk-two-write"}
    compressed = [s for s in got if s.name == "write.compress"]
    assert {p for n, p in kinds if n == "write.compress"} \
        <= {"write.add", "write.close"}
    assert all(s.thread.startswith("twk-two-zstd") for s in compressed)
    assert all(1 <= s.attrs["inflight"] <= BASE["threads"]
               for s in compressed)
    with TwoReader(str(tmp_path / "o.two")) as r:
        n_blocks = r.index.n
    assert len(compressed) == n_blocks \
        == sum(s.name == "write.block" for s in got)
    if path == "banded":
        staged = [s for s in got if s.thread.startswith("twk-stage")]
        assert {"engine.stage", "calc.read", "calc.inflate_wait",
                "engine.upload"} <= {s.name for s in staged}
        assert {p for n, p in kinds if n == "engine.stage"} \
            <= {"calc.job", "engine.group"}


@pytest.mark.parametrize("path", ["pipelined", "banded"])
def test_job_thread_covers_the_job(archive, tmp_path, monkeypatch, path):
    _, got, _ = _job(archive, tmp_path, monkeypatch, path)
    job = next(s for s in got if s.name == "calc.job")
    kids = [(s.start, s.end) for s in got
            if s.parent == job.id and s.thread == job.thread]
    assert spans._covered(kids, job.start, job.end) \
        >= 0.9 * (job.end - job.start)


@pytest.mark.parametrize("path", ["pipelined", "serial"])
def test_stats_are_their_spans(archive, tmp_path, monkeypatch, path):
    res, got, engines = _job(archive, tmp_path, monkeypatch, path)
    assert len(engines) == 1
    stats = engines[0].stats
    for key, name in (("count_s", "engine.count"),
                      ("extract_s", "engine.extract"),
                      ("math_s", "engine.math")):
        want = sum(s[key] for s in stats.values())
        have = sum((s.end - s.start) * 1e-9 for s in got if s.name == name)
        assert have == pytest.approx(want, rel=1e-9, abs=1e-12), key
    consumes = [s for s in got if s.name == "engine.consume"]
    assert sum(s.attrs["records"] for s in consumes) * 2 == res.n_records
    assert sum(s.attrs["candidates"] for s in consumes) == res.n_pairs
    assert sum(s.attrs["repaired"] for s in consumes) \
        == sum(s["n_repair"] for s in stats.values()) > 0
    blocks = [s for s in got if s.name == "write.block"]
    assert sum(s.attrs["records"] for s in blocks) == res.n_records
    assert all(s.attrs["bytes_out"] > 0 for s in blocks)


def test_each_run_group_is_a_job():
    """Library use: no compute_ld around the engine, so each run_group
    starts a job, and the consumer's spans carry it."""
    from test_torch_pipeline import N_SAMPLES, PAIRS, group_planes
    planes = group_planes(5, 10, 128, N_SAMPLES)
    eng = LdEngine(planes, N_SAMPLES, CalcSettings(min_r2=0.1,
                                                   sweep_segment=16), "cpu")
    try:
        with spans.recording():
            dispatch_pairs(eng, PAIRS, "phased", LdFilters(min_r2=0.1),
                           lambda recs, rev=None: None, planes)
    finally:
        eng.stage_close()
    got = spans.collect()
    groups = [s for s in got if s.name == "engine.group"]
    assert len(groups) == 2 and groups[0].job != groups[1].job
    assert all(g.parent is None for g in groups)
    for s in got:
        if s.name != "engine.group":
            assert s.job in {g.job for g in groups} and s.parent is not None


def test_performance_logs_the_span_table(archive, tmp_path, capsys):
    compute_ld(CalcSettings(input=archive, output=str(tmp_path / "o.two"),
                            performance=True, **BASE), device="cpu")
    err = capsys.readouterr().err
    head = err.index("count   total s    self s")
    assert err.index("cand pairs") < head
    table = err[head:]
    for name in ("calc.job", "engine.dispatch", "engine.consume",
                 "write.block"):
        assert name in table
    assert "twk-two-write" in table and "MainThread" in table
    # the attributes' sums: every record is written once
    line = next(ln for ln in table.splitlines() if "write.block" in ln)
    assert "records=" in line and "bytes_out=" in line
    line = next(ln for ln in table.splitlines() if "write.compress" in ln)
    assert "twk-two-zstd" in line and "inflight=" in line
    count = int(line[line.index("write.compress"):].split()[2])
    inflight = int(line.split("inflight=")[1].split()[0])
    assert count <= inflight <= BASE["threads"] * count
    # the job's spans were taken out with the table
    assert spans.collect() == []


def test_span_table_self_time():
    S = spans.Span
    rows = spans.table([
        S("a", 0, 100, "MainThread", 1, None, 1, {}),
        S("b", 10, 30, "MainThread", 2, 1, 1, {"n": 2}),
        S("b", 20, 50, "MainThread", 3, 1, 1, {"n": 5, "m": 1}),
        S("c", 0, 90, "twk-seg_0", 4, 1, 1, {}),
    ])
    assert [r[:3] for r in rows] == [("a", "MainThread", 1),
                                     ("c", "twk-seg", 1),
                                     ("b", "MainThread", 2)]
    # a: 100 ns less its children b (10-50) on its thread; c is not on it
    assert [x for r in rows for x in r[3:5]] == pytest.approx(
        [100e-9, 60e-9, 90e-9, 90e-9, 50e-9, 50e-9], abs=1e-15)
    assert [r[5] for r in rows] == [{}, {}, {"m": 1, "n": 7}]


def test_buffer_is_bounded(monkeypatch, capsys):
    monkeypatch.setattr(spans, "LIMIT", 3)
    before = spans.dropped()
    with spans.recording():
        for _ in range(5):
            with spans.span("x"):
                pass
    got = spans.collect()
    assert len(got) == 3
    assert spans.dropped() - before == 2
    spans.log_table(got, dropped=2)
    assert "2 spans not recorded: the buffer holds 3" \
        in capsys.readouterr().err
