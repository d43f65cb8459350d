"""The port's segment pipeline and its C tile loop, on the CPU.

- Depth 2 (a consumer thread handles segment k while segment k+1 is in
  flight) against depth 1, with the per-tile cap overflowing and the
  survivor buffer spilling inside the pipeline: the same records, record
  for record and in order.
- The per-group statistics (`n_supp` included) against the JAX engine's
  on the same planes and caps. With one segment in flight at a time both
  engines adapt their caps and prefixes at the same points, so every
  counter matches; at depth 2 the repair and supplementary counts follow
  the consumer thread's timing in both engines, and the counts of tiles,
  candidates, survivors and records are compared.
- A consumer failure: an `emit` that raises in the second segment stops
  the run with that error, nothing of a later segment is emitted, and no
  thread of the engine is alive after `stage_close`; the card running out
  of memory instead re-runs from that segment serially, with a warning.
- The C tile loop (csrc/sweep.cu, `sweeps._launch_sweep`) against the
  per-tile launches, with a stand-in for the kernel library: a model of
  the C loop, fed what `_launch_sweep` passes, hands every launcher the
  pointers, tile flags and stream the per-tile wrappers hand it.
"""

import ctypes
import threading
import types

import numpy as np
import pytest
import torch

import tomahawk_tpu_torch  # noqa: F401  (binds libzstd where needed)

from tomahawk_tpu.compute.engine import CalcSettings as JaxCalcSettings
from tomahawk_tpu.compute.engine import LdEngine as JaxLdEngine
from tomahawk_tpu.ops.ld_math import LdFilters as JaxLdFilters

from tomahawk_tpu_torch.compute import sweeps
from tomahawk_tpu_torch.compute.engine import CalcSettings, LdEngine
from tomahawk_tpu_torch.ops import _build, tiles
from tomahawk_tpu_torch.ops.ld_math import LdFilters

from test_torch_groups import group_planes
from test_torch_window import N_SAMPLES as WIN_SAMPLES
from test_torch_window import ALL_GROUPS, ALL_IDS, window_planes

N_SAMPLES, B, NB, MIN_R2 = 64, 128, 10, 0.1
#: 55 tiles, at most 16 a segment: 4 segments
PAIRS = [(i, j, i == j) for i in range(NB) for j in range(i, NB)]
STAT_KEYS = ("n_tiles", "n_cand", "n_pass", "n_records", "n_repair",
             "n_supp")


@pytest.fixture(scope="module")
def planes():
    """LD runs with missing genotypes on every other row: every tile has
    survivors, many more than a cap of 8."""
    return group_planes(5, NB, B, N_SAMPLES)


def _serial(engine):
    """One segment at a time for the whole run (a clean serial streak
    would otherwise re-enable the pipeline after 8 segments)."""
    engine._pipeline_enabled = False
    engine._pipeline_retry_after = 1 << 30


def _engine(planes, depth, cap=8, outcap=64, prefix=16):
    """Caps small enough that tiles overflow the cap, segments spill the
    buffer and the first segment of a group reads rows past its prefix."""
    e = LdEngine(planes, N_SAMPLES, CalcSettings(min_r2=MIN_R2,
                                                 sweep_segment=16), "cpu")
    if depth == 1:
        _serial(e)
    e.caps = dict(fused_cap=cap, outcap=outcap)
    e.PREFIX_ROWS0 = prefix
    return e


def _run(engine, runner="mixed", emit=None):
    """Records in emission order, and the threads that emitted them."""
    got, threads = [], set()

    def collect(recs, rev=None):
        threads.add(threading.current_thread().name)
        got.append(recs.copy())
    filt = LdFilters(min_r2=MIN_R2)
    try:
        if runner == "mixed":
            engine.run_mixed_pairs(PAIRS, filt, emit or collect)
        else:
            engine.run_unphased_pairs(PAIRS, True, filt, emit or collect)
    finally:
        engine.stage_close()
    return np.concatenate(got) if got else None, threads


@pytest.fixture
def threads_before():
    """The threads alive when the test starts: an engine that another test
    left open in this process (the JAX engine names its pools `twk-` as
    well) is not this test's."""
    return set(threading.enumerate())


def _seg_threads(before):
    """The `twk-` threads started since `before` and still alive."""
    return [t for t in threading.enumerate()
            if t.name.startswith("twk-") and t not in before]


@pytest.mark.parametrize("runner", ["mixed", "unphased"])
def test_depth_two_emits_the_serial_records_in_order(planes, runner,
                                                    threads_before):
    """Four segments a group, a cap of 8 and a 64-row buffer: tiles
    overflow the cap and segments spill, and the repairs run on the
    consumer thread beside the next sweep. The record stream equals the
    serial run's in every field and in order."""
    serial = _engine(planes, 1)
    want, t1 = _run(serial, runner)
    piped = _engine(planes, 2)
    got, t2 = _run(piped, runner)
    assert t1 == {"MainThread"} and t2 == {"twk-seg_0"}
    assert len(got) == len(want) > 0
    for f in want.dtype.names:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for e in (serial, piped):
        st = list(e.stats.values())
        assert sum(s["n_repair"] for s in st) > 0
        assert e.caps["fused_cap"] > 8 and e.caps["outcap"] > 64
        assert e.units_done == (8 if runner == "mixed" else 4)
    assert _seg_threads(threads_before) == []


@pytest.mark.parametrize("depth", [1, 2])
def test_group_stats_match_jax(planes, monkeypatch, depth):
    monkeypatch.setenv("TWK_DEVICE_FISHER", "0")
    port = _engine(planes, depth)
    _run(port)
    jax_engine = JaxLdEngine(planes, N_SAMPLES, JaxCalcSettings(
        min_r2=MIN_R2, sweep_segment=16))
    _serial(jax_engine)
    jax_engine._fused_cap, jax_engine._outcap = 8, 64
    jax_engine.PREFIX_ROWS0 = 16
    jfilt = JaxLdFilters(min_r2=MIN_R2)
    emit = lambda recs, rev=None: None
    jax_engine.run_mixed_pairs(PAIRS, jfilt, emit)
    jax_engine.stage_close()
    assert sorted(port.stats) == sorted(jax_engine.stats)
    keys = STAT_KEYS if depth == 1 else STAT_KEYS[:4]
    for group, st in port.stats.items():
        assert {k: st[k] for k in keys} \
            == {k: jax_engine.stats[group][k] for k in keys}, group
    if depth == 1:
        assert sum(s["n_supp"] for s in port.stats.values()) > 0
        assert sum(s["n_repair"] for s in port.stats.values()) > 0


def test_emit_failure_stops_the_run(planes, threads_before):
    """An emit that raises in segment 2: the error comes out of the run,
    segment 3 and later emit nothing, and no engine thread lives on."""
    engine = _engine(planes, 2, cap=1 << 14, outcap=1 << 18)
    calls = []

    def emit(recs, rev=None):
        calls.append(len(recs))
        if len(calls) == 2:
            raise OSError("disk full")
    with pytest.raises(OSError, match="disk full"):
        _run(engine, emit=emit)
    assert len(calls) == 2
    assert _seg_threads(threads_before) == []


def test_out_of_memory_goes_serial(planes, monkeypatch, capfd):
    """The card running out of memory in the consumer: the later
    segments in flight skip themselves, the failed one and the rest run
    one at a time on the same kernels, with a warning; the records are
    the serial run's, in order. Any other error raises."""
    want, _ = _run(_engine(planes, 1))
    engine = _engine(planes, 2)
    run = LdEngine._run_segment
    failed = []

    def flaky(self, tiles, cfg, filt, emit, state=None):
        if state is not None and not failed:
            failed.append(1)
            raise torch.cuda.OutOfMemoryError("out of memory (test)")
        return run(self, tiles, cfg, filt, emit, state)
    monkeypatch.setattr(LdEngine, "_run_segment", flaky)
    got, _ = _run(engine)
    assert failed and not engine._pipeline_enabled
    assert "[WARNING][ENGINE] the card ran out of memory" \
        in capfd.readouterr().err
    assert len(got) == len(want)
    for f in want.dtype.names:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    engine = _engine(planes, 2)

    def broken(self, tiles, cfg, filt, emit, state=None):
        raise RuntimeError("a kernel fault")
    monkeypatch.setattr(LdEngine, "_run_segment", broken)
    with pytest.raises(RuntimeError, match="kernel fault"):
        _run(engine)
    assert engine._pipeline_enabled


# -- the C tile loop, with a stand-in library ----------------------------
def _ints(ptr, n, ctype=ctypes.c_int32):
    return list((ctype * n).from_address(ptr)) if n else []


class _Library:
    """Records what the per-tile wrappers hand twk_phased_tile,
    twk_parts_tile and twk_compact; `twk_sweep` runs a model of
    csrc/sweep.cu's loop over what `_launch_sweep` hands it, recording
    the launcher calls the C loop would make."""

    def __init__(self):
        self.calls = []

    def twk_phased_tile(self, *args):
        self.calls.append(("phased_tile",) + args)
        return 0

    def twk_parts_tile(self, *args):
        self.calls.append(("parts_tile",) + args)
        return 0

    def twk_compact(self, *args):
        self.calls.append(("compact",) + args)
        return 0

    def twk_sweep(self, kind, x, y, z, W, ac, valid, an, nhet, nhom, pos,
                  rid, window, cls, B, n_samples, lo, hi, dp_lo, dp_hi,
                  need_nonzero, T,
                  pi, pj, dg, live, mask, parts, counts, screen, P, ncol, ld,
                  off, per_tile_off, cap, outcap, n_pass, n_cand, scratch,
                  ticket, buf, stream, done):
        at = lambda base, s, row: None if base is None else base + s * row
        plane, meta = B * W * 4, B * 4
        pi, pj = _ints(pi, T), _ints(pj, T)
        dg = _ints(dg, T, ctypes.c_uint8)
        live = [1] * T if live is None else _ints(live, T, ctypes.c_uint8)
        done[0] = done[1] = 0
        for t in range(T):
            if not live[t]:
                continue
            i, j = pi[t], pj[t]
            m = lambda base: (at(base, i, meta), at(base, j, meta))
            v = (at(valid, i, B), at(valid, j, B))
            if kind < 0:
                self.twk_phased_tile(
                    at(x, i, plane), at(x, j, plane), *m(ac), *v, *m(an),
                    *m(pos), *m(rid), window, cls, B, W, 2 * n_samples, lo,
                    hi, dp_lo, dp_hi, need_nonzero, dg[t], mask, parts,
                    counts, stream)
            else:
                self.twk_parts_tile(
                    kind, at(x, i, plane), at(y, i, plane), at(z, i, plane),
                    at(x, j, plane), at(y, j, plane), at(z, j, plane),
                    *m(ac), *v, *m(an), at(nhet, i, meta), at(nhom, i, meta),
                    at(nhet, j, meta), at(nhom, j, meta), *m(pos), *m(rid),
                    window, cls, B, W, n_samples, lo, hi, dp_lo, dp_hi,
                    need_nonzero, dg[t], mask, parts, counts,
                    screen if kind >= 1 else None, stream)
            done[0] += 1
            self.twk_compact(mask, parts, counts, P, ncol, ld, B,
                             off + 4 * t if per_tile_off else off, cap,
                             outcap, n_pass, n_cand, t, scratch, ticket, buf,
                             stream)
            done[1] += 1
        return 0


def _no_nulls(call):
    """A launcher call with C's nulls as None and a diag flag as int."""
    return tuple(None if a in (0, None) else int(a) if isinstance(a, bool)
                 else a for a in call)


@pytest.mark.parametrize("extract", [False, True], ids=["fused", "extract"])
@pytest.mark.parametrize("window", [0, 700])
@pytest.mark.parametrize("group", ALL_GROUPS, ids=ALL_IDS)
def test_c_sweep_gets_the_per_tile_arguments(monkeypatch, group, window,
                                             extract):
    """For every sweep group, window or not, the fused sweep (a dead tile
    in the list) and the repair sweep (an offset a tile): the launcher
    calls the C loop makes from `_launch_sweep`'s arguments equal the
    calls of the per-tile wrappers (`tiles._launch`,
    `sweeps._launch_compact`) on the same buffers, tile by tile, stream
    and the unphased groups' screen counter included, and the launches
    are counted as the loop reports them."""
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=7777))
    monkeypatch.setattr(sweeps, "_TICKETS", {})
    Bt = 128
    st = window_planes(3, n_blocks=3, B=Bt)
    cfg = sweeps.make_cfg(*group, Bt, WIN_SAMPLES, window, MIN_R2, 100.0)
    dev = sweeps.planes_to_device(st, "cpu", sweeps.dev_keys_for(cfg))
    pi = np.array([0, 0, 1, 2, 1], np.int32)
    pj = np.array([0, 1, 2, 2, 1], np.int32)
    dg = pi == pj
    live = None if extract else np.array([1, 1, 0, 1, 1], bool)
    T = len(pi)
    out, cnt, scratch = sweeps._sweep_buffers(cfg, "cpu")
    buf = torch.zeros((1 << 12, sweeps.buf_cols(cfg)), dtype=torch.int32)
    n_pass = torch.zeros(T, dtype=torch.int32)
    n_cand = torch.zeros(T, dtype=torch.int32)
    off = torch.zeros(T if extract else 1, dtype=torch.int32)
    screen = (torch.zeros(2, dtype=torch.int64)
              if cfg["table"] == "unphased" else None)
    _build.reset_counts()
    sweeps._launch_sweep(dev, pi, pj, dg, live, cfg, 256, out, cnt, scratch,
                         off, buf, n_pass, n_cand, screen=screen)
    from_c = [_no_nulls(c) for c in lib.calls]
    name = tiles.kernel_name(cfg)
    n_live = T if extract else 4
    assert _build.LAUNCHES[name] == _build.LAUNCHES["compact"] == n_live
    lib.calls = []
    for t in range(T):
        if live is not None and not live[t]:
            continue
        tiles._launch(dev, int(pi[t]), int(pj[t]), bool(dg[t]), cfg, out,
                      cnt, screen)
        sweeps._launch_compact(out[0], out[1],
                               off[t:t + 1] if extract else off, buf,
                               n_pass, n_cand, t, 256, cnt, scratch)
    per_tile = [_no_nulls(c) for c in lib.calls]
    assert len(from_c) == len(per_tile) == 2 * n_live
    assert [c[0] for c in from_c] == [name, "compact"] * n_live
    for a, b in zip(from_c, per_tile):
        assert a == b
    assert all(c[-1] == 7777 for c in from_c)


def test_c_sweep_rejects_a_tile_outside_the_planes(monkeypatch):
    monkeypatch.setattr(_build, "library", lambda: _Library())
    st = window_planes(3, n_blocks=2, B=128)
    cfg = sweeps.make_cfg("phased", False, "all", 128, WIN_SAMPLES, 0,
                          MIN_R2, 100.0)
    dev = sweeps.planes_to_device(st, "cpu", sweeps.dev_keys_for(cfg))
    out, cnt, scratch = sweeps._sweep_buffers(cfg, "cpu")
    buf = torch.zeros((1 << 12, 2), dtype=torch.int32)
    n = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        sweeps._launch_sweep(dev, np.array([2]), np.array([0]),
                             np.array([False]), np.array([True]), cfg, 256,
                             out, cnt, scratch,
                             torch.zeros(1, dtype=torch.int32), buf, n,
                             n.clone())


def test_depth_gate_reads_free_memory_once_a_group(planes, monkeypatch):
    """`run_group` asks for the depth before every dispatch; the card's
    free memory is read once a group, and again only when the caps grow
    (a read is a call into the CUDA runtime)."""
    engine = _engine(planes, 2)
    reads, asks = [], []
    monkeypatch.setattr(LdEngine, "_prefetch_headroom_ok",
                        lambda self, cfg: reads.append(
                            (cfg["cls"], self.caps["outcap"],
                             self.caps["fused_cap"]))
                        or True)
    depth = engine._pipeline_depth
    monkeypatch.setattr(engine, "_pipeline_depth",
                        lambda cfg: asks.append(cfg["cls"]) or depth(cfg))
    _run(engine)
    # the mixed dispatch's two groups, each read at least once, and no
    # read repeated within a group
    assert {r[0] for r in reads} == {"clean", "missing"}
    assert len(reads) == len(set(reads)) < len(asks)
