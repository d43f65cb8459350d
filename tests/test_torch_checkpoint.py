"""Checkpoint and resume of the port's `calc`, on the CPU, against the
JAX package (tests/test_checkpoint.py and the two-process resume cases of
tests/test_multihost.py, in parity form).

A run is crashed after a few sweep segments by a stand-in for
`LdEngine._run_segment` set up here (each segment passes through it at
either pipeline depth: inline at depth 1, on the consumer thread at
depth 2), then resumed from its sidecar:

- phased, mixed and banded (`memory_gb` tiny: band-pair loads, some
  skipped whole) at depth 1 and 2: the output equals an uninterrupted
  port run record for record, in order, its sorted stream equals the JAX
  package's, the totals are the whole run's and the sidecar is gone;
- the resumed run dispatches only the segments after the checkpoint,
  and sets up only the loads not done before it;
- a config mismatch, a stdout output, an output-path change and a
  missing output are refused, and so is a sidecar the other package
  wrote;
- with the in-sweep Fisher bracket on (and, at depth 1, caps that grow
  mid-run), the resumed records equal the uninterrupted run's, P bit for
  bit, and the JAX package's within the 1e-5 guard;
- two gloo ranks, hard-killed and relaunched: the tile partition with a
  sidecar a rank, and `--mesh dcn` with rank 0's sidecar broadcast; a
  rank whose sidecar fails its check fails both ranks at the resume
  barrier.
"""

import json
import os
import sys

import numpy as np
import pytest

import tomahawk_tpu_torch  # noqa: F401  (binds libzstd where needed)

from tomahawk_tpu.compute import sweeps as jsweeps
from tomahawk_tpu.compute.engine import CalcSettings as JaxCalcSettings
from tomahawk_tpu.compute.engine import LdEngine as JaxLdEngine
from tomahawk_tpu.compute.engine import compute_ld as jax_compute_ld
from tomahawk_tpu.io.importer import ImportSettings, import_vcf

from tomahawk_tpu_torch.compute import engine as E
from tomahawk_tpu_torch.compute import sweeps
from tomahawk_tpu_torch.compute.engine import (CalcSettings, LdEngine,
                                               compute_ld)
from tomahawk_tpu_torch.io.errors import CorruptFileError
from tomahawk_tpu_torch.io.two import TwoReader
from tomahawk_tpu_torch.parallel import distributed as dist

from test_importer import make_vcf
from test_torch_dist import _free_port, assert_ranks_ok, run_ranks
from test_torch_engine import _assert_same, _sorted

MODES = {"phased": dict(force_phased=True), "mixed": {},
         "banded": dict(memory_gb=2e-5)}
#: the base settings of every run here: 13 super-blocks of 16 rows, at
#: most 16 tiles a segment
BASE = dict(min_r2=0.0, min_p=1.0, tile_rows=16, sweep_segment=16)


class Crash(RuntimeError):
    pass


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """The JAX package's checkpoint case: 40 samples, 200 sites, 4%
    missing, blocks of 16."""
    d = tmp_path_factory.mktemp("torch_checkpoint")
    vcf = str(d / "in.vcf")
    make_vcf(vcf, n_samples=40, n_sites=200, seed=11, miss_frac=0.04,
             contigs=("20",))
    twk = str(d / "in.twk")
    import_vcf(ImportSettings(input=vcf, output=twk, block_size=16))
    return twk


@pytest.fixture(autouse=True)
def _host_fisher(monkeypatch):
    """P from the host's exact kernel in both packages, unless a test
    turns the bracket on."""
    monkeypatch.setenv("TWK_DEVICE_FISHER", "0")


def _settings(twk, out, ckpt="", mode="mixed", **kw):
    return CalcSettings(input=twk, output=out, checkpoint=ckpt,
                        checkpoint_interval=0.0,
                        **dict(BASE, **MODES[mode], **kw))


def _depth(monkeypatch, depth):
    monkeypatch.setattr(LdEngine, "_pipeline_depth",
                        lambda self, cfg: depth)


def _crash_after(monkeypatch, n_segments, cls=LdEngine):
    """Segments after the first `n_segments` raise Crash on entry."""
    orig = cls._run_segment
    calls = {"n": 0}

    def crashing(self, *a, **kw):
        if calls["n"] >= n_segments:
            raise Crash("simulated crash")
        calls["n"] += 1
        return orig(self, *a, **kw)
    monkeypatch.setattr(cls, "_run_segment", crashing)
    return calls


def _crashed_run(monkeypatch, settings, n_segments, run=None):
    """One run of `settings` crashed after `n_segments` segments; the
    sidecar it leaves."""
    with monkeypatch.context() as m:
        calls = _crash_after(m, n_segments)
        with pytest.raises(Crash):
            (run or (lambda s: compute_ld(s, device="cpu")))(settings)
    assert calls["n"] == n_segments
    assert os.path.exists(settings.checkpoint)
    with open(settings.checkpoint) as fh:
        return json.load(fh)


def _records(path):
    r = TwoReader(path)
    recs = r.records()
    r.close()
    return recs


def _jax_sorted(twk, path, mode, **kw):
    jax_compute_ld(JaxCalcSettings(input=twk, output=path, mesh="off",
                                   backend="device",
                                   **dict(BASE, **MODES[mode], **kw)))
    return _sorted(path)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("mode", list(MODES))
def test_resume_after_crashes_matches(archive, tmp_path, monkeypatch, mode,
                                      depth):
    """Two crashes, then a clean resume: record for record the
    uninterrupted port run, sorted the JAX package's, whole-run totals;
    the sidecar is removed."""
    _depth(monkeypatch, depth)
    ref = str(tmp_path / "ref.two")
    full = compute_ld(_settings(archive, ref, mode=mode), device="cpu")
    out, ckpt = str(tmp_path / "ck.two"), str(tmp_path / "calc.ckpt")
    for crash_at, units in ((2, 2), (1, 3)):
        ck = _crashed_run(monkeypatch, _settings(archive, out, ckpt, mode),
                          crash_at)
        assert ck["units"] == units
    res = compute_ld(_settings(archive, out, ckpt, mode), device="cpu")
    assert not os.path.exists(ckpt), "the sidecar must go on success"
    got, want = _records(out), _records(ref)
    assert len(got) == len(want) > 0
    for f in want.dtype.names:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    _assert_same(_sorted(out), _jax_sorted(
        archive, str(tmp_path / "jax.two"), mode))
    assert (res.n_pairs, res.n_records) == (full.n_pairs, full.n_records)
    if mode == "banded":
        assert res.stage_stats["n_loads"] > 1


@pytest.mark.parametrize("depth", [1, 2])
def test_resume_skips_completed_segments(archive, tmp_path, monkeypatch,
                                         depth):
    """A resumed run dispatches no segment the checkpoint holds: its
    segments and fused sweeps (one C tile-loop call each) are the
    uninterrupted run's less those done before the crash."""
    _depth(monkeypatch, depth)
    counts = {"seg": 0, "sweep": 0}
    orig_seg, orig_sweep = LdEngine._run_segment, sweeps.fused_sweep

    def counting_seg(self, *a, **kw):
        counts["seg"] += 1
        return orig_seg(self, *a, **kw)

    def counting_sweep(*a, **kw):
        counts["sweep"] += 1
        return orig_sweep(*a, **kw)

    def counted(settings):
        with monkeypatch.context() as m:
            m.setattr(LdEngine, "_run_segment", counting_seg)
            m.setattr(sweeps, "fused_sweep", counting_sweep)
            counts.update(seg=0, sweep=0)
            compute_ld(settings, device="cpu")
            return dict(counts)
    full = counted(_settings(archive, str(tmp_path / "full.two")))
    out, ckpt = str(tmp_path / "ck.two"), str(tmp_path / "calc.ckpt")
    ck = _crashed_run(monkeypatch, _settings(archive, out, ckpt), 4)
    assert ck["units"] == 4
    resumed = counted(_settings(archive, out, ckpt))
    assert resumed == dict(seg=full["seg"] - 4, sweep=full["sweep"] - 4)


def test_resume_skips_completed_loads(archive, tmp_path, monkeypatch):
    """A banded resume sets up only the loads the checkpoint does not
    hold whole: a skipped load is neither inflated nor staged."""
    loads, planes = [], []
    orig_set, orig_inflate = LdEngine.set_load, E.block_to_planes

    def counting_set(self, bands):
        loads.append([b for b, _ in bands])
        return orig_set(self, bands)

    def counting_inflate(*a, **kw):
        planes.append(1)
        return orig_inflate(*a, **kw)
    monkeypatch.setattr(LdEngine, "set_load", counting_set)
    monkeypatch.setattr(E, "block_to_planes", counting_inflate)
    full = compute_ld(_settings(archive, str(tmp_path / "full.two"),
                                mode="banded"), device="cpu")
    n_loads, n_inflated = len(loads), len(planes)
    out, ckpt = str(tmp_path / "ck.two"), str(tmp_path / "calc.ckpt")
    ck = _crashed_run(monkeypatch, _settings(archive, out, ckpt, "banded"),
                      12)
    whole = sum(c <= ck["units"] for c in ck["load_cum"])
    assert 0 < whole < n_loads == full.stage_stats["n_loads"]
    loads.clear()
    planes.clear()
    compute_ld(_settings(archive, out, ckpt, "banded"), device="cpu")
    assert len(loads) == n_loads - whole
    assert len(planes) < n_inflated


def test_checkpoint_config_mismatch(archive, tmp_path, monkeypatch):
    out, ckpt = str(tmp_path / "ck.two"), str(tmp_path / "calc.ckpt")
    _crashed_run(monkeypatch, _settings(archive, out, ckpt), 2)
    with pytest.raises(ValueError, match="different settings"):
        compute_ld(_settings(archive, out, ckpt, min_r2=0.5), device="cpu")


def test_checkpoint_rejects_stdout(archive, tmp_path):
    with pytest.raises(ValueError, match="file output"):
        compute_ld(_settings(archive, "-", str(tmp_path / "c.ckpt")),
                   device="cpu")


def test_checkpoint_rejects_output_change(archive, tmp_path, monkeypatch):
    """The output path is part of the key: the sidecar of a.two does not
    truncate or append to b.two."""
    ckpt = str(tmp_path / "calc.ckpt")
    _crashed_run(monkeypatch, _settings(archive, str(tmp_path / "a.two"),
                                        ckpt), 2)
    with pytest.raises(ValueError, match="different settings"):
        compute_ld(_settings(archive, str(tmp_path / "b.two"), ckpt),
                   device="cpu")


def test_resume_with_missing_output(archive, tmp_path, monkeypatch):
    out, ckpt = str(tmp_path / "a.two"), str(tmp_path / "calc.ckpt")
    _crashed_run(monkeypatch, _settings(archive, out, ckpt), 2)
    os.remove(out)
    with pytest.raises(CorruptFileError, match="output is missing"):
        compute_ld(_settings(archive, out, ckpt), device="cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sidecar_of_the_other_package_refused(archive, tmp_path,
                                              monkeypatch, writer):
    """The key names the engine: a sidecar the JAX package wrote is
    refused by the port with the "different settings" error, and the
    other way round, for the same settings, input and output."""
    out, ckpt = str(tmp_path / "ck.two"), str(tmp_path / "calc.ckpt")
    port_settings = _settings(archive, out, ckpt)
    jax_settings = JaxCalcSettings(input=archive, output=out, mesh="off",
                                   backend="device", checkpoint=ckpt,
                                   checkpoint_interval=0.0, **BASE)
    if writer == "jax":
        with monkeypatch.context() as m:
            _crash_after(m, 2, JaxLdEngine)
            with pytest.raises(Crash):
                jax_compute_ld(jax_settings)
        with pytest.raises(ValueError, match="different settings"):
            compute_ld(port_settings, device="cpu")
    else:
        _crashed_run(monkeypatch, port_settings, 2)
        with pytest.raises(ValueError, match="different settings"):
            jax_compute_ld(jax_settings)
    assert os.path.exists(ckpt)


@pytest.mark.parametrize("depth,fused_cap", [(1, 16), (2, None)],
                         ids=["depth1-small-cap", "depth2"])
def test_resume_with_the_bracket_on(archive, tmp_path, monkeypatch, depth,
                                    fused_cap):
    """The in-sweep Fisher bracket, its volume gate between the
    segments' survivor counts so that it opens on some and not on
    others: a resumed run cuts the same segments and, with the caps
    restored, extracts them as the uninterrupted run does, so P is
    bit-equal port to port (at depth 1 the per-tile cap of 16 overflows
    and grows mid-run); against the JAX package P is within the 1e-5
    guard."""
    monkeypatch.setenv("TWK_DEVICE_FISHER", "1")
    _depth(monkeypatch, depth)
    if fused_cap:
        monkeypatch.setattr(LdEngine, "FUSED_CAP", fused_cap)
    survivors, seen = [], []
    orig_p = LdEngine._fisher_p

    def watching(self, cfg, rows, data, n_pass, *a, **kw):
        p = orig_p(self, cfg, rows, data, n_pass, *a, **kw)
        survivors.append(int(n_pass.sum()))
        seen.append(p is not None)
        return p
    monkeypatch.setattr(LdEngine, "_fisher_p", watching)
    compute_ld(_settings(archive, str(tmp_path / "probe.two"),
                         mode="phased"), device="cpu")
    gate = sorted(survivors)[len(survivors) // 2]
    monkeypatch.setattr(sweeps, "FISHER_MIN_ROWS", gate)
    monkeypatch.setattr(jsweeps, "FISHER_MIN_ROWS", gate)
    seen.clear()
    ref = str(tmp_path / "ref.two")
    compute_ld(_settings(archive, ref, mode="phased"), device="cpu")
    assert any(seen) and not all(seen), "the gate must open and close"
    out, ckpt = str(tmp_path / "ck.two"), str(tmp_path / "calc.ckpt")
    ck = _crashed_run(monkeypatch, _settings(archive, out, ckpt, "phased"),
                      3)
    if fused_cap:
        assert ck["caps"]["fused_cap"] > fused_cap
    compute_ld(_settings(archive, out, ckpt, "phased"), device="cpu")
    got, want = _records(out), _records(ref)
    assert len(got) == len(want) > 0
    for f in want.dtype.names:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    jax = _jax_sorted(archive, str(tmp_path / "jax.two"), "phased")
    mine = _sorted(out)
    assert len(mine) == len(jax)
    for f in jax.dtype.names:
        if f == "P":
            np.testing.assert_allclose(mine[f], jax[f], rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(mine[f], jax[f], err_msg=f)


#: one rank of a two-rank run through the port's CLI: with a crash count
#: it hard-exits (exit 3, no clean-up) on entering the segment after that
#: many, once the sidecar `peer` exists (so both ranks leave one)
WORKER = r"""
import os, sys, time
from tomahawk_tpu_torch import cli
from tomahawk_tpu_torch.compute.engine import LdEngine
crash_after, peer = int(sys.argv[1]), sys.argv[2]
if crash_after:
    orig, n = LdEngine._run_segment, [0]

    def crashing(self, *a, **kw):
        if n[0] >= crash_after:
            deadline = time.time() + 60
            while not os.path.exists(peer) and time.time() < deadline:
                time.sleep(0.05)
            sys.stdout.flush()
            os._exit(3)
        n[0] += 1
        return orig(self, *a, **kw)
    LdEngine._run_segment = crashing
sys.exit(cli.main(sys.argv[3:]))
"""


def _rank_argvs(twk, out, ckpt, extra, crash_after=0):
    port = _free_port()
    peers = ([ckpt, ckpt] if "dcn" in extra
             else [f"{ckpt}.p1of2", f"{ckpt}.p0of2"])
    return [[sys.executable, "-c", WORKER, str(crash_after), peers[r],
             "calc", "-i", twk, "-o", out, "-r", "0", "-P", "1",
             "--tile-rows", "16", "--sweep-segment", "16", "--device", "cpu",
             "--checkpoint", ckpt, "--checkpoint-interval", "0",
             "--distributed", "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(r), *extra]
            for r in (0, 1)]


@pytest.mark.parametrize("extra", [[], ["--mesh", "dcn"]],
                         ids=["tile-partition", "dcn"])
def test_two_rank_kill_and_resume(archive, tmp_path, extra):
    """Both ranks hard-killed after two segments, then relaunched: the
    tile partition resumes each shard from its own sidecar (`.pKofN`),
    a dcn run from rank 0's, broadcast to rank 1. The result equals the
    JAX package's single-process records; no sidecar is left."""
    dcn = bool(extra)
    ckpt = str(tmp_path / "calc.ckpt")
    out = str(tmp_path / "dist.two")
    results = run_ranks(_rank_argvs(archive, out, ckpt, extra, 2))
    assert [rc for rc, _ in results] == [3, 3], results
    sidecars = [ckpt] if dcn else [f"{ckpt}.p0of2", f"{ckpt}.p1of2"]
    assert all(os.path.exists(s) for s in sidecars)
    assert os.path.exists(ckpt) == dcn
    results = run_ranks(_rank_argvs(archive, out, ckpt, extra))
    assert_ranks_ok(results)
    assert "Resuming from" in results[0][1]
    assert not any(os.path.exists(s) for s in sidecars)
    if dcn:
        got = _sorted(out)
    else:
        merged = str(tmp_path / "merged.two")
        dist.merge_shards(dist.shard_paths(out, 2), merged)
        got = _sorted(merged)
    _assert_same(got, _jax_sorted(archive, str(tmp_path / "jax.two"),
                                  "mixed"))


def test_failed_sidecar_check_fails_both_ranks(archive, tmp_path):
    """A rank whose sidecar fails its key check raises at the resume
    barrier, and so does the other rank: both exit non-zero inside the
    limit and neither waits in a later collective."""
    ckpt = str(tmp_path / "calc.ckpt")
    with open(f"{ckpt}.p1of2", "w") as fh:
        json.dump(dict(version=1, config="another run"), fh)
    results = run_ranks(_rank_argvs(archive, str(tmp_path / "d.two"), ckpt,
                                    []), limit=120)
    assert all(rc not in (0, None) for rc, _ in results), results
    assert "different settings" in results[1][1]
    assert "rank(s) [1] failed the checkpoint check" in results[0][1]
