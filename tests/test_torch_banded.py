"""Banded streaming of the port against the JAX package, on the CPU.

An archive whose planes exceed `memory_gb` streams in band-pair loads:
the port's `compute_ld` at `memory_gb=1e-6` (two super-blocks a load),
with the staging worker and without, in -p, -u, mixed and -w, gives the
JAX `compute_ld`'s records on the same archive and settings (the JAX
package's own banded case, tests/test_end2end.py, in parity form):
identity fields equal, D / D' / r2 / P within 1e-12, every other field
equal. The plan is the JAX package's: the same number of loads. Without
the worker every upload is on demand and the uploads match too; with
it they need not: the worker stages the planes the run has used by the
time it runs (`_seen_keys`), which in either engine depends on how far
the main thread's sweeps have got.

Also: the banded two-rank runs on gloo (tile partition, where each rank
bands its own super-blocks, and `--mesh dcn`, where the loads are
serial) against the JAX single-process records; a staging job that
fails loads its band on demand, in the port's engine as in the JAX one;
and `run_loads` on the engine directly keeps at most three bands
resident with the worker and gives the unbanded records.
"""

import numpy as np
import pytest

import tomahawk_tpu_torch  # noqa: F401  (binds libzstd where needed)

from tomahawk_tpu.compute.engine import CalcSettings as JaxCalcSettings
from tomahawk_tpu.compute.engine import LdEngine as JaxLdEngine
from tomahawk_tpu.compute.engine import compute_ld as jax_compute_ld
from tomahawk_tpu.compute.engine import dispatch_pairs as jax_dispatch
from tomahawk_tpu.io.importer import ImportSettings, import_vcf
from tomahawk_tpu.ops.ld_math import LdFilters as JaxLdFilters

from tomahawk_tpu_torch.compute.engine import (CalcSettings, LdEngine,
                                               _plan_loads, compute_ld,
                                               dispatch_pairs, run_loads)
from tomahawk_tpu_torch.ops.ld_math import LdFilters

from test_importer import make_vcf
from test_torch_dist import (_archive, _calc_argv, _free_port, _jax_single,
                             assert_ranks_ok, run_ranks)
from test_torch_engine import _sorted
from test_torch_groups import group_planes

#: the fields that name a record, and the statistics held to 1e-12
IDENTITY = ("ridA", "packA", "ridB", "packB", "controller")
STATS = ("D", "Dprime", "R2", "P")

MODES = {"phased": dict(force_phased=True),
         "unphased": dict(forced_unphased=True), "mixed": {},
         "window": dict(window=True, l_window=1000)}


def assert_records_match(got, want):
    """Identity fields equal, D / D' / r2 / P within 1e-12, the rest
    equal."""
    assert len(got) == len(want) > 0
    for f in want.dtype.names:
        if f in STATS:
            np.testing.assert_allclose(got[f], want[f], rtol=0, atol=1e-12,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert set(IDENTITY) <= set(want.dtype.names)


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """The JAX package's banded case: 30 samples, 40 sites on two
    contigs, 5% missing, blocks of 5 (8 super-blocks of 10 rows)."""
    d = tmp_path_factory.mktemp("torch_banded")
    vcf = str(d / "m.vcf")
    make_vcf(vcf, n_samples=30, n_sites=40, miss_frac=0.05, seed=11)
    twk = str(d / "m.twk")
    import_vcf(ImportSettings(input=vcf, output=twk, block_size=5,
                              threshold_miss=0.5))
    return twk


@pytest.mark.parametrize("stage", [True, False], ids=["staged", "serial"])
@pytest.mark.parametrize("mode", list(MODES))
def test_banded_calc_matches_jax(archive, tmp_path, monkeypatch, mode,
                                 stage):
    kw = dict(min_r2=0.0, tile_rows=10, memory_gb=1e-6,
              stage_prefetch=stage, **MODES[mode])
    monkeypatch.setenv("TWK_DEVICE_FISHER", "0")
    ref = str(tmp_path / "jax.two")
    jres = jax_compute_ld(JaxCalcSettings(input=archive, output=ref,
                                          mesh="off", backend="device", **kw))
    out = str(tmp_path / "port.two")
    res = compute_ld(CalcSettings(input=archive, output=out, **kw),
                     device="cpu")
    assert_records_match(_sorted(out), _sorted(ref))
    assert res.n_records == jres.n_records
    assert res.n_pairs == jres.n_pairs
    ss, js = res.stage_stats, jres.stage_stats
    assert ss["n_loads"] == js["n_loads"] > 1
    if stage:
        assert ss["n_prefetched"] > 0
    else:
        assert ss["n_uploads"] == js["n_uploads"]
        assert ss["n_prefetched"] == js["n_prefetched"] == 0


def test_banded_plan_is_the_jax_plan(archive):
    """The loads of a banded run, band by band and tile by tile, are the
    JAX package's `_plan_loads` (the port keeps a copy)."""
    from tomahawk_tpu.compute.engine import _plan_loads as jax_plan
    ids = list(range(8))
    pairs = [(i, j, i == j) for i in ids for j in ids if j >= i]
    for budget, parts in ((2, 2), (2, 3), (5, 3), (8, 2)):
        assert _plan_loads(ids, pairs, budget, parts) \
            == jax_plan(ids, pairs, budget, parts)


@pytest.mark.parametrize("extra", [[], ["--mesh", "dcn"]],
                         ids=["tile-partition", "dcn"])
def test_banded_two_rank_calc_matches_jax(tmp_path, monkeypatch, extra):
    """Two ranks on gloo with `-M 1e-6`: the tile partition (each rank
    bands its own super-blocks, staging on) merged, and the
    samples-sharded run (the same serial loads on both ranks), against
    the JAX package's single-process records."""
    from tomahawk_tpu_torch.parallel import distributed as dist
    twk = _archive(tmp_path, "s32")
    want = _jax_single(twk, str(tmp_path / "single.two"), "mixed",
                       monkeypatch)
    out = str(tmp_path / "banded.two")
    port = _free_port()
    results = run_ranks([_calc_argv(r, port, twk, out, "mixed",
                                    extra + ["-M", "1e-6"])
                         for r in (0, 1)])
    assert_ranks_ok(results)
    for _, text in results:
        assert "band-pair loads" in text
    if extra:
        got = _sorted(out)
    else:
        merged = str(tmp_path / "merged.two")
        dist.merge_shards(dist.shard_paths(out, 2), merged)
        got = _sorted(merged)
    assert_records_match(got, want)


def _band_engines(n_samples, B):
    settings = dict(min_r2=0.0, min_p=1.0)
    port = LdEngine(None, n_samples, CalcSettings(**settings), "cpu", B=B)
    jax_engine = JaxLdEngine(None, n_samples, JaxCalcSettings(**settings),
                             mesh=None, B=B)
    # the port takes its residency limit from each load (run_loads)
    jax_engine.MAX_RESIDENT_BANDS = 3
    return port, jax_engine


def _resident(engine):
    """The bands resident in either package's engine."""
    if isinstance(engine, LdEngine):
        return engine.bands.resident()
    return list(engine._band_host)


def test_staging_failure_loads_on_demand(monkeypatch, capfd):
    """A staging provider that raises does not stop the run: stage_wait
    reports it and the band loads on demand at the next set_load, in
    both engines, with the same candidates and records."""
    monkeypatch.setenv("TWK_DEVICE_FISHER", "0")
    n_samples, B = 100, 128
    stacked = group_planes(23, 4, B, n_samples)

    def band(b):
        return {k: v[2 * b:2 * b + 2] for k, v in stacked.items()}

    def boom():
        raise RuntimeError("inflate exploded")
    got = []
    for e, filt, dispatch in zip(_band_engines(n_samples, B),
                                 (LdFilters, JaxLdFilters),
                                 (dispatch_pairs, jax_dispatch)):
        e.stage_band_async(1, boom)
        e.stage_wait()                       # must not raise
        assert 1 not in _resident(e)
        e.set_load([(0, band(0)), (1, band(1))])
        out = []
        n = dispatch(e, [(0, 2, False), (1, 3, False)], "mixed",
                     filt(min_r2=0.0, min_p=1.0),
                     lambda recs, rev=None: out.append(recs.copy()),
                     e.stacked)
        e.stage_close()
        got.append((n, np.sort(np.concatenate(out),
                               order=list(out[0].dtype.names))))
    assert "staging band 1 failed (RuntimeError: inflate exploded)" \
        in capfd.readouterr().err
    (n, a), (jn, b) = got
    assert n == jn > 0
    assert_records_match(a, b)


def test_run_loads_with_staging_matches_one_band(monkeypatch):
    """The engine's load loop over bands of two super-blocks (and one of
    one) with the staging worker: never more than three bands resident,
    bands staged ahead of their loads, and the records of the unbanded
    run."""
    # host Fisher: the bands change the segments and so which segments
    # open the in-sweep Fisher's volume gate, and P from its bracket is the
    # exact kernel's only within the 1e-5 guard (tests/test_torch_fisher.py)
    monkeypatch.setenv("TWK_DEVICE_FISHER", "0")
    n_samples, B, NB = 100, 128, 7
    stacked = group_planes(17, NB, B, n_samples)
    pairs = [(i, j, i == j) for i in range(NB) for j in range(i, NB)]
    filt = LdFilters(min_r2=0.0, min_p=1.0)

    def run(engine, fn):
        out = []
        n = fn(engine, lambda recs, rev=None: out.append(recs.copy()))
        engine.stage_close()
        recs = np.concatenate(out)
        return n, np.sort(recs, order=list(recs.dtype.names))
    one = LdEngine(stacked, n_samples, CalcSettings(min_r2=0.0), "cpu")
    n1, want = run(one, lambda e, emit: dispatch_pairs(
        e, pairs, "mixed", filt, emit, stacked))
    bands, loads = _plan_loads(list(range(NB)), pairs, 6, parts=3)
    assert [len(b) for b in bands] == [2, 2, 2, 1] and len(loads) == 10
    engine, _ = _band_engines(n_samples, B)
    peak = []
    set_load = engine.set_load

    def watched(load, **kw):
        set_load(load, **kw)
        peak.append(len(engine.bands.resident()))
    monkeypatch.setattr(engine, "set_load", watched)
    provider = lambda b: {k: v[bands[b]] for k, v in stacked.items()}
    n, got = run(engine, lambda e, emit: run_loads(
        e, bands, loads, provider, "mixed", filt, emit, prefetch=True))
    assert n == n1
    assert_records_match(got, want)
    assert max(peak) <= 3
    assert engine.stage_stats["n_prefetched"] > 0
