"""The port's `calc` as a whole against the JAX package's: the same
imported archive through both engines (host Fisher on both sides) gives
the same sorted .two records in every field, with -p, with -u and in
the default mixed dispatch, on archives with and without missing
genotypes, and with D' bounds; on meshes, one-process distributed runs
and the CPU route (tests/test_torch_mesh.py, tests/test_torch_route.py
hold them in full); the --performance histogram. Also: repair of cap
overflow and buffer spill and the CLI's device rule (window mode:
tests/test_torch_window.py; banded streaming:
tests/test_torch_banded.py)."""

import dataclasses
import os
import socket

import numpy as np
import pytest
import torch

from test_importer import make_vcf

from tomahawk_tpu.compute.engine import CalcSettings
from tomahawk_tpu.compute.engine import LdEngine as JaxLdEngine
from tomahawk_tpu.compute.engine import compute_ld as jax_compute_ld
from tomahawk_tpu.io.importer import ImportSettings, import_vcf
from tomahawk_tpu.io.two import TwoReader
from tomahawk_tpu.ops.ld_math import LdFilters

from tomahawk_tpu_torch import cli
from tomahawk_tpu_torch.compute import engine as port_engine
from tomahawk_tpu_torch.compute.engine import LdEngine, compute_ld
from tomahawk_tpu_torch.ops import _build

from test_torch_groups import group_planes


def _sorted(path):
    r = TwoReader(path)
    recs = r.records()
    r.close()
    return np.sort(recs, order=list(recs.dtype.names))


def _assert_same(a, b):
    assert len(a) == len(b) > 0
    for f in a.dtype.names:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """Phased, no missing genotypes, two contigs; imported through the
    port's CLI and its own importer."""
    d = tmp_path_factory.mktemp("torch_engine")
    vcf = str(d / "in.vcf")
    make_vcf(vcf, n_samples=48, n_sites=600, seed=21, miss_frac=0.0,
             contigs=("20", "21"))
    twk = str(d / "in.twk")
    assert cli.main(["import", "-i", vcf, "-o", twk, "-b", "64"]) == 0
    return twk


@pytest.fixture(scope="module")
def jax_records(archive, tmp_path_factory):
    """The JAX engine's records, phased and mixed dispatch."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TWK_DEVICE_FISHER", "0")
    d = tmp_path_factory.mktemp("torch_engine_ref")
    out = {}
    try:
        for phased in (True, False):
            path = str(d / f"jax_{phased}.two")
            jax_compute_ld(CalcSettings(
                input=archive, output=path, force_phased=phased,
                min_r2=0.05, tile_rows=128, mesh="off", backend="device"))
            out[phased] = _sorted(path)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("entry,phased", [("api", True), ("api", False),
                                          ("cli", True)])
def test_calc_matches_jax(archive, jax_records, tmp_path, entry, phased):
    out = str(tmp_path / "torch.two")
    _build.reset_counts()
    if entry == "api":
        res = compute_ld(CalcSettings(input=archive, output=out,
                                      force_phased=phased, min_r2=0.05,
                                      tile_rows=128), device="cpu")
        assert res.n_records == len(jax_records[phased])
    else:
        assert cli.main(["calc", "-i", archive, "-o", out, "-p",
                         "-r", "0.05", "--tile-rows", "128",
                         "--device", "cpu"]) == 0
    _assert_same(_sorted(out), jax_records[phased])
    # CPU tensors take the plain versions, never a kernel
    assert _build.PLAIN_CALLS["phased_tile"] > 0
    assert _build.PLAIN_CALLS["compact"] > 0
    assert sum(_build.LAUNCHES.values()) == 0


def _correlated_archive(tmp_path, n=30, sites=60, miss_frac=0.0):
    """Sites in groups of 10 share a haplotype template: many
    survivors per tile. With miss_frac, that share of genotypes is
    missing (`.|.`)."""
    rng = np.random.default_rng(3)
    lines = ["##fileformat=VCFv4.2", "##contig=<ID=c1,length=10000000>",
             '##FORMAT=<ID=GT,Number=1,Type=String,Description="G">',
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(f"S{i}" for i in range(n))]
    pos = 1000
    for s in range(sites):
        if s % 10 == 0:
            base = rng.random(2 * n) < 0.4
        hap = base ^ (rng.random(2 * n) < 0.06)
        miss = rng.random(n) < miss_frac
        pos += int(rng.integers(40, 200))
        gt = "\t".join(".|." if miss[i] else
                       f"{int(hap[2 * i])}|{int(hap[2 * i + 1])}"
                       for i in range(n))
        lines.append(f"c1\t{pos}\t.\tA\tC\t.\tPASS\t.\tGT\t{gt}")
    vcf = tmp_path / "r.vcf"
    vcf.write_text("\n".join(lines) + "\n")
    twk = str(tmp_path / "r.twk")
    import_vcf(ImportSettings(input=str(vcf), output=twk, block_size=8,
                              threshold_miss=0.5))
    return twk


def _repair_runs(tmp_path, monkeypatch, twk, stat_key, **settings):
    """Runs whose caps overflow (cap 8) or whose buffer spills (outcap
    512) give the records of caps nothing overflows, and the JAX
    engine's; each run grows the cap it overran."""
    settings = dict(input=twk, min_r2=0.0, tile_rows=16, **settings)
    runs, engines = {}, {}
    orig_init = LdEngine.__init__
    for cap, outcap in ((1 << 20, 1 << 20), (8, 64), (256, 512)):
        def init(self, *a, cap=cap, **kw):
            orig_init(self, *a, **kw)
            engines[cap] = self
        monkeypatch.setattr(LdEngine, "__init__", init)
        monkeypatch.setattr(LdEngine, "FUSED_CAP", cap)
        monkeypatch.setattr(LdEngine, "OUTCAP0", outcap)
        out = str(tmp_path / f"o{cap}.two")
        compute_ld(CalcSettings(output=out, **settings), device="cpu")
        runs[cap] = _sorted(out)
    monkeypatch.setenv("TWK_DEVICE_FISHER", "0")
    ref = str(tmp_path / "jax.two")
    jax_compute_ld(CalcSettings(output=ref, mesh="off", backend="device",
                                **settings))
    for cap in (8, 256):
        _assert_same(runs[cap], runs[1 << 20])
        assert engines[cap].stats[stat_key]["n_repair"] > 0
    _assert_same(runs[8], _sorted(ref))
    assert engines[8]._fused_cap > 8
    assert engines[256]._outcap > 512


def test_cap_overflow_and_spill_repair(tmp_path, monkeypatch):
    """Tiles past the fused cap and a spilling buffer (~1,800 survivors)
    are repaired exactly."""
    _repair_runs(tmp_path, monkeypatch, _correlated_archive(tmp_path),
                 "phased/nomiss/all", force_phased=True)


def test_cap_overflow_and_spill_repair_nine_parts(tmp_path, monkeypatch):
    """The same repair for the 9-part group: -u on an archive where
    every block has missing genotypes."""
    twk = _correlated_archive(tmp_path, miss_frac=0.05)
    _repair_runs(tmp_path, monkeypatch, twk, "unphased/miss/all",
                 forced_unphased=True)


@pytest.mark.parametrize("runner", ["unphased", "unphased_missing",
                                    "mixed"])
def test_pair_runners_match_jax(runner, monkeypatch):
    """LdEngine.run_unphased_pairs (4- and 9-part tables) and
    run_mixed_pairs give the JAX engine's records on the same planes."""
    monkeypatch.setenv("TWK_DEVICE_FISHER", "0")
    n_samples = 64
    st = group_planes(9, 2, 128, n_samples,
                      miss_frac=0.0 if runner == "unphased" else 0.05)
    pairs = [(0, 0, True), (0, 1, False), (1, 1, True)]
    filt = LdFilters(min_r2=0.05)
    got = []
    for engine in (LdEngine(st, n_samples, CalcSettings(min_r2=0.05),
                            "cpu"),
                   JaxLdEngine(st, n_samples, CalcSettings(min_r2=0.05))):
        out = []
        emit = lambda r, rev=None: out.append(r.copy())
        try:
            if runner == "mixed":
                engine.run_mixed_pairs(pairs, filt, emit)
            else:
                engine.run_unphased_pairs(pairs, runner != "unphased", filt,
                                          emit)
        finally:
            engine.stage_close()
        recs = np.concatenate(out)
        got.append(np.sort(recs, order=list(recs.dtype.names)))
    _assert_same(*got)


def test_cli_calc_needs_cuda(archive, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.two"
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["calc", "-i", archive, "-o", str(out), "-p"])
    assert not out.exists()


MODES = {"mixed": dict(), "phased": dict(force_phased=True),
         "unphased": dict(forced_unphased=True)}
FLAGS = {"mixed": [], "phased": ["-p"], "unphased": ["-u"]}


@pytest.fixture(scope="module")
def missing_archives(tmp_path_factory):
    """5% missing genotypes, phased (`|`) and unphased (`/`) VCFs."""
    d = tmp_path_factory.mktemp("torch_engine_miss")
    out = {}
    for phased in (True, False):
        vcf = str(d / f"m{phased}.vcf")
        make_vcf(vcf, n_samples=40, n_sites=400, seed=4, miss_frac=0.05,
                 phased=phased)
        twk = str(d / f"m{phased}.twk")
        import_vcf(ImportSettings(input=vcf, output=twk, block_size=64,
                                  threshold_miss=0.5))
        out[phased] = twk
    return out


@pytest.fixture(scope="module")
def jax_missing_records(missing_archives, tmp_path_factory):
    """The JAX engine's records for every (archive, mode)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TWK_DEVICE_FISHER", "0")
    d = tmp_path_factory.mktemp("torch_engine_miss_ref")
    out = {}
    try:
        for phased, twk in missing_archives.items():
            for mode, kw in MODES.items():
                path = str(d / f"jax_{phased}_{mode}.two")
                jax_compute_ld(CalcSettings(
                    input=twk, output=path, min_r2=0.05, tile_rows=128,
                    mesh="off", backend="device", **kw))
                out[phased, mode] = _sorted(path)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("phased", [True, False], ids=["phased_vcf",
                                                      "unphased_vcf"])
def test_calc_with_missing_matches_jax(missing_archives, jax_missing_records,
                                       tmp_path, phased, mode):
    """-p (4-part phased table), -u (4- and 9-part unphased) and the
    mixed dispatch (the clean phased and missing unphased halves of
    every tile with missing data) on archives with missing genotypes."""
    out = str(tmp_path / "torch.two")
    _build.reset_counts()
    res = compute_ld(CalcSettings(input=missing_archives[phased],
                                  output=out, min_r2=0.05, tile_rows=128,
                                  **MODES[mode]), device="cpu")
    want = jax_missing_records[phased, mode]
    assert res.n_records == len(want)
    _assert_same(_sorted(out), want)
    assert _build.PLAIN_CALLS["parts_tile"] > 0
    assert (_build.PLAIN_CALLS["phased_tile"] > 0) == (mode == "mixed")
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_calc_with_missing_matches_jax(missing_archives,
                                           jax_missing_records, tmp_path,
                                           mode):
    out = str(tmp_path / "cli.two")
    assert cli.main(["calc", "-i", missing_archives[True], "-o", out,
                     "-r", "0.05", "--tile-rows", "128", "--device", "cpu",
                     *FLAGS[mode]]) == 0
    _assert_same(_sorted(out), jax_missing_records[True, mode])


@pytest.mark.parametrize("kw", [
    dict(min_dprime=0.5), dict(window=True, l_window=1000, max_dprime=0.9),
])
def test_dprime_settings_match_jax(archive, tmp_path, monkeypatch, kw):
    """D' bounds (-d/-D), all-vs-all and windowed: the port's records
    equal the JAX engine's, field by field (host Fisher on both sides),
    and the bounds cut records."""
    monkeypatch.setenv("TWK_DEVICE_FISHER", "0")
    got = []
    for run, tag in ((compute_ld, "port"), (jax_compute_ld, "jax")):
        for bounds in (kw, {k: v for k, v in kw.items()
                            if "dprime" not in k}):
            path = str(tmp_path / f"{tag}{len(bounds)}.two")
            settings = CalcSettings(input=archive, output=path,
                                    min_r2=0.05, tile_rows=128, **bounds)
            if tag == "port":
                run(settings, device="cpu")
            else:
                run(dataclasses.replace(settings, mesh="off",
                                        backend="device"))
            got.append(_sorted(path))
    port, port_all, jax_dp, _ = got
    _assert_same(port, jax_dp)
    assert len(port) < len(port_all)


@pytest.mark.parametrize("kw", [
    pytest.param(dict(distributed=True, mesh="2x2"), id="kw2"),
    pytest.param(dict(mesh="2x1"), id="kw3"),
    pytest.param(dict(backend="cpu"), id="kw4"),
])
def test_out_of_slice_settings_rejected(archive, tmp_path, kw):
    """What the port once rejected, now parity cases: a one-process
    `--distributed` run on a 2x2 mesh, a 2x1 mesh (both of `cpu`
    entries) and `--backend cpu` give the JAX engine's records under the
    same mesh shape over its virtual CPU devices, or its `--backend
    cpu`."""
    port = dict(kw)
    if kw.get("distributed"):
        port.update(coordinator=f"127.0.0.1:{_free_port()}",
                    num_processes=1, process_id=0)
    jax_kw = {k: v for k, v in kw.items() if k != "distributed"}
    if "mesh" in kw:
        jax_kw.update(mesh="cpu:" + kw["mesh"], backend="device")
    got = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TWK_DEVICE_FISHER", "0")
        for tag in ("port", "jax"):
            out = str(tmp_path / f"{tag}.two")
            settings = CalcSettings(input=archive, tile_rows=128, output=out,
                                    min_r2=0.05)
            if tag == "port":
                compute_ld(dataclasses.replace(settings, **port),
                           device="cpu")
            else:
                jax_compute_ld(dataclasses.replace(settings, **jax_kw))
            got.append(_sorted(out))
    _assert_same(*got)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_performance_histogram_matches_jax(tmp_path, capsys):
    """`calc --performance` prints the allele-count histogram (survivors
    and kept records by log2 bucket of min(ac_a, ac_b)) with the JAX
    CLI's lines, on the same archive, after the group table; the port's
    span table follows it."""
    from tomahawk_tpu.cli import main as jax_main
    vcf = str(tmp_path / "p.vcf")
    make_vcf(vcf, n_samples=24, n_sites=30, miss_frac=0.02, seed=4)
    twk = str(tmp_path / "p.twk")
    assert jax_main(["import", "-i", vcf, "-o", twk]) == 0
    capsys.readouterr()
    lines = []
    for run, extra in ((jax_main, ["--mesh", "off"]),
                       (cli.main, ["--device", "cpu"])):
        assert run(["calc", "-i", twk, "-o", str(tmp_path / "p.two"), "-r",
                    "0.0", "--performance", *extra]) == 0
        err = capsys.readouterr().err.splitlines()
        head = next(i for i, ln in enumerate(err) if "min(ac) bucket" in ln)
        perf = [ln.split("[PERF] ", 1)[1] for ln in err[head:]
                if "[PERF]" in ln]
        # the port's span table (spans.log_table) comes last
        spans_at = [i for i, ln in enumerate(perf) if ln.startswith("span ")]
        assert len(spans_at) == (run is cli.main)
        lines.append(perf[:spans_at[0]] if spans_at else perf)
        assert any("count-sweep rate" in ln for ln in err[:head])
    assert len(lines[0]) > 2 and lines[0] == lines[1]


@pytest.mark.parametrize("mode", ["phased", "mixed"])
def test_checkpointed_calc_matches_jax(archive, tmp_path, monkeypatch,
                                       mode):
    """`--checkpoint` runs (tests/test_torch_checkpoint.py crashes and
    resumes it): a checkpointed run writes a sidecar after every segment
    and the JAX engine's records, and removes the sidecar at the end."""
    monkeypatch.setenv("TWK_DEVICE_FISHER", "0")
    kw = dict(min_r2=0.05, tile_rows=128, checkpoint_interval=0.0,
              force_phased=mode == "phased")
    writes = []
    real = port_engine._ckpt_write
    monkeypatch.setattr(port_engine, "_ckpt_write",
                        lambda *a, **k: writes.append(a[2]) or real(*a, **k))
    got = []
    for run, tag in ((compute_ld, "port"), (jax_compute_ld, "jax")):
        path = str(tmp_path / f"{tag}.two")
        ckpt = str(tmp_path / f"{tag}.ckpt")
        settings = CalcSettings(input=archive, output=path,
                                checkpoint=ckpt, **kw)
        if tag == "port":
            run(settings, device="cpu")
        else:
            run(dataclasses.replace(settings, mesh="off", backend="device"))
        assert not os.path.exists(ckpt)
        got.append(_sorted(path))
    assert writes == list(range(1, len(writes) + 1)) and writes
    _assert_same(*got)
