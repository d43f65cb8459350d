"""The port's small-workload CPU route against the JAX package's
(tests/test_backend_route.py, case for case): `_route_backend` with the
run's device in place of the JAX platform check, so the tests decide a
route for a card they do not have; the limit (TWK_CPU_ROUTE_WORK, which
tests/conftest.py sets to 0 for every test, and the card's measured
default); and the routed run: `calc --backend cpu` gives the JAX
package's `--backend cpu` records and the port's device route's, with no
kernel launched and no plain version taken, on the native CPU tile
engine; a checkpointed routed run and a host without the native library
take the segment engine on the CPU. Records are equal in every field
(host Fisher on both sides)."""

import pytest
import torch

from tomahawk_tpu.compute.engine import CalcSettings
from tomahawk_tpu.compute.engine import compute_ld as jax_compute_ld
from tomahawk_tpu.io.importer import ImportSettings, import_vcf

from tomahawk_tpu_torch import cli, native
from tomahawk_tpu_torch.compute.engine import (CPU_ROUTE_WORK,
                                               _route_backend, compute_ld)
from tomahawk_tpu_torch.ops import _build
from tomahawk_tpu_torch.parallel.mesh import make_mesh

from test_importer import make_vcf
from test_torch_engine import _assert_same, _sorted


def _settings(**kw):
    return CalcSettings(**kw)


class TestRouteDecision:
    def test_explicit_cpu_wins(self):
        assert _route_backend(_settings(backend="cpu"), 10**15, 10**6, 1,
                              device="cuda")

    def test_explicit_device_wins(self):
        assert not _route_backend(_settings(backend="device"), 1, 2, 1,
                                  device="cuda")

    def test_distributed_routes_like_single_process(self, monkeypatch):
        """Tile-partition processes route their own partitions; only a
        dcn mesh is device-only."""
        monkeypatch.setenv("TWK_CPU_ROUTE_WORK", "1e9")
        assert _route_backend(_settings(backend="auto"), 10**6, 64, 4,
                              device="cuda")
        assert _route_backend(_settings(backend="cpu"), 1, 2, 4,
                              device="cuda")

    def test_dcn_never_routes(self, monkeypatch):
        monkeypatch.setenv("TWK_CPU_ROUTE_WORK", "1e30")
        assert not _route_backend(_settings(backend="auto"), 1, 2, 4,
                                  dcn=True, device="cuda")

    def test_dcn_rejects_forced_cpu(self):
        with pytest.raises(ValueError):
            _route_backend(_settings(backend="cpu"), 1, 2, 4, dcn=True,
                           device="cuda")

    def test_explicit_mesh_wins(self, monkeypatch):
        monkeypatch.setenv("TWK_CPU_ROUTE_WORK", "1e30")
        assert not _route_backend(
            _settings(backend="auto", mesh="cpu:2x1"), 1, 2, 1,
            device="cuda")
        assert not _route_backend(_settings(backend="auto"), 1, 2, 1,
                                  device="cuda",
                                  mesh=make_mesh(1, 1, ["cuda:0"]))
        assert _route_backend(_settings(backend="auto", mesh="off"), 1, 2,
                              1, device="cuda")

    def test_auto_small_workload(self, monkeypatch):
        """On a card, work below TWK_CPU_ROUTE_WORK routes to the CPU and
        work above it stays on the card; a run on the CPU never
        routes."""
        monkeypatch.setenv("TWK_CPU_ROUTE_WORK", "1e9")
        small = _settings(backend="auto")
        assert _route_backend(small, 10**6, 64, 1, device="cuda")
        assert not _route_backend(small, 10**9, 5000, 1, device="cuda")
        assert not _route_backend(small, 10**6, 64, 1, device="cpu")


def test_route_limit(monkeypatch):
    """The limit: TWK_CPU_ROUTE_WORK where it is set (conftest sets 0:
    never), else CPU_ROUTE_WORK, the card's measured crossover; the
    route is taken strictly below it."""
    s = _settings(backend="auto")
    n = 2504
    below = int(CPU_ROUTE_WORK // (2 * n)) - 1
    assert not _route_backend(s, below, n, 1, device="cuda")   # "0"
    monkeypatch.delenv("TWK_CPU_ROUTE_WORK")
    assert _route_backend(s, below, n, 1, device="cuda")
    assert not _route_backend(s, below + 2, n, 1, device="cuda")
    monkeypatch.setenv("TWK_CPU_ROUTE_WORK", str(2 * n * 1000))
    assert _route_backend(s, 999, n, 1, device="cuda")
    assert not _route_backend(s, 1000, n, 1, device="cuda")


@pytest.fixture(scope="module")
def small_archive(tmp_path_factory):
    d = tmp_path_factory.mktemp("route")
    vcf = str(d / "in.vcf")
    make_vcf(vcf, n_samples=40, n_sites=300, seed=11, contigs=("20",))
    twk = str(d / "in.twk")
    import_vcf(ImportSettings(input=vcf, output=twk, block_size=64))
    return twk


KW = dict(force_phased=True, min_r2=0.05, tile_rows=128)


def _jax_cpu(twk, path):
    jax_compute_ld(_settings(input=twk, output=path, mesh="off",
                             backend="cpu", **KW))
    return _sorted(path)


def test_cpu_backend_output_matches(small_archive, tmp_path, monkeypatch,
                                    capsys):
    """calc --backend cpu: the JAX package's --backend cpu records and
    the port's device route's, from the native CPU tile engine, with no
    kernel launched and no plain version taken; logged under ENGINE."""
    monkeypatch.setenv("TWK_DEVICE_FISHER", "0")
    want = _jax_cpu(small_archive, str(tmp_path / "jax.two"))
    out = str(tmp_path / "cpu.two")
    _build.reset_counts()
    res = compute_ld(_settings(input=small_archive, output=out,
                               backend="cpu", **KW), device="cpu")
    assert not any(_build.LAUNCHES.values())
    assert not any(_build.PLAIN_CALLS.values())
    assert res.stage_stats is None and res.n_records == len(want)
    assert "running on the CPU (--backend device overrides)" in \
        capsys.readouterr().err
    _assert_same(_sorted(out), want)
    dev = str(tmp_path / "dev.two")
    compute_ld(_settings(input=small_archive, output=dev, backend="device",
                         **KW), device="cpu")
    assert _build.PLAIN_CALLS["compact"] > 0
    _assert_same(_sorted(dev), want)


def test_auto_route_starts_no_card(small_archive, tmp_path, monkeypatch):
    """`--backend auto` below the limit on a host whose card is asked for:
    the run is routed before any device work, so it neither needs nor
    touches CUDA (here there is none: its one check is stubbed); with the
    limit at 0 the same run goes to the card, which is missing, and
    raises."""
    monkeypatch.setenv("TWK_DEVICE_FISHER", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    want = _jax_cpu(small_archive, str(tmp_path / "jax.two"))
    monkeypatch.setenv("TWK_CPU_ROUTE_WORK", "1e30")
    out = str(tmp_path / "auto.two")
    compute_ld(_settings(input=small_archive, output=out, **KW),
               device="cuda")
    _assert_same(_sorted(out), want)
    monkeypatch.setenv("TWK_CPU_ROUTE_WORK", "0")
    with pytest.raises((RuntimeError, AssertionError)):
        compute_ld(_settings(input=small_archive, output=out, **KW),
                   device="cuda")


def test_cli_backend_cpu_needs_no_card(small_archive, tmp_path,
                                       monkeypatch):
    monkeypatch.setenv("TWK_DEVICE_FISHER", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "cli.two")
    assert cli.main(["calc", "-i", small_archive, "-o", out, "-p", "-r",
                     "0.05", "--tile-rows", "128", "--backend", "cpu"]) == 0
    _assert_same(_sorted(out), _jax_cpu(small_archive,
                                        str(tmp_path / "jax.two")))


@pytest.mark.parametrize("how", ["checkpoint", "no_native"])
def test_routed_run_on_the_segment_engine(small_archive, tmp_path,
                                          monkeypatch, capsys, how):
    """A checkpointed routed run keeps the segment engine, on the CPU
    (the plain versions), and so does a host without the native library
    (the JAX package goes to XLA:CPU there); both logged, both the JAX
    package's records."""
    monkeypatch.setenv("TWK_DEVICE_FISHER", "0")
    want = _jax_cpu(small_archive, str(tmp_path / "jax.two"))
    out = str(tmp_path / f"{how}.two")
    kw = dict(KW)
    if how == "checkpoint":
        kw.update(checkpoint=out + ".ckpt", checkpoint_interval=0.0)
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    _build.reset_counts()
    compute_ld(_settings(input=small_archive, output=out, backend="cpu",
                         **kw), device="cpu")
    assert _build.PLAIN_CALLS["compact"] > 0
    assert not any(_build.LAUNCHES.values())
    err = capsys.readouterr().err
    assert "running on the CPU" in err
    assert ("No native CPU tile engine" in err) == (how == "no_native")
    _assert_same(_sorted(out), want)

