"""The in-sweep D' filter (-d/-D) of the port against the JAX package's,
on the CPU: `dprime_prefilter_cells` bit for bit (cancellation and
dmax_num == 0 included), the phased and unphased plain tile prefilters
with D' bounds in mask and survivors, and `compute_ld` with -d/-D in -p,
-u and the mixed dispatch, record for record. Every comparison is exact:
the port's f32 expressions round as the JAX package's do, and the kernels
(csrc/prefilter.cuh, checked on the card by chip_smoke.py) as these."""

import numpy as np
import pytest
import torch

import tomahawk_tpu_torch  # noqa: F401  (binds libzstd where needed)

jnp = pytest.importorskip("jax.numpy")

from tomahawk_tpu.compute import sweeps as jsweeps
from tomahawk_tpu.compute.engine import CalcSettings as JaxCalcSettings
from tomahawk_tpu.compute.engine import compute_ld as jax_compute_ld
from tomahawk_tpu.io.importer import ImportSettings, import_vcf
from tomahawk_tpu.io.two import TwoReader
from tomahawk_tpu.ops import ld_kernels as JK

from tomahawk_tpu_torch.compute import sweeps
from tomahawk_tpu_torch.compute.engine import CalcSettings, compute_ld
from tomahawk_tpu_torch.ops import ld_kernels as K
from tomahawk_tpu_torch.ops import tiles

from test_importer import make_vcf
from test_torch_ld_kernels import jax_dev
from test_torch_window import N_SAMPLES, window_planes

BOUNDS = [(0.5, 100.0), (0.0, 0.9), (0.3, 0.7), (0.99, 1.0), (0.0, 100.0)]


def _cells(seed, n=20_000):
    """Integer 2x2 cells: random tables, tables whose rr*aa and ar*ra
    cancel (D near 0 against large products), and tables with a zero
    margin (dmax_num == 0)."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 3000, size=(n, 4))
    k = n // 4
    # rr*aa == ar*ra exactly, or off by one cell
    a, b = rng.integers(1, 2000, (2, k))
    c[:k] = np.stack([a, b, a, b], axis=1)
    c[k:2 * k] = np.stack([a + 1, b, a, b], axis=1)
    z = rng.integers(0, 4, k)
    c[2 * k:3 * k, 0] = np.where(z == 0, 0, c[2 * k:3 * k, 0])
    c[2 * k:3 * k, 1] = np.where(z <= 1, 0, c[2 * k:3 * k, 1])
    c[2 * k:3 * k, 3] = np.where(z == 3, 0, c[2 * k:3 * k, 3])
    return c.astype(np.int32)


@pytest.mark.parametrize("bounds", BOUNDS)
def test_dprime_cells_bit_equal_to_jax(bounds):
    c = _cells(1)
    got = K.dprime_prefilter_cells(
        tuple(torch.from_numpy(c[:, q]) for q in range(4)), *bounds)
    want = JK.dprime_prefilter_cells(
        tuple(jnp.asarray(c[:, q]) for q in range(4)), *bounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if bounds != (0.0, 100.0):
        assert 0 < got.numpy().mean() < 1
    # f32 cells of the unphased fold, as its prefilter hands them over
    f = c.astype(np.float32) * np.float32(0.5)
    got = K.dprime_prefilter_cells(
        tuple(torch.from_numpy(f[:, q]) for q in range(4)), *bounds)
    want = JK.dprime_prefilter_cells(
        tuple(jnp.asarray(f[:, q]) for q in range(4)), *bounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


GROUPS = [("phased", False, "all"), ("phased", True, "all"),
          ("unphased", False, "all"), ("unphased", True, "all"),
          ("phased", False, "clean"), ("unphased", True, "missing")]


@pytest.mark.parametrize("bounds", [(0.0, 0.9), (0.8, 100.0)])
@pytest.mark.parametrize("group", GROUPS, ids=["-".join(map(str, g))
                                               for g in GROUPS])
def test_tile_prefilter_with_dprime_matches_jax(group, bounds):
    """Each sweep group's plain tile with D' bounds: the candidate mask
    and the survivors equal the JAX tile_prefilter's, and in phased tables
    the bounds cut survivors the default keeps."""
    B = 128
    st = window_planes(9, n_blocks=2, B=B)
    dev = sweeps.planes_to_device(st, "cpu")
    jdev = jax_dev(st)
    kept = np.zeros(2, int)
    for i, j in ((0, 0), (0, 1)):
        for q, dp in enumerate((bounds, (0.0, 100.0))):
            cfg = sweeps.make_cfg(*group, B, N_SAMPLES, 0, 0.05, 100.0, *dp)
            jcfg = jsweeps.make_cfg(*group, B, N_SAMPLES, 0, 0.05, 100.0,
                                    min_dprime=dp[0], max_dprime=dp[1])
            mask, parts = tiles.tile_prefilter_plain(dev, i, j, i == j, cfg)
            pf, m, jparts = jsweeps.tile_prefilter(jdev, i, j, i == j, jcfg)
            np.testing.assert_array_equal(mask.numpy() >= 1, np.asarray(m))
            np.testing.assert_array_equal(mask.numpy() == 2, np.asarray(pf))
            kept[q] += int((mask == 2).sum())
    # the unphased EM case (a double heterozygote) passes whatever its D'
    assert 0 < kept[0] <= kept[1]
    if group[0] == "phased":
        assert kept[0] < kept[1]


def test_fused_sweep_with_dprime_matches_jax():
    """The survivor rows of a fused sweep with D' bounds, equal to the
    JAX fused sweep's row for row."""
    B = 128
    st = window_planes(4, n_blocks=3, B=B)
    pairs = [(i, j, i == j) for i in range(3) for j in range(i, 3)]
    tl = (np.array([p[0] for p in pairs], np.int32),
          np.array([p[1] for p in pairs], np.int32),
          np.array([p[2] for p in pairs]), np.ones(len(pairs), bool))
    cfg = sweeps.make_cfg("phased", True, "all", B, N_SAMPLES, 0, 0.05,
                          100.0, 0.5, 0.95)
    jcfg = jsweeps.make_cfg("phased", True, "all", B, N_SAMPLES, 0, 0.05,
                            100.0, min_dprime=0.5, max_dprime=0.95)
    cap, outcap = 4096, 1 << 15
    n, nc, buf = sweeps.fused_sweep(sweeps.planes_to_device(st, "cpu"), *tl,
                                    cfg=cfg, cap=cap, outcap=outcap)
    jn, jnc, jbuf = jsweeps.jit_fused_sweep(jcfg, cap, outcap)(jax_dev(st),
                                                               *tl)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(nc.numpy(), np.asarray(jnc))
    total = int(n.sum())
    assert total > 0
    np.testing.assert_array_equal(buf.numpy()[:total],
                                  np.asarray(jbuf)[:total])


def _sorted(path):
    r = TwoReader(path)
    recs = r.records()
    r.close()
    return np.sort(recs, order=list(recs.dtype.names))


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """Phased and unphased VCFs, 5% of genotypes missing."""
    d = tmp_path_factory.mktemp("torch_dprime")
    out = {}
    for phased in (True, False):
        vcf = str(d / f"d{phased}.vcf")
        make_vcf(vcf, n_samples=40, n_sites=400, seed=8, miss_frac=0.05,
                 phased=phased)
        twk = str(d / f"d{phased}.twk")
        import_vcf(ImportSettings(input=vcf, output=twk, block_size=64,
                                  threshold_miss=0.5))
        out[phased] = twk
    return out


MODES = {"phased": dict(force_phased=True), "unphased":
         dict(forced_unphased=True), "mixed": {}}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("phased", [True, False], ids=["phased_vcf",
                                                      "unphased_vcf"])
def test_compute_ld_with_dprime_matches_jax(archives, tmp_path, monkeypatch,
                                            mode, phased):
    monkeypatch.setenv("TWK_DEVICE_FISHER", "0")
    kw = dict(input=archives[phased], min_r2=0.05, tile_rows=128,
              min_dprime=0.5, max_dprime=0.95, **MODES[mode])
    compute_ld(CalcSettings(output=str(tmp_path / "port.two"), **kw),
               device="cpu")
    jax_compute_ld(JaxCalcSettings(output=str(tmp_path / "jax.two"),
                                   mesh="off", backend="device", **kw))
    got, want = _sorted(tmp_path / "port.two"), _sorted(tmp_path / "jax.two")
    assert len(got) == len(want) > 0
    for f in got.dtype.names:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert (np.abs(got["Dprime"]) >= 0.5).all()
