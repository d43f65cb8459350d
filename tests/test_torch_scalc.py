"""The port's `scalc` (compute/scalc.py, and the CLI subcommand) against
the JAX package's `compute_single`, on the CPU: a small VCF with missing
calls, ranged targets in blocks of 100 rows (neighbour_block), the mixed
dispatch over target x target and target x neighbour tiles, with and
without D' bounds. The record multisets are equal in every field but P,
and P within the reference's 1e-5 guard (either engine may take P from
its in-sweep Fisher bracket)."""

import numpy as np
import pytest

import tomahawk_tpu_torch  # noqa: F401  (binds libzstd where needed)

pytest.importorskip("jax")

from tomahawk_tpu.compute.scalc import ScalcSettings as JaxScalcSettings
from tomahawk_tpu.compute.scalc import compute_single as jax_compute_single
from tomahawk_tpu.io.two import TwoReader

from tomahawk_tpu_torch import cli
from tomahawk_tpu_torch.compute.scalc import ScalcSettings, compute_single
from tomahawk_tpu_torch.io.twk import TwkReader
from tomahawk_tpu_torch.ops import _build

from test_importer import make_vcf


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """400 phased sites on one contig, 4% of calls missing; the targets
    are 120 sites in the middle (two blocks of 100 rows, one of them
    partial), the neighbours every other site."""
    d = tmp_path_factory.mktemp("torch_scalc")
    vcf = str(d / "in.vcf")
    make_vcf(vcf, n_samples=48, n_sites=400, seed=12, miss_frac=0.04,
             contigs=("20",))
    twk = str(d / "in.twk")
    assert cli.main(["import", "-i", vcf, "-o", twk, "-n", "0.5"]) == 0
    with TwkReader(twk) as r:
        pos = [rec.pos for rec in r.records()]
    interval = f"20:{pos[140] + 1}-{pos[259] + 1}"
    return twk, interval


def _sorted(path):
    r = TwoReader(path)
    recs = r.records()
    r.close()
    order = [f for f in recs.dtype.names if f != "P"]
    return np.sort(recs, order=order), order


@pytest.mark.parametrize("dprime", [(), ("-d", "0.5")], ids=["all", "d0.5"])
@pytest.mark.parametrize("entry", ["api", "cli"])
def test_scalc_matches_jax(archive, tmp_path, entry, dprime):
    twk, interval = archive
    min_dprime = float(dprime[1]) if dprime else 0.0
    out = str(tmp_path / "port.two")
    _build.reset_counts()
    if entry == "api":
        compute_single(ScalcSettings(input=twk, output=out,
                                     interval=interval, l_surrounding=1e9,
                                     min_r2=0.05, min_dprime=min_dprime),
                       device="cpu")
    else:
        assert cli.main(["scalc", "-i", twk, "-o", out, "-I", interval,
                         "-w", "1e9", "-r", "0.05", *dprime,
                         "--device", "cpu"]) == 0
    ref = str(tmp_path / "jax.two")
    jax_compute_single(JaxScalcSettings(
        input=twk, output=ref, interval=interval, l_surrounding=10 ** 9,
        min_r2=0.05, min_dprime=min_dprime))
    (got, order), (want, _) = _sorted(out), _sorted(ref)
    assert len(got) == len(want) > 100
    for f in order:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert np.abs(got["P"] - want["P"]).max() <= 1e-5
    # both mixed classes ran, at 100-row blocks
    assert _build.PLAIN_CALLS["phased_tile"] > 0
    assert _build.PLAIN_CALLS["parts_tile"] > 0
    if dprime:
        assert (np.abs(got["Dprime"]) >= 0.5).all()
