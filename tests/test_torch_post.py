"""The port's post-processing subcommands against the JAX package's, on
the CPU: each of `view`, `sort`, `concat`, `aggregate`, `stats`, `decay`,
`haplotype` and `relationship` through the port's CLI and through the JAX
CLI on the same `.two` / `.twk`, outputs equal -- text for view, stats,
decay, haplotype and relationship, records for sort and concat, the
`.twa` for aggregate. `relationship`'s kinship on the port's CPU route is
bit-equal to the JAX function's on both of its routes, and the kinship
GEMM's wrapper (ops/kinship.py) equals an integer product at shapes that
need `torch._int_mm`'s padding. The wrapper's card route is held against
its plain version by the `gpu` test here and by chip_smoke.py.
"""

import io

import numpy as np
import pytest
import torch

import tomahawk_tpu_torch  # noqa: F401  (binds libzstd where needed)

from tomahawk_tpu import cli as jcli
from tomahawk_tpu.post import aggregate as jaggregate
from tomahawk_tpu.post.relationship import relationship as jrelationship

from tomahawk_tpu_torch import cli
from tomahawk_tpu_torch.io.importer import ImportSettings, import_vcf
from tomahawk_tpu_torch.io.two import TwoReader
from tomahawk_tpu_torch.ops import _build, kinship
from tomahawk_tpu_torch.post import aggregate
from tomahawk_tpu_torch.post.relationship import relationship

from test_importer import make_vcf


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """An archive of 36 samples and 240 sites on two contigs, 3%
    missing, and the port's `calc -r 0.05` of it."""
    d = tmp_path_factory.mktemp("torch_post")
    vcf, twk = str(d / "in.vcf"), str(d / "in.twk")
    make_vcf(vcf, n_samples=36, n_sites=240, seed=5, miss_frac=0.03)
    import_vcf(ImportSettings(input=vcf, output=twk, block_size=32))
    two = str(d / "ld.two")
    assert cli.main(["calc", "-i", twk, "-o", two, "-r", "0.05",
                     "--tile-rows", "64", "--device", "cpu"]) == 0
    with TwoReader(two) as r:
        names = [c.name for c in r.header.contigs]
        first = r.records()[0]
    return dict(twk=twk, two=two, dir=d, contig=names[0],
                pos=int(first["packA"] >> 2))


def _both(capsys, argv):
    """The stdout of the port's CLI and of the JAX CLI on `argv`."""
    out = []
    for main in (cli.main, jcli.main):
        assert main(list(argv)) in (0, None)
        out.append(capsys.readouterr().out)
    return out


def _both_files(tmp_path, argv, suffix):
    """Run each CLI with `-o <its own file>`; the two files' paths."""
    paths = []
    for tag, main in (("port", cli.main), ("jax", jcli.main)):
        path = str(tmp_path / f"{tag}{suffix}")
        assert main(list(argv) + ["-o", path]) in (0, None)
        paths.append(path)
    return paths


def _text(path):
    with open(path) as fh:
        return fh.read()


def _recs(path):
    with TwoReader(path) as r:
        return r.records()


@pytest.mark.parametrize("flags", [
    [], ["-H"], ["-J"], ["--header-only"], ["-r", "0.3", "-l"],
    ["-I", "CONTIG"]], ids=["plain", "no-header", "json", "header-only",
                            "filtered", "interval"])
def test_view_matches_jax(inputs, tmp_path, flags):
    flags = [inputs["contig"] if f == "CONTIG" else f for f in flags]
    port, jax = _both_files(tmp_path, ["view", "-i", inputs["two"], *flags],
                            ".txt")
    assert _text(port) == _text(jax)
    assert len(_text(port)) > 0


def test_view_binary_records_match_jax(inputs, tmp_path):
    port, jax = _both_files(tmp_path, ["view", "-i", inputs["two"], "-O",
                                       "b", "-r", "0.2"], ".two")
    a, b = _recs(port), _recs(jax)
    assert len(a) == len(b) > 0
    np.testing.assert_array_equal(a, b)


def test_sort_records_match_jax(inputs, tmp_path):
    port, jax = _both_files(tmp_path, ["sort", "-i", inputs["two"]], ".two")
    a, b = _recs(port), _recs(jax)
    assert len(a) == len(b) == len(_recs(inputs["two"]))
    np.testing.assert_array_equal(a, b)
    # (ridA, ridB, A's position, B's position), the reference's order
    key = np.lexsort((a["packB"] >> 2, a["packA"] >> 2, a["ridB"],
                      a["ridA"]))
    np.testing.assert_array_equal(key, np.arange(len(a)))


def test_concat_records_match_jax(inputs, tmp_path):
    port, jax = _both_files(tmp_path, ["concat", "-i", inputs["two"], "-i",
                                       inputs["two"]], ".two")
    a, b = _recs(port), _recs(jax)
    one = _recs(inputs["two"])
    assert len(a) == len(b) == 2 * len(one)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[len(one):], one)


@pytest.mark.parametrize("agg,reduce", [("r2", "mean"), ("dprime", "max"),
                                        ("p", "count")])
def test_aggregate_twa_matches_jax(inputs, tmp_path, agg, reduce):
    port, jax = _both_files(tmp_path, [
        "aggregate", "-i", inputs["two"], "-f", agg, "-r", reduce, "-x",
        "20", "-y", "16", "-c", "1"], ".twa")
    a, b = aggregate.Twa.open(port), jaggregate.Twa.open(jax)
    for f in ("x", "y", "bpx", "bpy", "n_original", "range", "filename",
              "rid_offsets"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.data.shape == (20, 16) and np.isfinite(a.data).all()
    np.testing.assert_array_equal(a.data, b.data)


def test_aggregate_text_matches_jax(inputs, tmp_path):
    port, jax = _both_files(tmp_path, [
        "aggregate", "-i", inputs["two"], "-O", "u", "-x", "8", "-y", "8",
        "-c", "1"], ".txt")
    assert _text(port) == _text(jax) and _text(port).count("\n") == 8


@pytest.mark.parametrize("bins", [10, 3])
def test_stats_matches_jax(inputs, capsys, bins):
    port, jax = _both(capsys, ["stats", "-i", inputs["two"], "-b",
                               str(bins)])
    assert port == jax and "contig" in port


@pytest.mark.parametrize("flags", [["-b", "20", "-w", "100000"],
                                   ["--positional", "-I", "CONTIG"]],
                         ids=["binned", "positional"])
def test_decay_matches_jax(inputs, capsys, flags):
    flags = [inputs["contig"] if f == "CONTIG" else f for f in flags]
    port, jax = _both(capsys, ["decay", "-i", inputs["two"], *flags])
    assert port == jax and len(port.splitlines()) > 2


@pytest.mark.parametrize("flags", [[], ["-m"], ["-n"]],
                         ids=["fasta", "matrix", "numeric"])
def test_haplotype_matches_jax(inputs, tmp_path, flags):
    region = f"{inputs['contig']}:1-{inputs['pos'] + 50_000}"
    port, jax = _both_files(tmp_path, ["haplotype", "-i", inputs["twk"],
                                       "-I", region, *flags], ".txt")
    assert _text(port) == _text(jax) and len(_text(port)) > 0


@pytest.mark.parametrize("flags", [[], ["-I", "CONTIG"]],
                         ids=["all", "interval"])
def test_relationship_matches_jax(inputs, tmp_path, flags):
    flags = [inputs["contig"] if f == "CONTIG" else f for f in flags]
    paths = []
    for tag, main, extra in (("port", cli.main, ["--device", "cpu"]),
                             ("jax", jcli.main, [])):
        paths.append(str(tmp_path / f"{tag}.txt"))
        assert main(["relationship", "-i", inputs["twk"], "-o", paths[-1],
                     *flags, *extra]) in (0, None)
    port, jax = map(_text, paths)
    assert port == jax and port.count("\n") == 36


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("block_rows", [512, 20])
def test_relationship_kin_bit_equal(inputs, monkeypatch, backend,
                                    block_rows):
    """The port's CPU route gives the JAX function's kinship bit for bit,
    on either JAX route; blocks of 20 rows leave a partial last block.

    The JAX device route hands its jitted accumulation the host block
    buffer it refills for the next block, and on the CPU that array may
    alias the buffer (zero-copy) while the call is still queued (async
    dispatch): where the buffer happens to be aligned, a block is read
    after it was overwritten (ROADMAP.md queue 3, R6). So the JAX route
    is given a fresh copy of each block here."""
    import jax.numpy as jnp
    real = jnp.asarray
    monkeypatch.setattr(jnp, "asarray",
                        lambda a, *k, **kw: real(np.array(a), *k, **kw))
    _build.reset_counts()
    got = relationship(inputs["twk"], block_rows=block_rows,
                       out_stream=io.StringIO(), device="cpu")
    want = jrelationship(inputs["twk"], block_rows=block_rows,
                         out_stream=io.StringIO(), backend=backend)
    assert got.shape == want.shape == (36, 36)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert _build.PLAIN_CALLS[_build.KINSHIP] > 0
    assert _build.LAUNCHES[_build.KINSHIP] == 0


@pytest.mark.parametrize("rows,n", [(512, 2504), (5, 13), (17, 40), (8, 1)])
def test_gram_accumulate_matches_integer_product(rows, n):
    """The wrapper's padding (rows to a multiple of 8, samples to a
    multiple of 8 above 16) adds nothing: two blocks accumulated equal
    the integer product of the stacked blocks."""
    rng = np.random.default_rng(rows * 7 + n)
    blocks = [rng.integers(-1, 2, (rows, n)).astype(np.int8)
              for _ in range(2)]
    kin = kinship.new_accumulator(n, "cpu")
    side = kinship.padded_samples(n)
    assert kin.shape == (side, side) and side % 8 == 0 and side > 16
    for b in blocks:
        g = kinship.block_to_device(b, "cpu")
        assert g.shape[0] % 8 == 0 and g.dtype == torch.int8
        kin = kinship.gram_accumulate(kin, g)
    g = np.concatenate(blocks).astype(np.int64)
    np.testing.assert_array_equal(kinship.to_host(kin, n), g.T @ g)


def test_relationship_cuda_needs_a_card(inputs):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        relationship(inputs["twk"], out_stream=io.StringIO())


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
def test_gram_accumulate_on_card_matches_plain():
    rng = np.random.default_rng(3)
    b = rng.integers(-1, 2, (512, 2504)).astype(np.int8)
    kin = kinship.new_accumulator(2504, "cuda")
    kin = kinship.gram_accumulate(kin, kinship.block_to_device(b, "cuda"))
    plain = kinship.gram_plain(kinship.new_accumulator(2504, "cpu"),
                               kinship.block_to_device(b, "cpu"))
    assert torch.equal(kin.cpu(), plain)
