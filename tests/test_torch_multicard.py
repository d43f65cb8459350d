"""The port's `calc` over several devices and ranks: the device
collectives' backend decided from the layout of cards (by UUID, so ranks
started with `CUDA_VISIBLE_DEVICES=k` each, all on `cuda:0`, are told
apart); the row groups of a `dcn:P` mesh, made in every layout, each
pairs shard reducing over its own row's group (two gloo ranks on the
CPU, a spy on `torch.distributed.all_reduce`, records against the JAX
package's `compute_ld`); four gloo ranks with `--mesh dcn` and the tile
partition plus `merge_shards`; and `all_reduce_parts` on a row's tensor
with the process group stubbed. The same paths run over NCCL between
distinct H100s in `python3 chip_smoke.py multi`.

Run as a script this file is one rank of the spied run:
`python test_torch_multicard.py <out.json> <calc argv...>`.
"""

import json
import os
import sys
import types

import pytest
import torch

# first: binds libzstd where the zstandard package is missing
import tomahawk_tpu_torch  # noqa: F401
from tomahawk_tpu_torch.ops import _build
from tomahawk_tpu_torch.parallel import distributed as dist
from tomahawk_tpu_torch.parallel.mesh import SamplesGroup


def _layout(*ranks):
    """A layout of ranks on one host: each rank a list of (device name,
    card id) rows."""
    return [("host", list(rows)) for rows in ranks]


# -- (a) the backend from the layout ----------
@pytest.mark.parametrize("layout,want", [
    pytest.param(_layout([("cuda:0", "GPU-a")], [("cuda:1", "GPU-b")]),
                 "nccl", id="distinct-uuids"),
    pytest.param(_layout([("cuda:0", "GPU-a")], [("cuda:0", "GPU-a")]),
                 "gloo", id="shared-uuid"),
    pytest.param(_layout(*[[("cuda:0", f"GPU-{k}")] for k in range(4)]),
                 "nccl", id="cuda-visible-devices-per-rank"),
    pytest.param(_layout([("cuda:0", "GPU-a")], [("cpu", "cpu")]),
                 "gloo", id="a-cpu-rank"),
    pytest.param(_layout([("cpu", "cpu")], [("cpu", "cpu")]),
                 "gloo", id="cpu-ranks"),
    pytest.param(_layout([("cuda:0", "GPU-a"), ("cuda:1", "GPU-b")],
                         [("cuda:2", "GPU-c"), ("cuda:3", "GPU-d")]),
                 "nccl", id="dcn2-cards-of-their-own"),
    pytest.param(_layout([("cuda:0", "GPU-a"), ("cuda:1", "GPU-b")],
                         [("cuda:0", "GPU-a"), ("cuda:1", "GPU-b")]),
                 "gloo", id="dcn2-shared-cards"),
    pytest.param(_layout([("cuda:0", "GPU-a"), ("cuda:1", "GPU-b")],
                         [("cuda:2", "GPU-c"), ("cuda:0", "GPU-a")]),
                 "gloo", id="dcn2-a-card-in-two-rows"),
    pytest.param(_layout([("cuda:0", "GPU-a")]), "gloo", id="one-rank"),
])
def test_device_backend_from_layout(layout, want):
    assert dist.device_backend(layout) == want


def test_device_backend_tells_hosts_apart():
    """Two hosts whose cards report one id are two cards."""
    layout = [("a", [("cuda:0", "GPU-x")]), ("b", [("cuda:0", "GPU-x")])]
    assert dist.device_backend(layout) == "nccl"


def test_card_id_of_the_cpu():
    assert dist.card_id("cpu") == "cpu"
    assert dist.card_id(torch.device("cpu")) == "cpu"


# -- (d) all_reduce_parts on a row's tensor, the group stubbed ----------
def _stub_group(monkeypatch, backend="nccl"):
    """A rank of a dcn:2 run on cards 2 and 3 (rows 0 and 1), its groups
    stand-ins; torch.distributed.all_reduce records (tensor, group)."""
    import torch.distributed as tdist
    calls = []
    monkeypatch.setattr(tdist, "all_reduce", lambda t, op=None, group=None:
                        calls.append((t, group)))
    rows = [dist.ProcessGroup(1, 2, torch.device("cuda", c), backend,
                              f"row{p}", "host")
            for p, c in enumerate((2, 3))]
    grp = dist.ProcessGroup(1, 2, rows[0].device, backend, None, "host",
                            rows)
    return grp, calls


def _on(card):
    """A stand-in for an i32 parts tensor on `card` (no card here)."""
    return types.SimpleNamespace(device=torch.device("cuda", card),
                                 is_cuda=True)


def test_all_reduce_parts_reduces_a_rows_tensor_over_its_group(monkeypatch):
    """A tensor on the rank's second card, which is not its first, is
    reduced over row 1's group (it was refused under NCCL); row 0's over
    row 0's."""
    grp, calls = _stub_group(monkeypatch)
    on3, on2 = _on(3), _on(2)
    dist.all_reduce_parts(on3, grp.rows[1])
    dist.all_reduce_parts(on2, grp.rows[0])
    assert [(t, g) for t, g in calls] == [(on3, "row1"), (on2, "row0")]


def test_all_reduce_parts_refuses_the_group_and_a_card_off_the_row(
        monkeypatch):
    """The run's group, which has rows and no device group of its own,
    raises, whichever card the tensor is on; under NCCL a tensor on
    another card than the row's raises; nothing is reduced."""
    grp, calls = _stub_group(monkeypatch)
    for card in (2, 3):
        with pytest.raises(ValueError, match="a row of the process group"):
            dist.all_reduce_parts(_on(card), grp)
    with pytest.raises(ValueError, match="the row's card"):
        dist.all_reduce_parts(_on(3), grp.rows[0])
    assert calls == []


def test_all_reduce_parts_cpu_rows(monkeypatch):
    """On the CPU (gloo) every row's card is the CPU: each row reduces
    over its own group."""
    import torch.distributed as tdist
    calls = []
    monkeypatch.setattr(tdist, "all_reduce", lambda t, op=None, group=None:
                        calls.append(group))
    cpu = torch.device("cpu")
    rows = [dist.ProcessGroup(0, 2, cpu, "gloo", f"row{p}", "host")
            for p in range(2)]
    x = torch.zeros(2, 3, 3, dtype=torch.int32)
    dist.all_reduce_parts(x, rows[1])
    dist.all_reduce_parts(x, rows[0])
    assert calls == ["row1", "row0"]


def test_dcn_mesh_column_is_the_rows_cards(monkeypatch):
    """A dcn mesh's column on this rank is its rows' cards; one whose
    column is not raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    rows = [dist.ProcessGroup(1, 2, torch.device("cuda", c), "nccl",
                              f"row{p}", "host") for p, c in enumerate((2, 3))]
    grp = dist.ProcessGroup(1, 2, rows[0].device, "nccl", None, "host",
                            rows)
    monkeypatch.setattr(dist, "_group", grp)
    mesh = dist.make_dcn_mesh("dcn:2", "cuda")
    assert list(mesh.devices[:, 1]) == [r.device for r in rows]
    assert list(mesh.devices[:, 0]) == [torch.device("cuda", 0),
                                        torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="row groups"):
        dist.make_dcn_mesh("dcn", "cuda")


def test_launches_by_card_tally():
    """A launch counted with its card lands in LAUNCHES and in
    LAUNCHES_BY_CARD; a plain call or a launch without a card only in
    its own counts; reset_counts clears both."""
    _build.reset_counts()
    try:
        _build.count(_build.LAUNCHES, "compact", 3, torch.device("cuda", 1))
        _build.count(_build.LAUNCHES, "compact", device="cuda:2")
        _build.count(_build.LAUNCHES, "local_parts", device="cuda:1")
        _build.count(_build.LAUNCHES, "tile_epilogue")
        _build.count(_build.PLAIN_CALLS, "compact", device="cpu")
        assert _build.LAUNCHES["compact"] == 4
        assert _build.LAUNCHES["tile_epilogue"] == 1
        assert _build.LAUNCHES_BY_CARD == {
            "cuda:1": {"compact": 3, "local_parts": 1},
            "cuda:2": {"compact": 1}}
    finally:
        _build.reset_counts()
    assert _build.LAUNCHES_BY_CARD == {}


def test_samples_group_timing_off_the_card():
    """On the CPU the peers are added in place and no event is recorded,
    even with the timing list set."""
    parts = torch.ones((1, 2, 2), dtype=torch.int32)
    peers = [({}, (None, torch.full((1, 2, 2), k, dtype=torch.int32)))
             for k in (2, 3)]
    SamplesGroup.timing = []
    try:
        SamplesGroup(peers).all_reduce_parts(parts)
        assert SamplesGroup.timing == []
    finally:
        SamplesGroup.timing = None
    assert torch.equal(parts, torch.full((1, 2, 2), 6, dtype=torch.int32))


# -- multi's card-by-card checks (chip_smoke.py) ----------
@pytest.mark.parametrize("P,S,want", [
    (4, 1, {c: ("phased_tile", "compact") for c in range(4)}),
    (2, 2, {0: ("local_parts", "tile_epilogue", "compact"),
            1: ("local_parts",),
            2: ("local_parts", "tile_epilogue", "compact"),
            3: ("local_parts",)}),
    (1, 4, {0: ("local_parts", "tile_epilogue", "compact"),
            **{c: ("local_parts",) for c in (1, 2, 3)}})],
    ids=["4x1", "2x2", "1x4"])
def test_multi_cards_of_a_mesh(P, S, want):
    """The kernels `multi` requires of each card of a local mesh: the
    fused kernels and compact on every pairs shard's card at S = 1;
    local_parts on every card and the epilogue and compact on each
    row's first card at S > 1 (row-major cards, as make_mesh lays
    them)."""
    import chip_smoke
    assert chip_smoke._local_cards(("phased_tile",), P, S) == want


def test_multi_check_cards():
    """A card that missed a kernel, launched one its place does not
    hold, or is outside the mesh and launched anything fails the run;
    launches by card add up."""
    import chip_smoke
    need = {0: ("local_parts", "compact"), 1: ("local_parts",)}
    idle = ("phased_tile",)
    ok = {0: {"local_parts": 3, "compact": 3, "fisher_bracket": 1},
          1: {"local_parts": 3}}
    chip_smoke._check_cards("ok", ok, need, idle)
    for bad in ({0: {"local_parts": 3}, 1: {"local_parts": 3}},
                {**ok, 1: {"local_parts": 3, "phased_tile": 1}},
                {**ok, 2: {"compact": 1}}):
        with pytest.raises(SystemExit):
            chip_smoke._check_cards("bad", bad, need, idle)
    tally = {}
    chip_smoke._add_cards(tally, ok)
    chip_smoke._add_cards(tally, {1: {"local_parts": 2, "compact": 1}})
    chip_smoke._add_cards(None, ok)
    assert tally == {0: {"local_parts": 3, "compact": 3, "fisher_bracket": 1},
                     1: {"local_parts": 5, "compact": 1}}


@pytest.mark.parametrize("P,S,by_card,want", [
    # a's 10 tiles at 4,096 rows on 4x1: every card runs the Fisher
    # launch, only card 0 a tile (14 launches with the repairs)
    (4, 1, {0: {"phased_tile": 14, "compact": 14, "fisher_bracket": 1},
            **{c: {"phased_tile": 0, "compact": 0, "fisher_bracket": 1}
               for c in (1, 2, 3)}}, ([14, 0, 0, 0], [1, 2, 3])),
    # 2x2 -M 0.03: card 2, row 1's first, runs only the Fisher launch
    (2, 2, {0: {"local_parts": 11, "tile_epilogue": 11, "compact": 11},
            1: {"local_parts": 11}, 2: {"fisher_bracket": 10}},
     ([11, 0], [2, 3])),
    (2, 2, {c: {"local_parts": 5, "tile_epilogue": 5} for c in range(4)},
     ([5, 5], [])),
    (2, 1, {0: {"parts_tile": 2, "phased_tile": 1}, 1: {"parts_tile": 3}},
     ([3, 3], []))],
    ids=["4x1-one-shard", "2x2-one-row", "2x2-both-rows", "2x1-mixed"])
def test_multi_shard_work(P, S, by_card, want):
    """multi_idle's tile launches a pairs shard and the cards of shards
    that ran no tile, from launches by card (the first two: what four
    H100s measured)."""
    import chip_smoke
    assert chip_smoke._shard_work(by_card, P, S) == want


def test_multi_kernel_check_on_the_cpu(monkeypatch, capsys):
    """`multi`'s check of every wrapper against its plain version runs
    its whole course on a CPU device at 64 rows a tile (where each
    wrapper takes its plain version, so this holds the check's own code,
    not a kernel), the Fisher gate lowered so the grouped planes' 10
    tiles open it; nothing counts as a launch."""
    import chip_smoke
    from tomahawk_tpu_torch.compute import sweeps
    monkeypatch.setattr(sweeps, "FISHER_MIN_ROWS", 256)
    _build.reset_counts()
    try:
        chip_smoke.hold_kernels_on("cpu", 64)
        assert not any(_build.LAUNCHES.values())
        assert _build.LAUNCHES_BY_CARD == {}
    finally:
        _build.reset_counts()
    assert "equal to their plain versions" in capsys.readouterr().out


# -- (b), (c) ranks on the CPU against the JAX package ----------
jax = pytest.importorskip("jax")

from tomahawk_tpu.io.importer import ImportSettings, import_vcf  # noqa: E402

from test_importer import make_vcf  # noqa: E402
from test_torch_dist import (CLI_FLAGS, _jax_single, _free_port,  # noqa: E402
                             assert_ranks_ok, run_ranks)
from test_torch_engine import _assert_same, _sorted  # noqa: E402

#: 70 samples x 160 sites in blocks of 16: 10 super-blocks, 55 tiles, so
#: a segment of 32 tiles (the quantum of 16 a pairs shard at P = 2) puts
#: live tiles on both pairs shards
WIDE = dict(n_samples=70, n_sites=160, seed=5, miss_frac=0.04,
            contigs=("20",))
#: the JAX package's multi-process inputs (test_torch_dist.INPUTS)
S32 = dict(n_samples=32, n_sites=120, seed=21, miss_frac=0.03,
           contigs=("20", "21"))


def _archive(d, name, args):
    vcf, twk = str(d / f"{name}.vcf"), str(d / f"{name}.twk")
    make_vcf(vcf, **args)
    import_vcf(ImportSettings(input=vcf, output=twk, block_size=16))
    return twk


def _argv(n, rank, port, twk, out, mode, extra):
    return ["calc", "-i", twk, "-o", out, "-r", "0", "-P", "1",
            "--tile-rows", "16", "--device", "cpu", "--distributed",
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
            "--process-id", str(rank), *CLI_FLAGS[mode], *extra]


def spy_rank(out_path, argv):
    """One rank of the spied run: the port's CLI with every
    `torch.distributed.all_reduce` recorded by its group, and the ids of
    the rows' and the host's groups read as the run shuts its group down;
    the counts by row go to `out_path` as JSON."""
    import torch.distributed as tdist
    from tomahawk_tpu_torch import cli
    calls = []
    real_reduce, real_shutdown = tdist.all_reduce, dist.shutdown
    groups = {}

    def reduce(tensor, *a, group=None, **kw):
        calls.append((id(group), tuple(tensor.shape)))
        return real_reduce(tensor, *a, group=group, **kw)

    def shutdown():
        g = dist._group
        if g is not None:
            groups["rows"] = [id(r.device_group) for r in g.rows]
            groups["host"] = id(g.host_group)
            groups["device"] = g.device_group
        real_shutdown()

    tdist.all_reduce, dist.shutdown = reduce, shutdown
    rc = cli.main(argv)
    rows = groups["rows"]
    out = dict(rc=rc, rows=[sum(g == r for g, _ in calls) for r in rows],
               host=sum(g == groups["host"] for g, _ in calls),
               other=sum(g not in rows and g != groups["host"]
                         for g, _ in calls),
               shapes=sorted({s for _, s in calls}),
               no_device_group=groups["device"] is None)
    with open(out_path, "w") as fh:
        json.dump(out, fh)


@pytest.mark.parametrize("mode", ["phased", "mixed"])
def test_dcn2_rows_reduce_over_their_own_groups(tmp_path, monkeypatch, mode):
    """`calc --distributed --mesh dcn:2` as two gloo ranks on the CPU:
    each rank makes two row groups besides the host group (the run's
    group has no device group of its own), every parts
    reduction of the run goes to a row's group (both rows reduce, none
    goes to the host group), and rank 0's one output equals the JAX
    package's single-process `compute_ld` in every field."""
    twk = _archive(tmp_path, "wide", WIDE)
    want = _jax_single(twk, str(tmp_path / "single.two"), mode, monkeypatch)
    out = str(tmp_path / "dcn.two")
    port = _free_port()
    spies = [str(tmp_path / f"spy{r}.json") for r in (0, 1)]
    results = run_ranks([[sys.executable, os.path.abspath(__file__),
                          spies[r], *_argv(2, r, port, twk, out, mode,
                                           ["--mesh", "dcn:2"])]
                         for r in (0, 1)])
    assert_ranks_ok(results)
    for _, text in results:
        assert "device collectives over gloo in 2 row group(s)" in text
        assert "Device mesh: {'pairs': 2, 'samples': 2}" in text
    seen = []
    for path in spies:
        with open(path) as fh:
            spy = json.load(fh)
        assert spy["rc"] == 0 and spy["no_device_group"]
        assert spy["host"] == 0 and spy["other"] == 0
        assert len(spy["rows"]) == 2 and min(spy["rows"]) > 0
        assert all(len(s) == 3 and s[1:] == [128, 128] for s in spy["shapes"])
        seen.append(spy["rows"])
    assert seen[0] == seen[1]        # the ranks' collectives line up
    assert not os.path.exists(str(tmp_path / "dcn.p0of2.two"))
    _assert_same(_sorted(out), want)


def test_four_ranks_dcn_and_tile_partition(tmp_path, monkeypatch):
    """Four gloo ranks on the CPU, the mixed dispatch: `--mesh dcn` (each
    rank a quarter of every word plane, rank 0 writes the one output)
    and the tile partition (four shards, then `merge_shards`), each equal
    to the JAX package's single-process `compute_ld` in every field."""
    twk = _archive(tmp_path, "s32", S32)
    want = _jax_single(twk, str(tmp_path / "single.two"), "mixed",
                       monkeypatch)
    out = str(tmp_path / "dcn.two")
    port = _free_port()
    cmd = [sys.executable, "-m", "tomahawk_tpu_torch"]
    results = run_ranks([cmd + _argv(4, r, port, twk, out, "mixed",
                                     ["--mesh", "dcn"]) for r in range(4)])
    assert_ranks_ok(results)
    assert all("device collectives over gloo in 1 row group(s)" in t
               for _, t in results)
    assert not os.path.exists(str(tmp_path / "dcn.p0of4.two"))
    _assert_same(_sorted(out), want)
    base = str(tmp_path / "part")
    port = _free_port()
    assert_ranks_ok(run_ranks([cmd + _argv(4, r, port, twk, base, "mixed",
                                           []) for r in range(4)]))
    shards = dist.shard_paths(base + ".two", 4)
    assert all(os.path.exists(s) for s in shards)
    merged = str(tmp_path / "merged.two")
    assert dist.merge_shards(shards, merged) == len(want)
    _assert_same(_sorted(merged), want)


if __name__ == "__main__":
    spy_rank(sys.argv[1], sys.argv[2:])
