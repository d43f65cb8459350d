"""Multi-process `calc` of the port against the JAX package: the
parts-only step of the samples-sharded sweep on word slices against the
TPU kernel it replaces (`tile_parts_pallas`, Pallas interpret mode); the
epilogue on the summed parts against the JAX tile; the samples-sharded
sweeps of two gloo ranks on the CPU against the JAX single-device
sweeps; `calc --distributed --mesh dcn` and `calc --distributed` (tile
partition, then `merge_shards`) in two processes against the JAX
package's single-process `compute_ld`; the shard helpers against their
originals. The CUDA kernels are compared with their plain versions by
the `gpu` tests, which run only where torch sees a card.

Run as a script this file is one rank of the two-rank sweep test:
`python test_torch_dist.py <rank> <port> <out.npz>`.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

# first: binds libzstd where the zstandard package is missing
import tomahawk_tpu_torch  # noqa: F401

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from tomahawk_tpu.compute import sweeps as jsweeps
from tomahawk_tpu.compute.engine import CalcSettings as JaxCalcSettings
from tomahawk_tpu.compute.engine import compute_ld as jax_compute_ld
from tomahawk_tpu.io.importer import ImportSettings, import_vcf
from tomahawk_tpu.io.two import TwoReader
from tomahawk_tpu.ops import pallas_tiles as PT
from tomahawk_tpu.parallel import distributed as jdist

from tomahawk_tpu_torch.compute import sweeps
from tomahawk_tpu_torch.ops import _build, tiles
from tomahawk_tpu_torch.parallel import distributed as dist

from test_importer import make_vcf
from test_torch_engine import _assert_same, _sorted
from test_torch_ld_kernels import jax_dev
from test_torch_sweeps import intact, tile_list
from test_torch_window import ALL_GROUPS, ALL_IDS, window_planes

REPO = pathlib.Path(__file__).resolve().parents[1]
B, N_SAMPLES, MIN_R2 = 128, 100, 0.05
#: the four (table, has_missing) instances of the parts-only kernel
INSTANCES = [("phased", False), ("phased", True), ("unphased", False),
             ("unphased", True)]
INSTANCE_IDS = ["-".join(map(str, x)) for x in INSTANCES]
#: seconds a spawned rank may take before it is killed
RANK_LIMIT = 240


def planes(seed=11, n_blocks=2):
    """B = 128, 100 samples, ~4% of the genotypes of every other row
    missing, positions 50 bp apart."""
    return window_planes(seed, n_blocks, B=B)


def cfg_pair(group, window=0, **kw):
    table, miss, cls = group
    args = (table, miss, cls, B, N_SAMPLES, window, MIN_R2, 100.0)
    return sweeps.make_cfg(*args, **kw), jsweeps.make_cfg(*args)


def jax_word_slice(st, s, S):
    """The planes as the JAX engine cuts them for a 'samples' mesh axis
    of size S (LdEngine._pad_samples_axis, then an even split): the word
    axis padded to a multiple of S with zeros, `miss_bits` with ones,
    and slice s of it."""
    out = dict(st)
    for k in jsweeps.WORD_KEYS:
        v = st[k]
        W = v.shape[-1]
        Wp = -(-W // S) * S
        pad = np.zeros((*v.shape[:-1], Wp - W), v.dtype)
        v = np.concatenate([v, ~pad if k == "miss_bits" else pad], axis=-1)
        out[k] = v[..., s * Wp // S:(s + 1) * Wp // S]
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argvs, limit=RANK_LIMIT):
    """Run one process per argv at once, each with the wall limit, kill
    what is left; [(returncode, output)]."""
    path = os.pathsep.join(filter(None, [str(REPO),
                                         os.environ.get("PYTHONPATH")]))
    env = dict(os.environ, PYTHONPATH=path, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for a in argvs]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=limit)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n[killed at the limit]")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def assert_ranks_ok(results):
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank} exited {rc}:\n{out[-3000:]}"


# -- (1) the parts-only step on word slices ----------
@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("instance", INSTANCES, ids=INSTANCE_IDS)
def test_local_parts_match_pallas_on_word_slices(instance, S):
    """Each slice's parts equal the TPU parts-only kernel's on the same
    slice, and the slices sum to the JAX full-width parts, every lane."""
    st = planes()
    cfg, jcfg = cfg_pair((*instance, "all"))
    keys = sweeps.dev_keys_for(cfg)
    P = sweeps.payload_cols(*instance)
    W = st[tiles.plane_keys(*instance)[0]].shape[-1]
    for i, j in ((0, 0), (0, 1)):
        total = torch.zeros((P, B, B), dtype=torch.int32)
        for s in range(S):
            jst = jax_word_slice(st, s, S)
            dev = sweeps.planes_to_device(st, "cpu", keys, word_slice=(s, S))
            for k in tiles.plane_keys(*instance):
                assert dev[k].shape[-1] == -(-W // S)
                np.testing.assert_array_equal(
                    dev[k].numpy().view(np.uint32), jst[k])
            want = PT.tile_parts_pallas(jax_dev(jst), jnp.int32(i),
                                        jnp.int32(j), jcfg, interpret=True)
            out = tiles.tile_buffers(cfg, "cpu")
            out[0].fill_(7)
            _build.reset_counts()
            got = tiles.tile_local_parts(dev, i, j, cfg, out)
            assert _build.PLAIN_CALLS["local_parts"] == 1
            assert got is out[1] and bool((out[0] == 7).all())
            assert len(want) == P
            for p in range(P):
                np.testing.assert_array_equal(got[p].numpy(),
                                              np.asarray(want[p]))
            total += got
        _, _, full = jsweeps.tile_prefilter(
            jax_dev(st), jnp.int32(i), jnp.int32(j), jnp.asarray(i == j),
            jcfg)
        for p in range(P):
            np.testing.assert_array_equal(total[p].numpy(),
                                          np.asarray(full[p]))
        assert int(total.sum()) > 0


# -- (2) the epilogue on the summed parts ----------
@pytest.mark.parametrize("window", [0, 700])
@pytest.mark.parametrize("group", ALL_GROUPS, ids=ALL_IDS)
def test_epilogue_matches_jax(group, window):
    """mask 0/1/2 from the parts summed over three word slices equals
    the JAX tile's (pf, m) on the XLA path, every lane."""
    st = planes()
    cfg, jcfg = cfg_pair(group, window)
    keys = sweeps.dev_keys_for(cfg)
    S = 3
    devs = [sweeps.planes_to_device(st, "cpu", keys, word_slice=(s, S))
            for s in range(S)]
    seen = set()
    for i, j, diag in ((0, 0, True), (0, 1, False)):
        out = tiles.tile_buffers(cfg, "cpu")
        total = torch.zeros_like(out[1])
        for dev in devs:
            total += tiles.tile_local_parts(dev, i, j, cfg, out)
        out[1].copy_(total)
        _build.reset_counts()
        mask, parts = tiles.tile_epilogue(devs[0], i, j, diag, cfg, out)
        assert _build.PLAIN_CALLS["tile_epilogue"] == 1
        assert mask is out[0] and torch.equal(parts, total)
        pf, m, _ = jsweeps.tile_prefilter(
            jax_dev(st), jnp.int32(i), jnp.int32(j), jnp.asarray(diag), jcfg)
        np.testing.assert_array_equal(mask.numpy() >= 1, np.asarray(m))
        np.testing.assert_array_equal(mask.numpy() == 2, np.asarray(pf))
        seen |= set(np.unique(mask.numpy()).tolist())
    assert {0, 1} <= seen and (group[2] == "clean" or 2 in seen)


# -- (3) two gloo ranks: the samples-sharded sweeps ----------
#: (group, window) of every sweep the two ranks run, in this order
SWEEPS = [(g, 0) for g in ALL_GROUPS] + [(ALL_GROUPS[0], 700),
                                         (ALL_GROUPS[-1], 700)]
SWEEP_IDS = [f"{'-'.join(map(str, g))}-w{w}" for g, w in SWEEPS]
CAP, OUTCAP, N_BLOCKS = 64, 1 << 12, 3


def rank_main(rank: int, port: int, out_path: str):
    """One of two ranks: every sweep of SWEEPS over the word slice
    `rank` of 2, in order; the results go to an .npz file."""
    dist.init_distributed(f"127.0.0.1:{port}", 2, rank, "cpu")
    group = dist.group().rows[0]
    st = planes(n_blocks=N_BLOCKS)
    tl = tile_list(N_BLOCKS)
    res = {}
    # the compactions handed no counts with their mask
    compact, no_counts = sweeps.compact_survivors, []

    def spy(*args, **kwargs):
        counts = args[8] if len(args) > 8 else kwargs.get("counts")
        no_counts.append(counts is None)
        return compact(*args, **kwargs)
    sweeps.compact_survivors = spy
    for n, (grp, window) in enumerate(SWEEPS):
        cfg, _ = cfg_pair(grp, window, psum_group=group)
        dev = sweeps.planes_to_device(st, "cpu", sweeps.dev_keys_for(cfg),
                                      word_slice=(rank, 2))
        c_pass, c_cand = sweeps.count_sweep(dev, *tl, cfg=cfg)
        n_pass, n_cand, buf = sweeps.fused_sweep(dev, *tl, cfg=cfg, cap=CAP,
                                                 outcap=OUTCAP)
        # what the engine's repair does: every tile again at exact offsets
        offs = np.cumsum(n_pass.numpy()) - n_pass.numpy()
        big = int(max(n_pass.max(), 1))
        rbuf = sweeps.extract_sweep(dev, *tl[:3], offs, cfg=cfg, cap=big,
                                    outcap=int(n_pass.sum()) + big)
        for k, v in dict(c_pass=c_pass, c_cand=c_cand, n_pass=n_pass,
                         n_cand=n_cand, buf=buf, rbuf=rbuf).items():
            res[f"{n}_{k}"] = v.numpy()
    for k, v in _build.PLAIN_CALLS.items():
        res[f"plain_{k}"] = np.int64(v)
    res["compact_calls"] = np.int64(len(no_counts))
    res["compact_no_counts"] = np.int64(sum(no_counts))
    dist.sync_shards()
    dist.shutdown()
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def two_rank_sweeps(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dist_sweeps")
    port = _free_port()
    outs = [str(d / f"rank{r}.npz") for r in (0, 1)]
    assert_ranks_ok(run_ranks(
        [[sys.executable, __file__, str(r), str(port), outs[r]]
         for r in (0, 1)]))
    return [dict(np.load(o)) for o in outs]


@pytest.mark.parametrize("n", range(len(SWEEPS)), ids=SWEEP_IDS)
def test_two_rank_sweeps_match_jax(two_rank_sweeps, n):
    """Both ranks' counts and survivor rows equal the JAX single-device
    sweeps' on the full-width planes, and each other's; the epilogue's
    counts reach every compaction, which then counts no mask itself."""
    grp, window = SWEEPS[n]
    _, jcfg = cfg_pair(grp, window)
    jdev = jax_dev(planes(n_blocks=N_BLOCKS))
    tl = tile_list(N_BLOCKS)
    jc_pass, jc_cand = jsweeps.jit_count_sweep(jcfg)(jdev, *tl)
    jn, jnc, jbuf = (np.asarray(x) for x in jsweeps.jit_fused_sweep(
        jcfg, CAP, OUTCAP)(jdev, *tl))
    offs, ok = intact(jn, CAP, OUTCAP)
    assert jn.sum() > 0 or grp[2] == "clean"
    big = int(max(jn.max(), 1))
    jr = np.asarray(jsweeps.jit_extract_sweep(
        jcfg, big, int(jn.sum()) + big)(jdev, *tl[:3],
                                        offs.astype(np.int32)))
    for rank, res in enumerate(two_rank_sweeps):
        get = lambda k: res[f"{n}_{k}"]
        np.testing.assert_array_equal(get("c_pass"), np.asarray(jc_pass))
        np.testing.assert_array_equal(get("c_cand"), np.asarray(jc_cand))
        np.testing.assert_array_equal(get("n_pass"), jn)
        np.testing.assert_array_equal(get("n_cand"), jnc)
        for t in np.flatnonzero(ok & (jn > 0)):
            lo, hi = offs[t], offs[t] + jn[t]
            np.testing.assert_array_equal(get("buf")[lo:hi], jbuf[lo:hi])
        total = int(jn.sum())
        np.testing.assert_array_equal(get("rbuf")[:total], jr[:total])
        # the step ran through the wrappers' plain versions, per tile,
        # and every compaction was handed the epilogue's counts
        assert res["plain_local_parts"] == res["plain_tile_epilogue"] > 0
        assert res["plain_phased_tile"] == res["plain_parts_tile"] == 0
        assert res["plain_compact"] == res["compact_calls"] > 0
        assert res["compact_no_counts"] == 0
    a, b = two_rank_sweeps
    np.testing.assert_array_equal(a[f"{n}_buf"], b[f"{n}_buf"])
    np.testing.assert_array_equal(a[f"{n}_rbuf"], b[f"{n}_rbuf"])


# -- (4) calc in two processes ----------
#: name -> make_vcf arguments (the inputs of the JAX package's
#: multi-process tests)
INPUTS = {
    "s70": dict(n_samples=70, n_sites=96, seed=5, miss_frac=0.04,
                contigs=("20",)),
    "s32": dict(n_samples=32, n_sites=120, seed=21, miss_frac=0.03,
                contigs=("20", "21")),
    "s32-one-tile": dict(n_samples=32, n_sites=12, seed=21, miss_frac=0.03,
                         contigs=("20",)),
}
FLAGS = {"mixed": {}, "phased": dict(force_phased=True),
         "unphased": dict(forced_unphased=True),
         "window": dict(window=True, l_window=5000)}
CLI_FLAGS = {"mixed": [], "phased": ["-p"], "unphased": ["-u"],
             "window": ["-w", "5000"]}


def _archive(d, name):
    vcf, twk = str(d / f"{name}.vcf"), str(d / f"{name}.twk")
    make_vcf(vcf, **INPUTS[name])
    import_vcf(ImportSettings(input=vcf, output=twk, block_size=16))
    return twk


def _jax_single(twk, path, mode, monkeypatch):
    """The JAX package's single-process records (host Fisher, as the
    port computes P)."""
    monkeypatch.setenv("TWK_DEVICE_FISHER", "0")
    jax_compute_ld(JaxCalcSettings(
        input=twk, output=path, min_r2=0.0, min_p=1.0, mesh="off",
        tile_rows=16, backend="device", **FLAGS[mode]))
    return _sorted(path)


def _calc_argv(rank, port, twk, out, mode, extra):
    return [sys.executable, "-m", "tomahawk_tpu_torch", "calc", "-i", twk,
            "-o", out, "-r", "0", "-P", "1", "--tile-rows", "16",
            "--device", "cpu", "--distributed", "--coordinator",
            f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
            str(rank), *CLI_FLAGS[mode], *extra]


@pytest.mark.parametrize("name,mode,mesh", [
    pytest.param("s70", "mixed", "dcn", id="s70-mixed"),
    pytest.param("s70", "phased", "dcn", id="s70-phased"),
    pytest.param("s70", "unphased", "dcn", id="s70-unphased"),
    pytest.param("s32", "window", "dcn", id="s32-window"),
    pytest.param("s32-one-tile", "mixed", "dcn", id="s32-one-tile-mixed"),
    pytest.param("s70", "mixed", "dcn:2", id="s70-mixed-dcn2")])
def test_two_process_dcn_calc_matches_jax(tmp_path, monkeypatch, name, mode,
                                          mesh):
    """`calc --distributed --mesh dcn`: each process holds half of every
    word plane, process 0 writes the one output, which equals the JAX
    package's single-process output in every field. Each process runs
    the host math of its half of every segment's survivor rows
    (`_dcn_records`): the two halves add up to the rows, rank 0's the
    larger by at most one a segment. `dcn:2`: a local pairs axis of two
    shards in each process."""
    twk = _archive(tmp_path, name)
    want = _jax_single(twk, str(tmp_path / "single.two"), mode, monkeypatch)
    out = str(tmp_path / "dcn.two")
    port = _free_port()
    results = run_ranks([_calc_argv(r, port, twk, out, mode,
                                    ["--mesh", mesh]) for r in (0, 1)])
    assert_ranks_ok(results)
    split = []
    for _, text in results:
        assert "device collectives over gloo" in text
        line = next(ln for ln in text.splitlines() if "host math of" in ln)
        mine, rows = (int(x.replace(",", "")) for x in
                      line.split("host math of ")[1].split(" survivor")[0]
                      .split(" of "))
        split.append((mine, rows))
    (a, rows), (b, rows_b) = split
    assert rows == rows_b > 0 and a + b == rows and 0 <= a - b
    assert (a > 0 and b > 0) or rows == 1
    if mesh == "dcn:2":
        assert all("Device mesh: {'pairs': 2, 'samples': 2}" in text
                   for _, text in results)
    assert not os.path.exists(str(tmp_path / "dcn.p0of2.two"))
    _assert_same(_sorted(out), want)
    r = TwoReader(out)
    assert "##tomahawk_tpu_torch_calcVersion" in r.header.literals
    r.close()


@pytest.mark.parametrize("name,sort_shards", [
    ("s32", False), ("s32", True), ("s32-one-tile", False)])
def test_two_process_tile_partition_matches_jax(tmp_path, monkeypatch, name,
                                                sort_shards):
    """`calc --distributed`: each process sweeps its round-robin share
    of the tiles into its own shard; `merge_shards` of the two equals
    the JAX package's single-process output. With one tile, process 1
    has none and still writes a valid empty shard."""
    twk = _archive(tmp_path, name)
    want = _jax_single(twk, str(tmp_path / "single.two"), "mixed",
                       monkeypatch)
    base = str(tmp_path / "dist")
    port = _free_port()
    extra = ["--sort-shards"] if sort_shards else []
    assert_ranks_ok(run_ranks([_calc_argv(r, port, twk, base, "mixed", extra)
                               for r in (0, 1)]))
    shards = dist.shard_paths(base + ".two", 2)
    assert all(os.path.exists(s) for s in shards)
    counts = []
    for s in shards:
        r = TwoReader(s)
        counts.append(len(r.records()))
        assert "##tomahawk_tpu_torch_calcVersion" in r.header.literals
        if sort_shards:
            pos = r.records()[["ridA", "ridB", "packA", "packB"]]
            assert (np.sort(pos, order=list(pos.dtype.names)) == pos).all()
        r.close()
    assert (counts[1] == 0) == (name == "s32-one-tile") and counts[0] > 0
    merged = str(tmp_path / "merged.two")
    n = dist.merge_shards(f"{base}.p*of2.two", merged)   # glob form
    assert n == sum(counts) == len(want)
    _assert_same(_sorted(merged), want)


def test_failed_rank_fails_the_run(tmp_path):
    """A rank that dies after the rendezvous takes the run down: the
    other rank exits non-zero inside its limit and does not hang in a
    collective."""
    twk = _archive(tmp_path, "s70")
    port = _free_port()
    argvs = [_calc_argv(r, port, twk, str(tmp_path / "dcn.two"), "mixed",
                        ["--mesh", "dcn"]) for r in (0, 1)]
    argvs[1][argvs[1].index(twk)] = str(tmp_path / "missing.twk")
    results = run_ranks(argvs, limit=120)
    assert all(rc not in (0, None) for rc, _ in results), results
    assert not any("killed at the limit" in o for _, o in results), results


# -- (5) the shard helpers ----------
@pytest.mark.parametrize("n_procs", [1, 2, 3])
def test_shard_helpers_match_originals(n_procs):
    pairs = [(i, j, i == j) for i in range(5) for j in range(i, 5)]
    for p in range(n_procs):
        assert dist.partition_tiles(pairs, p, n_procs) \
            == jdist.partition_tiles(pairs, p, n_procs)
        for out in ("a/out.two", "out", "x.two.two"):
            assert dist.shard_output_path(out, p, n_procs) \
                == jdist.shard_output_path(out, p, n_procs)
    assert dist.shard_paths("o.two", n_procs) \
        == jdist.shard_paths("o.two", n_procs)
    with pytest.raises(ValueError, match="file output"):
        dist.shard_output_path("-", 0, n_procs)
    with pytest.raises(ValueError, match="no shards"):
        dist.merge_shards([], "x.two")


def test_rendezvous_and_mesh_arguments_checked():
    from tomahawk_tpu_torch.compute.engine import CalcSettings
    from tomahawk_tpu_torch.compute.engine import compute_ld
    with pytest.raises(ValueError, match="--coordinator"):
        dist.init_distributed("", 2, 0, "cpu")
    with pytest.raises(ValueError, match="--process-id"):
        dist.init_distributed("127.0.0.1:1", 2, 2, "cpu")
    with pytest.raises(RuntimeError, match="init_distributed"):
        dist.group()
    with pytest.raises(ValueError, match="multi-process"):
        compute_ld(CalcSettings(input="x.twk", mesh="dcn"), device="cpu")
    with pytest.raises(ValueError, match="multi-process"):
        dist.make_dcn_mesh("dcn", "cpu")
    assert dist.process_devices("cpu", 3) == [torch.device("cpu")]
    assert dist.process_devices("cuda:1", 3) == [torch.device("cuda", 1)]


# -- (6) the kernels on the card ----------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("instance", INSTANCES, ids=INSTANCE_IDS)
def test_local_parts_kernel_matches_plain_on_card(instance, S):
    card = _card()
    st = planes()
    cfg, _ = cfg_pair((*instance, "all"))
    for s in range(S):
        dev = sweeps.planes_to_device(st, card, sweeps.dev_keys_for(cfg),
                                      word_slice=(s, S))
        out = tiles.tile_buffers(cfg, card)
        got = tiles.tile_local_parts(dev, 0, 1, cfg, out)
        want = torch.stack(tiles.tile_local_parts_plain(dev, 0, 1, cfg))
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 700])
@pytest.mark.parametrize("group", ALL_GROUPS, ids=ALL_IDS)
def test_epilogue_kernel_matches_plain_on_card(group, window):
    card = _card()
    cfg, _ = cfg_pair(group, window)
    dev = sweeps.planes_to_device(planes(), card, sweeps.dev_keys_for(cfg))
    for i, j, diag in ((0, 0, True), (0, 1, False)):
        out = tiles.tile_buffers(cfg, card)
        counts = tiles.counts_buffer(cfg, card).fill_(-1)
        tiles.tile_local_parts(dev, i, j, cfg, out)
        mask, parts = tiles.tile_epilogue(dev, i, j, diag, cfg, out, counts)
        assert torch.equal(mask, tiles.tile_epilogue_plain(
            dev, i, j, diag, cfg, parts))
        assert torch.equal(counts, tiles.tile_counts_plain(mask))
        fused = tiles.counts_buffer(cfg, card)
        want_m, want_p = tiles.tile_prefilter(dev, i, j, diag, cfg,
                                              counts=fused)
        assert torch.equal(mask, want_m) and torch.equal(counts, fused)
        on = (want_m != 0).unsqueeze(0)
        assert torch.equal(parts * on, want_p * on)


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
