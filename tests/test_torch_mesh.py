"""The port's device meshes against the JAX package's (CPU only): the
engine under ('pairs', 'samples') meshes of 8x1, 4x2 and 2x4 repeated
`cpu` devices against the JAX engine under `make_mesh` over the 8
virtual CPU devices of tests/conftest.py and against the port's
`mesh=None`, in the phased, unphased and mixed dispatch; banded
streaming with the staging worker on a mesh; `calc` under a mesh spec
and a checkpointed mesh run (its segments counted with the quantum 16 a
pairs shard, as the JAX engine counts them); the mesh resolution
(`resolve_mesh`, the placement under --distributed, `make_mesh`'s
check). Records must be equal in every field (host Fisher on both
sides, so P too; the contract's guard would be 1e-5)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from tomahawk_tpu.compute import engine as jax_engine
from tomahawk_tpu.compute.engine import CalcSettings
from tomahawk_tpu.compute.engine import LdEngine as JaxLdEngine
from tomahawk_tpu.compute.engine import compute_ld as jax_compute_ld
from tomahawk_tpu.compute.engine import dispatch_pairs as jax_dispatch
from tomahawk_tpu.ops.ld_math import LdFilters
from tomahawk_tpu.parallel.mesh import make_mesh as jax_make_mesh

from tomahawk_tpu_torch.compute import resume as port_resume
from tomahawk_tpu_torch.compute.engine import (LdEngine, compute_ld,
                                               dispatch_pairs)
from tomahawk_tpu_torch.ops import _build
from tomahawk_tpu_torch.parallel import distributed as dist
from tomahawk_tpu_torch.parallel.mesh import Mesh, SamplesGroup, make_mesh

from conftest import cpu_devices
from test_torch_engine import _assert_same, _sorted, archive  # noqa: F401
from test_torch_groups import group_planes

N_SAMPLES = 96
MIN_R2 = 0.05
#: tiles of 16 rows over 8 blocks: 36 tiles, so every pairs axis up to 8
#: has shards with tiles and shards with dead padding only
NB, B = 8, 16
SHAPES = [(8, 1), (4, 2), (2, 4)]
SHAPE_IDS = ["8x1", "4x2", "2x4"]
MODES = ["phased", "unphased", "mixed"]


@pytest.fixture(autouse=True)
def _host_fisher(monkeypatch):
    monkeypatch.setenv("TWK_DEVICE_FISHER", "0")


def _planes(seed=4, miss_frac=0.05):
    return group_planes(seed, NB, B, N_SAMPLES, miss_frac=miss_frac)


def _run(engine, stacked, mode):
    """The records of every tile of `stacked` through `dispatch_pairs`,
    in emission order."""
    filt = LdFilters(min_r2=MIN_R2)
    pairs = [(i, j, i == j) for i in range(NB) for j in range(i, NB)]
    got = []
    try:
        n = dispatch_pairs(engine, pairs, mode, filt,
                           lambda recs, rev=None: got.append(recs.copy()),
                           stacked) \
            if isinstance(engine, LdEngine) else \
            jax_dispatch(engine, pairs, mode, filt,
                         lambda recs, rev=None: got.append(recs.copy()),
                         stacked)
    finally:
        engine.stage_close()
    return n, np.concatenate(got)


def _srt(recs):
    return np.sort(recs, order=list(recs.dtype.names))


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("mode", MODES)
def test_engine_under_mesh_matches_jax(mode, shape):
    """The port's engine on a P x S mesh of `cpu` entries gives the
    records of its mesh=None run in the same order (pairs shards read in
    shard order) and the JAX engine's records under the same mesh shape
    over the virtual CPU devices; every shard's sweep took the plain
    versions, the samples-sharded ones through local_parts and the
    epilogue."""
    P, S = shape
    devs = cpu_devices()
    if len(devs) < P * S:
        pytest.skip(f"need {P * S} virtual cpu devices")
    stacked = _planes()
    settings = CalcSettings(min_r2=MIN_R2)
    n_ref, ref = _run(LdEngine(stacked, N_SAMPLES, settings, "cpu"),
                      stacked, mode)
    _build.reset_counts()
    mesh = make_mesh(P, S, ["cpu"] * (P * S))
    engine = LdEngine(stacked, N_SAMPLES, settings, mesh=mesh)
    assert engine._segment_size(36) == 16 * P
    n, got = _run(engine, stacked, mode)
    assert n == n_ref and len(got) == len(ref) > 0
    for f in ref.dtype.names:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    if S > 1:
        assert _build.PLAIN_CALLS["local_parts"] > 0
        assert _build.PLAIN_CALLS["tile_epilogue"] > 0
    assert sum(_build.LAUNCHES.values()) == 0
    n_jax, want = _run(JaxLdEngine(stacked, N_SAMPLES, settings,
                                   mesh=jax_make_mesh(P, S,
                                                      devs[:P * S])),
                       stacked, mode)
    assert n == n_jax
    _assert_same(_srt(got), _srt(want))


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_banded_staging_on_mesh(shape):
    """Banded streaming with the staging worker on a mesh (the JAX
    package's test_banded_staging_prefetch_on_mesh): the worker's
    uploads to every position, word planes cut on the samples axis, give
    the records of the JAX engine's all-resident run on the same mesh
    shape."""
    P, S = shape
    stacked = _planes(seed=17, miss_frac=0.03)
    n_ref, ref = _run(JaxLdEngine(
        stacked, N_SAMPLES, CalcSettings(min_r2=MIN_R2),
        mesh=jax_make_mesh(P, S, cpu_devices()[:P * S])), stacked, "mixed")
    bands = [(0, 3), (3, 6), (6, 8)]

    def band(b):
        lo, hi = bands[b]
        return {k: v[lo:hi] for k, v in stacked.items()}

    engine = LdEngine(None, N_SAMPLES, CalcSettings(min_r2=MIN_R2), B=B,
                      mesh=make_mesh(P, S, ["cpu"] * (P * S)))
    filt = LdFilters(min_r2=MIN_R2)
    loads = [(p, q) for p in range(3) for q in range(p, 3)]
    got, n = [], 0
    try:
        for li, (p, q) in enumerate(loads):
            engine.stage_wait()
            resident = engine.bands.resident()
            load = [(p, None if p in resident else band(p))]
            if q != p:
                load.append((q, None if q in resident else band(q)))
            engine.set_load(load, limit=3)
            if li + 1 < len(loads):
                for b in set(loads[li + 1]):
                    engine.stage_band_async(b, lambda b=b: band(b))
            width = bands[p][1] - bands[p][0]
            tiles = [(i - bands[p][0],
                      j - bands[q][0] + (0 if q == p else width), i == j)
                     for i in range(*bands[p]) for j in range(*bands[q])
                     if q != p or j >= i]
            n += dispatch_pairs(engine, tiles, "mixed", filt,
                                lambda r, rev=None: got.append(r.copy()),
                                engine.stacked)
    finally:
        engine.stage_close()
    assert engine.stage_stats["n_prefetched"] > 0
    # a word plane on a samples slice holds its share of the words
    alt = engine.bands._dev[("alt_bits", 0)]
    assert len(alt) == P * S and alt[0].shape[-1] == \
        -(-stacked["alt_bits"].shape[-1] // S)
    assert n == n_ref
    _assert_same(_srt(np.concatenate(got)), _srt(ref))


@pytest.mark.parametrize("spec", ["cpu:4x1", "cpu:1x2", "cpu:2x2"])
def test_calc_mesh_spec_matches_jax(archive, tmp_path, spec):
    """`calc --mesh <spec>` through compute_ld: the JAX engine's records
    under the same spec, and the port's without a mesh."""
    got = []
    for tag, run in (("port", compute_ld), ("none", compute_ld),
                     ("jax", jax_compute_ld)):
        out = str(tmp_path / f"{tag}.two")
        settings = CalcSettings(input=archive, output=out, min_r2=MIN_R2,
                                tile_rows=128,
                                mesh="off" if tag == "none" else spec)
        if tag == "jax":
            run(dataclasses.replace(settings, backend="device"))
        else:
            run(settings, device="cpu")
        got.append(_sorted(out))
    _assert_same(got[0], got[1])
    _assert_same(got[0], got[2])


def test_calc_explicit_mesh(archive, tmp_path, capsys):
    """compute_ld(mesh=Mesh) over an explicit list that repeats a device
    (how the card's smoke run meshes one card) equals the run without."""
    out, ref = str(tmp_path / "m.two"), str(tmp_path / "r.two")
    kw = dict(input=archive, min_r2=MIN_R2, tile_rows=128)
    compute_ld(CalcSettings(output=ref, **kw), device="cpu")
    compute_ld(CalcSettings(output=out, **kw), device="cpu",
               mesh=make_mesh(2, 2, ["cpu"] * 4))
    assert "Device mesh: {'pairs': 2, 'samples': 2}" in capsys.readouterr().err
    _assert_same(_sorted(out), _sorted(ref))
    with pytest.raises(ValueError, match="single-process"):
        compute_ld(CalcSettings(output=out, distributed=True, **kw),
                   device="cpu", mesh=make_mesh(1, 1, ["cpu"]))


def test_checkpointed_mesh_counts_segments_as_jax(archive, tmp_path,
                                                  monkeypatch):
    """A checkpointed run on a 2 x 1 mesh: segments of 16 tiles a pairs
    shard (32), the sidecar written after each, as many as the JAX
    engine writes under the same mesh spec; the key holds the quantum
    (`seg_effective`), so a run with another pairs axis refuses the
    sidecar; the records equal the JAX engine's."""
    kw = dict(input=archive, min_r2=MIN_R2, tile_rows=64,
              checkpoint_interval=0.0, sweep_segment=16, mesh="cpu:2x1")
    writes = {"port": [], "jax": []}
    for mod, tag in ((port_resume, "port"), (jax_engine, "jax")):
        real = mod._ckpt_write
        monkeypatch.setattr(mod, "_ckpt_write",
                            lambda *a, _r=real, _t=tag, **k:
                            writes[_t].append(a[2]) or _r(*a, **k))
    got = []
    for tag, run in (("port", compute_ld), ("jax", jax_compute_ld)):
        out = str(tmp_path / f"{tag}.two")
        settings = CalcSettings(output=out, checkpoint=out + ".ckpt", **kw)
        if tag == "port":
            run(settings, device="cpu")
        else:
            run(dataclasses.replace(settings, backend="device"))
        assert not os.path.exists(out + ".ckpt")
        got.append(_sorted(out))
    assert writes["port"] == writes["jax"] == [1, 2]
    _assert_same(*got)
    settings = CalcSettings(output=str(tmp_path / "k.two"),
                            checkpoint=str(tmp_path / "k.ckpt"), **kw)
    keys = [port_resume._resume_state(settings, 0, 1, False, p)[1]
            for p in (1, 2)]
    assert keys[1] == port_resume._ckpt_config_key(settings, 32)
    assert keys[0] == port_resume._ckpt_config_key(settings, 16) != keys[1]


def test_samples_group_sums_peers():
    """A SamplesGroup's reduction adds every peer's parts to the row's
    own (the in-process psum), through all_reduce_parts."""
    parts = torch.arange(12, dtype=torch.int32).view(3, 2, 2)
    peers = [({}, (None, torch.full((3, 2, 2), k, dtype=torch.int32)))
             for k in (1, 10)]
    dist.all_reduce_parts(parts, SamplesGroup(peers))
    assert torch.equal(parts, torch.arange(12, dtype=torch.int32)
                       .view(3, 2, 2) + 11)


def test_make_mesh_checks_the_device_count():
    mesh = make_mesh(2, 3, ["cpu"] * 6)
    assert mesh.shape == {"pairs": 2, "samples": 3}
    assert mesh.devices.shape == (2, 3) and mesh.group is None
    assert make_mesh(None, 2, ["cpu"] * 4).shape == {"pairs": 2,
                                                     "samples": 2}
    with pytest.raises(ValueError, match="2 x 2 != 3 devices"):
        make_mesh(2, 2, ["cpu"] * 3)


def _cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


def test_resolve_mesh(monkeypatch):
    """cpu:2x2, auto, off, too few cards, and the placement of a
    distributed run: process k meshes cards k*P*S up to (k+1)*P*S,
    modulo the count; auto is one card a process there."""
    _cards(monkeypatch, 3)
    m = dist.resolve_mesh("cpu:2x2")
    assert m.shape == {"pairs": 2, "samples": 2}
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert dist.resolve_mesh("2x2", device="cpu").shape["samples"] == 2
    assert dist.resolve_mesh("off") is None
    assert dist.resolve_mesh("") is None and dist.resolve_mesh(None) is None
    auto = dist.resolve_mesh("auto")
    assert auto.shape == {"pairs": 3, "samples": 1}
    assert list(auto.devices[:, 0]) == [torch.device("cuda", i)
                                        for i in range(3)]
    assert dist.resolve_mesh("auto", device="cpu") is None
    assert dist.resolve_mesh("auto", local_only=True) is None
    with pytest.raises(ValueError, match="needs 4 cards"):
        dist.resolve_mesh("2x2")
    with pytest.raises(ValueError, match="expected"):
        dist.resolve_mesh("2y2")
    assert list(dist.resolve_mesh("cuda:1x2").devices.flat) == \
        [torch.device("cuda", 0), torch.device("cuda", 1)]
    # placement under --distributed: process 1 of a 2x1 mesh each
    assert list(dist.resolve_mesh("2x1", local_only=True, rank=1)
                .devices.flat) == [torch.device("cuda", 2),
                                   torch.device("cuda", 0)]
    _cards(monkeypatch, 1)
    assert dist.resolve_mesh("auto") is None
    assert dist.resolve_mesh("1x1").shape == {"pairs": 1, "samples": 1}
    assert dist.process_devices("cuda", 5) == [torch.device("cuda", 0)]
    assert not dist.mesh_is_multiprocess(None)
    assert not dist.mesh_is_multiprocess(m)
    assert dist.mesh_is_multiprocess(Mesh(m.devices, group=object()))
    with pytest.raises(ValueError, match="multi-process"):
        dist.resolve_mesh("dcn")


@pytest.mark.parametrize("spec,rank,want", [
    ("off", 3, [3]), ("auto", 4, [4]), ("2x3", 1, [6, 7, 8, 9, 10, 11]),
    ("cuda:1x2", 2, [4, 5]), ("dcn", 1, [1]), ("dcn:2", 1, [2, 3]),
    ("dcn:3", 2, [6, 7, 8]), ("2x2", 3, [12, 13, 14, 15])])
def test_process_devices_one_rule(monkeypatch, spec, rank, want):
    """The one placement rule under --distributed (`process_devices`):
    rank k of a spec that takes n cards gets cards k*n up to (k+1)*n,
    modulo the count; the rendezvous card (the first) and the mesh a
    process builds (`resolve_mesh(local_only=True)`, `make_dcn_mesh`'s
    column k) come from that one list."""
    _cards(monkeypatch, 7)
    got = dist.process_devices("cuda", rank, spec)
    assert got == [torch.device("cuda", i % 7) for i in want]
    if spec.startswith("dcn"):
        monkeypatch.setattr(dist, "_group", dist.ProcessGroup(
            rank, rank + 1, got[0], "gloo", None, None))
        mesh = dist.make_dcn_mesh(spec, "cuda")
        assert list(mesh.devices[:, rank]) == got
    elif spec not in ("off", "auto"):
        mesh = dist.resolve_mesh(spec, local_only=True, rank=rank)
        assert list(mesh.devices.flat) == got
    # an explicit card stands where a process takes one card; the CPU,
    # or a 'cpu:' spec, is n entries of the CPU
    n = len(want)
    assert dist.process_devices("cuda:5", rank, spec)[0] == (
        torch.device("cuda", 5) if n == 1 else got[0])
    cpu = [torch.device("cpu")] * n
    if not spec.startswith("cuda:"):   # else the spec's platform wins
        assert dist.process_devices("cpu", rank, spec) == cpu
    if not spec.startswith("dcn"):
        shape = spec.split(":")[-1]
        assert dist.process_devices("cuda", rank, "cpu:" + shape) == cpu
