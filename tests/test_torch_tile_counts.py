"""The per-segment counts a tile hands to the compaction, and the
compaction and sweeps that use them, against the JAX package on the same
numpy planes; and the kernel bounds chip_smoke.py states.

Everything compared here is an integer, and every comparison is exact:
(a) `tile_counts_plain` of the port's mask, and the counts buffer
`tile_prefilter` fills in every sweep group, against the counts of the
fused TPU kernel's mask (Pallas interpret mode); (b) `compact_survivors`
on CPU tensors, with the counts given and without, against the JAX
package's fused sweep over the same tile list, and the compaction's
fault mark (a stale scan ticket) turned into an exception at the host's
read of the counts; (c) `fused_sweep` and `extract_sweep`, which allocate
their buffers once and hand the counts to every tile, against the JAX
sweeps, window tiles included; (d) `chip_smoke._bound`, `_int8_ms`,
`_cuda_core_ms` and `kernel_bounds` against the figures they are meant
to print (bounds are floats computed from integers and two constants:
compared to the 3 decimals they are quoted with), and
`chip_smoke.library_call`, the library yardstick, against the parts. The
CUDA kernels themselves are held against these plain versions by
chip_smoke.py on a card."""

import ctypes
import types

import numpy as np
import pytest
import torch

# first: binds libzstd where the zstandard package is missing
import tomahawk_tpu_torch  # noqa: F401

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from tomahawk_tpu.compute import sweeps as jsweeps
from tomahawk_tpu.ops import pallas_tiles as PT

from tomahawk_tpu_torch.compute import sweeps
from tomahawk_tpu_torch.ops import _build, tiles

import chip_smoke
from test_torch_groups import group_planes
from test_torch_ld_kernels import jax_dev, stacked_planes
from test_torch_sweeps import grouped_planes, intact, tile_list
from test_torch_window import window_planes

N_SAMPLES, MIN_R2 = 100, 0.05


def counts_of(mask, seg):
    """numpy statement of the counts: survivors | candidates << 16 of
    each `seg`-column segment of each row of mask (0 / 1 / 2)."""
    B = mask.shape[0]
    n_seg = -(-B // seg)
    m = np.zeros((B, n_seg * seg), np.uint8)
    m[:, :B] = mask
    m = m.reshape(B, n_seg, seg)
    return ((m == 2).sum(axis=2) | ((m != 0).sum(axis=2) << 16)) \
        .astype(np.int32)


# -- (a) the counts of a tile's mask ----------
@pytest.mark.parametrize("i,j,diag", [(0, 0, True), (0, 1, False)])
@pytest.mark.parametrize("Bt", [128, 192])
@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("cls", ["all", "clean"])
def test_tile_counts_match_pallas_mask(cls, window, Bt, i, j, diag):
    """B = 192 is one and a half segments, and its blocks end in padding
    rows (valid = 0), which count as nothing. The TPU kernel blocks rows
    by 128 and refuses 192, so there the JAX mask comes from the XLA
    tile path, the kernel's own reference."""
    st = window_planes(7, B=Bt)
    args = ("phased", False, cls, Bt, N_SAMPLES, window, MIN_R2, 100.0)
    cfg, jcfg = sweeps.make_cfg(*args), jsweeps.make_cfg(*args)
    dev = sweeps.planes_to_device(st, "cpu", sweeps.dev_keys_for(cfg))
    jargs = (jax_dev(st), jnp.int32(i), jnp.int32(j), jnp.asarray(diag), jcfg)
    if Bt % 128 == 0:
        pf, m, _ = PT.tile_prefilter_pallas(*jargs, interpret=True)
    else:
        pf, m, _ = jsweeps.tile_prefilter(*jargs)
    jmask = np.asarray(m).astype(np.uint8) + np.asarray(pf).astype(np.uint8)
    assert not st["valid"].all() and (jmask != 0).any()
    assert (jmask == 2).any() or (window > 0 and not diag)
    counts = tiles.counts_buffer(cfg, "cpu").fill_(-1)
    assert counts.shape == (Bt, -(-Bt // tiles.SEG))
    mask, _ = tiles.tile_prefilter(dev, i, j, diag, cfg, counts=counts)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    want = counts_of(jmask, tiles.SEG)
    np.testing.assert_array_equal(counts.numpy(), want)
    np.testing.assert_array_equal(tiles.tile_counts_plain(mask).numpy(),
                                  want)
    # another segment width, as a statement of the function alone
    np.testing.assert_array_equal(
        tiles.tile_counts_plain(mask, 48).numpy(), counts_of(jmask, 48))
    total = want.astype(np.int64).sum()
    assert total & 0xFFFF == (jmask == 2).sum()
    assert total >> 16 == (jmask != 0).sum()


#: every sweep group, (table, has_missing, cls)
ALL_GROUPS = [("phased", False, "all"), ("phased", False, "clean"),
              ("phased", True, "all"), ("unphased", False, "all"),
              ("unphased", True, "all"), ("unphased", True, "missing")]
GROUP_IDS = ["-".join(map(str, g)) for g in ALL_GROUPS]


def test_counts_only_from_the_phased_tile_kernel():
    """The counts once came from phased_tile alone; now every fused tile
    kernel (phased_tile and parts_tile) writes them, so every group gets
    a buffer and tile_prefilter takes it, and so does the samples-sharded
    sweep, whose epilogue writes them too. A buffer of the wrong shape
    is refused."""
    st = group_planes(3, 1, 128, 64)
    for group in ALL_GROUPS:
        cfg = sweeps.make_cfg(*group, 128, 64, 0, 0.1, 100.0)
        counts = tiles.counts_buffer(cfg, "cpu")
        assert counts.shape == (128, 1) and counts.dtype == torch.int32
        dev = sweeps.planes_to_device(st, "cpu", sweeps.dev_keys_for(cfg))
        mask, _ = tiles.tile_prefilter(dev, 0, 0, True, cfg,
                                       counts=counts.fill_(-1))
        assert torch.equal(counts, tiles.tile_counts_plain(mask))
        assert sweeps._sweep_buffers(cfg, "cpu")[1] is not None
        sharded = dict(cfg, psum_group=object())
        assert sweeps._sweep_buffers(sharded, "cpu")[1] is not None
        with pytest.raises(ValueError, match="counts"):
            tiles.tile_prefilter(dev, 0, 0, True, cfg, counts=torch.zeros(
                (128, 2), dtype=torch.int32))


@pytest.mark.parametrize("i,j,diag", [(0, 0, True), (0, 1, False)])
@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("group", ALL_GROUPS, ids=GROUP_IDS)
def test_every_fused_group_counts_match_pallas_mask(group, window, i, j,
                                                    diag):
    """tile_prefilter's counts buffer in every sweep group, with and
    without a window, equals the counts of the TPU kernel's mask (Pallas
    interpret mode) on planes with missing genotypes."""
    Bt = 128
    st = window_planes(5, B=Bt)
    args = (*group, Bt, N_SAMPLES, window, MIN_R2, 100.0)
    cfg, jcfg = sweeps.make_cfg(*args), jsweeps.make_cfg(*args)
    dev = sweeps.planes_to_device(st, "cpu", sweeps.dev_keys_for(cfg))
    pf, m, _ = PT.tile_prefilter_pallas(jax_dev(st), jnp.int32(i),
                                        jnp.int32(j), jnp.asarray(diag), jcfg,
                                        interpret=True)
    jmask = np.asarray(m).astype(np.uint8) + np.asarray(pf).astype(np.uint8)
    counts = tiles.counts_buffer(cfg, "cpu").fill_(-1)
    mask, _ = tiles.tile_prefilter(dev, i, j, diag, cfg, counts=counts)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    np.testing.assert_array_equal(counts.numpy(), counts_of(jmask, tiles.SEG))


# -- (b) the compaction with and without counts ----------
COMPACT_GROUPS = [("phased", False, "all"), ("phased", True, "all"),
                  ("unphased", True, "all")]


@pytest.mark.parametrize("with_counts", [True, False],
                         ids=["counts", "no-counts"])
@pytest.mark.parametrize("n_samples", [64, 70_000],
                         ids=["packed", "unpacked"])
@pytest.mark.parametrize("group", COMPACT_GROUPS, ids=["P1", "P4", "P9"])
def test_compact_survivors_matches_jax_fused_sweep(group, n_samples,
                                                   with_counts):
    """Tile by tile through tile_prefilter and compact_survivors, as the
    sweep does: n_pass, n_cand and the running offset equal the JAX fused
    sweep's, and so do the rows of every tile the cap and the buffer left
    intact; a tile over the cap keeps its first `cap` rows. The counts,
    which every fused tile kernel writes, are given or not."""
    Bt, outcap = 64, 1 << 10
    # one tile under the cap and one over it, in every case
    cap = 128 if group[0] == "unphased" and n_samples == 64 else 64
    st = group_planes(11, 2, Bt, n_samples)
    args = (*group, Bt, n_samples, 0, 0.1, 100.0)
    cfg, jcfg = sweeps.make_cfg(*args), jsweeps.make_cfg(*args)
    assert sweeps.pack16_ok(cfg) == (n_samples == 64)
    pi, pj, dg, live = tile_list(2)
    dev = sweeps.planes_to_device(st, "cpu", sweeps.dev_keys_for(cfg))
    T = len(pi)
    buf = torch.zeros((outcap, sweeps.buf_cols(cfg)), dtype=torch.int32)
    n_pass = torch.zeros(T, dtype=torch.int32)
    n_cand = torch.zeros(T, dtype=torch.int32)
    off = torch.zeros(1, dtype=torch.int32)
    out = tiles.tile_buffers(cfg, "cpu")
    counts = tiles.counts_buffer(cfg, "cpu") if with_counts else None
    scratch = sweeps.compact_scratch(Bt, "cpu")
    _build.reset_counts()
    for t in range(T):
        mask, parts = tiles.tile_prefilter(dev, int(pi[t]), int(pj[t]),
                                           bool(dg[t]), cfg, out, counts)
        sweeps.compact_survivors(mask, parts, off, buf, n_pass, n_cand, t,
                                 cap, counts, scratch)
    assert _build.PLAIN_CALLS["compact"] == T
    jn, jnc, jbuf = (np.asarray(x) for x in jsweeps.jit_fused_sweep(
        jcfg, cap, outcap)(jax_dev(st), pi, pj, dg, live))
    n = n_pass.numpy()
    np.testing.assert_array_equal(n, jn)
    np.testing.assert_array_equal(n_cand.numpy(), jnc)
    assert int(off[0]) == min(int(n.sum()), outcap)
    assert (n > cap).any(), "no tile overflows the cap"
    offs, ok = intact(n, cap, outcap)
    assert (ok & (n > 0)).any()
    for t in np.flatnonzero(ok & (n > 0)):
        lo, hi = offs[t], offs[t] + n[t]
        np.testing.assert_array_equal(buf.numpy()[lo:hi], jbuf[lo:hi])
    t = int(np.flatnonzero(n > cap)[0])
    if offs[t] + cap <= outcap - cap:
        np.testing.assert_array_equal(buf.numpy()[offs[t]:offs[t] + cap],
                                      jbuf[offs[t]:offs[t] + cap])


# -- (c) the sweeps with buffers allocated once ----------
def _cfgs(B, n_samples, min_r2):
    args = ("phased", False, "all", B, n_samples, 0, min_r2, 100.0)
    return sweeps.make_cfg(*args), jsweeps.make_cfg(*args)


@pytest.mark.parametrize("dense,dead_last", [(False, False), (True, False),
                                             (True, True)])
def test_fused_sweep_with_counts_matches_jax(dense, dead_last):
    B, n_samples = 128, 64
    st = (grouped_planes(1, 3, B, n_samples) if dense
          else stacked_planes(2, 3, B, n_samples))
    cap, outcap = 64, 1 << 12
    cfg, jcfg = _cfgs(B, n_samples, 0.1)
    tl = tile_list(3, dead_last)
    n, nc, buf = (x.numpy() for x in sweeps.fused_sweep(
        sweeps.planes_to_device(st, "cpu"), *tl, cfg=cfg, cap=cap,
        outcap=outcap))
    jn, jnc, jbuf = (np.asarray(x) for x in jsweeps.jit_fused_sweep(
        jcfg, cap, outcap)(jax_dev(st), *tl))
    np.testing.assert_array_equal(n, jn)
    np.testing.assert_array_equal(nc, jnc)
    assert n.sum() > 0 and (not dead_last or n[-1] == nc[-1] == 0)
    offs, ok = intact(n, cap, outcap)
    if dense:
        assert (n > cap).any() and ok.any()
    for t in np.flatnonzero(ok & (n > 0)):
        lo, hi = offs[t], offs[t] + n[t]
        np.testing.assert_array_equal(buf[lo:hi], jbuf[lo:hi])


def test_fused_sweep_with_counts_clamps_at_outcap():
    B, n_samples = 8, 4 * 128
    st = stacked_planes(3, 6, B, n_samples)
    cfg, jcfg = _cfgs(B, n_samples, 0.0)
    tl = tile_list(6)
    dev = sweeps.planes_to_device(st, "cpu")
    cap, outcap = 64, 128
    n, nc, buf = (x.numpy() for x in sweeps.fused_sweep(
        dev, *tl, cfg=cfg, cap=cap, outcap=outcap))
    jn, jnc = (np.asarray(x) for x in
               jsweeps.jit_count_sweep(jcfg)(jax_dev(st), *tl))
    np.testing.assert_array_equal(n, jn)
    np.testing.assert_array_equal(nc, jnc)
    assert n.sum() > outcap
    _, _, ref = sweeps.fused_sweep(dev, *tl, cfg=cfg, cap=cap,
                                   outcap=1 << 14)
    offs, ok = intact(n, cap, outcap)
    assert ok[:3].any()
    for t in np.flatnonzero(ok & (n > 0)):
        lo, hi = offs[t], offs[t] + n[t]
        np.testing.assert_array_equal(buf[lo:hi], ref.numpy()[lo:hi])


def test_extract_sweep_with_counts_matches_jax():
    B, n_samples = 128, 64
    st = grouped_planes(4, 3, B, n_samples)
    cfg, jcfg = _cfgs(B, n_samples, 0.1)
    pi, pj, dg, live = tile_list(3)
    n, _ = (np.asarray(x) for x in
            jsweeps.jit_count_sweep(jcfg)(jax_dev(st), pi, pj, dg, live))
    off = (np.cumsum(n) - n).astype(np.int32)
    total = int(n.sum())
    rcap, routcap = 4096, 1 << 15
    buf = sweeps.extract_sweep(sweeps.planes_to_device(st, "cpu"), pi, pj,
                               dg, off, cfg=cfg, cap=rcap, outcap=routcap)
    jbuf = jsweeps.jit_extract_sweep(jcfg, rcap, routcap)(
        jax_dev(st), pi, pj, dg, off)
    assert total > 0
    np.testing.assert_array_equal(buf.numpy()[:total],
                                  np.asarray(jbuf)[:total])


@pytest.mark.parametrize("sweep", ["fused", "extract"])
@pytest.mark.parametrize("group", COMPACT_GROUPS, ids=["P1", "P4", "P9"])
def test_sweeps_allocate_their_buffers_once(group, sweep, monkeypatch):
    """A sweep makes the tile buffers, the counts buffer and the
    compaction's scratch once and hands the same ones to every tile; the
    compaction gets the counts in every group, equal to the mask's. The
    results equal the JAX sweep's."""
    Bt, n_samples, cap, outcap = 64, 64, 2048, 1 << 13
    st = group_planes(11, 2, Bt, n_samples)
    args = (*group, Bt, n_samples, 0, 0.1, 100.0)
    cfg, jcfg = sweeps.make_cfg(*args), jsweeps.make_cfg(*args)
    pi, pj, dg, live = tile_list(2)
    dev = sweeps.planes_to_device(st, "cpu", sweeps.dev_keys_for(cfg))
    made = {"tile_buffers": 0, "counts_buffer": 0, "compact_scratch": 0}
    seen = []

    def counting(name):
        fn = getattr(sweeps, name)

        def wrapped(*a, **kw):
            made[name] += 1
            return fn(*a, **kw)
        return wrapped

    for name in made:
        monkeypatch.setattr(sweeps, name, counting(name))
    compact = sweeps.compact_survivors

    def spy(mask, parts, off, buf, n_pass, n_cand, t, cap, counts, scratch,
            ncol=None):
        seen.append((mask.data_ptr(), parts.data_ptr(), scratch.data_ptr(),
                     None if counts is None else counts.data_ptr()))
        if counts is not None:
            np.testing.assert_array_equal(
                counts.numpy(), tiles.tile_counts_plain(mask).numpy())
        return compact(mask, parts, off, buf, n_pass, n_cand, t, cap, counts,
                       scratch, ncol)

    monkeypatch.setattr(sweeps, "compact_survivors", spy)
    jn, _, jbuf = (np.asarray(x) for x in jsweeps.jit_fused_sweep(
        jcfg, cap, outcap)(jax_dev(st), pi, pj, dg, live))
    total = int(jn.sum())
    assert 0 < total <= outcap - cap and (jn <= cap).all()
    if sweep == "fused":
        n, _, buf = sweeps.fused_sweep(dev, pi, pj, dg, live, cfg=cfg,
                                       cap=cap, outcap=outcap)
        np.testing.assert_array_equal(n.numpy(), jn)
    else:
        off = (np.cumsum(jn) - jn).astype(np.int32)
        buf = sweeps.extract_sweep(dev, pi, pj, dg, off, cfg=cfg, cap=cap,
                                   outcap=outcap)
    np.testing.assert_array_equal(buf.numpy()[:total], jbuf[:total])
    assert made == {"tile_buffers": 1, "counts_buffer": 1,
                    "compact_scratch": 1}
    assert len(seen) == len(pi) and len(set(seen)) == 1
    assert seen[0][3] is not None


@pytest.mark.parametrize("window", [300, 2000])
@pytest.mark.parametrize("group", ALL_GROUPS[2:], ids=GROUP_IDS[2:])
def test_window_sweeps_with_counts_match_jax(group, window):
    """The 4- and 9-part groups' window sweeps, where whole thread blocks
    of a tile hold no candidate: fused_sweep (which hands each tile's
    counts to its compaction) and extract_sweep against the JAX sweeps."""
    Bt, cap, outcap = 128, 4096, 1 << 14
    st = window_planes(9, n_blocks=3, B=Bt)
    args = (*group, Bt, N_SAMPLES, window, MIN_R2, 100.0)
    cfg, jcfg = sweeps.make_cfg(*args), jsweeps.make_cfg(*args)
    pi, pj, dg, live = tile_list(3)
    dev = sweeps.planes_to_device(st, "cpu", sweeps.dev_keys_for(cfg))
    jn, jnc, jbuf = (np.asarray(x) for x in jsweeps.jit_fused_sweep(
        jcfg, cap, outcap)(jax_dev(st), pi, pj, dg, live))
    n, nc, buf = sweeps.fused_sweep(dev, pi, pj, dg, live, cfg=cfg, cap=cap,
                                    outcap=outcap)
    np.testing.assert_array_equal(n.numpy(), jn)
    np.testing.assert_array_equal(nc.numpy(), jnc)
    total = int(jn.sum())
    assert total > 0 and (jnc < Bt * Bt).all()
    np.testing.assert_array_equal(buf.numpy()[:total], jbuf[:total])
    off = (np.cumsum(jn) - jn).astype(np.int32)
    ebuf = sweeps.extract_sweep(dev, pi, pj, dg, off, cfg=cfg, cap=cap,
                                outcap=outcap)
    np.testing.assert_array_equal(ebuf.numpy()[:total], jbuf[:total])


class _FaultingLibrary:
    """Stands in for the kernel library: twk_compact does what compact.cu
    does when its scan finds the ticket not 0 (marks n_pass[t], sets the
    ticket to 0) and records the pointers it was handed."""

    def __init__(self):
        self.calls = []

    def twk_compact(self, mask, parts, counts, P, ncol, ld, B, off, cap,
                    outcap, n_pass, n_cand, t, scratch, ticket, buf, stream):
        self.calls.append(dict(n_pass=n_pass, t=t, ticket=ticket))
        ctypes.c_int32.from_address(n_pass + 4 * t).value = \
            sweeps.TICKET_FAULT
        ctypes.c_int32.from_address(ticket).value = 0
        return 0


def test_compaction_fault_raises_at_the_host_read(monkeypatch):
    """The compaction's wrapper hands the kernel n_pass, the tile index
    and its (device, stream) ticket; the kernel's fault mark in n_pass[t]
    becomes a RuntimeError where the host reads the counts
    (sweeps.host_counts, the engine's one sync of a sweep), and the
    counts read as before where there is none."""
    lib = _FaultingLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(sweeps, "_TICKETS", {})
    Bt = 64
    mask = torch.zeros((Bt, Bt), dtype=torch.uint8)
    parts = torch.zeros((1, Bt, Bt), dtype=torch.int32)
    n_pass = torch.tensor([3, 0, 5], dtype=torch.int32)
    n_cand = torch.tensor([7, 0, 9], dtype=torch.int32)
    off = torch.zeros(1, dtype=torch.int32)
    buf = torch.zeros((256, 2), dtype=torch.int32)
    ticket = sweeps._ticket(mask.device, 0).fill_(11)
    n, nc = sweeps.host_counts(n_pass, n_cand)
    assert n.tolist() == [3, 0, 5] and nc.tolist() == [7, 0, 9]
    assert n.dtype == nc.dtype == np.int64
    sweeps._launch_compact(mask, parts, off, buf, n_pass, n_cand, 1, 64,
                           tiles.tile_counts_plain(mask), None)
    assert lib.calls == [dict(n_pass=n_pass.data_ptr(), t=1,
                              ticket=ticket.data_ptr())]
    assert n_pass.tolist() == [3, sweeps.TICKET_FAULT, 5]
    assert int(ticket[0]) == 0
    with pytest.raises(RuntimeError, match=r"tiles \[1\].*ticket"):
        sweeps.host_counts(n_pass, n_cand)


def test_engine_raises_for_a_faulted_compaction(monkeypatch):
    """LdEngine reads a segment's counts through sweeps.host_counts, so a
    tile its compaction marked stops the run instead of emitting rows."""
    from tomahawk_tpu_torch.compute.engine import CalcSettings, LdEngine
    from tomahawk_tpu_torch.ops.ld_math import LdFilters
    st = stacked_planes(2, 2, 128, N_SAMPLES)
    engine = LdEngine(st, N_SAMPLES, CalcSettings(min_r2=MIN_R2), "cpu")
    fused = sweeps.fused_sweep

    def faulted(*a, **kw):
        n_pass, n_cand, buf = fused(*a, **kw)
        n_pass[0] = sweeps.TICKET_FAULT
        return n_pass, n_cand, buf

    monkeypatch.setattr(sweeps, "fused_sweep", faulted)
    emitted = []
    try:
        with pytest.raises(RuntimeError, match="ticket"):
            engine.run_phased_pairs(
                [(0, 0, True), (0, 1, False)], False,
                LdFilters(min_r2=MIN_R2),
                lambda recs, rev=None: emitted.append(recs))
    finally:
        engine.stage_close()
    assert emitted == []


# -- (d) the bounds chip_smoke.py prints ----------
#: (table, has_missing, word slices) of one 4096 x 4096 tile at 2,504
#: samples, then in ms: its operations over the 1-bit MMA's rate, over the
#: published int8 peak, and its popcounts over the CUDA cores' POPC rate
BOUNDS = [
    (("phased", False, 1), 0.017, 0.087, 0.639),
    (("phased", True, 1), 0.067, 0.347, 2.557),
    (("unphased", False, 1), 0.034, 0.174, 1.278),
    (("unphased", True, 1), 0.076, 0.391, 2.876),
    (("phased", False, 2), 0.008, 0.043, 0.320),
    (("phased", True, 2), 0.034, 0.174, 1.278),
    (("unphased", False, 2), 0.017, 0.087, 0.639),
    (("unphased", True, 2), 0.038, 0.195, 1.438),
]


@pytest.mark.parametrize("shape,b1_ms,int8_ms,core_ms", BOUNDS,
                         ids=["-".join(map(str, b[0])) for b in BOUNDS])
def test_chip_smoke_contraction_bounds(shape, b1_ms, int8_ms, core_ms):
    words = chip_smoke.contraction_pair_words(*shape)
    ms, by = chip_smoke._bound(words, 0)
    assert by == "operations"
    assert round(ms, 3) == b1_ms
    assert ms == 64 * words / 10.2e15 * 1e3
    assert round(chip_smoke._int8_ms(words), 3) == int8_ms
    assert round(chip_smoke._cuda_core_ms(words), 3) == core_ms
    # bytes win once they take longer than the operations
    slow = int(ms * 1e-3 * chip_smoke.HBM_BYTES_PER_S) + 4096
    assert chip_smoke._bound(words, slow)[1] == "bytes"
    assert chip_smoke._bound(words, slow)[0] > ms


#: the fused tile kernels' bounds with their bytes: every one is the bytes'
TILE_BOUNDS = [(("phased", False), 0.027), (("phased", True), 0.088),
               (("unphased", False), 0.087), (("unphased", True), 0.188)]


@pytest.mark.parametrize("group,ms", TILE_BOUNDS,
                         ids=["-".join(map(str, b[0])) for b in TILE_BOUNDS])
def test_chip_smoke_tile_bounds_are_the_bytes(group, ms):
    P = tiles.payload_cols(*group)
    n = chip_smoke.tile_bytes(*group)
    # the outputs alone: a mask byte and P int32 parts a pair
    assert n > 4096 * 4096 * (1 + 4 * P)
    got = chip_smoke._bound(chip_smoke.contraction_pair_words(*group), n)
    assert got == (n / 3.35e12 * 1e3, "bytes")
    assert round(got[0], 3) == ms


@pytest.mark.parametrize("group", ALL_GROUPS[::2] + ALL_GROUPS[3:4],
                         ids=["-".join(map(str, g[:2])) for g in
                              ALL_GROUPS[::2] + ALL_GROUPS[3:4]])
def test_chip_smoke_library_call_computes_the_parts(group):
    """The library yardstick chip_smoke.py times (torch._int_mm once a
    part on int8 operands unpacked beforehand, miss as valid = ~miss, in
    PRODUCTS' order) computes the tile's parts, equal to the plain
    version's on every lane, for a slice of the words too."""
    Bt = 64
    st = window_planes(3, B=Bt)
    cfg = sweeps.make_cfg(*group, Bt, N_SAMPLES, 0, MIN_R2, 100.0)
    keys = tiles.plane_keys(*group[:2])
    P = tiles.payload_cols(*group[:2])
    for word_slice in (None, (1, 3)):
        dev = sweeps.planes_to_device(st, "cpu", keys + ("valid",),
                                      word_slice=word_slice)
        want = torch.stack(tiles.tile_local_parts_plain(dev, 0, 1, cfg))
        got = chip_smoke.library_call(dev, 0, 1, keys, P)()
        assert len(got) == P
        assert torch.equal(torch.stack(got), want)


def test_chip_smoke_kernel_bounds():
    b = chip_smoke.kernel_bounds(30720)
    assert round(b["phased_tile"][0], 3) == 0.027
    assert round(b["parts_tile"][0], 3) == 0.188
    assert b["phased_tile"][1] == b["parts_tile"][1] == "bytes"
    ms, by = b["compact"]
    assert by == "bytes"
    want = (4096 * 4096 + 4096 * 32 * 4 + 30720 * 12) / 3.35e12 * 1e3
    assert ms == pytest.approx(want, rel=1e-12)
    # 9 parts in 6 columns: 9 parts gathered and 6 columns written a row
    want = (4096 * 4096 + 4096 * 32 * 4 + 1000 * 15 * 4) / 3.35e12 * 1e3
    assert chip_smoke.compact_bound_ms(9, 6, 1000) == pytest.approx(
        want, rel=1e-12)
