"""The port's sweeps against the JAX package's on the same numpy planes
(Fisher column off): per-tile counts identical, survivor rows of intact
tiles identical, the running offset clamped at outcap, exact-offset
repair rows identical, the host payload helpers the same, and the D'
bounds carried into every group's count sweep."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from tomahawk_tpu.compute import sweeps as jsweeps
from tomahawk_tpu.ops.bitpack import (BlockPlanes, _pack_bits,
                                      stack_planes, words_for)

from tomahawk_tpu_torch.compute import sweeps

from test_torch_ld_kernels import jax_dev, stacked_planes


def grouped_planes(seed, n_blocks, B, n_samples, group=16, flip=0.02):
    """Records-dense planes: every `group` consecutive variants are noisy
    copies of one haplotype template (as bench.build_planes_grouped)."""
    rng = np.random.default_rng(seed)
    Wh, Ws = words_for(2 * n_samples), words_for(n_samples)
    z = np.zeros((B, n_samples), bool)
    planes = []
    for _ in range(n_blocks):
        base = rng.random((B // group, 2 * n_samples)) < 0.35
        alt = np.repeat(base, group, axis=0)
        alt ^= rng.random((B, 2 * n_samples)) < flip
        planes.append(BlockPlanes(
            n_rec=B, alt_bits=_pack_bits(alt, Wh),
            miss_bits=_pack_bits(np.zeros_like(alt), Wh),
            het_bits=_pack_bits(z, Ws), hom_bits=_pack_bits(z, Ws),
            valid_bits=_pack_bits(~z, Ws),
            pos=np.arange(B, dtype=np.int32), rid=np.zeros(B, np.int32),
            ac=alt.sum(axis=1).astype(np.int32), an=np.zeros(B, np.int32),
            n_het=np.zeros(B, np.int32), n_hom=np.zeros(B, np.int32),
            hwe=np.ones(B, np.float32), has_missing=np.zeros(B, bool),
            valid=np.ones(B, bool)))
    return stack_planes(planes)


def tile_list(nb, dead_last=False):
    pairs = [(i, j, i == j) for i in range(nb) for j in range(i, nb)]
    pi = np.array([p[0] for p in pairs], np.int32)
    pj = np.array([p[1] for p in pairs], np.int32)
    dg = np.array([p[2] for p in pairs], bool)
    live = np.ones(len(pairs), bool)
    live[-1] = not dead_last
    return pi, pj, dg, live


def cfgs(B, n_samples, min_r2):
    return (sweeps.make_cfg("phased", False, "all", B, n_samples, 0,
                            min_r2, 100.0),
            jsweeps.make_cfg("phased", False, "all", B, n_samples, 0,
                             min_r2, 100.0))


def run_both(st, B, n_samples, min_r2, cap, outcap, dead_last=False):
    cfg, jcfg = cfgs(B, n_samples, min_r2)
    tl = tile_list(st["alt_bits"].shape[0], dead_last)
    got = sweeps.fused_sweep(sweeps.planes_to_device(st, "cpu"), *tl,
                             cfg=cfg, cap=cap, outcap=outcap)
    want = jsweeps.jit_fused_sweep(jcfg, cap, outcap)(jax_dev(st), *tl)
    return [x.numpy() for x in got], [np.asarray(x) for x in want]


def intact(n, cap, outcap):
    offs = np.cumsum(n.astype(np.int64)) - n
    return offs, (n <= cap) & (offs + n <= outcap - cap)


@pytest.mark.parametrize("dense,dead_last", [(False, False), (True, False),
                                             (True, True)])
def test_fused_sweep_matches_jax(dense, dead_last):
    B, n_samples = 128, 64
    st = (grouped_planes(1, 3, B, n_samples) if dense
          else stacked_planes(2, 3, B, n_samples))
    cap, outcap = 64, 1 << 12
    (n, nc, buf), (jn, jnc, jbuf) = run_both(st, B, n_samples, 0.1, cap,
                                             outcap, dead_last)
    np.testing.assert_array_equal(n, jn)
    np.testing.assert_array_equal(nc, jnc)
    assert n.sum() > 0 and (not dead_last or n[-1] == nc[-1] == 0)
    offs, ok = intact(n, cap, outcap)
    if dense:
        assert (n > cap).any() and ok.any()
    for t in np.flatnonzero(ok & (n > 0)):
        lo, hi = offs[t], offs[t] + n[t]
        np.testing.assert_array_equal(buf[lo:hi], jbuf[lo:hi])


def test_fused_sweep_offset_clamps_at_outcap():
    """The running offset clamps at outcap: the intact prefix stays exact
    and matches a no-spill run row for row (tests/test_parallel.py's
    check, on the port)."""
    B, n_samples = 8, 4 * 128
    st = stacked_planes(3, 6, B, n_samples)
    cfg, jcfg = cfgs(B, n_samples, 0.0)
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
    assert ok[:3].any(), "test data produced no intact-prefix tiles"
    for t in np.flatnonzero(ok & (n > 0)):
        lo, hi = offs[t], offs[t] + n[t]
        np.testing.assert_array_equal(buf[lo:hi], ref.numpy()[lo:hi])


def test_extract_sweep_matches_jax():
    B, n_samples = 128, 64
    st = grouped_planes(4, 3, B, n_samples)
    cfg, jcfg = cfgs(B, n_samples, 0.1)
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


def test_count_sweep_matches_jax():
    B, n_samples = 128, 64
    st = stacked_planes(5, 2, B, n_samples)
    cfg, jcfg = cfgs(B, n_samples, 0.1)
    tl = tile_list(2, dead_last=True)
    got = sweeps.count_sweep(sweeps.planes_to_device(st, "cpu"), *tl,
                             cfg=cfg)
    want = jsweeps.jit_count_sweep(jcfg)(jax_dev(st), *tl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("table,miss", [("phased", False), ("phased", True),
                                        ("unphased", False),
                                        ("unphased", True)])
@pytest.mark.parametrize("n_samples", [4 * 128, 70_000])
def test_payload_helpers_match_jax(table, miss, n_samples):
    cfg = dict(table=table, has_missing=miss, n_samples=n_samples)
    assert sweeps.payload_cols(table, miss) == \
        jsweeps.payload_cols(table, miss)
    assert sweeps.pack16_ok(cfg) == jsweeps.pack16_ok(cfg)
    assert sweeps.buf_cols(cfg) == jsweeps.buf_cols(cfg)
    rng = np.random.default_rng(6)
    cols = rng.integers(-2**31, 2**31, size=(50, sweeps.buf_cols(cfg) - 1),
                        dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(
        sweeps.unpack_payload(cols, table, miss, n_samples),
        jsweeps.unpack_payload(cols, table, miss, n_samples))


@pytest.mark.parametrize("args", [
    ("phased", True, "all", 0, 0.2, 100.0),
    ("unphased", True, "missing", 10_000, 0.0, 0.9),
    ("phased", False, "all", 10_000, 0.1, 100.0),
    ("phased", False, "all", 0, 0.2, 100.0),
    ("unphased", False, "all", 0, 0.0, 0.5),
])
def test_make_cfg_carries_dprime_bounds(args):
    """D' bounds ride the config as in the JAX make_cfg, and the count
    sweep with them (the in-sweep D' filter in the group's prefilter, a
    window where one is set) gives the JAX count sweep's per-tile survivor
    and candidate counts, equal."""
    # test_torch_window imports this module
    from test_torch_window import N_SAMPLES as WIN_SAMPLES
    from test_torch_window import window_planes
    table, miss, cls, window, dmin, dmax = args
    cfg = sweeps.make_cfg(table, miss, cls, 128, WIN_SAMPLES, window, 0.1,
                          100.0, dmin, dmax)
    jcfg = jsweeps.make_cfg(table, miss, cls, 128, WIN_SAMPLES, window, 0.1,
                            100.0, min_dprime=dmin, max_dprime=dmax)
    assert (cfg["min_dprime"], cfg["max_dprime"]) \
        == (jcfg["min_dprime"], jcfg["max_dprime"]) == (dmin, dmax)
    st = window_planes(3, n_blocks=2, B=128)
    tl = tile_list(2)
    got = sweeps.count_sweep(sweeps.planes_to_device(st, "cpu"), *tl,
                             cfg=cfg)
    want = jsweeps.jit_count_sweep(jcfg)(jax_dev(st), *tl)
    assert int(got[1].sum()) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_planes_to_device_keeps_bits():
    st = stacked_planes(8, 1, 128, 50)
    dev = sweeps.planes_to_device(st, "cpu")
    assert set(dev) == set(sweeps.DEV_KEYS)
    assert dev["alt_bits"].dtype == torch.int32
    np.testing.assert_array_equal(dev["alt_bits"].numpy().view(np.uint32),
                                  st["alt_bits"])
    np.testing.assert_array_equal(dev["valid"].numpy(), st["valid"])
    np.testing.assert_array_equal(dev["ac"].numpy(), st["ac"])
