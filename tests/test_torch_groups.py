"""The port's sweep groups beyond phased / no-missing / cls "all" -- the
mixed dispatch's clean and missing halves, phased with missing data, and
unphased with and without -- against the JAX package on the same numpy
planes: the plain versions of ld_kernels, the whole tile (against the
XLA path and the fused TPU kernel in Pallas interpret mode), the
unphased prefilter's superset property against the exact host filter,
the compaction of 4- and 9-part payloads against `_pack_cols`, and the
sweeps. The CUDA kernels are compared with their plain versions by the
`gpu` tests, which run only where torch sees a card."""

import numpy as np
import pytest
import torch

# first: binds libzstd for the shared io code where the zstandard
# package is missing (so the gpu tests run on a card's host too)
import tomahawk_tpu_torch  # noqa: F401

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from tomahawk_tpu.compute import sweeps as jsweeps
from tomahawk_tpu.ops import ld_kernels as JK
from tomahawk_tpu.ops import pallas_tiles as PT
from tomahawk_tpu.ops.bitpack import stack_planes
from tomahawk_tpu.ops.ld_math import LdFilters, PairMeta, ld_records

from tomahawk_tpu_torch.compute import sweeps
from tomahawk_tpu_torch.ops import _build, tiles
from tomahawk_tpu_torch.ops import ld_kernels as K

from test_kernels import _block_from_codes
from test_torch_ld_kernels import jax_dev
from test_torch_sweeps import intact, tile_list

B, N_SAMPLES, MIN_R2 = 256, 100, 0.05

#: the (table, has_missing, cls) groups beyond phased / no missing / "all"
GROUPS = [("phased", False, "clean"), ("phased", True, "all"),
          ("unphased", False, "all"), ("unphased", True, "all"),
          ("unphased", True, "missing")]
GROUP_IDS = ["-".join(str(x) for x in g) for g in GROUPS]


def group_planes(seed, n_blocks=2, B=B, n_samples=N_SAMPLES,
                 miss_frac=0.05):
    """bitpack.stack_planes output for blocks of padded rows in LD runs
    (each row a noisy copy of the one before, every fourth row fresh),
    with missing genotypes on every other row, so the clean and missing
    pair classes both have members."""
    rng = np.random.default_rng(seed)
    planes = []
    for _ in range(n_blocks):
        n_var = int(rng.integers(B // 2, B + 1))
        rows, clean = [], None
        for v in range(n_var):
            if v % 4 == 0:
                maf = rng.uniform(0.05, 0.5)
                clean = ((rng.random(n_samples) < maf).astype(np.uint8) << 2
                         | (rng.random(n_samples) < maf).astype(np.uint8))
            else:
                flip = rng.random(n_samples) < 0.08
                clean = clean.copy()
                clean[flip] = rng.integers(0, 4, int(flip.sum())) & 0b101
            codes = clean.copy()
            if v % 2:
                codes[rng.random(n_samples) < miss_frac] = (2 << 2) | 2
            rows.append(codes)
        planes.append(_block_from_codes(rows, pad_to=B))
    return stack_planes(planes)


def cfg_pair(group, B=B, n_samples=N_SAMPLES, min_r2=MIN_R2):
    table, miss, cls = group
    return (sweeps.make_cfg(table, miss, cls, B, n_samples, 0, min_r2,
                            100.0),
            jsweeps.make_cfg(table, miss, cls, B, n_samples, 0, min_r2,
                             100.0))


@pytest.mark.parametrize("i,j,diag", [(0, 0, True), (0, 1, False)])
@pytest.mark.parametrize("group", GROUPS, ids=GROUP_IDS)
def test_group_tile_matches_jax_and_pallas(group, i, j, diag):
    """Parts, candidate mask and prefilter mask bit-identical to the JAX
    XLA tile path and to the fused TPU kernel (interpret mode)."""
    st = group_planes(7)
    jdev = jax_dev(st)
    cfg, jcfg = cfg_pair(group)
    dev = sweeps.planes_to_device(st, "cpu", sweeps.dev_keys_for(cfg))
    args = (jdev, jnp.int32(i), jnp.int32(j), jnp.asarray(diag))
    pf_x, m_x, parts_x = jsweeps.tile_prefilter(*args, jcfg)
    pf_p, m_p, parts_p = PT.tile_prefilter_pallas(*args, jcfg,
                                                  interpret=True)
    _build.reset_counts()
    mask, parts = (x.numpy() for x in
                   tiles.tile_prefilter(dev, i, j, diag, cfg))
    assert _build.PLAIN_CALLS[tiles.kernel_name(cfg)] == 1
    assert parts.shape == (sweeps.payload_cols(*group[:2]), B, B)
    for want in (parts_x, parts_p):
        assert len(want) == len(parts)
        for got, w in zip(parts, want):
            np.testing.assert_array_equal(got, np.asarray(w))
    for want in (m_x, m_p):
        np.testing.assert_array_equal(mask >= 1, np.asarray(want))
    for want in (pf_x, pf_p):
        np.testing.assert_array_equal(mask == 2, np.asarray(want))
    assert (mask >= 1).any()
    assert group[2] == "clean" or (mask == 2).any()


@pytest.mark.parametrize("table,miss", [("phased", True),
                                        ("unphased", False),
                                        ("unphased", True)])
def test_plain_functions_match_jax(table, miss):
    """ld_kernels' parts, cells, r2 and prefilter functions give the JAX
    functions' values on the same planes, every lane."""
    st = group_planes(3, n_blocks=1)
    t = lambda k: torch.from_numpy(np.ascontiguousarray(
        st[k][0].view(np.int32) if st[k].dtype == np.uint32 else st[k][0]))
    j = lambda k: jnp.asarray(st[k][0])
    valid = t("valid")
    pm = valid[:, None] & valid[None, :]
    if table == "phased":
        parts = K.phased_parts_tile(t("alt_bits"), t("alt_bits"),
                                    t("miss_bits"), t("miss_bits"))
        jparts = JK.phased_parts_tile(j("alt_bits"), j("miss_bits"),
                                      j("alt_bits"), j("miss_bits"), True)
        cells = K.phased_cells(parts, t("ac"), t("ac"), N_SAMPLES)
        jcells = JK.phased_cells(jparts, j("ac"), j("ac"), N_SAMPLES)
        np.testing.assert_array_equal(
            K.phased_r2_cells(*cells).numpy(),
            np.asarray(JK.phased_r2_cells(*jcells)))
        pf = K.phased_prefilter_cells(cells, pm, 0.1, 100.0)
        jpf = JK.phased_prefilter_cells(jcells, jnp.asarray(pm.numpy()),
                                        0.1, 100.0)
    else:
        val = (t("valid_bits"), t("valid_bits")) if miss else (None, None)
        parts = K.unphased_parts_tile(t("het_bits"), t("hom_bits"), val[0],
                                      t("het_bits"), t("hom_bits"), val[1],
                                      miss)
        jparts = JK.unphased_parts_tile(
            j("het_bits"), j("hom_bits"), j("valid_bits"), j("het_bits"),
            j("hom_bits"), j("valid_bits"), miss)
        cells = K.unphased_cells(parts, t("n_het"), t("n_hom"), t("n_het"),
                                 t("n_hom"), N_SAMPLES)
        jcells = JK.unphased_cells(jparts, j("n_het"), j("n_hom"),
                                   j("n_het"), j("n_hom"), N_SAMPLES)
        pf = K.unphased_prefilter_cells(cells, pm, 0.1, 100.0)
        jpf = JK.unphased_prefilter_cells(jcells, jnp.asarray(pm.numpy()),
                                          0.1, 100.0)
    assert len(parts) == len(jparts) == sweeps.payload_cols(table, miss)
    for got, want in zip(parts + cells, tuple(jparts) + tuple(jcells)):
        np.testing.assert_array_equal(
            np.broadcast_to(got.numpy(), (B, B)),
            np.broadcast_to(np.asarray(want), (B, B)))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jpf))
    assert pf.any() and not pf.all()


def test_unphased_bounds_round_as_jax():
    for r2 in (0.0, 0.05, 0.1, 0.3, 0.5, 0.8, 1.0, 100.0):
        lo, hi = K.unphased_bounds(r2, r2)
        assert lo == np.asarray(jnp.float32(r2) * 0.98 - 1e-4)
        assert hi == np.asarray(jnp.float32(r2) * 1.02 + 1e-4)


def _tables(kind, rng, K_=3000, n=60):
    """[K, 3, 3] genotype tables of n samples drawn from random
    haplotype frequencies (strong and weak LD): `no_double_hets` zeroes
    T11 into T00, `zero_marginals` makes variant B monomorphic."""
    f = rng.dirichlet(np.full(4, 0.4), size=K_)       # f00 f01 f10 f11
    T = np.zeros((K_, 3, 3), np.int64)
    for k in range(K_):
        h = rng.choice(4, size=(n, 2), p=f[k])
        a = (h >> 1).sum(axis=1)
        b = (h & 1).sum(axis=1)
        if kind == "zero_marginals":
            b[:] = 0
        np.add.at(T[k], (a, b), 1)
    if kind == "no_double_hets":
        T[:, 0, 0] += T[:, 1, 1]
        T[:, 1, 1] = 0
    return T


@pytest.mark.parametrize("min_r2", [0.1, 0.5])
@pytest.mark.parametrize("kind", ["double_hets", "no_double_hets",
                                  "zero_marginals"])
def test_unphased_prefilter_keeps_exact_survivors(kind, min_r2):
    """The f32 unphased prefilter keeps every pair the exact host path
    (the shared native record pipeline: cubic EM, filters, Fisher)
    keeps, and makes the JAX function's decision on every table."""
    rng = np.random.default_rng({"double_hets": 1, "no_double_hets": 2,
                                 "zero_marginals": 3}[kind])
    T = _tables(kind, rng)
    z = np.zeros(len(T), np.int64)
    meta = PairMeta(pos_a=z, pos_b=z + 1, rid_a=z, rid_b=z, ac_a=z + 10,
                    ac_b=z + 10, an_a=z, an_b=z, hwe_a=np.ones(len(T)),
                    hwe_b=np.ones(len(T)))
    out = ld_records("unphased", T, meta, LdFilters(min_r2=min_r2))
    keep = np.zeros(len(T), bool)
    keep[out[2]] = True
    cells = [torch.from_numpy(T[:, r, c].copy())
             for r in range(3) for c in range(3)]
    pm = torch.ones(len(T), dtype=torch.bool)
    pf = K.unphased_prefilter_cells(cells, pm, min_r2, 100.0).numpy()
    jpf = JK.unphased_prefilter_cells(
        [jnp.asarray(c.numpy()) for c in cells], jnp.asarray(pm.numpy()),
        min_r2, 100.0)
    np.testing.assert_array_equal(pf, np.asarray(jpf))
    assert not (keep & ~pf).any(), "prefilter dropped an exact survivor"
    if kind == "zero_marginals":
        assert not keep.any()
    else:
        assert keep.any() and not pf.all()


@pytest.mark.parametrize("n_samples", [2504, 70_000])
@pytest.mark.parametrize("miss", [False, True], ids=["P4", "P9"])
def test_compact_payloads_match_jax(miss, n_samples):
    """4- and 9-part payloads, pair-packed while pack16_ok holds and one
    part per column otherwise: the port's compaction writes the rows of
    JAX's compact_indices_small + _pack_cols."""
    rng = np.random.default_rng(5)
    Bt, cap, outcap = 48, 512, 1024
    cfg = dict(table="unphased", has_missing=miss, n_samples=n_samples)
    assert sweeps.pack16_ok(cfg) == (n_samples < 1 << 16)
    P = sweeps.payload_cols("unphased", miss)
    mask = rng.choice(3, size=(Bt, Bt), p=[0.6, 0.3, 0.1]).astype(np.uint8)
    parts = rng.integers(0, n_samples, size=(P, Bt, Bt)).astype(np.int32)
    buf = torch.full((outcap, sweeps.buf_cols(cfg)), -7, dtype=torch.int32)
    n_pass = torch.zeros(2, dtype=torch.int32)
    n_cand = torch.zeros(2, dtype=torch.int32)
    off = torch.tensor([3], dtype=torch.int32)
    sweeps.compact_survivors(torch.from_numpy(mask),
                             torch.from_numpy(parts), off, buf, n_pass,
                             n_cand, 1, cap)
    n, idx = JK.compact_indices_small(jnp.asarray(mask == 2), cap)
    safe = jnp.minimum(idx, Bt * Bt - 1)
    want = np.asarray(jsweeps._pack_cols(
        idx, tuple(jnp.asarray(p) for p in parts), safe, cfg))
    k = int(n)
    assert 0 < k == int(n_pass[1]) < cap
    np.testing.assert_array_equal(buf.numpy()[3:3 + k], want[:k])
    assert (buf.numpy()[3 + k:] == -7).all()
    assert int(n_cand[1]) == int((mask != 0).sum())
    np.testing.assert_array_equal(
        sweeps.unpack_payload(buf.numpy()[3:3 + k, 1:], "unphased", miss,
                              n_samples),
        parts.reshape(P, -1)[:, (mask == 2).ravel()].T)


@pytest.mark.parametrize("group", GROUPS, ids=GROUP_IDS)
def test_fused_sweep_groups_match_jax(group):
    """Per-tile counts identical, and the survivor rows of every intact
    tile identical, to the JAX fused sweep's."""
    Bt = 128
    st = group_planes(11, 3, Bt, 64)
    cfg, jcfg = cfg_pair(group, Bt, 64, 0.1)
    tl = tile_list(3, dead_last=True)
    cap, outcap = 64, 1 << 12
    dev = sweeps.planes_to_device(st, "cpu", sweeps.dev_keys_for(cfg))
    n, nc, buf = (x.numpy() for x in sweeps.fused_sweep(
        dev, *tl, cfg=cfg, cap=cap, outcap=outcap))
    jn, jnc, jbuf = (np.asarray(x) for x in
                     jsweeps.jit_fused_sweep(jcfg, cap, outcap)(
                         jax_dev(st), *tl))
    np.testing.assert_array_equal(n, jn)
    np.testing.assert_array_equal(nc, jnc)
    assert buf.shape == jbuf.shape
    assert nc.sum() > 0 and n[-1] == nc[-1] == 0
    assert group[2] == "clean" or n.sum() > 0
    offs, ok = intact(n, cap, outcap)
    for t in np.flatnonzero(ok & (n > 0)):
        lo, hi = offs[t], offs[t] + n[t]
        np.testing.assert_array_equal(buf[lo:hi], jbuf[lo:hi])


def test_extract_sweep_nine_parts_matches_jax():
    Bt = 128
    group = ("unphased", True, "all")
    st = group_planes(4, 3, Bt, 64)
    cfg, jcfg = cfg_pair(group, Bt, 64, 0.05)
    pi, pj, dg, live = tile_list(3)
    n, _ = (np.asarray(x) for x in
            jsweeps.jit_count_sweep(jcfg)(jax_dev(st), pi, pj, dg, live))
    dev = sweeps.planes_to_device(st, "cpu", sweeps.dev_keys_for(cfg))
    got_n, _ = sweeps.count_sweep(dev, pi, pj, dg, live, cfg=cfg)
    np.testing.assert_array_equal(got_n.numpy(), n)
    off = (np.cumsum(n) - n).astype(np.int32)
    total = int(n.sum())
    rcap, routcap = 4096, 1 << 15
    buf = sweeps.extract_sweep(dev, pi, pj, dg, off, cfg=cfg, cap=rcap,
                               outcap=routcap)
    jbuf = jsweeps.jit_extract_sweep(jcfg, rcap, routcap)(
        jax_dev(st), pi, pj, dg, off)
    assert total > 0 and buf.shape[1] == 6
    np.testing.assert_array_equal(buf.numpy()[:total],
                                  np.asarray(jbuf)[:total])


def test_dev_keys_follow_the_group():
    cfg = lambda t, m, c: sweeps.make_cfg(t, m, c, 128, 64, 0, 0.1, 100.0)
    assert set(sweeps.dev_keys_for(cfg("phased", False, "all"))) == {
        "alt_bits", "ac", "valid"}
    assert set(sweeps.dev_keys_for(cfg("phased", False, "clean"))) == {
        "alt_bits", "ac", "an", "valid"}
    assert set(sweeps.dev_keys_for(cfg("phased", True, "all"))) == {
        "alt_bits", "miss_bits", "ac", "valid"}
    assert set(sweeps.dev_keys_for(cfg("unphased", True, "missing"))) == {
        "het_bits", "hom_bits", "valid_bits", "n_het", "n_hom", "ac", "an",
        "valid"}
    with pytest.raises(ValueError):
        cfg("phased", False, "dirty")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("group", GROUPS, ids=GROUP_IDS)
def test_group_kernel_matches_plain_on_card(group):
    card = _card()
    cfg, _ = cfg_pair(group)
    dev = sweeps.planes_to_device(group_planes(7), card,
                                  sweeps.dev_keys_for(cfg))
    for i, j, diag in [(0, 0, True), (0, 1, False)]:
        mask, parts = tiles.tile_prefilter(dev, i, j, diag, cfg)
        want_m, want_p = tiles.tile_prefilter_plain(dev, i, j, diag, cfg)
        assert torch.equal(mask, want_m) and torch.equal(parts, want_p)


@pytest.mark.gpu
@pytest.mark.parametrize("n_samples", [2504, 70_000])
@pytest.mark.parametrize("P", [4, 9])
def test_compact_payload_kernel_matches_plain_on_card(P, n_samples):
    card = _card()
    rng = np.random.default_rng(2)
    Bt, cap, outcap = 300, 512, 4096
    cfg = dict(table="unphased", has_missing=P == 9, n_samples=n_samples)
    mask = torch.from_numpy(rng.choice(3, size=(Bt, Bt),
                                       p=[0.7, 0.29, 0.01]).astype(np.uint8))
    parts = torch.from_numpy(
        rng.integers(0, n_samples, size=(P, Bt, Bt)).astype(np.int32))
    # the kernel reads the counts the tile kernels write beside the mask
    counts = tiles.tile_counts_plain(mask.to(card))
    with pytest.raises(ValueError, match="counts"):
        sweeps.compact_survivors(mask.to(card), parts.to(card),
                                 *[torch.zeros(1, dtype=torch.int32,
                                               device=card)] * 4, 0, cap)
    outs = []
    for fn in (lambda *a: sweeps.compact_survivors(*a, counts),
               sweeps.compact_survivors_plain):
        bufs = [torch.zeros((outcap, sweeps.buf_cols(cfg)),
                            dtype=torch.int32, device=card),
                torch.zeros(2, dtype=torch.int32, device=card),
                torch.zeros(2, dtype=torch.int32, device=card),
                torch.tensor([100], dtype=torch.int32, device=card)]
        for t in range(2):
            fn(mask.to(card), parts.to(card), bufs[3], bufs[0], bufs[1],
               bufs[2], t, cap)
        outs.append([b.cpu() for b in bufs])
    for got, want in zip(*outs):
        assert torch.equal(got, want)
