"""The port's tile operations against the JAX package, on the same numpy
planes: unpack, contraction and candidate mask bit-identical to the JAX
XLA path and to the fused TPU kernel (run in Pallas interpret mode); the
f32 prefilter differing from JAX's only on pairs the exact f64 filter
drops; the survivor compaction's contract. The CUDA kernels themselves
are compared with their plain versions by the `gpu` tests, which run
only where torch sees a card."""

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
from tomahawk_tpu.ops.ld_math import LdFilters, PairMeta, phased_math

from tomahawk_tpu_torch.compute import sweeps
from tomahawk_tpu_torch.ops import _build, tiles
from tomahawk_tpu_torch.ops import ld_kernels as K

from test_kernels import _block_from_codes, _random_rows

B, N_SAMPLES, MIN_R2 = 256, 100, 0.05


def stacked_planes(seed, n_blocks=2, B=B, n_samples=N_SAMPLES):
    """bitpack.stack_planes output for random phased blocks with no
    missing genotypes, each padded to B rows."""
    rng = np.random.default_rng(seed)
    planes = []
    for _ in range(n_blocks):
        n_var = int(rng.integers(B // 2, B + 1))
        rows = _random_rows(rng, n_var, n_samples, 0.0)
        planes.append(_block_from_codes(rows, pad_to=B))
    return stack_planes(planes)


def jax_dev(st):
    return {k: jnp.asarray(v) for k, v in st.items()
            if k in jsweeps.DEV_KEYS}


def exact_keep(ac_a, ac_b, altalt, cand, n_samples, min_r2):
    """[I, J] bool: candidate pairs the exact f64 filter keeps."""
    k, l = np.nonzero(cand)
    ac_a = ac_a[k].astype(np.int64)
    ac_b = ac_b[l].astype(np.int64)
    aa = altalt[k, l].astype(np.int64)
    counts = np.stack([2 * n_samples - ac_a - ac_b + aa, ac_b - aa,
                       ac_a - aa, aa], axis=1)
    z = np.zeros(len(k), np.int64)
    meta = PairMeta(pos_a=z, pos_b=z + 1, rid_a=z, rid_b=z, ac_a=ac_a,
                    ac_b=ac_b, an_a=z, an_b=z, hwe_a=np.ones(len(k)),
                    hwe_b=np.ones(len(k)))
    _, kept = phased_math(counts, meta, LdFilters(min_r2=min_r2))
    out = np.zeros(cand.shape, bool)
    out[k[kept], l[kept]] = True
    return out


def test_unpack_bits_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, size=(3, 8), dtype=np.uint32)
    want = np.asarray(JK.unpack_bits(jnp.asarray(x)))
    got = K.unpack_bits(torch.from_numpy(x.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("i,j,diag", [(0, 0, True), (0, 1, False),
                                      (1, 1, True)])
def test_tile_matches_jax_and_pallas(i, j, diag):
    st = stacked_planes(7)
    jdev = jax_dev(st)
    dev = sweeps.planes_to_device(st, "cpu")
    jcfg = jsweeps.make_cfg("phased", False, "all", B, N_SAMPLES, 0,
                            MIN_R2, 100.0)
    cfg = sweeps.make_cfg("phased", False, "all", B, N_SAMPLES, 0,
                          MIN_R2, 100.0)
    args = (jdev, jnp.int32(i), jnp.int32(j), jnp.asarray(diag))
    pf_x, m_x, (aa_x,) = jsweeps.tile_prefilter(*args, jcfg)
    pf_p, m_p, (aa_p,) = PT.tile_prefilter_pallas(*args, jcfg,
                                                  interpret=True)
    mask, parts = tiles.tile_prefilter(dev, i, j, diag, cfg)
    assert parts.shape == (1, B, B)
    mask, altalt = mask.numpy(), parts[0].numpy()
    (aa_k,) = K.phased_parts_tile(dev["alt_bits"][i], dev["alt_bits"][j])
    (aa_j,) = JK.phased_parts_tile(jdev["alt_bits"][i], None,
                                   jdev["alt_bits"][j], None, False)
    for want in (aa_x, aa_p, aa_j):
        np.testing.assert_array_equal(altalt, np.asarray(want))
    np.testing.assert_array_equal(aa_k.numpy(), altalt)
    for want in (m_x, m_p):
        np.testing.assert_array_equal(mask >= 1, np.asarray(want))
    keep = exact_keep(st["ac"][i], st["ac"][j], altalt, mask >= 1,
                      N_SAMPLES, MIN_R2)
    pf = mask == 2
    assert keep.any()
    assert not (keep & ~pf).any(), "prefilter dropped an exact survivor"
    for want in (pf_x, pf_p):
        assert not ((pf ^ np.asarray(want)) & keep).any()


def test_prefilter_never_drops_exact_survivors():
    """The port's f32 prefilter is conservative wrt the f64 filter (the
    check of tests/test_kernels.py on the port's functions)."""
    rng = np.random.default_rng(5)
    n_samples = 64
    rows_a = _random_rows(rng, 12, n_samples, 0.0)
    # B rows are noisy copies of A rows (hap A allele flipped at 10% of
    # samples), so some pairs are in real LD
    rows_b = [r ^ ((rng.random(n_samples) < 0.1) << 2).astype(np.uint8)
              for r in rows_a]
    pa = _block_from_codes(rows_a)
    pb = _block_from_codes(rows_b)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    ac_a, ac_b = t(pa.ac), t(pb.ac)
    parts = K.phased_parts_tile(t(pa.alt_bits.view(np.int32)),
                                t(pb.alt_bits.view(np.int32)))
    pm = K.pair_mask_tile(t(pa.valid), t(pb.valid), ac_a, ac_b, False)
    cells = K.phased_cells(parts, ac_a, ac_b, n_samples)
    dev_mask = K.phased_prefilter_cells(cells, pm, 0.1, 100.0).numpy()
    keep = exact_keep(pa.ac, pb.ac, parts[0].numpy(), pm.numpy(),
                      n_samples, 0.1)
    assert keep.any()
    assert not (keep & ~dev_mask).any()


@pytest.mark.parametrize("density,cap", [(0.2, 64), (0.01, 64),
                                         (0.5, 4096)])
def test_compact_indices_matches_jax(density, cap):
    rng = np.random.default_rng(4)
    mask = rng.random((64, 64)) < density
    n_j, idx_j = JK.compact_indices_small(jnp.asarray(mask), cap)
    n_p, idx_p = K.compact_indices_small(torch.from_numpy(mask), cap)
    assert int(n_p) == int(n_j) == mask.sum()
    k = min(int(n_j), cap)
    np.testing.assert_array_equal(idx_p.numpy()[:k], np.asarray(idx_j)[:k])


@pytest.mark.parametrize("off0,cap", [(5, 16), (60, 16), (0, 1024)])
def test_compact_survivors_contract(off0, cap):
    """First min(n, cap) survivors in ascending flat index at row
    min(off, outcap - cap); counts written; offset advanced and clamped
    at outcap. CPU tensors take the plain version, never the kernel."""
    rng = np.random.default_rng(11)
    Bt, outcap = 40, 1024 if cap == 1024 else 64
    mask = torch.from_numpy(rng.choice(3, size=(Bt, Bt),
                                       p=[0.6, 0.3, 0.1]).astype(np.uint8))
    altalt = torch.from_numpy(
        rng.integers(0, 500, size=(Bt, Bt)).astype(np.int32))
    buf = torch.full((outcap, 2), -7, dtype=torch.int32)
    n_pass = torch.zeros(3, dtype=torch.int32)
    n_cand = torch.zeros(3, dtype=torch.int32)
    off = torch.tensor([off0], dtype=torch.int32)
    _build.reset_counts()
    sweeps.compact_survivors(mask, altalt[None], off, buf, n_pass, n_cand,
                             1, cap)
    assert _build.PLAIN_CALLS["compact"] == 1
    assert _build.LAUNCHES["compact"] == 0
    flat = np.flatnonzero(mask.numpy().ravel() == 2)
    n = len(flat)
    k = min(n, cap)
    base = min(off0, outcap - cap)
    want = np.stack([flat[:k], altalt.numpy().ravel()[flat[:k]]], axis=1)
    np.testing.assert_array_equal(buf.numpy()[base:base + k], want)
    assert (buf.numpy()[:base] == -7).all()
    assert (buf.numpy()[base + k:] == -7).all()
    assert n_pass.tolist() == [0, n, 0]
    assert n_cand.tolist() == [0, int((mask != 0).sum()), 0]
    assert int(off) == min(off0 + n, outcap)


def test_wrappers_reject_other_devices():
    st = stacked_planes(3, n_blocks=1)
    dev = {k: v.to("meta") for k, v in
           sweeps.planes_to_device(st, "cpu").items()}
    cfg = sweeps.make_cfg("phased", False, "all", B, N_SAMPLES, 0,
                          MIN_R2, 100.0)
    with pytest.raises(ValueError):
        tiles.tile_prefilter(dev, 0, 0, True, cfg)
    m = torch.zeros((4, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        sweeps.compact_survivors(m, m.int(), None, None, None, None, 0, 1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_tile_kernel_matches_plain_on_card():
    dev = sweeps.planes_to_device(stacked_planes(7), _card())
    cfg = sweeps.make_cfg("phased", False, "all", B, N_SAMPLES, 0,
                          MIN_R2, 100.0)
    for i, j, diag in [(0, 0, True), (0, 1, False)]:
        mask, parts = tiles.tile_prefilter(dev, i, j, diag, cfg)
        want_m, want_p = tiles.tile_prefilter_plain(dev, i, j, diag, cfg)
        assert torch.equal(mask, want_m) and torch.equal(parts, want_p)


@pytest.mark.gpu
def test_compact_kernel_matches_plain_on_card():
    card = _card()
    rng = np.random.default_rng(2)
    Bt, cap, outcap = 300, 512, 4096
    mask = torch.from_numpy(rng.choice(3, size=(Bt, Bt),
                                       p=[0.7, 0.29, 0.01]).astype(np.uint8))
    altalt = torch.from_numpy(
        rng.integers(0, 500, size=(Bt, Bt)).astype(np.int32))
    # the kernel reads the counts the tile kernels write beside the mask
    counts = tiles.tile_counts_plain(mask.to(card))
    with pytest.raises(ValueError, match="counts"):
        sweeps.compact_survivors(mask.to(card), altalt[None].to(card),
                                 *[torch.zeros(1, dtype=torch.int32,
                                               device=card)] * 4, 0, cap)
    outs = []
    for fn in (lambda *a: sweeps.compact_survivors(*a, counts),
               sweeps.compact_survivors_plain):
        bufs = [torch.zeros((outcap, 2), dtype=torch.int32, device=card),
                torch.zeros(2, dtype=torch.int32, device=card),
                torch.zeros(2, dtype=torch.int32, device=card),
                torch.tensor([100], dtype=torch.int32, device=card)]
        for t in range(2):
            fn(mask.to(card), altalt[None].to(card), bufs[3], bufs[0],
               bufs[1], bufs[2], t, cap)
        outs.append([b.cpu() for b in bufs])
    for got, want in zip(*outs):
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dprime", [(), (0.5, 0.95)],
                         ids=["dprime_off", "dprime_on"])
@pytest.mark.parametrize("miss", [False, True], ids=["kind1", "kind2"])
def test_parts_tile_screen_on_card(miss, dprime):
    """parts_tile's unphased instances on a tile near the r2 floor by
    construction: mask, parts and counts bit for bit the plain version's,
    and the screen counter (candidates screened, undecided) the plain
    twin's; chip_smoke.py's kernel checks then still pass (its
    compare_screen is this check at B = 4096)."""
    import chip_smoke
    from tomahawk_tpu_torch import workloads
    Bt, n_samples = 256, 600
    dev = sweeps.planes_to_device(
        workloads.threshold_planes(1, Bt, n_samples, group=32), _card())
    cfg = sweeps.make_cfg("unphased", miss, "all", Bt, n_samples, 0, 0.1,
                          100.0, *dprime)
    screen = torch.zeros(2, dtype=torch.int64, device="cuda")
    want_s = torch.zeros(2, dtype=torch.int64, device="cuda")
    for diag in (False, True):
        counts = tiles.counts_buffer(cfg, "cuda")
        mask, parts = tiles.tile_prefilter(dev, 0, 0, diag, cfg,
                                           counts=counts, screen=screen)
        want_m, want_p = tiles.tile_prefilter_plain(dev, 0, 0, diag, cfg)
        assert torch.equal(mask, want_m) and torch.equal(parts, want_p)
        assert torch.equal(counts, tiles.tile_counts_plain(mask))
        want_s += tiles.tile_screen_plain(dev, 0, 0, diag, cfg, want_p)
    assert torch.equal(screen, want_s)
    assert 0 < int(screen[1]) < int(screen[0])
    chip_smoke.build_kernels()
    chip_smoke.compare_groups()
    chip_smoke.compare_screen()
