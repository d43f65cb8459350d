"""Window mode (`calc -w`) of the port against the JAX package, on the
same numpy planes and the same archives: the candidate mask with the
window term; the whole tile against the XLA path and the fused TPU
kernel (Pallas interpret mode, dead blocks included); the numpy
statement of the dead-block test the CUDA kernels run; the sweeps over
`Balancer.window_pairs`; `compute_ld` and the CLI with `-w` in every
mode. The CUDA kernels are compared with their plain versions by the
`gpu` tests, which run only where torch sees a card."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

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

from tomahawk_tpu_torch import cli
from tomahawk_tpu_torch.compute import sweeps
from tomahawk_tpu_torch.compute.balancer import Balancer
from tomahawk_tpu_torch.compute.engine import CalcSettings, compute_ld
from tomahawk_tpu_torch.ops import _build, tiles
from tomahawk_tpu_torch.ops import ld_kernels as K
from tomahawk_tpu_torch.workloads import super_ranges

from test_importer import make_vcf
from test_torch_groups import GROUPS, GROUP_IDS, group_planes
from test_torch_ld_kernels import jax_dev
from test_torch_sweeps import intact

B, N_SAMPLES, MIN_R2 = 256, 100, 0.05
ALL_GROUPS = [("phased", False, "all")] + GROUPS
ALL_IDS = ["phased-False-all"] + GROUP_IDS
KEYS = ("ridA", "packA", "ridB", "packB")


def window_planes(seed, n_blocks=2, spacing=50, two_contigs=False, B=B):
    """group_planes with positions ascending across the blocks' real
    rows, `spacing` bp apart. With two_contigs the rows alternate
    between contigs 0 and 1 in stripes of 8 (a layout the engine never
    builds; the mask and the dead-block test must hold on it all the
    same). Padding rows keep pos = rid = 0 and valid = 0."""
    st = group_planes(seed, n_blocks, B, N_SAMPLES)
    rank = np.cumsum(st["valid"].reshape(-1)).reshape(n_blocks, B)
    pos = 1000 + spacing * rank
    st["pos"] = np.where(st["valid"], pos, 0).astype(np.int32)
    if two_contigs:
        st["rid"] = np.where(st["valid"], (np.arange(B) // 8 % 2)[None, :],
                             0).astype(np.int32)
    return st


def cfg_pair(group, window, B=B):
    table, miss, cls = group
    args = (table, miss, cls, B, N_SAMPLES, window, MIN_R2, 100.0)
    return sweeps.make_cfg(*args), jsweeps.make_cfg(*args)


# -- (1) the candidate mask ----------
@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("cls", ["all", "clean", "missing"])
def test_pair_mask_window_matches_jax(cls, diag):
    st = window_planes(5, two_contigs=True)
    window = 700
    t = lambda k, s: torch.from_numpy(st[k][s])
    i, j = (0, 0) if diag else (0, 1)
    got = K.pair_mask_tile(t("valid", i), t("valid", j), t("ac", i),
                           t("ac", j), diag, cls, t("an", i), t("an", j),
                           window, t("pos", i), t("pos", j), t("rid", i),
                           t("rid", j))
    want = jsweeps.tile_mask(jax_dev(st), i, j, jnp.asarray(diag), B,
                             window, cls)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()
    # the window really cuts: the same mask without it holds more pairs
    wide = K.pair_mask_tile(t("valid", i), t("valid", j), t("ac", i),
                            t("ac", j), diag, cls, t("an", i), t("an", j))
    assert int(wide.sum()) > int(got.sum())


# -- (2) the whole tile ----------
def _assert_tile(group, st, window, i, j, diag):
    """The port's plain tile against the XLA path (every lane) and the
    fused TPU kernel in interpret mode (mask on every lane, parts where
    the mask is not 0: dead blocks leave theirs unwritten)."""
    cfg, jcfg = cfg_pair(group, window)
    dev = sweeps.planes_to_device(st, "cpu", sweeps.dev_keys_for(cfg))
    assert ("pos" in dev) == ("rid" in dev) == (window > 0)
    args = (jax_dev(st), jnp.int32(i), jnp.int32(j), jnp.asarray(diag))
    pf_x, m_x, parts_x = jsweeps.tile_prefilter(*args, jcfg)
    pf_p, m_p, parts_p = PT.tile_prefilter_pallas(*args, jcfg,
                                                  interpret=True)
    mask, parts = (x.numpy() for x in
                   tiles.tile_prefilter(dev, i, j, diag, cfg))
    for want in (m_x, m_p):
        np.testing.assert_array_equal(mask >= 1, np.asarray(want))
    for want in (pf_x, pf_p):
        np.testing.assert_array_equal(mask == 2, np.asarray(want))
    for got, w in zip(parts, parts_x):
        np.testing.assert_array_equal(got, np.asarray(w))
    on = mask >= 1
    assert len(parts_p) == len(parts)
    for got, w in zip(parts, parts_p):
        np.testing.assert_array_equal(got[on], np.asarray(w)[on])
    return mask


@pytest.mark.parametrize("i,j,diag", [(0, 0, True), (0, 1, False)])
@pytest.mark.parametrize("group", ALL_GROUPS, ids=ALL_IDS)
def test_window_tile_matches_jax_and_pallas(group, i, j, diag):
    """The window case of tests/test_pallas_tiles.py (window 300 over
    positions 50 bp apart) for every sweep group."""
    mask = _assert_tile(group, window_planes(7), 300, i, j, diag)
    assert (mask >= 1).any() and (mask >= 1).mean() < 0.1


@pytest.mark.parametrize("i,j,diag", [(0, 0, True), (0, 1, False)])
@pytest.mark.parametrize("group", [("phased", False, "all"),
                                   ("unphased", True, "missing")],
                         ids=["phased-False-all", "unphased-True-missing"])
def test_window_block_skip_matches_jax_and_pallas(group, i, j, diag,
                                                  monkeypatch):
    """tests/test_pallas_tiles.py::test_window_block_skip with
    candidates: rows 10 bp apart inside each 128-row block, the blocks
    100 kb apart, so every pair of distinct blocks is further apart
    than the window and the TPU kernel skips those blocks."""
    monkeypatch.setenv("TWK_PALLAS_MAX_BM", "128")
    st = window_planes(3)
    row = np.arange(B)
    pos = (row // 128 * 100_000 + row % 128 * 10)[None, :] \
        + np.array([[0], [10**6]])
    st["pos"] = np.where(st["valid"], pos, 0).astype(np.int32)
    mask = _assert_tile(group, st, 300, i, j, diag)
    assert not (mask[:128, 128:] >= 1).any()
    assert (mask >= 1).any() == diag


# -- (3) the dead-block test ----------
def _brute_mask(valid_i, valid_j, pos_i, pos_j, rid_i, rid_j, window, diag):
    m = valid_i[:, None] & valid_j[None, :]
    m &= rid_i[:, None] == rid_j[None, :]
    m &= np.abs(pos_i[:, None].astype(np.int64)
                - pos_j[None, :].astype(np.int64)) <= window
    if diag:
        m &= (np.arange(len(valid_i))[:, None]
              < np.arange(len(valid_j))[None, :])
    return m


def _side(n, max_pos):
    return hst.tuples(
        hst.lists(hst.integers(0, max_pos), min_size=n, max_size=n),
        hst.lists(hst.integers(0, 2), min_size=n, max_size=n),
        hst.lists(hst.booleans(), min_size=n, max_size=n))


@settings(max_examples=300, deadline=None)
@given(data=hst.data(), rows=hst.sampled_from([4, 8, 16]),
       cols=hst.sampled_from([4, 8]), window=hst.integers(1, 400),
       diag=hst.booleans(), sort=hst.booleans(), one_rid=hst.booleans(),
       kill=hst.booleans())
def test_block_live_never_kills_a_candidate(data, rows, cols, window, diag,
                                            sort, one_rid, kill):
    """Over drawn pos / rid / valid (sorted or not, one contig or
    several, whole blocks invalid or not) a block `block_live` marks
    dead holds no pair of the window mask; a block with an invalid side
    is dead."""
    n = 32
    sides = []
    for _ in range(2):
        pos, rid, valid = (np.array(x) for x in data.draw(_side(n, 2000)))
        if sort:
            pos = np.sort(pos)
        if one_rid:
            rid[:] = 0
        valid = valid.astype(bool)
        if kill:
            valid[:rows] = False
        sides.append((valid, pos.astype(np.int32), rid.astype(np.int32)))
    (vi, pi, ri), (vj, pj, rj) = sides
    live = K.block_live(vi, vj, pi, pj, ri, rj, window, rows, cols, diag)
    assert live.shape == (n // rows, n // cols)
    mask = _brute_mask(vi, vj, pi, pj, ri, rj, window, diag)
    has = mask.reshape(n // rows, rows, n // cols, cols).any(axis=(1, 3))
    assert not (has & ~live).any()
    if kill:
        assert not live[0].any()
    # one block over the whole tile: the TPU kernel's own granularity
    whole = K.block_live(vi, vj, pi, pj, ri, rj, window, diag=diag)
    assert whole.shape == (1, 1) and (whole[0, 0] or not mask.any())


def test_block_live_kills_far_blocks_only_on_one_contig():
    """Blocks further apart than the window die on one shared contig
    and stay live when a side spans two contigs (the pos test is then
    unsound, so the TPU kernel keeps such blocks)."""
    v = np.ones(16, bool)
    pos = np.arange(16, dtype=np.int32) * 100
    rid = np.zeros(16, np.int32)
    live = K.block_live(v, v, pos, pos, rid, rid, 150, 4, 4)
    want = np.abs(np.subtract.outer(np.arange(4), np.arange(4))) <= 1
    np.testing.assert_array_equal(live, want)
    rid2 = rid.copy()
    rid2[::4] = 1                       # every block holds both contigs
    assert K.block_live(v, v, pos, pos, rid2, rid2, 150, 4, 4).all()
    # disjoint contigs never meet
    assert not K.block_live(v, v, pos, pos, rid, rid + 1, 10**6, 4, 4).any()
    # a diagonal tile's blocks wholly below the diagonal are dead
    diag = K.block_live(v, v, pos, pos, rid, rid, 10**6, 4, 4, diag=True)
    np.testing.assert_array_equal(diag, np.triu(np.ones((4, 4), bool)))


# -- (4) the sweeps over window_pairs ----------
@pytest.mark.parametrize("group", [("phased", False, "all"),
                                   ("phased", True, "all"),
                                   ("unphased", True, "missing")],
                         ids=["phased-False-all", "phased-True-all",
                              "unphased-True-missing"])
def test_window_sweeps_match_jax(group):
    """count_sweep and fused_sweep over the tile list window_pairs
    keeps: per-tile counts and the survivor rows of intact tiles
    bit-identical to the JAX sweeps."""
    Bs, window = 128, 2500
    st = window_planes(11, n_blocks=4, B=Bs)
    pairs = Balancer.build(4).window_pairs(*super_ranges(st), window)
    assert 4 < len(pairs) < 10          # some tile pairs are dropped
    pi = np.array([p[0] for p in pairs], np.int32)
    pj = np.array([p[1] for p in pairs], np.int32)
    dg = np.array([p[2] for p in pairs], bool)
    live = np.ones(len(pairs), bool)
    cfg, jcfg = cfg_pair(group, window, Bs)
    dev = sweeps.planes_to_device(st, "cpu", sweeps.dev_keys_for(cfg))
    jdev = jax_dev(st)
    cn, cnc = (x.numpy() for x in sweeps.count_sweep(dev, pi, pj, dg, live,
                                                     cfg=cfg))
    jn, jnc = (np.asarray(x) for x in
               jsweeps.jit_count_sweep(jcfg)(jdev, pi, pj, dg, live))
    np.testing.assert_array_equal(cn, jn)
    np.testing.assert_array_equal(cnc, jnc)
    assert 0 < cnc.sum() < len(pairs) * Bs * Bs // 4
    cap, outcap = 2048, 1 << 15
    n, nc, buf = (x.numpy() for x in sweeps.fused_sweep(
        dev, pi, pj, dg, live, cfg=cfg, cap=cap, outcap=outcap))
    _, _, jbuf = (np.asarray(x) for x in jsweeps.jit_fused_sweep(
        jcfg, cap, outcap)(jdev, pi, pj, dg, live))
    np.testing.assert_array_equal(n, jn)
    np.testing.assert_array_equal(nc, jnc)
    offs, ok = intact(n, cap, outcap)
    assert (ok & (n > 0)).any()
    for t in np.flatnonzero(ok & (n > 0)):
        lo, hi = offs[t], offs[t] + n[t]
        np.testing.assert_array_equal(buf[lo:hi], jbuf[lo:hi])


# -- (5) calc -w as a whole ----------
MODES = {"mixed": dict(), "phased": dict(force_phased=True),
         "unphased": dict(forced_unphased=True)}
FLAGS = {"mixed": [], "phased": ["-p"], "unphased": ["-u"]}
WINDOW = 6000        # ~22 sites of make_vcf's 50-500 bp spacing


def _records(path):
    r = TwoReader(path)
    recs = r.records()
    r.close()
    return np.sort(recs, order=KEYS)


def _assert_close(a, b):
    """Equal record streams within the repo's 1e-5 guard: integer
    fields and counts exact, statistics to 1e-5 absolute."""
    assert len(a) == len(b) > 0
    for f in a.dtype.names:
        if a.dtype[f].kind == "f" and f != "cnt":
            np.testing.assert_allclose(a[f], b[f], rtol=0, atol=1e-5,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """Two contigs, 420 sites in 64-variant blocks: without missing
    genotypes, and with 5%."""
    d = tmp_path_factory.mktemp("torch_window")
    out = {}
    for name, miss in (("clean", 0.0), ("missing", 0.05)):
        vcf = str(d / f"{name}.vcf")
        make_vcf(vcf, n_samples=40, n_sites=420, seed=31, miss_frac=miss,
                 contigs=("20", "21"))
        twk = str(d / f"{name}.twk")
        import_vcf(ImportSettings(input=vcf, output=twk, block_size=64,
                                  threshold_miss=0.5))
        out[name] = twk
    return out


@pytest.fixture(scope="module")
def jax_window_records(archives, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("TWK_DEVICE_FISHER", "0")
    d = tmp_path_factory.mktemp("torch_window_ref")
    out = {}
    try:
        for name, twk in archives.items():
            for mode, kw in MODES.items():
                path = str(d / f"jax_{name}_{mode}.two")
                jax_compute_ld(JaxCalcSettings(
                    input=twk, output=path, min_r2=MIN_R2, tile_rows=128,
                    window=True, l_window=WINDOW, mesh="off",
                    backend="device", **kw))
                out[name, mode] = _records(path)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["clean", "missing"])
def test_calc_window_matches_jax(archives, jax_window_records, tmp_path,
                                 name, mode):
    """compute_ld with a window against the JAX compute_ld, and against
    a brute-force position filter of the port's own all-vs-all run."""
    out = str(tmp_path / "w.two")
    _build.reset_counts()
    res = compute_ld(CalcSettings(
        input=archives[name], output=out, min_r2=MIN_R2, tile_rows=128,
        window=True, l_window=WINDOW, **MODES[mode]), device="cpu")
    got = _records(out)
    assert res.n_records == len(got)
    _assert_close(got, jax_window_records[name, mode])
    assert sum(_build.LAUNCHES.values()) == 0
    assert sum(_build.PLAIN_CALLS.values()) > 0

    full = str(tmp_path / "full.two")
    res_full = compute_ld(CalcSettings(
        input=archives[name], output=full, min_r2=MIN_R2, tile_rows=128,
        **MODES[mode]), device="cpu")
    allv = _records(full)
    dist = np.abs((allv["packA"] >> 2).astype(np.int64)
                  - (allv["packB"] >> 2).astype(np.int64))
    keep = (allv["ridA"] == allv["ridB"]) & (dist <= WINDOW)
    assert 0 < keep.sum() < len(allv)
    _assert_close(got, allv[keep])
    assert res.n_pairs < res_full.n_pairs


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_calc_window_matches_jax(archives, jax_window_records, tmp_path,
                                     mode):
    out = str(tmp_path / "cli.two")
    assert cli.main(["calc", "-i", archives["missing"], "-o", out, "-r",
                     str(MIN_R2), "--tile-rows", "128", "-w", str(WINDOW),
                     "--device", "cpu", *FLAGS[mode]]) == 0
    _assert_close(_records(out), jax_window_records["missing", mode])


def test_cli_rejects_non_positive_window(archives, tmp_path):
    for w in ("0", "-5", "0.5"):
        with pytest.raises(SystemExit, match="non-positive window"):
            cli.main(["calc", "-i", archives["clean"], "-o",
                      str(tmp_path / "x.two"), "-w", w, "--device", "cpu"])


# -- (6) chunking ----------
@pytest.mark.parametrize("entry", ["api", "cli"])
def test_window_with_chunking_raises(archives, tmp_path, entry):
    out = str(tmp_path / "x.two")
    with pytest.raises(ValueError, match="chunking in window mode"):
        if entry == "api":
            compute_ld(CalcSettings(input=archives["clean"], output=out,
                                    window=True, l_window=WINDOW,
                                    n_chunks=3, c_chunk=1), device="cpu")
        else:
            cli.main(["calc", "-i", archives["clean"], "-o", out, "-w",
                      str(WINDOW), "-c", "3", "-C", "1", "--device", "cpu"])


def test_make_cfg_takes_a_window_and_keys_follow():
    cfg = sweeps.make_cfg("phased", False, "all", 128, 64, 10_000, 0.1,
                          100.0)
    assert cfg["window"] == 10_000
    assert {"pos", "rid"} <= set(sweeps.dev_keys_for(cfg))
    cfg0 = sweeps.make_cfg("phased", False, "all", 128, 64, 0, 0.1, 100.0)
    assert not {"pos", "rid"} & set(sweeps.dev_keys_for(cfg0))
    for jcfg in (cfg, cfg0):
        assert sweeps.dev_keys_for(jcfg) == tuple(
            k for k in sweeps.DEV_KEYS if k in jsweeps.dev_keys_for(jcfg))
    with pytest.raises(ValueError, match="window"):
        sweeps.make_cfg("phased", False, "all", 128, 64, -1, 0.1, 100.0)


# -- on the card ----------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("two_contigs", [False, True])
@pytest.mark.parametrize("group", ALL_GROUPS, ids=ALL_IDS)
def test_window_kernel_matches_plain_on_card(group, two_contigs):
    """The CUDA window instances against their plain versions: mask on
    every lane, parts where the mask is not 0, and the thread blocks the
    kernel skipped (parts left as filled) equal to block_live's."""
    card = _card()
    st = window_planes(7, spacing=40, two_contigs=two_contigs)
    cfg, _ = cfg_pair(group, 1500)
    dev = sweeps.planes_to_device(st, card, sweeps.dev_keys_for(cfg))
    rows, cols = {1: (128, 128), 4: (64, 64), 9: (32, 64)}[
        tiles.payload_cols(*group[:2])]
    for i, j, diag in [(0, 0, True), (0, 1, False)]:
        out = tiles.tile_buffers(cfg, card)
        out[1].fill_(-1)
        mask, parts = tiles.tile_prefilter(dev, i, j, diag, cfg, out)
        want_m, want_p = tiles.tile_prefilter_plain(dev, i, j, diag, cfg)
        assert torch.equal(mask, want_m)
        on = (want_m != 0).unsqueeze(0)
        assert torch.equal(parts * on, want_p * on)
        live = K.block_live(st["valid"][i], st["valid"][j], st["pos"][i],
                            st["pos"][j], st["rid"][i], st["rid"][j],
                            cfg["window"], rows, cols, diag)
        skipped = (parts[0].view(B // rows, rows, B // cols, cols) == -1) \
            .all(dim=3).all(dim=1).cpu().numpy()
        np.testing.assert_array_equal(~skipped, live)
