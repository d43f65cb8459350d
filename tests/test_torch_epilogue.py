"""The samples-sharded sweep's epilogue (`tiles.tile_epilogue`) with its
counts buffer against the JAX package: the mask and the per-segment
counts the compaction reads, from the parts summed over two word slices,
against the JAX tile's (pf, m) on the XLA path and a numpy count of that
mask, in every (table, has_missing) kind, pair class, window and D' case,
on a diagonal and an off-diagonal tile. The CUDA kernel is compared with
its plain version by the `gpu` test in tests/test_torch_dist.py, which
runs only where torch sees a card."""

import numpy as np
import pytest
import torch

# first: binds libzstd where the zstandard package is missing
import tomahawk_tpu_torch  # noqa: F401

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from tomahawk_tpu.compute import sweeps as jsweeps

from tomahawk_tpu_torch.compute import sweeps
from tomahawk_tpu_torch.ops import _build, tiles

from test_torch_ld_kernels import jax_dev
from test_torch_window import N_SAMPLES, window_planes

#: 192 rows: two counts segments a row, the second one cut short
B, MIN_R2 = 192, 0.05
KINDS = [("phased", False), ("phased", True), ("unphased", False),
         ("unphased", True)]
#: positions 2,500 bp apart, so a 250 kb window cuts inside a tile
SPACING, WINDOW = 2500, 250_000
DPRIME = (0.9, 0.95)


def numpy_counts(mask):
    """int32 [B, ceil(B / 128)]: n_survivors | n_candidates << 16 of each
    128-column segment of each row of a 0/1/2 mask."""
    rows = mask.shape[0]
    n_seg = -(-mask.shape[1] // 128)
    m = np.zeros((rows, n_seg * 128), np.int64)
    m[:, :mask.shape[1]] = mask
    m = m.reshape(rows, n_seg, 128)
    return ((m == 2).sum(2) | ((m != 0).sum(2) << 16)).astype(np.int32)


@pytest.mark.parametrize("dprime", [False, True], ids=["dp-off", "dp-on"])
@pytest.mark.parametrize("window", [0, WINDOW])
@pytest.mark.parametrize("cls", ["all", "clean", "missing"])
@pytest.mark.parametrize("kind", KINDS, ids=["-".join(map(str, k))
                                             for k in KINDS])
def test_epilogue_counts_match_jax_mask(kind, cls, window, dprime):
    st = window_planes(11, spacing=SPACING, B=B)
    dp = DPRIME if dprime else (0.0, 100.0)
    args = (*kind, cls, B, N_SAMPLES, window, MIN_R2, 100.0)
    cfg = sweeps.make_cfg(*args, *dp)
    jcfg = jsweeps.make_cfg(*args, min_dprime=dp[0], max_dprime=dp[1])
    keys = sweeps.dev_keys_for(cfg)
    devs = [sweeps.planes_to_device(st, "cpu", keys, word_slice=(s, 2))
            for s in range(2)]
    seen = set()
    for i, j, diag in ((0, 0, True), (0, 1, False)):
        out = tiles.tile_buffers(cfg, "cpu")
        total = torch.zeros_like(out[1])
        for dev in devs:
            total += tiles.tile_local_parts(dev, i, j, cfg, out)
        out[1].copy_(total)
        counts = tiles.counts_buffer(cfg, "cpu").fill_(-1)
        _build.reset_counts()
        mask, _ = tiles.tile_epilogue(devs[0], i, j, diag, cfg, out, counts)
        assert _build.PLAIN_CALLS["tile_epilogue"] == 1
        pf, m, _ = jsweeps.tile_prefilter(
            jax_dev(st), jnp.int32(i), jnp.int32(j), jnp.asarray(diag), jcfg)
        want = np.asarray(m).astype(np.int64) + np.asarray(pf)
        np.testing.assert_array_equal(mask.numpy(), want)
        np.testing.assert_array_equal(counts.numpy(), numpy_counts(want))
        seen |= set(np.unique(want).tolist())
    assert 1 in seen and (cls == "clean" or 2 in seen)


def test_epilogue_refuses_a_wrong_counts_buffer():
    st = window_planes(11, B=B)
    cfg = sweeps.make_cfg("phased", False, "all", B, N_SAMPLES, 0, MIN_R2,
                          100.0)
    dev = sweeps.planes_to_device(st, "cpu", sweeps.dev_keys_for(cfg))
    out = tiles.tile_buffers(cfg, "cpu")
    tiles.tile_local_parts(dev, 0, 1, cfg, out)
    for bad in (torch.zeros((B, 1), dtype=torch.int32),
                torch.zeros((B, 2), dtype=torch.int64)):
        with pytest.raises(ValueError, match="counts"):
            tiles.tile_epilogue(dev, 0, 1, False, cfg, out, bad)
