"""The port's unphased engine at biobank width, on the CPU: UK Biobank's
488,377 samples (15,264 words a sample plane), the last width the
unphased prefilter's division-free screen takes (2**19 samples) and the
first it declines (2**19 + 1), with missing calls on every variant.

Each case runs `LdEngine` + `dispatch_pairs` in mode `unphased` over two
super-blocks of LD-grouped genotype planes (groups whose copies flip
0-25% of their alleles, so r2 spreads across the 0.1 floor) on every
tile of the region, diagonal ones included, and holds the records to
the JAX package's engine on the same planes: every field equal, P
within 1e-4 of its size. The `engine.group` span of the P = 9 group
carries the screen's counts, which must equal the plain statement's
(`tiles.tile_screen_plain`) over the group's tiles: all undecided where
the screen declines.

On the card (marked `gpu`): `parts_tile` P = 9 at 488,377 samples and
B = 4096, on an off-diagonal and a diagonal tile of the benchmark's
spectrum with 1% missing calls, against the plain version bit for bit,
its screen counts against the plain counts. The file imports no jax at
module level, so that test runs where only the port is installed."""

import numpy as np
import pytest
import torch

from tomahawk_tpu_torch import spans, workloads
from tomahawk_tpu_torch.compute import sweeps
from tomahawk_tpu_torch.compute.engine import (CalcSettings, LdEngine,
                                               dispatch_pairs)
from tomahawk_tpu_torch.ops import tiles
from tomahawk_tpu_torch.ops.bitpack import words_for
from tomahawk_tpu_torch.ops.ld_math import LdFilters

UKB = 488377
B = 32
B_CARD = 4096
MIN_R2 = 0.1
SEED = 2 ** 33 + 22
TILES = [(i, j, i == j) for i in range(2) for j in range(i, 2)]


def _records(engine, stacked, filt):
    out = []
    try:
        dispatch_pairs(engine, TILES, "unphased", filt,
                       lambda r, rev=None: out.append(r.copy()), stacked)
    finally:
        if hasattr(engine, "stage_close"):
            engine.stage_close()
    recs = np.concatenate(out)
    return np.sort(recs, order=[f for f in recs.dtype.names if f != "P"])


@pytest.mark.parametrize("n_samples", [UKB, 1 << 19, (1 << 19) + 1])
def test_biobank_width_matches_reference(n_samples):
    je = pytest.importorskip("tomahawk_tpu.compute.engine")
    from tomahawk_tpu.ops.ld_math import LdFilters as JaxLdFilters
    stacked = workloads.genotype_planes(
        2, B, n_samples, miss_frac=0.01, seed=SEED % 1000, group=8,
        flip=np.linspace(0.0, 0.25, B), miss_rows=1.0)
    assert stacked["has_missing"].all()
    assert stacked["het_bits"].shape[-1] == words_for(n_samples)
    engine = LdEngine(stacked, n_samples, CalcSettings(min_r2=MIN_R2),
                      device="cpu")
    cfg = engine._cfg("unphased", True, "all")
    with spans.recording():
        got = _records(engine, stacked, LdFilters(min_r2=MIN_R2))
    groups = [s for s in spans.collect() if s.name == "engine.group"
              and s.attrs["tiles"]]
    assert len(groups) == 1

    # the screen's counts of the group, as the plain statement counts
    dev = sweeps.planes_to_device(stacked, "cpu")
    want = torch.zeros(2, dtype=torch.int64)
    for i, j, diag in TILES:
        parts = tiles.tile_local_parts_plain(dev, i, j, cfg)
        want += tiles.tile_screen_plain(dev, i, j, diag, cfg, parts)
    attrs = groups[0].attrs
    assert (attrs["screened"], attrs["undecided"]) == tuple(want.tolist())
    # every pair is a candidate: no variant is that rare
    assert attrs["screened"] == B * (B - 1) + B * B
    if n_samples > 1 << 19:
        assert attrs["undecided"] == attrs["screened"]
    else:
        assert 0 < attrs["undecided"] < attrs["screened"] // 4

    want = _records(je.LdEngine(stacked, n_samples,
                                je.CalcSettings(min_r2=MIN_R2)),
                    stacked, JaxLdFilters(min_r2=MIN_R2))
    assert len(got) == len(want) > 50
    for f in got.dtype.names:
        if f != "P":
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    gap = np.abs(got["P"] - want["P"]) / np.maximum(want["P"], 1e-250)
    assert gap.max() <= 1e-4


def _pack(bits):
    """bool [n, L] -> int32 [n, words_for(L)] on its device (bit k of
    word w: column 32 w + k)."""
    n, L = bits.shape
    W = words_for(L)
    full = torch.zeros((n, W * 32), dtype=torch.bool, device=bits.device)
    full[:, :L] = bits
    full = full.view(n, W, 32)
    out = torch.zeros((n, W), dtype=torch.int32, device=bits.device)
    for k in range(32):
        out |= full[:, :, k].to(torch.int32) << k
    return out


def card_planes(seed, n_samples, n_blocks, device):
    """The sweep's device tensors of `n_blocks` super-blocks of B_CARD
    unphased variants: frequencies Beta(0.5, 2) x 0.5 + 0.001 (capped at
    0.5), Hardy-Weinberg genotypes, 1% of each variant's calls
    missing."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {k: [] for k in ("het_bits", "hom_bits", "valid_bits", "n_het",
                           "n_hom")}
    for _ in range(n_blocks):
        p = torch.from_numpy(np.minimum(
            rng.beta(0.5, 2.0, B_CARD) * 0.5 + 0.001, 0.5)).to(device)
        het, hom, called = [], [], []
        for r0 in range(0, B_CARD, 256):
            pp = p[r0:r0 + 256, None].float()
            u = torch.rand((len(pp), n_samples), generator=gen,
                           device=device)
            c = torch.rand((len(pp), n_samples), generator=gen,
                           device=device) >= 0.01
            g = ((u < pp * pp).to(torch.int8)
                 + (u < 2 * pp - pp * pp).to(torch.int8)) * c
            het.append(_pack(g == 1))
            hom.append(_pack(g == 2))
            called.append(_pack(c))
            out["n_het"].append((g == 1).sum(1, dtype=torch.int32))
            out["n_hom"].append((g == 2).sum(1, dtype=torch.int32))
        for k, v in (("het_bits", het), ("hom_bits", hom),
                     ("valid_bits", called)):
            out[k].append(torch.cat(v))
    dev = {k: torch.stack(out[k]) for k in ("het_bits", "hom_bits",
                                            "valid_bits")}
    for k in ("n_het", "n_hom"):
        dev[k] = torch.cat(out[k]).view(n_blocks, B_CARD)
    dev["ac"] = dev["n_het"] + 2 * dev["n_hom"]
    dev["valid"] = torch.ones((n_blocks, B_CARD), dtype=torch.bool,
                              device=device)
    return dev


@pytest.mark.gpu
def test_parts_tile_matches_plain_at_biobank_width_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda")
    dev = card_planes(SEED, UKB, 2, card)
    assert dev["het_bits"].shape[-1] == 15264
    cfg = sweeps.make_cfg("unphased", True, "all", B_CARD, UKB, 0, MIN_R2,
                          100.0)
    for i, j, diag in [(0, 1, False), (1, 1, True)]:
        screen = torch.zeros(2, dtype=torch.int64, device=card)
        mask, parts = tiles.tile_prefilter(dev, i, j, diag, cfg,
                                           screen=screen)
        want_m, want_p = tiles.tile_prefilter_plain(dev, i, j, diag, cfg)
        assert torch.equal(mask, want_m) and torch.equal(parts, want_p)
        want_s = tiles.tile_screen_plain(dev, i, j, diag, cfg, want_p)
        assert torch.equal(screen, want_s)
        assert int(screen[0]) == int((mask != 0).sum())
