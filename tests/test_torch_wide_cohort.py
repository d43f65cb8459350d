"""The port's phased engine at wide cohorts, on the CPU: the last width
inside the in-sweep Fisher gate (2N <= 2**15) and the first outside it,
the Haplotype Reference Consortium's 32,470 samples, and the first width
whose survivor payload no longer fits 16 bits (2N = 2**16).

Each case runs `LdEngine` + `dispatch_pairs` over two super-blocks of
LD-grouped planes on every tile of the region, diagonal ones included,
and holds the records to the JAX package's engine on the same planes:
every field equal, P within 1e-4 of its size. The groups are small
enough that a segment stays below `sweeps.FISHER_MIN_ROWS` survivors, so
every P is the host's exact scan on both sides of the gate. The route
each width takes is asserted: the engine's `_device_fisher`, the
payload's packing, and the `fisher` attribute of its `engine.group`
span.

On the card (marked `gpu`): the phased tile kernel at 32,470 samples and
B = 4096, on an off-diagonal and a diagonal tile of rare variants (exact
minor counts from the 1/k spectrum on [5, 32,470], as the HRC cell draws
them), against the plain version bit for bit. The file imports no jax at
module level, so that test runs where only the port is installed."""

import numpy as np
import pytest
import torch

from tomahawk_tpu_torch import spans
from tomahawk_tpu_torch.compute import sweeps
from tomahawk_tpu_torch.compute.engine import (CalcSettings, LdEngine,
                                               dispatch_pairs)
from tomahawk_tpu_torch.ops import tiles
from tomahawk_tpu_torch.ops.bitpack import (BlockPlanes, _pack_bits,
                                            stack_planes, words_for)
from tomahawk_tpu_torch.ops.ld_math import LdFilters

B = 256
B_CARD = 4096
MIN_R2 = 0.1
SEED = 2 ** 33 + 18


def block(alt, pos0):
    """BlockPlanes of the haplotype rows `alt` (bool [n, 2N]), no allele
    missing, positions 100 apart from pos0."""
    n, n_hap = alt.shape
    N = n_hap // 2
    Wh, Ws = words_for(n_hap), words_for(N)
    z = np.zeros((n, N), bool)
    return BlockPlanes(
        n_rec=n, alt_bits=_pack_bits(alt, Wh),
        miss_bits=_pack_bits(np.zeros_like(alt), Wh, pad_value=1),
        het_bits=_pack_bits(z, Ws), hom_bits=_pack_bits(z, Ws),
        valid_bits=_pack_bits(~z, Ws),
        pos=(pos0 + 100 * np.arange(n)).astype(np.int32),
        rid=np.zeros(n, np.int32), ac=alt.sum(axis=1).astype(np.int32),
        an=np.zeros(n, np.int32), n_het=np.zeros(n, np.int32),
        n_hom=np.zeros(n, np.int32), hwe=np.ones(n, np.float32),
        has_missing=np.zeros(n, bool), valid=np.ones(n, bool))


def grouped_planes(seed, n_samples, n_blocks=2, group=32, flip=0.02):
    """Records-dense planes: every `group` consecutive variants are noisy
    copies of one haplotype template."""
    rng = np.random.default_rng(seed)
    planes = []
    for b in range(n_blocks):
        base = rng.random((B // group, 2 * n_samples)) < 0.35
        alt = np.repeat(base, group, axis=0)
        alt ^= rng.random((B, 2 * n_samples)) < flip
        planes.append(block(alt, 1 + 100 * B * b))
    return stack_planes(planes)


def _records(engine, stacked, filt):
    out = []
    try:
        dispatch_pairs(engine, [(i, j, i == j) for i in range(2)
                                for j in range(i, 2)], "phased", filt,
                       lambda r, rev=None: out.append(r.copy()), stacked)
    finally:
        engine.stage_close()
    recs = np.concatenate(out)
    return np.sort(recs, order=[f for f in recs.dtype.names if f != "P"])


@pytest.mark.parametrize("n_samples", [16384, 16385, 32470, 32768])
def test_wide_cohort_matches_reference(n_samples):
    je = pytest.importorskip("tomahawk_tpu.compute.engine")
    from tomahawk_tpu.ops.ld_math import LdFilters as JaxLdFilters
    stacked = grouped_planes(SEED, n_samples)
    engine = LdEngine(stacked, n_samples, CalcSettings(min_r2=MIN_R2),
                      device="cpu")
    n_hap = 2 * n_samples
    in_sweep = n_hap <= 1 << 15
    cfg = engine._cfg("phased", False, "all")
    assert engine._device_fisher == in_sweep == sweeps.fisher_on(cfg)
    assert sweeps.pack16_ok(cfg) == (n_hap < 1 << 16)
    assert sweeps.buf_cols(cfg) == 2
    with spans.recording():
        got = _records(engine, stacked, LdFilters(min_r2=MIN_R2))
    groups = [s for s in spans.collect() if s.name == "engine.group"]
    assert groups and {g.attrs["fisher"] for g in groups} == {int(in_sweep)}

    want = _records(je.LdEngine(stacked, n_samples,
                                je.CalcSettings(min_r2=MIN_R2)),
                    stacked, JaxLdFilters(min_r2=MIN_R2))
    assert len(got) == len(want) > 2000
    for f in got.dtype.names:
        if f != "P":
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    gap = np.abs(got["P"] - want["P"]) / np.maximum(want["P"], 1e-250)
    assert gap.max() <= 1e-4


def mac_planes(seed, n_samples, n_blocks, device):
    """Rare variants as the HRC cell draws them: a minor count k from
    P(k) ~ 1/k on [5, n_samples], and exactly k carriers at random (the
    k lowest of a row of random keys, drawn on `device`)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ks = np.arange(5, n_samples + 1)
    p = 1.0 / ks
    planes = []
    for b in range(n_blocks):
        k = torch.from_numpy(rng.choice(ks, size=B_CARD, p=p / p.sum()))
        keys = torch.rand((B_CARD, 2 * n_samples), generator=gen,
                          device=device, dtype=torch.float64)
        kth = keys.sort(dim=1).values.gather(1, k.to(device)[:, None] - 1)
        alt = (keys <= kth).cpu().numpy()
        assert np.array_equal(alt.sum(1), k.numpy())
        planes.append(block(alt, 1 + 1000 * B_CARD * b))
    return stack_planes(planes)


@pytest.mark.gpu
def test_phased_tile_matches_plain_at_hrc_width_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda")
    n_samples = 32470
    stacked = mac_planes(SEED, n_samples, 2, card)
    dev = sweeps.planes_to_device(stacked, card,
                                  keys=("alt_bits", "ac", "valid"))
    assert dev["alt_bits"].shape[-1] == 2032
    # the cell's r2 floor, and one low enough that rare variants sharing
    # a haplotype survive the prefilter
    for min_r2, some in ((MIN_R2, False), (0.002, True)):
        cfg = sweeps.make_cfg("phased", False, "all", B_CARD, n_samples, 0,
                              min_r2, 100.0)
        for i, j, diag in [(0, 1, False), (1, 1, True)]:
            mask, parts = tiles.tile_prefilter(dev, i, j, diag, cfg)
            want_m, want_p = tiles.tile_prefilter_plain(dev, i, j, diag,
                                                        cfg)
            assert torch.equal(mask, want_m) and torch.equal(parts, want_p)
            assert int((mask == 2).sum()) > 0 or not some
