"""Seeded planes for the port's measured workloads.

Each returns `bitpack.stack_planes` output for `n_blocks` super-blocks
of `B` variants, built without a file: what `chip_smoke.py` sweeps when
it times the engine and checks the kernels. `build_planes` and
`build_planes_grouped` draw what bench.py's functions of the same names
draw from the same seeds -- the same alt planes, allele counts and
positions -- so rates measured on them compare across both packages.
They differ in one place: the miss plane's padding bits (past 2N) are
ones here, as `bitpack.block_to_planes` packs them, where bench.py
leaves them zero; the 4-part phased kernels rely on that padding.
Positions ascend along the blocks with a mean spacing of 275 bp on one
contig, so a 4096-variant super-block spans about 1.1 Mb. `fisher_tables`
and `fisher_buffer` give the Fisher kernel survivor rows of a cohort
wider than the planes' (2N = 32,768 haplotypes) without a sweep.
`genotype_planes_on` draws unphased planes on the card at biobank width.
"""

import numpy as np
import torch

from .ops.bitpack import (BlockPlanes, _pack_bits, _popcount_rows,
                          stack_planes, words_for)


def _phased_block(alt, pos, n_samples):
    """BlockPlanes of fully called phased variants `alt` [B, 2N] bool:
    no missing allele, empty genotype-class planes."""
    B = alt.shape[0]
    Wh, Ws = words_for(2 * n_samples), words_for(n_samples)
    none = np.zeros((B, n_samples), bool)
    zero = np.zeros(B, np.int32)
    return BlockPlanes(
        n_rec=B, alt_bits=_pack_bits(alt, Wh),
        miss_bits=_pack_bits(np.zeros_like(alt), Wh, pad_value=1),
        het_bits=_pack_bits(none, Ws), hom_bits=_pack_bits(none, Ws),
        valid_bits=_pack_bits(~none, Ws),
        pos=pos, rid=zero.copy(), ac=alt.sum(axis=1).astype(np.int32),
        an=zero.copy(), n_het=zero.copy(), n_hom=zero.copy(),
        hwe=np.ones(B, np.float32), has_missing=np.zeros(B, bool),
        valid=np.ones(B, bool))


def build_planes(n_blocks, B, n_samples, seed=0):
    """Independent phased variants with a beta-distributed MAF spectrum
    folded to (0, 0.5]: the sparse workload (few pairs survive)."""
    rng = np.random.default_rng(seed)
    planes = []
    pos0 = 0
    for _ in range(n_blocks):
        maf = np.minimum(rng.beta(0.5, 2.0, size=B) * 0.5 + 1e-3, 0.5)
        alt = rng.random((B, 2 * n_samples)) < maf[:, None]
        pos = pos0 + np.cumsum(rng.integers(50, 500, B)).astype(np.int32)
        pos0 = int(pos[-1])
        planes.append(_phased_block(alt, pos, n_samples))
    return stack_planes(planes)


def build_planes_grouped(n_blocks, B, n_samples, seed=1, group=16,
                         flip=0.02):
    """LD-structured phased variants: every `group` consecutive
    variants share a haplotype template with `flip` per-haplotype
    perturbation, so in-group pairs carry r2 ~ 0.9 and flow through
    survivor extraction, the exact host math and record emission: the
    records-dense workload."""
    rng = np.random.default_rng(seed)
    planes = []
    pos0 = 0
    for _ in range(n_blocks):
        n_grp = B // group
        maf = np.minimum(rng.beta(0.5, 2.0, size=n_grp) * 0.4 + 0.05, 0.5)
        base = rng.random((n_grp, 2 * n_samples)) < maf[:, None]
        alt = np.repeat(base, group, axis=0)
        alt ^= rng.random((B, 2 * n_samples)) < flip
        pos = pos0 + np.cumsum(rng.integers(50, 500, B)).astype(np.int32)
        pos0 = int(pos[-1])
        planes.append(_phased_block(alt, pos, n_samples))
    return stack_planes(planes)


def genotype_planes(n_blocks, B, n_samples, miss_frac=0.02, seed=3,
                    group=16, flip=0.02, miss_rows=0.5):
    """Genotype variants with missing data, packed as
    bitpack.block_to_planes packs them: every `group` consecutive
    variants are noisy copies of one haplotype template (group=1,
    flip=0: independent variants), each allele flipped with probability
    `flip` (a float, or one per variant); a `miss_rows` share of the
    variants miss `miss_frac` of their genotypes (both alleles); the miss
    plane's padding bits are ones; ac and an count alt and missing
    alleles; n_het/n_hom are counted from the planes. Positions come from
    a generator of their own (seed + 1000)."""
    rng = np.random.default_rng(seed)
    pos_rng = np.random.default_rng(seed + 1000)
    Wh, Ws = words_for(2 * n_samples), words_for(n_samples)
    planes = []
    pos0 = 0
    for _ in range(n_blocks):
        n_grp = B // group
        maf = np.minimum(rng.beta(0.5, 2.0, size=n_grp) * 0.4 + 0.05, 0.5)
        base = rng.random((n_grp, 2 * n_samples), np.float32) < maf[:, None]
        alt = np.repeat(base, group, axis=0)
        if np.any(flip):
            alt ^= rng.random((B, 2 * n_samples), np.float32) \
                < np.reshape(flip, (-1, 1))
        miss = rng.random((B, n_samples), np.float32) < miss_frac
        miss &= (rng.random(B) < miss_rows)[:, None]
        hap_miss = np.repeat(miss, 2, axis=1)
        alt &= ~hap_miss
        a, b = alt[:, 0::2], alt[:, 1::2]
        full = ~miss
        het_w = _pack_bits(full & (a ^ b), Ws)
        hom_w = _pack_bits(full & a & b, Ws)
        pos = pos0 + np.cumsum(pos_rng.integers(50, 500, B)).astype(np.int32)
        pos0 = int(pos[-1])
        planes.append(BlockPlanes(
            n_rec=B, alt_bits=_pack_bits(alt, Wh),
            miss_bits=_pack_bits(hap_miss, Wh, pad_value=1),
            het_bits=het_w, hom_bits=hom_w,
            valid_bits=_pack_bits(full, Ws),
            pos=pos, rid=np.zeros(B, np.int32),
            ac=alt.sum(axis=1).astype(np.int32),
            an=(2 * miss.sum(axis=1)).astype(np.int32),
            n_het=_popcount_rows(het_w), n_hom=_popcount_rows(hom_w),
            hwe=np.ones(B, np.float32), has_missing=miss.any(axis=1),
            valid=np.ones(B, bool)))
    return stack_planes(planes)


def threshold_planes(n_blocks, B, n_samples, seed=9, group=64):
    """genotype_planes whose pairs straddle the prefilter's r2 floor of
    0.1: every `group` consecutive variants copy one template, each with
    its own flip rate, spread over [0, 0.3) and shuffled, so that the
    pairs of a group (a tile of a super-block with itself) run from r2 ~1
    down past 0.1, many of them within the unphased screen's margin of
    it."""
    flip = np.random.default_rng(seed).permutation(
        np.linspace(0.0, 0.3, B, endpoint=False))
    return genotype_planes(n_blocks, B, n_samples, seed=seed, group=group,
                           flip=flip)


def _pack_on(bits, W):
    """bool [n, L] -> int32 [n, W] on its device (bit k of word w: column
    32 w + k; W >= words of L, the rest zero)."""
    n, L = bits.shape
    full = torch.zeros((n, W * 32), dtype=torch.bool, device=bits.device)
    full[:, :L] = bits
    full = full.view(n, W, 32)
    out = torch.zeros((n, W), dtype=torch.int32, device=bits.device)
    for k in range(32):
        out |= full[:, :, k].to(torch.int32) << k
    return out


def genotype_planes_on(device, n_blocks, B, n_samples, seed, W=None,
                       miss_frac=0.01):
    """The unphased sweep's device tensors (compute/sweeps.py
    `planes_to_device` keys: het/hom/valid planes, n_het, n_hom, ac, an,
    valid) of `n_blocks` super-blocks of B independent variants, drawn on
    `device`: frequencies Beta(0.5, 2) x 0.5 + 0.001 (capped at 0.5),
    Hardy-Weinberg genotypes, `miss_frac` of each variant's calls
    missing. W: words a plane (words_for(n_samples) by default). At
    biobank width the host's genotype_planes would take minutes; on the
    card this takes seconds."""
    W = words_for(n_samples) if W is None else W
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    keys = ("het_bits", "hom_bits", "valid_bits", "n_het", "n_hom", "an")
    out = {k: [] for k in keys}
    for _ in range(n_blocks):
        p = torch.from_numpy(np.minimum(
            rng.beta(0.5, 2.0, B) * 0.5 + 0.001, 0.5)).to(device)
        het, hom, called = [], [], []
        for r0 in range(0, B, 256):
            pp = p[r0:r0 + 256, None].float()
            u = torch.rand((len(pp), n_samples), generator=gen,
                           device=device)
            c = torch.rand((len(pp), n_samples), generator=gen,
                           device=device) >= miss_frac
            g = ((u < pp * pp).to(torch.int8)
                 + (u < 2 * pp - pp * pp).to(torch.int8)) * c
            het.append(_pack_on(g == 1, W))
            hom.append(_pack_on(g == 2, W))
            called.append(_pack_on(c, W))
            out["n_het"].append((g == 1).sum(1, dtype=torch.int32))
            out["n_hom"].append((g == 2).sum(1, dtype=torch.int32))
            out["an"].append(2 * (~c).sum(1, dtype=torch.int32))
        for k, v in (("het_bits", het), ("hom_bits", hom),
                     ("valid_bits", called)):
            out[k].append(torch.cat(v))
    dev = {k: torch.stack(out[k]) for k in keys[:3]}
    for k in keys[3:]:
        dev[k] = torch.cat(out[k]).view(n_blocks, B)
    dev["ac"] = dev["n_het"] + 2 * dev["n_hom"]
    dev["valid"] = torch.ones((n_blocks, B), dtype=torch.bool,
                              device=device)
    return dev


def super_ranges(stacked):
    """({s: minpos}, {s: maxpos}, {s: rid}) of each super-block's valid
    rows: what `Balancer.window_pairs` takes."""
    minpos, maxpos, rid = {}, {}, {}
    for s in range(len(stacked["pos"])):
        v = stacked["valid"][s]
        minpos[s] = int(stacked["pos"][s][v].min())
        maxpos[s] = int(stacked["pos"][s][v].max())
        rid[s] = int(stacked["rid"][s][v][0])
    return minpos, maxpos, rid


def fisher_tables(n_hap, k, seed):
    """k 2x2 tables (REFREF, REFALT, ALTREF, ALTALT) int64 of n_hap
    haplotypes in strong LD (allele frequencies 0.05-0.5, r2 0.1-1, cells
    drawn from the multinomial), then 600 symmetric tables (n1 = m1) and
    tables with the observed cell at either end of the support, and four
    trivial or tied ones."""
    rng = np.random.default_rng(seed)
    p, q = rng.uniform(0.05, 0.5, (2, k))
    r2 = rng.uniform(0.1, 1.0, k)
    D = np.minimum(np.sqrt(r2 * p * (1 - p) * q * (1 - q)),
                   np.minimum(p * (1 - q), q * (1 - p)))
    cells = np.stack([(1 - p) * (1 - q) + D, (1 - p) * q - D,
                      p * (1 - q) - D, p * q + D], 1).clip(0)
    out = [rng.multinomial(n_hap, c / c.sum()) for c in cells]
    for e in range(600):
        n1 = int(rng.integers(1, n_hap))
        m1 = n1 if e % 2 else int(rng.integers(1, n_hap))
        kmin, kmax = max(0, n1 + m1 - n_hap), min(n1, m1)
        a = (kmin, kmax, int(rng.integers(kmin, kmax + 1)))[e % 3]
        out.append((a, n1 - a, m1 - a, n_hap - n1 - m1 + a))
    out += [(0, 0, 0, 0), (7, 0, 0, 0), (n_hap // 2, 0, 0, n_hap // 2),
            (0, n_hap // 2, n_hap // 2, 0)]
    return np.array(out, np.int64)


def fisher_buffer(tables, ncol):
    """The survivor rows of one tile of a phased sweep with missing data
    holding `tables` [K, 4] (the 4 parts pair-packed, as
    compute/sweeps.py's compaction writes them while they fit uint16),
    in an int32 [2K, ncol] buffer whose other rows and columns are 0."""
    rr, ra, ar, aa = tables.T
    K = len(tables)
    out = np.zeros((2 * K, ncol), np.int64)
    out[:K, 0] = np.arange(K)
    out[:K, 1] = aa | (aa + ar) << 16
    out[:K, 2] = (aa + ra) | (rr + ra + ar + aa) << 16
    return out.astype(np.uint32).view(np.int32)
