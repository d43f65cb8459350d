"""Unphased genotypes with missing calls at biobank width, with planted
pairs in LD between two regions.

Each variant's alt allele frequency p comes from Beta(0.5, 2) x
`maf_scale` + `maf_floor`, capped at 0.5; a sample's genotype is 2, 1 or
0 alt alleles with the Hardy-Weinberg shares p^2, 2p(1 - p), (1 - p)^2
(one uniform draw a sample). A `miss_rows` share of the variants miss
each sample's call with probability `miss_frac`; a missing call carries
no allele.

Planted pairs: the super-blocks' first half stands for one region and
the second half for the other (a `far` cell of two equal regions). For
every pair of a block a of the first region and a block b of the
second, one row of b copies one row of a: each sample takes the source's
genotype with probability sqrt(r2) (where the source calls it), else a
genotype drawn afresh at the source's frequency, with r2 drawn
log-uniform on `planted_r2`; its missing calls are its own. So each tile
of the cell holds one pair whose r2 lies anywhere from far below the
cell's 0.1 to 1, some near it. `stacked["planted"]` lists them: int64
[n, 4] rows (block a, row, block b, row).

The planes are the unphased ones (het, hom, called), packed on the card
a sample word at a time into int32 (no wider transient), with the
per-variant counts beside them. The haplotype planes (alt, missing
allele), which an unphased sweep never reads, are one constant row each,
broadcast read-only over every super-block and row, so the host holds
three sample planes, not five planes of which two are twice as wide.
Frequencies, missing rows, planted rows and positions (50-499 bp steps
from 0) come from `seed` on the host, the bits from a `torch.Generator`
seeded with it on the device: the same seed gives the same planes.
"""

import numpy as np
import torch

from ldbench.traffic import _pack

#: variants drawn at once (two float32 draws a sample each)
ROWS = 256


def pack_words(bits: torch.Tensor, n_words: int) -> torch.Tensor:
    """bool [n, L] -> int32 [n, n_words] on its device: bit k of word w is
    column 32 w + k, the bits past L 0. Built a bit position at a time
    into the int32 words."""
    n, L = bits.shape
    full = torch.zeros((n, n_words * 32), dtype=torch.bool,
                       device=bits.device)
    full[:, :L] = bits
    full = full.view(n, n_words, 32)
    out = torch.zeros((n, n_words), dtype=torch.int32, device=bits.device)
    for k in range(32):
        out |= full[:, :, k].to(torch.int32) << k
    return out


def genotypes(p: torch.Tensor, n_samples: int, gen) -> torch.Tensor:
    """int8 [n, N] alt allele counts of Hardy-Weinberg draws at
    frequencies p [n] (float64 on the device)."""
    u = torch.rand((len(p), n_samples), generator=gen, device=p.device)
    hom = (p * p).float()[:, None]
    het = (2 * p - p * p).float()[:, None]
    return (u < hom).to(torch.int8) + (u < het).to(torch.int8)


def plant_plan(rng, sizes, planted_r2):
    """The planted pairs of `sizes`' blocks: int64 [n, 4] (block a, row,
    block b, row) and their r2 [n], one a pair of a first-half block a
    and a second-half block b; none where there is one block."""
    half = len(sizes) // 2
    first, second = range(half), range(half, 2 * half)
    lo, hi = np.log(planted_r2[0]), np.log(planted_r2[1])
    plan = []
    for b in second:
        rows = rng.choice(sizes[b], min(half, sizes[b]), replace=False)
        for a, rb in zip(first, rows):
            plan.append((a, int(rng.integers(sizes[a])), b, int(rb)))
    plan = np.array(plan, np.int64).reshape(-1, 4)
    return plan, np.exp(rng.uniform(lo, hi, len(plan)))


def draw(sizes, B: int, n_samples: int, seed: int, device,
         miss_frac: float = 0.01, miss_rows: float = 1.0,
         maf_scale: float = 0.5, maf_floor: float = 0.001,
         planted_r2=(0.02, 1.0), **_):
    """Stacked planes of super-blocks holding `sizes` variants, B rows
    each, and the list of planted pairs."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    NB = len(sizes)
    Wh, Ws = _pack.words_for(2 * n_samples), _pack.words_for(n_samples)
    plan, r2 = plant_plan(rng, sizes, planted_r2)
    out = {k: np.zeros((NB, B), np.int32)
           for k in ("pos", "rid", "ac", "an", "n_het", "n_hom")}
    out.update(hwe=np.ones((NB, B), np.float32),
               has_missing=np.zeros((NB, B), bool),
               valid=np.zeros((NB, B), bool))
    for key in ("het_bits", "hom_bits", "valid_bits"):
        out[key] = np.zeros((NB, B, Ws), np.uint32)
    miss = _pack.pack(torch.zeros((0, 2 * n_samples), dtype=torch.bool), Wh,
                      1, pad_value=1)[0]
    out["miss_bits"] = np.broadcast_to(miss, (NB, B, Wh))
    out["alt_bits"] = np.broadcast_to(np.zeros(Wh, np.uint32), (NB, B, Wh))
    sources = {}      # (block, row) -> (int8 genotypes, called, frequency)
    want = {(int(a), int(ra)) for a, ra, _, _ in plan}
    pos0 = 0
    for b, n in enumerate(sizes):
        maf = np.minimum(rng.beta(0.5, 2.0, size=n) * maf_scale + maf_floor,
                         0.5)
        pos = pos0 + np.cumsum(rng.integers(50, 500, n))
        pos0 = int(pos[-1])
        rows_miss = rng.random(n) < miss_rows
        targets = {int(rb): k for k, (_, _, bb, rb) in enumerate(plan)
                   if bb == b}
        for r0 in range(0, n, ROWS):
            r1 = min(n, r0 + ROWS)
            p = torch.from_numpy(maf[r0:r1]).to(device)
            g = genotypes(p, n_samples, gen)
            called = ~(torch.rand((r1 - r0, n_samples), generator=gen,
                                  device=device) < miss_frac)
            called |= ~torch.from_numpy(rows_miss[r0:r1]).to(device)[:, None]
            for r in range(r0, r1):
                if r in targets:
                    a, ra, _, _ = plan[targets[r]]
                    src, src_called, f = sources[(int(a), int(ra))]
                    fresh = genotypes(torch.tensor([f], dtype=torch.float64,
                                                   device=device),
                                      n_samples, gen)[0]
                    keep = torch.rand(n_samples, generator=gen,
                                      device=device) < float(
                                          np.sqrt(r2[targets[r]]))
                    g[r - r0] = torch.where(keep & src_called, src, fresh)
            g = torch.where(called, g, torch.zeros_like(g))
            for r in range(r0, r1):
                if (b, r) in want:
                    sources[(b, r)] = (g[r - r0].clone(),
                                       called[r - r0].clone(), float(maf[r]))
            for key, bits in (("het_bits", g == 1), ("hom_bits", g == 2),
                              ("valid_bits", called)):
                torch.from_numpy(out[key][b, r0:r1].view(np.int32)).copy_(
                    pack_words(bits, Ws))
            n_het = (g == 1).sum(1)
            n_hom = (g == 2).sum(1)
            n_miss = n_samples - called.sum(1)
            out["n_het"][b, r0:r1] = n_het.cpu().numpy()
            out["n_hom"][b, r0:r1] = n_hom.cpu().numpy()
            out["ac"][b, r0:r1] = (n_het + 2 * n_hom).cpu().numpy()
            out["an"][b, r0:r1] = (2 * n_miss).cpu().numpy()
            out["has_missing"][b, r0:r1] = (n_miss > 0).cpu().numpy()
        out["pos"][b, :n] = pos
        out["valid"][b, :n] = True
    out["n_rec"] = np.array(sizes, np.int32)
    out["planted"] = plan
    return out
