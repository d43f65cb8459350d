"""Unphased genotypes with missing calls: the draw of the port's
`workloads.genotype_planes` for independent variants (group 1, no flip),
moved onto the card.

Each variant's alt allele frequency comes from Beta(0.5, 2) x
`maf_scale` + `maf_floor`, capped at 0.5 (the port's genotype_planes:
0.4 and 0.05; build_planes' spectrum, 0.5 and 0.001, keeps rare
variants); each haplotype carries it independently. A
`miss_rows` share of the variants miss each sample's genotype (both
alleles) with probability `miss_frac`; a missing genotype carries no alt
allele. The planes are the unphased ones: het (one alt allele), hom (two)
and called, with the haplotype planes beside them. Frequencies, the
variants that miss calls and positions (50-499 bp steps) come from
`seed` on the host, the bits from a `torch.Generator` seeded with it on
the device.
"""

import numpy as np
import torch

from ldbench.traffic import _pack


def draw(sizes, B: int, n_samples: int, seed: int, device,
         miss_frac: float = 0.02, miss_rows: float = 0.5,
         maf_scale: float = 0.4, maf_floor: float = 0.05, **_):
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    blocks, pos0 = [], 0
    for n in sizes:
        maf = np.minimum(rng.beta(0.5, 2.0, size=n) * maf_scale
                         + maf_floor, 0.5)
        pos = pos0 + np.cumsum(rng.integers(50, 500, n))
        pos0 = int(pos[-1])
        rows = torch.from_numpy(rng.random(n) < miss_rows).to(device)
        m = torch.from_numpy(maf.astype(np.float32)).to(device)
        alt = torch.rand((n, 2 * n_samples), generator=gen,
                         device=device) < m[:, None]
        miss = torch.rand((n, n_samples), generator=gen,
                          device=device) < miss_frac
        miss &= rows[:, None]
        hap_miss = torch.repeat_interleave(miss, 2, dim=1)
        alt &= ~hap_miss
        a, b = alt[:, 0::2], alt[:, 1::2]
        called = ~miss
        blocks.append(_pack.block(B, n_samples, alt, pos, miss=hap_miss,
                                  het=called & (a ^ b), hom=called & a & b,
                                  valid_s=called))
    return _pack.stack(blocks)
