"""Independent phased variants: the draw of the port's
`workloads.build_planes` (bench.py's sparse workload), moved onto the
card.

Every variant's minor allele frequency comes from Beta(0.5, 2) x 0.5 +
0.001, capped at 0.5, so most are rare; each haplotype carries the alt
allele with that frequency, independently, with no missing allele.
Positions ascend from 0 by 50-499 bp steps over all the super-blocks, so
a later region lies after an earlier one on the one contig. The
frequencies and positions are drawn on the host from `seed`, the bits on
the device by a `torch.Generator` seeded with it: the same seed gives the
same planes.
"""

import numpy as np
import torch

from ldbench.traffic import _pack


def draw(sizes, B: int, n_samples: int, seed: int, device, **_):
    """Stacked planes of super-blocks holding `sizes` variants, B rows
    each."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    blocks, pos0 = [], 0
    for n in sizes:
        maf = np.minimum(rng.beta(0.5, 2.0, size=n) * 0.5 + 1e-3, 0.5)
        pos = pos0 + np.cumsum(rng.integers(50, 500, n))
        pos0 = int(pos[-1])
        m = torch.from_numpy(maf.astype(np.float32)).to(device)
        alt = torch.rand((n, 2 * n_samples), generator=gen,
                         device=device) < m[:, None]
        blocks.append(_pack.block(B, n_samples, alt, pos))
    return _pack.stack(blocks)
