"""LD-grouped phased variants: the draw of the port's
`workloads.build_planes_grouped` (the records-dense workload), moved onto
the card, with groups of `group` variants.

In each super-block, every `group` consecutive variants are noisy copies
of one haplotype template (the last group of a block takes the
remainder): the template carries the alt allele with a frequency from
Beta(0.5, 2) x 0.4 + 0.05, capped at 0.5, and each copy flips each
haplotype with probability `flip`. Pairs in a group have r2 near 0.9;
pairs across groups are independent. Positions ascend from 0 by 50-499
bp steps. Frequencies and positions come from `seed` on the host, the
bits from a `torch.Generator` seeded with it on the device.
"""

import numpy as np
import torch

from ldbench.traffic import _pack


def group_sizes(n: int, group: int):
    """Groups of a block of n variants: full groups, then the remainder."""
    return [group] * (n // group) + ([n % group] if n % group else [])


def draw(sizes, B: int, n_samples: int, seed: int, device, group: int = 94,
         flip: float = 0.02, **_):
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    blocks, pos0 = [], 0
    for n in sizes:
        grp = group_sizes(n, group)
        maf = np.minimum(rng.beta(0.5, 2.0, size=len(grp)) * 0.4 + 0.05, 0.5)
        pos = pos0 + np.cumsum(rng.integers(50, 500, n))
        pos0 = int(pos[-1])
        m = torch.from_numpy(maf.astype(np.float32)).to(device)
        base = torch.rand((len(grp), 2 * n_samples), generator=gen,
                          device=device) < m[:, None]
        reps = torch.tensor(grp, device=device)
        alt = torch.repeat_interleave(base, reps, dim=0)
        alt ^= torch.rand((n, 2 * n_samples), generator=gen,
                          device=device) < flip
        blocks.append(_pack.block(B, n_samples, alt, pos))
    return _pack.stack(blocks)
