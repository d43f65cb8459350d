"""Independent phased variants with exact minor allele counts from the
neutral spectrum: a reference panel filtered on minor allele count, as
the Haplotype Reference Consortium's sites are (minor allele count >=
5).

Every variant's minor allele count k is drawn from P(k) ∝ 1/k on
[`mac_floor`, n_samples] (the neutral site frequency spectrum, folded at
half the haplotypes), and exactly k of the 2N haplotypes carry the alt
(minor) allele, chosen at random (`exact_bits`). No allele is missing.
Positions ascend from 0 by 50-499 bp steps over all the super-blocks.
The counts and positions are drawn on the host from `seed`, the bits on
the device by a `torch.Generator` seeded with it: the same seed gives
the same planes.

The planes are built as the engine reads them: the alt plane (the only
word plane a phased sweep without missing data uploads) and the called
samples' plane are arrays of their own; the missing-allele plane (its
padding bits set) and the empty het and hom planes are one constant row
each, broadcast read-only over every super-block and row. At 32,470
samples that keeps the host at the alt plane's 16.6 KB and the called
plane's 4.1 KB a variant, not twice as much.
"""

import numpy as np
import torch

from ldbench.traffic import _pack

#: rows of a super-block drawn at once (a float and a key a haplotype:
#: 12 bytes a haplotype a row on the device)
ROWS = 1024


def mac_spectrum(n_samples: int, mac_floor: int):
    """(counts, probabilities) of the minor allele count: 1/k on
    [mac_floor, n_samples], normalised."""
    ks = np.arange(mac_floor, n_samples + 1)
    p = 1.0 / ks
    return ks, p / p.sum()


def exact_bits(k: torch.Tensor, n_hap: int, gen, device) -> torch.Tensor:
    """bool [n, n_hap] with exactly k[r] set bits in row r, at random:
    each bit set with probability k[r] / n_hap, then a row's shortfall
    (surplus) made up at the clear (set) bits of lowest random key, the
    keys unique (random high bits above the bit's index). Every step is
    blind to the bits' order, so every k-subset is as likely."""
    idx_bits = max(1, (n_hap - 1).bit_length())
    idx = torch.arange(n_hap, device=device, dtype=torch.int64)
    top = torch.iinfo(torch.int64).max
    out = torch.empty((len(k), n_hap), dtype=torch.bool, device=device)
    for r0 in range(0, len(k), ROWS):
        kk = k[r0:r0 + ROWS]
        bits = torch.rand((len(kk), n_hap), generator=gen, device=device) \
            < (kk.double() / n_hap).float()[:, None]
        d = kk - bits.sum(1)
        keys = torch.randint(0, 1 << (62 - idx_bits), (len(kk), n_hap),
                             generator=gen, device=device) << idx_bits | idx
        # the candidates: clear bits of a row short of k, set bits of one
        # over it
        keys.masked_fill_(bits == (d > 0)[:, None], top)
        m = int(d.abs().max())
        if m:
            pick = keys.topk(m, dim=1, largest=False).indices
            flip = torch.arange(m, device=device) < d.abs()[:, None]
            bits.scatter_(1, pick, bits.gather(1, pick) ^ flip)
        out[r0:r0 + len(kk)] = bits
    return out


def draw(sizes, B: int, n_samples: int, seed: int, device,
         mac_floor: int = 5, **_):
    """Stacked planes of super-blocks holding `sizes` variants, B rows
    each."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n_hap = 2 * n_samples
    Wh, Ws = _pack.words_for(n_hap), _pack.words_for(n_samples)
    NB = len(sizes)
    ks, p = mac_spectrum(n_samples, mac_floor)
    out = {k: np.zeros((NB, B), np.int32)
           for k in ("pos", "rid", "ac", "an", "n_het", "n_hom")}
    out.update(alt_bits=np.empty((NB, B, Wh), np.uint32),
               valid_bits=np.zeros((NB, B, Ws), np.uint32),
               hwe=np.ones((NB, B), np.float32),
               has_missing=np.zeros((NB, B), bool),
               valid=np.zeros((NB, B), bool))
    miss = _pack.pack(torch.zeros((0, n_hap), dtype=torch.bool), Wh, 1,
                      pad_value=1)[0]
    out["miss_bits"] = np.broadcast_to(miss, (NB, B, Wh))
    for key in ("het_bits", "hom_bits"):
        out[key] = np.broadcast_to(np.zeros(Ws, np.uint32), (NB, B, Ws))
    called = _pack.pack(torch.ones((1, n_samples), dtype=torch.bool), Ws, 1)
    pos0 = 0
    for b, n in enumerate(sizes):
        mac = rng.choice(ks, size=n, p=p)
        pos = pos0 + np.cumsum(rng.integers(50, 500, n))
        pos0 = int(pos[-1])
        alt = exact_bits(torch.from_numpy(mac).to(device), n_hap, gen,
                         device)
        out["alt_bits"][b] = _pack.pack(alt, Wh, B)
        out["ac"][b, :n] = alt.sum(1).cpu().numpy()
        out["pos"][b, :n] = pos
        out["valid"][b, :n] = True
        out["valid_bits"][b, :n] = called
    out["n_rec"] = np.array(sizes, np.int32)
    return out
