"""Packing of drawn bits into the word planes the port's engine takes.

Bit k of word w is haplotype (or sample) 32 w + k; a plane has
`words_for(n)` words, a multiple of 4; the bits past n are 0, but for
the missing-allele plane, whose padding bits are 1 (the port's layout,
tomahawk_tpu_torch/ops/bitpack.py). A super-block holds `B` rows; rows
past its variants are padding: every plane 0 there, the missing plane's
padding bits 1, `valid` False.
"""

import numpy as np
import torch

#: the per-super-block arrays of a stacked plane set, in the port's order
KEYS = ("alt_bits", "miss_bits", "het_bits", "hom_bits", "valid_bits",
        "pos", "rid", "ac", "an", "n_het", "n_hom", "hwe", "has_missing",
        "valid")


def words_for(n_bits: int) -> int:
    """uint32 words that hold n_bits, rounded up to a multiple of 4."""
    return -(-(-(-n_bits // 32)) // 4) * 4


def pack(bits: torch.Tensor, n_words: int, rows: int,
         pad_value: int = 0) -> np.ndarray:
    """bool [n, L] on any device -> uint32 [rows, n_words] on the host,
    rows past n all 0 but for the padding bits past L."""
    n, L = bits.shape
    full = torch.full((rows, n_words * 32), pad_value, dtype=torch.int64,
                      device=bits.device)
    full[:, :L] = 0
    full[:n, :L] = bits.to(torch.int64)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (full.view(rows, n_words, 32) << shifts).sum(-1)
    return words.cpu().numpy().astype(np.uint32)


def block(rows: int, n_samples: int, alt, pos, miss=None, het=None,
          hom=None, valid_s=None) -> dict:
    """One super-block's arrays from bits drawn on the device: `alt`
    bool [n, 2N] and `miss` (None: no missing allele) at the haplotype
    level; `het`, `hom`, `valid_s` bool [n, N] at the sample level (None:
    phased, no genotype classes, every sample called); `pos` int [n]."""
    n = alt.shape[0]
    Wh, Ws = words_for(2 * n_samples), words_for(n_samples)
    z = np.zeros(rows, np.int32)
    out = dict(alt_bits=pack(alt, Wh, rows), pos=z.copy(), rid=z.copy(),
               ac=z.copy(), an=z.copy(), n_het=z.copy(), n_hom=z.copy(),
               hwe=np.ones(rows, np.float32),
               has_missing=np.zeros(rows, bool), valid=np.zeros(rows, bool))
    if miss is None:
        pad = pack(torch.zeros((0, 2 * n_samples), dtype=torch.bool), Wh, 1,
                   pad_value=1)
        out["miss_bits"] = np.repeat(pad, rows, axis=0)
    else:
        out["miss_bits"] = pack(miss, Wh, rows, pad_value=1)
        miss_s = miss[:, 0::2] | miss[:, 1::2]
        out["an"][:n] = 2 * miss_s.sum(1).cpu().numpy()
        out["has_missing"][:n] = miss_s.any(1).cpu().numpy()
    if valid_s is None:
        out["het_bits"] = np.zeros((rows, Ws), np.uint32)
        out["hom_bits"] = np.zeros((rows, Ws), np.uint32)
        called = pack(torch.ones((1, n_samples), dtype=torch.bool), Ws, 1)
        out["valid_bits"] = np.zeros((rows, Ws), np.uint32)
        out["valid_bits"][:n] = called
    else:
        out["het_bits"] = pack(het, Ws, rows)
        out["hom_bits"] = pack(hom, Ws, rows)
        out["valid_bits"] = pack(valid_s, Ws, rows)
        out["n_het"][:n] = het.sum(1).cpu().numpy()
        out["n_hom"][:n] = hom.sum(1).cpu().numpy()
    out["pos"][:n] = pos
    out["ac"][:n] = alt.sum(1).cpu().numpy()
    out["valid"][:n] = True
    return out


def stack(blocks) -> dict:
    """[NB, ...] arrays of every key, and `n_rec`: what the port's
    `bitpack.stack_planes` gives."""
    out = {k: np.stack([b[k] for b in blocks]) for k in KEYS}
    out["n_rec"] = np.array([int(b["valid"].sum()) for b in blocks],
                            np.int32)
    return out


def unpack(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """uint32 words as int32 [n, W] on any device -> bool [n, n_bits]."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words.to(torch.int32).unsqueeze(-1) >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :n_bits].bool()
