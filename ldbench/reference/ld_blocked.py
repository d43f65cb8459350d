"""The plain unphased reference at biobank width: every pair of two row
sets, from the benchmark's het, hom and called sample planes, in blocks
of samples.

A tile unpacked whole at 488,377 samples would take tens of GB a side,
so the 3 x 3 genotype counts of each pair are summed over blocks of
`WORDS` sample words: each block's 0/1 indicators of the three
genotypes among the called samples (hom: two alt alleles, het: one,
called and neither: none), their float32 matrix products (exact: a
block's counts stay below 2**24, and TF32 is off), added in float64
(exact below 2**53). Counts are integers, so the blocking changes
nothing: the tables are those ldbench/reference/ld.py counts from the
haplotype planes, and the statistics are its own, `unphased_pairs` in
`dtype`. Plain PyTorch; it imports nothing of the port.
"""

import torch

from ldbench.reference import ld as ref_ld

#: sample words a block (32,768 samples: 128 MB of float32 a side and
#: genotype at 1,024 rows)
WORDS = 1024


def _indicators(planes: dict, w0: int, w1: int, n_bits: int):
    """float32 0/1 [n, n_bits] of genotypes 0, 1, 2 among the called
    samples of words [w0, w1)."""
    het, hom, called = (ref_ld.unpack(planes[k][:, w0:w1], n_bits)
                        for k in ("het_bits", "hom_bits", "valid_bits"))
    return [called - het - hom, het, hom]


def genotype_tables(planes_i: dict, planes_j: dict, n_samples: int,
                    words: int = WORDS) -> torch.Tensor:
    """int64 [n_i, n_j, 3, 3]: the genotype table of every pair of a row
    of `planes_i` and a row of `planes_j` (the rows' `het_bits`,
    `hom_bits` and `valid_bits` words, tensors on the device to work
    on), row x the first variant's alt alleles, column x the second's."""
    n_i, n_j = planes_i["het_bits"].shape[0], planes_j["het_bits"].shape[0]
    W = planes_i["het_bits"].shape[1]
    dev = planes_i["het_bits"].device
    T = torch.zeros((3, 3, n_i, n_j), dtype=torch.float64, device=dev)
    for w0 in range(0, W, words):
        w1 = min(W, w0 + words)
        n_bits = min(n_samples, 32 * w1) - 32 * w0
        if n_bits <= 0:
            break
        ia = _indicators(planes_i, w0, w1, n_bits)
        ib = _indicators(planes_j, w0, w1, n_bits)
        for x in range(3):
            for y in range(3):
                T[x, y] += ref_ld._mm(ia[x], ib[y]).to(torch.float64)
    return T.round().to(torch.int64).permute(2, 3, 0, 1)


def tile(planes_i: dict, planes_j: dict, diag: bool, n_samples: int,
         min_r2: float, dtype=torch.float64, words: int = WORDS) -> dict:
    """ld.tile's result for the unphased table, from sample planes: the
    kept pairs' fields (`idx`: row_i * n_j + row_j; only row_i < row_j
    where `diag`, both sides then the same rows) and the tied pairs."""
    T = genotype_tables(planes_i, planes_j, n_samples, words)
    n_i, n_j = T.shape[:2]
    dev = T.device
    rows = torch.arange(n_i, device=dev)[:, None]
    cols = torch.arange(n_j, device=dev)[None, :]
    cand = (cols > rows) if diag else torch.ones(
        (n_i, n_j), dtype=torch.bool, device=dev)
    sel = torch.nonzero(cand.flatten()).flatten()
    return ref_ld.unphased_pairs(T.reshape(-1, 3, 3)[sel], sel, min_r2,
                                 dtype)
