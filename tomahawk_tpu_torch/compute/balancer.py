"""Static load balancer: partition the upper-triangular block-pair grid.

Reimplements the reference's chunking scheme (reference:
lib/ld/ld_balancing.h:13-108 twk_ld_balancer): the n_blks x n_blks
upper-triangular grid is split into c = k(k+1)/2 chunks arranged as the
upper triangle of a k x k super-grid; chunk (i, j) covers block rows
[i*L, (i+1)*L) x columns [j*L, (j+1)*L). Diagonal chunks contain their
own upper triangle. This is the multi-machine scale-out unit: each chunk
is an independent job whose .two outputs are concat+sorted afterwards.
"""

import math
from dataclasses import dataclass, field
from typing import List, Tuple


def triangular_k(c: int) -> int:
    """k such that k(k+1)/2 == c, or -1."""
    k = int((math.isqrt(8 * c + 1) - 1) // 2)
    return k if k * (k + 1) // 2 == c else -1


@dataclass
class Balancer:
    """Selected block ranges for one chunk of the pair grid."""
    n_blks: int
    fromL: int = 0
    toL: int = 0
    fromR: int = 0
    toR: int = 0
    diag: bool = True

    @classmethod
    def build(cls, n_blks: int, n_chunks: int = 1, c_chunk: int = 0
              ) -> "Balancer":
        if n_blks == 0:
            raise ValueError("no blocks available")
        if n_chunks <= 1:
            return cls(n_blks, 0, n_blks, 0, n_blks, True)
        if not 0 <= c_chunk < n_chunks:
            raise ValueError(
                f"chunk id must be in [0, {n_chunks}), got {c_chunk}")
        k = triangular_k(n_chunks)
        if k < 0:
            raise ValueError(
                f"n_chunks must be a triangular number k(k+1)/2 "
                f"(1, 3, 6, 10, ...), got {n_chunks}")
        if k > n_blks:
            raise ValueError(f"more chunk rows ({k}) than blocks ({n_blks})")
        # enumerate super-grid upper triangle in row-major order
        cnt = 0
        for i in range(k):
            for j in range(i, k):
                if cnt == c_chunk:
                    L = n_blks / k
                    fromL = round(i * L)
                    toL = round((i + 1) * L)
                    fromR = round(j * L)
                    toR = round((j + 1) * L)
                    return cls(n_blks, fromL, toL, fromR, toR, i == j)
                cnt += 1
        raise AssertionError("unreachable")

    @property
    def n_blocks_loaded(self) -> int:
        if self.diag:
            return self.toL - self.fromL
        return (self.toL - self.fromL) + (self.toR - self.fromR)

    def block_ids(self) -> List[int]:
        """Global block indices this chunk touches, in load order."""
        ids = list(range(self.fromL, self.toL))
        if not self.diag:
            ids += list(range(self.fromR, self.toR))
        return ids

    def tile_pairs(self) -> List[Tuple[int, int, bool]]:
        """All (block_i, block_j, is_diagonal_tile) pairs of this chunk,
        as global block indices; i <= j always."""
        pairs = []
        if self.diag:
            for i in range(self.fromL, self.toL):
                for j in range(i, self.toL):
                    pairs.append((i, j, i == j))
        else:
            for i in range(self.fromL, self.toL):
                for j in range(self.fromR, self.toR):
                    pairs.append((i, j, False))
        return pairs

    def window_pairs(self, minpos, maxpos, rid, l_window: int
                     ) -> List[Tuple[int, int, bool]]:
        """Pairs restricted to the distance window: block j can contain a
        partner for block i only if they share a contig and the minimum
        distance between their ranges is <= l_window (reference:
        ld_balancing.h:176-204 GetBlockWindow)."""
        pairs = []
        for i in range(self.fromL, self.toL):
            for j in range(i, self.toR if not self.diag else self.toL):
                if j < self.fromR and not self.diag:
                    continue
                if rid[i] != rid[j]:
                    break  # index is contig-sorted; later blocks differ too
                if minpos[j] > maxpos[i] + l_window:
                    break
                pairs.append((i, j, i == j))
        return pairs
