"""Plain PyTorch versions of the phased tile operations.

Counterpart of tomahawk_tpu/ops/ld_kernels.py for the phased / no-missing
slice. These are the reference path of the hand kernels: the CPU tests
run them against the JAX functions, and the kernel wrappers
(ops/tiles.py, compute/sweeps.py) use them for tensors on the CPU. A
CUDA tensor never takes them inside the sweep; the on-card comparison
calls them directly.

Uint32 bit planes are held as int32 views (torch's uint32 has almost no
operations), and bits are unpacked through a uint8 view, as the JAX
version does: `>>` is not implemented for uint32 on the CPU.
"""

import numpy as np
import torch


def unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """[..., W] int32 (uint32 bits) -> [..., W*32] int8 of 0/1,
    little-endian bit order (bit k of word w is lane 32*w + k)."""
    b8 = x.contiguous().view(torch.uint8)                 # [..., 4W]
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    bits = (b8.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*x.shape[:-1], x.shape[-1] * 32).to(torch.int8)


def phased_parts_tile(alt_a: torch.Tensor, alt_b: torch.Tensor):
    """(ALTALT,) [I, J] int32: the no-missing contraction of
    ld_kernels.phased_parts_tile. int8 @ int8 wraps in torch, so the
    CPU contracts in int32; CUDA has no int32 matmul, so it contracts
    0/1 values in float32 with TF32 off, which is exact while the
    contraction length (32 * W bits) stays below 2**24."""
    a = unpack_bits(alt_a)
    b = unpack_bits(alt_b)
    if a.is_cuda:
        if a.shape[-1] >= 1 << 24:
            raise ValueError("contraction too long for an exact f32 sum")
        torch.backends.cuda.matmul.allow_tf32 = False
        return (torch.matmul(a.float(), b.float().T).to(torch.int32),)
    return (torch.matmul(a.to(torch.int32), b.to(torch.int32).T),)


def phased_cells(parts, ac_a, ac_b, n_samples: int):
    """(REFREF, REFALT, ALTREF, ALTALT) [I, J] from the no-missing
    contraction and per-variant allele counts (the reference's trick
    for skipping 3 of 4 popcount passes, ld_engine.cpp:683-685)."""
    (altalt,) = parts
    altref = ac_a[:, None] - altalt
    refalt = ac_b[None, :] - altalt
    refref = 2 * n_samples - (ac_a[:, None] + ac_b[None, :]) + altalt
    return refref, refalt, altref, altalt


def pair_mask_tile(valid_a, valid_b, ac_a, ac_b, diagonal: bool):
    """Candidate pairs of a tile (sweeps.tile_mask with no window and
    cls "all"): both rows real, the reference's ac skip rule
    (ac_i + ac_j > 2, ld_engine.cpp:1910-1912), and the upper triangle
    on diagonal tiles."""
    m = valid_a[:, None] & valid_b[None, :]
    m &= (ac_a[:, None] + ac_b[None, :]) > 2
    if diagonal:
        i = torch.arange(m.shape[0], device=m.device)[:, None]
        j = torch.arange(m.shape[1], device=m.device)[None, :]
        m &= i < j
    return m


def prefilter_bounds(min_r2: float, max_r2: float):
    """(lo, hi, need_nonzero) of the f32 r2 range test, rounded exactly
    as ld_kernels.phased_prefilter_cells rounds them: lo is computed in
    double and cast, hi is computed in f32 after the cast."""
    lo_d = min_r2 * 0.999 - 1e-6
    lo = np.float32(max(lo_d, 0.0))
    hi = np.float32(max_r2) * np.float32(1.001) + np.float32(1e-6)
    return lo, hi, lo_d > 0


def phased_prefilter_cells(cells, pair_mask, min_r2: float,
                           max_r2: float):
    """Conservative f32 r2 filter, the expression order of
    ld_kernels.phased_prefilter_cells (default D' bounds): integer
    guards, then D2 >= lo * denom and D2 <= hi * denom in
    multiplicative form. The host recomputes survivors exactly in f64."""
    refref, refalt, altref, altalt = cells
    t = refref + refalt + altref + altalt
    m = pair_mask & (t >= 5)
    guard = torch.where(refref < altalt,
                        refalt + altref + refref,
                        altalt + refalt + altref)
    m &= guard >= 5
    rr = refref.to(torch.float32)
    ra = refalt.to(torch.float32)
    ar = altref.to(torch.float32)
    aa = altalt.to(torch.float32)
    d_num = rr * aa - ar * ra
    d2 = d_num * d_num
    denom = (rr + ra) * (ar + aa) * (rr + ar) * (ra + aa)
    lo, hi, need_nonzero = prefilter_bounds(min_r2, max_r2)
    lo = torch.tensor(lo, device=d2.device)
    hi = torch.tensor(hi, device=d2.device)
    if need_nonzero:
        # exact-integer D = 0 means r2 ~ 0 < min_r2; also drops
        # zero-marginal tables (denom = 0 implies d_num = 0)
        m &= d_num != 0
    m &= (d2 >= lo * denom) & (d2 <= hi * denom)
    return m


def compact_indices_small(mask: torch.Tensor, cap: int):
    """(n_pass, idx[cap] int32): the flat indices of the first `cap`
    set bits of `mask`, ascending. Slots k >= n_pass hold the
    out-of-range index mask.numel(); callers read only the first
    n_pass (the contract of ld_kernels.compact_indices_small)."""
    flat = mask.reshape(-1)
    idx = torch.nonzero(flat).reshape(-1)
    out = torch.full((cap,), flat.numel(), dtype=torch.int32,
                     device=mask.device)
    k = min(idx.numel(), cap)
    out[:k] = idx[:k].to(torch.int32)
    return torch.tensor(idx.numel(), dtype=torch.int32), out
