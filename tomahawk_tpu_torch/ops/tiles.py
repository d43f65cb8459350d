"""One tile of the phased sweep: packed alt planes -> (mask, ALTALT).

Counterpart of tomahawk_tpu/ops/pallas_tiles.py (`tile_prefilter_pallas`
and the fused TPU kernel behind it). `tile_prefilter` launches the hand
kernel `csrc/phased_tile.cu` for CUDA tensors and runs the plain PyTorch
version for CPU tensors; any other device raises.

Both return mask u8 [B, B] (0 = not a candidate, 1 = candidate, 2 =
survivor of the f32 prefilter, the diagonal triangle applied) and
ALTALT i32 [B, B], the TPU kernel's contract with its parts narrowed to
the one no-missing contraction.
"""

import torch

from . import _build
from . import ld_kernels as K


def tile_prefilter_plain(dev, i: int, j: int, diag: bool, cfg):
    ac_i, ac_j = dev["ac"][i], dev["ac"][j]
    m = K.pair_mask_tile(dev["valid"][i], dev["valid"][j], ac_i, ac_j,
                         diag)
    parts = K.phased_parts_tile(dev["alt_bits"][i], dev["alt_bits"][j])
    cells = K.phased_cells(parts, ac_i, ac_j, cfg["n_samples"])
    pf = K.phased_prefilter_cells(cells, m, cfg["min_r2"], cfg["max_r2"])
    return m.to(torch.uint8) + pf.to(torch.uint8), parts[0]


def tile_prefilter(dev, i: int, j: int, diag: bool, cfg):
    """(mask, ALTALT) for the tile of super-blocks (i, j)."""
    alt = dev["alt_bits"]
    if alt.is_cuda:
        return _launch(dev, i, j, diag, cfg)
    if alt.device.type != "cpu":
        raise ValueError(f"no tile kernel for device {alt.device}")
    _build.PLAIN_CALLS["phased_tile"] += 1
    return tile_prefilter_plain(dev, i, j, diag, cfg)


def _launch(dev, i, j, diag, cfg):
    alt, ac, valid = dev["alt_bits"], dev["ac"], dev["valid"]
    if alt.dim() != 3 or alt.dtype != torch.int32:
        raise ValueError("alt_bits must be int32 [NB, B, W]")
    NB, B, W = alt.shape
    for name, t, dtype in (("ac", ac, torch.int32),
                           ("valid", valid, torch.bool)):
        if t.dtype != dtype or tuple(t.shape) != (NB, B):
            raise ValueError(f"{name} must be {dtype} [{NB}, {B}]")
    if not all(t.is_contiguous() and t.device == alt.device
               for t in (alt, ac, valid)):
        raise ValueError("tile inputs must be contiguous and on one device")
    if B != cfg["B"] or not (0 <= i < NB and 0 <= j < NB):
        raise ValueError(f"tile ({i}, {j}) outside [{NB}] x B={B}")
    lo, hi, need_nonzero = K.prefilter_bounds(cfg["min_r2"],
                                              cfg["max_r2"])
    mask = torch.empty((B, B), dtype=torch.uint8, device=alt.device)
    altalt = torch.empty((B, B), dtype=torch.int32, device=alt.device)
    lib = _build.library()
    rc = lib.twk_phased_tile(
        alt[i].data_ptr(), alt[j].data_ptr(), ac[i].data_ptr(),
        ac[j].data_ptr(), valid[i].data_ptr(), valid[j].data_ptr(),
        B, W, 2 * cfg["n_samples"], float(lo), float(hi),
        int(need_nonzero), int(bool(diag)), mask.data_ptr(),
        altalt.data_ptr(), torch.cuda.current_stream(alt.device).cuda_stream)
    _build.check(rc, "phased_tile launch")
    _build.LAUNCHES["phased_tile"] += 1
    return mask, altalt
