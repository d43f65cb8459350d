"""One tile of a sweep: packed planes -> (mask, parts).

Counterpart of tomahawk_tpu/ops/pallas_tiles.py (`tile_prefilter_pallas`
and the fused TPU kernel behind it) for every sweep group, with and
without a distance window. `tile_prefilter` launches a hand kernel for
CUDA tensors and runs the plain PyTorch version for CPU tensors; any
other device raises.
The kernel serving each group:

    (table, has_missing)   planes per side         P   kernel
    phased, no missing     alt                     1   csrc/phased_tile.cu
    phased, missing        alt, miss               4   csrc/parts_tile.cu
    unphased, no missing   het, hom                4   csrc/parts_tile.cu
    unphased, missing      het, hom, valid         9   csrc/parts_tile.cu

each with the pair class `cls` ("all", "clean", "missing") of the mixed
dispatch, read from the per-variant `an` (missing-allele counts). With
cfg["window"] > 0 a pair must also share its contig (`rid`) and lie
within `window` bp (`pos`), and the kernels skip the contraction of
every thread block that can hold no such pair (`block_live`): its mask
is 0 and its region of `parts` is left unwritten.

Both versions return mask u8 [B, B] (0 = not a candidate, 1 =
candidate, 2 = survivor of the f32 prefilter, the diagonal triangle
applied) and parts i32 [P, B, B], the raw contractions in the column
order of ld_kernels.*_parts_tile: the TPU kernel's contract. In window
mode the kernels' parts are defined only where mask >= 1.
"""

import torch

from . import _build
from . import ld_kernels as K

_CLS = {"all": 0, "clean": 1, "missing": 2}
#: parts_tile.cu's instance codes
_KIND = {("phased", True): 0, ("unphased", False): 1, ("unphased", True): 2}


def payload_cols(table: str, has_missing: bool) -> int:
    """Raw contraction parts of a tile, and per survivor (the host
    re-derives the full table from these plus per-variant metadata)."""
    if table == "phased":
        return 4 if has_missing else 1
    return 9 if has_missing else 4


def plane_keys(table: str, has_missing: bool):
    """The packed planes one side of a tile reads."""
    if table == "phased":
        return ("alt_bits", "miss_bits") if has_missing else ("alt_bits",)
    return (("het_bits", "hom_bits", "valid_bits") if has_missing
            else ("het_bits", "hom_bits"))


def tile_buffers(cfg, device):
    """(mask u8 [B, B], parts i32 [P, B, B]): output buffers a sweep
    allocates once and hands to every tile (at P = 9 and B = 4096 the
    parts alone are 604 MB)."""
    B = cfg["B"]
    P = payload_cols(cfg["table"], cfg["has_missing"])
    return (torch.empty((B, B), dtype=torch.uint8, device=device),
            torch.empty((P, B, B), dtype=torch.int32, device=device))


def tile_prefilter_plain(dev, i: int, j: int, diag: bool, cfg):
    """The plain PyTorch version: fresh (mask, parts) tensors."""
    table, miss, cls = cfg["table"], cfg["has_missing"], cfg["cls"]
    ac_i, ac_j = dev["ac"][i], dev["ac"][j]
    an_i, an_j = ((dev["an"][i], dev["an"][j]) if cls != "all"
                  else (None, None))
    win = cfg["window"]
    pos_rid = ((dev["pos"][i], dev["pos"][j], dev["rid"][i], dev["rid"][j])
               if win > 0 else ())
    m = K.pair_mask_tile(dev["valid"][i], dev["valid"][j], ac_i, ac_j,
                         diag, cls, an_i, an_j, win, *pos_rid)
    n = cfg["n_samples"]
    if table == "phased":
        miss_i, miss_j = ((dev["miss_bits"][i], dev["miss_bits"][j])
                          if miss else (None, None))
        parts = K.phased_parts_tile(dev["alt_bits"][i], dev["alt_bits"][j],
                                    miss_i, miss_j)
        cells = K.phased_cells(parts, ac_i, ac_j, n)
        pf = K.phased_prefilter_cells(cells, m, cfg["min_r2"],
                                      cfg["max_r2"])
    else:
        val_i, val_j = ((dev["valid_bits"][i], dev["valid_bits"][j])
                        if miss else (None, None))
        parts = K.unphased_parts_tile(
            dev["het_bits"][i], dev["hom_bits"][i], val_i,
            dev["het_bits"][j], dev["hom_bits"][j], val_j, miss)
        cells = K.unphased_cells(parts, dev["n_het"][i], dev["n_hom"][i],
                                 dev["n_het"][j], dev["n_hom"][j], n)
        pf = K.unphased_prefilter_cells(cells, m, cfg["min_r2"],
                                        cfg["max_r2"])
    return m.to(torch.uint8) + pf.to(torch.uint8), torch.stack(parts)


def kernel_name(cfg) -> str:
    """The hand kernel that serves a sweep group."""
    if cfg["table"] == "phased" and not cfg["has_missing"]:
        return "phased_tile"
    return "parts_tile"


def tile_prefilter(dev, i: int, j: int, diag: bool, cfg, out=None):
    """(mask, parts) for the tile of super-blocks (i, j), written into
    `out` (tile_buffers) when given, and returned."""
    valid = dev["valid"]
    if out is None:
        out = tile_buffers(cfg, valid.device)
    if valid.is_cuda:
        return _launch(dev, i, j, diag, cfg, out)
    if valid.device.type != "cpu":
        raise ValueError(f"no tile kernel for device {valid.device}")
    _build.PLAIN_CALLS[kernel_name(cfg)] += 1
    mask, parts = tile_prefilter_plain(dev, i, j, diag, cfg)
    out[0].copy_(mask)
    out[1].copy_(parts)
    return out


def _check_inputs(dev, cfg, out):
    """(NB, B, W) after checking every tensor the kernel reads and
    writes: dtype, shape, contiguity and device."""
    keys = plane_keys(cfg["table"], cfg["has_missing"])
    first = dev[keys[0]]
    if first.dim() != 3:
        raise ValueError(f"{keys[0]} must be int32 [NB, B, W]")
    NB, B, W = first.shape
    P = payload_cols(cfg["table"], cfg["has_missing"])
    want = [(k, torch.int32, (NB, B, W)) for k in keys]
    meta = ["ac", "valid"]
    if cfg["cls"] != "all":
        meta.append("an")
    if cfg["table"] == "unphased" and not cfg["has_missing"]:
        meta += ["n_het", "n_hom"]
    if cfg["window"] > 0:
        meta += ["pos", "rid"]
    want += [(k, torch.bool if k == "valid" else torch.int32, (NB, B))
             for k in meta]
    tensors = [(k, dev[k], dt, shape) for k, dt, shape in want]
    tensors += [("mask", out[0], torch.uint8, (B, B)),
                ("parts", out[1], torch.int32, (P, B, B))]
    for name, t, dtype, shape in tensors:
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != first.device:
            raise ValueError(f"tile input {name} {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}: expected {shape} "
                             f"{dtype}, contiguous, on {first.device}")
    if B != cfg["B"] or B * B >= 1 << 31:
        raise ValueError(f"tile rows {B} do not match B={cfg['B']}")
    return NB, B, W


def _launch(dev, i, j, diag, cfg, out):
    NB, B, W = _check_inputs(dev, cfg, out)
    if not (0 <= i < NB and 0 <= j < NB):
        raise ValueError(f"tile ({i}, {j}) outside [{NB}]")
    table, miss, cls = cfg["table"], cfg["has_missing"], cfg["cls"]
    mask, parts = out
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    ptr = lambda k, s: dev[k][s].data_ptr()
    cls_code = _CLS[cls]
    an = [ptr("an", i), ptr("an", j)] if cls != "all" else [None, None]
    window = int(cfg["window"])
    win = ([ptr("pos", i), ptr("pos", j), ptr("rid", i), ptr("rid", j)]
           if window > 0 else [None] * 4)
    lib = _build.library()
    if table == "phased":
        lo, hi, need_nonzero = K.prefilter_bounds(cfg["min_r2"],
                                                  cfg["max_r2"])
    else:
        lo, hi = K.unphased_bounds(cfg["min_r2"], cfg["max_r2"])
        need_nonzero = False
    name = kernel_name(cfg)
    if name == "phased_tile":
        rc = lib.twk_phased_tile(
            ptr("alt_bits", i), ptr("alt_bits", j), ptr("ac", i),
            ptr("ac", j), ptr("valid", i), ptr("valid", j), *an, *win,
            window, cls_code, B, W, 2 * cfg["n_samples"], float(lo),
            float(hi), int(need_nonzero), int(bool(diag)), mask.data_ptr(),
            parts.data_ptr(), stream)
    else:
        keys = plane_keys(table, miss)
        side = lambda s: [ptr(k, s) for k in keys] + [None] * (3 - len(keys))
        nh = ([ptr("n_het", i), ptr("n_hom", i), ptr("n_het", j),
               ptr("n_hom", j)] if table == "unphased" and not miss
              else [None] * 4)
        rc = lib.twk_parts_tile(
            _KIND[(table, miss)], *side(i), *side(j), ptr("ac", i),
            ptr("ac", j), ptr("valid", i), ptr("valid", j), *an, *nh, *win,
            window, cls_code, B, W, cfg["n_samples"], float(lo), float(hi),
            int(need_nonzero), int(bool(diag)), mask.data_ptr(),
            parts.data_ptr(), stream)
    _build.check(rc, f"{name} launch")
    _build.LAUNCHES[name] += 1
    return out
