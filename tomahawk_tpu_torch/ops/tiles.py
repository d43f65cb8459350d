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
dispatch, read from the per-variant `an` (missing-allele counts). The
unphased instance with missing data has a wide form for rows of at least
160 words with no window (its operand stages copied by the TMA and
shared by clusters of blocks, csrc/cluster_stage.cuh): the C entry
chooses it from the arguments, `twk_parts_tile_wide` tells which it
took, and `_build.WIDE_LAUNCHES` counts the wide launches. With
cfg["window"] > 0 a pair must also share its contig (`rid`) and lie
within `window` bp (`pos`), and the kernels skip the contraction of
every thread block that can hold no such pair (`block_live`): its mask
is 0 and its region of `parts` is left unwritten. With D' bounds
(cfg["min_dprime"], cfg["max_dprime"] other than 0, 100) the prefilter
adds the in-sweep D' filter (ld_kernels.dprime_prefilter_cells; in the
kernels a term of csrc/prefilter.cuh whose bounds are runtime arguments).

`tile_prefilter` can also fill a counts buffer (`counts_buffer`): int32
[B, ceil(B / 128)], the survivors and candidates of each 128-column
segment of each mask row as n_survivors | n_candidates << 16
(`tile_counts_plain` states it). Both fused kernels write it from the
registers that hold the mask, and so does `tile_epilogue`, and the
compaction (compute/sweeps.py) then reads the mask only where a segment
has a survivor.

For the unphased table `tile_prefilter` can also count how often the
division-free screen of the f32 prefilter (csrc/prefilter.cuh's
`unphased_screen`, ld_kernels.unphased_screen_cells) settles a pair: an
int64 [2] `screen` tensor is added the candidate pairs screened and those
it left to the exact statement (`tile_screen_plain` states it). The
engine hands one to every unphased segment's sweep (compute/sweeps.py's
`fused_sweep`) and reads it back with the segment's counts.

Both versions return mask u8 [B, B] (0 = not a candidate, 1 =
candidate, 2 = survivor of the f32 prefilter, the diagonal triangle
applied) and parts i32 [P, B, B], the raw contractions in the column
order of ld_kernels.*_parts_tile: the TPU kernel's contract. In window
mode the kernels' parts are defined only where mask >= 1.

The samples-sharded sweep (compute/sweeps.py with a process group) holds
only a word slice of every plane on each rank, so it takes the tile in
two steps with an all-reduce of the parts between them:
`tile_local_parts` (csrc/local_parts.cu, the counterpart of
`tile_parts_pallas`: the P parts of the local words, every lane written)
and `tile_epilogue` (csrc/epilogue.cu: the mask, and the counts when
given, from the global parts).
Both follow the same rule: the kernel for CUDA tensors, the plain
version for CPU tensors.
"""

import torch

from . import _build
from . import ld_kernels as K

#: mask columns of one cell of a counts buffer
SEG = 128
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


def counts_buffer(cfg, device):
    """int32 [B, ceil(B / SEG)] for the per-segment counts of a tile's
    mask, which `tile_prefilter` fills in every sweep group."""
    B = cfg["B"]
    return torch.empty((B, -(-B // SEG)), dtype=torch.int32, device=device)


def tile_counts_plain(mask, seg: int = SEG):
    """The plain PyTorch version of the counts a tile kernel writes beside
    its mask: int32 [B, ceil(B / seg)], cell [k, s] = n_survivors |
    n_candidates << 16 over mask[k, s * seg:(s + 1) * seg] (survivor:
    mask == 2, candidate: mask != 0)."""
    B = mask.shape[0]
    n_seg = -(-B // seg)
    m = torch.zeros((B, n_seg * seg), dtype=torch.uint8, device=mask.device)
    m[:, :B] = mask
    m = m.view(B, n_seg, seg)
    n_pass = (m == 2).sum(dim=2, dtype=torch.int32)
    n_cand = (m != 0).sum(dim=2, dtype=torch.int32)
    return n_pass | (n_cand << 16)


def _sides(dev, i: int, j: int, cfg):
    keys = plane_keys(cfg["table"], cfg["has_missing"])
    return [dev[k][i] for k in keys], [dev[k][j] for k in keys]


def tile_local_parts_plain(dev, i: int, j: int, cfg):
    """The plain PyTorch version of `tile_local_parts`: a tuple of P
    fresh [B, B] tensors over the words `dev` holds."""
    return K.local_parts_tile(*_sides(dev, i, j, cfg), cfg["table"],
                              cfg["has_missing"])


def _pair_mask_plain(dev, i: int, j: int, diag: bool, cfg):
    """The candidate pairs of tile (i, j): ld_kernels.pair_mask_tile on
    the metadata the sweep group reads."""
    cls, win = cfg["cls"], cfg["window"]
    an = (dev["an"][i], dev["an"][j]) if cls != "all" else (None, None)
    pos_rid = ((dev["pos"][i], dev["pos"][j], dev["rid"][i], dev["rid"][j])
               if win > 0 else ())
    return K.pair_mask_tile(dev["valid"][i], dev["valid"][j], dev["ac"][i],
                            dev["ac"][j], diag, cls, *an, win, *pos_rid)


def tile_epilogue_plain(dev, i: int, j: int, diag: bool, cfg, parts):
    """The plain PyTorch version of `tile_epilogue`: a fresh mask from
    the global parts (a tuple or a [P, B, B] tensor)."""
    m = _pair_mask_plain(dev, i, j, diag, cfg)
    nh = ((dev["n_het"][i], dev["n_hom"][i], dev["n_het"][j],
           dev["n_hom"][j]) if cfg["table"] == "unphased" else ())
    return K.epilogue_tile(tuple(parts), m, cfg["table"], cfg["n_samples"],
                           cfg["min_r2"], cfg["max_r2"], dev["ac"][i],
                           dev["ac"][j], *nh, dprime=_dprime(cfg))


def tile_prefilter_plain(dev, i: int, j: int, diag: bool, cfg):
    """The plain PyTorch version: fresh (mask, parts) tensors."""
    parts = tile_local_parts_plain(dev, i, j, cfg)
    return (tile_epilogue_plain(dev, i, j, diag, cfg, parts),
            torch.stack(parts))


def tile_screen_plain(dev, i: int, j: int, diag: bool, cfg, parts):
    """The plain PyTorch version of the `screen` counts of the unphased
    tile (i, j) from its parts: int64 [2], the candidate pairs screened
    and those unphased_screen_cells leaves undecided."""
    m = _pair_mask_plain(dev, i, j, diag, cfg)
    nh = ((dev["n_het"][i], dev["n_hom"][i], dev["n_het"][j],
           dev["n_hom"][j]) if not cfg["has_missing"] else (None,) * 4)
    cells = K.unphased_cells(tuple(parts), *nh, cfg["n_samples"])
    s = K.unphased_screen_cells(cells, cfg["n_samples"], cfg["min_r2"],
                                cfg["max_r2"], *_dprime(cfg))
    und = m & (s == K.SCREEN_UNDECIDED)
    return torch.stack([m.sum(), und.sum()]).to(torch.int64)


def kernel_name(cfg) -> str:
    """The hand kernel that serves a sweep group."""
    if cfg["table"] == "phased" and not cfg["has_missing"]:
        return "phased_tile"
    return "parts_tile"


def tile_prefilter(dev, i: int, j: int, diag: bool, cfg, out=None,
                   counts=None, screen=None):
    """(mask, parts) for the tile of super-blocks (i, j), written into
    `out` (tile_buffers) when given, and returned. `counts`
    (counts_buffer) is filled with the mask's per-segment counts.
    `screen` (int64 [2], unphased table only) is added the candidate
    pairs the prefilter's screen saw and those it left undecided."""
    valid = dev["valid"]
    if out is None:
        out = tile_buffers(cfg, valid.device)
    _check_counts(cfg, counts, out[0].device)
    _check_screen(cfg, screen, out[0].device)
    if valid.is_cuda:
        return _launch(dev, i, j, diag, cfg, out, counts, screen)
    if valid.device.type != "cpu":
        raise ValueError(f"no tile kernel for device {valid.device}")
    _build.count(_build.PLAIN_CALLS, kernel_name(cfg))
    mask, parts = tile_prefilter_plain(dev, i, j, diag, cfg)
    out[0].copy_(mask)
    out[1].copy_(parts)
    if counts is not None:
        counts.copy_(tile_counts_plain(mask))
    if screen is not None:
        screen += tile_screen_plain(dev, i, j, diag, cfg, parts)
    return out


def _check_counts(cfg, counts, device):
    """Refuse a counts buffer (counts_buffer; None: none) that is not
    int32 [B, ceil(B / SEG)], contiguous, on `device`."""
    if counts is None:
        return
    shape = (cfg["B"], -(-cfg["B"] // SEG))
    if counts.dtype != torch.int32 or tuple(counts.shape) != shape \
            or not counts.is_contiguous() or counts.device != device:
        raise ValueError(f"counts {tuple(counts.shape)} {counts.dtype} on "
                         f"{counts.device}: expected {shape} torch.int32, "
                         f"contiguous, on {device}")


def _check_screen(cfg, screen, device):
    """Refuse a screen buffer (None: none) that is not int64 [2],
    contiguous, on `device`, or is given for the phased table."""
    if screen is None:
        return
    if cfg["table"] != "unphased":
        raise ValueError("the prefilter's screen serves the unphased "
                         "table only")
    if screen.dtype != torch.int64 or tuple(screen.shape) != (2,) \
            or not screen.is_contiguous() or screen.device != device:
        raise ValueError(f"screen {tuple(screen.shape)} {screen.dtype} on "
                         f"{screen.device}: expected (2,) torch.int64, "
                         f"contiguous, on {device}")


def _meta_keys(cfg):
    """The per-variant tensors a tile's mask and cells read."""
    meta = ["ac", "valid"]
    if cfg["cls"] != "all":
        meta.append("an")
    if cfg["table"] == "unphased" and not cfg["has_missing"]:
        meta += ["n_het", "n_hom"]
    if cfg["window"] > 0:
        meta += ["pos", "rid"]
    return meta


def _check_inputs(dev, cfg, out, planes=True, meta=True):
    """(NB, B, W) after checking every tensor the kernel reads and
    writes: dtype, shape, contiguity and device. W is the word count the
    device holds, which on a rank of a samples-sharded run is its slice
    of the row. `planes` and `meta` select what the kernel reads (the
    parts-only kernel reads no metadata and writes no mask, the epilogue
    reads no plane; W is then 0)."""
    mask, parts = out
    device = parts.device
    B = cfg["B"]
    P = payload_cols(cfg["table"], cfg["has_missing"])
    tensors = [("parts", parts, torch.int32, (P, B, B))]
    W = 0
    if planes:
        keys = plane_keys(cfg["table"], cfg["has_missing"])
        first = dev[keys[0]]
        if first.dim() != 3 or first.shape[2] < 1:
            raise ValueError(f"{keys[0]} must be int32 [NB, B, W >= 1]")
        NB, _, W = first.shape
        tensors += [(k, dev[k], torch.int32, (NB, B, W)) for k in keys]
    else:
        NB = dev["ac"].shape[0]
    if meta:
        tensors += [(k, dev[k], torch.bool if k == "valid" else torch.int32,
                     (NB, B)) for k in _meta_keys(cfg)]
        tensors.append(("mask", mask, torch.uint8, (B, B)))
    for name, t, dtype, shape in tensors:
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != device:
            raise ValueError(f"tile input {name} {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}: expected {shape} "
                             f"{dtype}, contiguous, on {device}")
    if B * B >= 1 << 31:
        raise ValueError(f"tile rows {B} too many for an int32 flat index")
    return NB, B, W


def _dprime(cfg):
    return cfg["min_dprime"], cfg["max_dprime"]


def _bounds(cfg):
    """(lo, hi, dp_lo, dp_hi, need_nonzero): the f32 prefilter's r2
    bounds and its D' bounds, (-inf, inf) where the D' filter is off."""
    if cfg["table"] == "phased":
        lo, hi, need_nonzero = K.prefilter_bounds(cfg["min_r2"],
                                                  cfg["max_r2"])
    else:
        (lo, hi), need_nonzero = K.unphased_bounds(cfg["min_r2"],
                                                   cfg["max_r2"]), False
    return (lo, hi, *K.dprime_bounds(*_dprime(cfg)), need_nonzero)


def sweep_args(dev, cfg) -> list:
    """The arguments of csrc/sweep.cu's `twk_sweep` that hold for every
    tile of a sweep: the instance, the base pointers of the word planes
    and of the metadata the group reads (None for the rest), the word
    count and the prefilter's terms. Check the tensors first
    (`_check_inputs`)."""
    table, miss = cfg["table"], cfg["has_missing"]
    keys = plane_keys(table, miss)
    planes = [dev[k].data_ptr() for k in keys] + [None] * (3 - len(keys))
    meta = set(_meta_keys(cfg))
    ptr = lambda k: dev[k].data_ptr() if k in meta else None
    *bounds, need_nonzero = _bounds(cfg)
    return [-1 if kernel_name(cfg) == "phased_tile" else _KIND[(table, miss)],
            *planes, dev[keys[0]].shape[-1],
            *[ptr(k) for k in ("ac", "valid", "an", "n_het", "n_hom", "pos",
                               "rid")],
            int(cfg["window"]), _CLS[cfg["cls"]], cfg["B"], cfg["n_samples"],
            *map(float, bounds), int(need_nonzero)]


def _launch(dev, i, j, diag, cfg, out, counts=None, screen=None):
    NB, B, W = _check_inputs(dev, cfg, out)
    _in_range(i, j, NB)
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
    *bounds, need_nonzero = map(float, _bounds(cfg))
    name = kernel_name(cfg)
    if screen is not None and counts is None:
        # the kernel counts the screened pairs from its row counts
        counts = counts_buffer(cfg, mask.device)
    cnt = None if counts is None else counts.data_ptr()
    if name == "phased_tile":
        rc = lib.twk_phased_tile(
            ptr("alt_bits", i), ptr("alt_bits", j), ptr("ac", i),
            ptr("ac", j), ptr("valid", i), ptr("valid", j), *an, *win,
            window, cls_code, B, W, 2 * cfg["n_samples"], *bounds,
            int(need_nonzero), int(bool(diag)), mask.data_ptr(),
            parts.data_ptr(), cnt, stream)
    else:
        keys = plane_keys(table, miss)
        side = lambda s: [ptr(k, s) for k in keys] + [None] * (3 - len(keys))
        nh = ([ptr("n_het", i), ptr("n_hom", i), ptr("n_het", j),
               ptr("n_hom", j)] if table == "unphased" and not miss
              else [None] * 4)
        rc = lib.twk_parts_tile(
            _KIND[(table, miss)], *side(i), *side(j), ptr("ac", i),
            ptr("ac", j), ptr("valid", i), ptr("valid", j), *an, *nh, *win,
            window, cls_code, B, W, cfg["n_samples"], *bounds,
            int(need_nonzero), int(bool(diag)), mask.data_ptr(),
            parts.data_ptr(), cnt,
            None if screen is None else screen.data_ptr(), stream)
    _build.check(rc, f"{name} launch")
    _build.count(_build.LAUNCHES, name, device=mask.device)
    if name == "parts_tile":
        _build.count(_build.WIDE_LAUNCHES, name, lib.twk_parts_tile_wide(
            _KIND[(table, miss)], window, W, *side(i), *side(j)))
    return out


#: local_parts.cu's and epilogue.cu's instance codes
_LOCAL_KIND = {("phased", False): 0, ("phased", True): 1,
               ("unphased", False): 2, ("unphased", True): 3}


def tile_local_parts(dev, i: int, j: int, cfg, out):
    """The P raw parts of tile (i, j) over the words `dev` holds (a
    rank's slice of every plane in a samples-sharded run), written into
    every lane of out[1] (tile_buffers); out[0] is left alone. The sum
    over the ranks is the tile's global parts."""
    parts = out[1]
    if parts.is_cuda:
        return _launch_local_parts(dev, i, j, cfg, out)
    if parts.device.type != "cpu":
        raise ValueError(f"no tile kernel for device {parts.device}")
    _build.count(_build.PLAIN_CALLS, "local_parts")
    parts.copy_(torch.stack(tile_local_parts_plain(dev, i, j, cfg)))
    return parts


def tile_epilogue(dev, i: int, j: int, diag: bool, cfg, out, counts=None):
    """The mask of tile (i, j) from its global parts in out[1], written
    into out[0]; returns `out`, the (mask, parts) a fused tile kernel
    gives. `counts` (counts_buffer) is filled with the mask's
    per-segment counts, as `tile_prefilter` fills it."""
    mask, parts = out
    _check_counts(cfg, counts, mask.device)
    if parts.is_cuda:
        return _launch_epilogue(dev, i, j, diag, cfg, out, counts)
    if parts.device.type != "cpu":
        raise ValueError(f"no tile kernel for device {parts.device}")
    _build.count(_build.PLAIN_CALLS, "tile_epilogue")
    mask.copy_(tile_epilogue_plain(dev, i, j, diag, cfg, parts))
    if counts is not None:
        counts.copy_(tile_counts_plain(mask))
    return out


def _in_range(i, j, NB):
    if not (0 <= i < NB and 0 <= j < NB):
        raise ValueError(f"tile ({i}, {j}) outside [{NB}]")


def _launch_local_parts(dev, i, j, cfg, out):
    NB, B, W = _check_inputs(dev, cfg, out, meta=False)
    _in_range(i, j, NB)
    keys = plane_keys(cfg["table"], cfg["has_missing"])
    side = lambda s: [dev[k][s].data_ptr() for k in keys] \
        + [None] * (3 - len(keys))
    parts = out[1]
    rc = _build.library().twk_local_parts(
        _LOCAL_KIND[(cfg["table"], cfg["has_missing"])], *side(i), *side(j),
        B, W, parts.data_ptr(),
        torch.cuda.current_stream(parts.device).cuda_stream)
    _build.check(rc, "local_parts launch")
    _build.count(_build.LAUNCHES, "local_parts", device=parts.device)
    return parts


def _launch_epilogue(dev, i, j, diag, cfg, out, counts=None):
    NB, B, _ = _check_inputs(dev, cfg, out, planes=False)
    _in_range(i, j, NB)
    table, miss, cls = cfg["table"], cfg["has_missing"], cfg["cls"]
    mask, parts = out
    ptr = lambda k, s: dev[k][s].data_ptr()
    an = [ptr("an", i), ptr("an", j)] if cls != "all" else [None, None]
    nh = ([ptr("n_het", i), ptr("n_hom", i), ptr("n_het", j),
           ptr("n_hom", j)] if table == "unphased" and not miss
          else [None] * 4)
    window = int(cfg["window"])
    win = ([ptr("pos", i), ptr("pos", j), ptr("rid", i), ptr("rid", j)]
           if window > 0 else [None] * 4)
    *bounds, need_nonzero = map(float, _bounds(cfg))
    rc = _build.library().twk_tile_epilogue(
        _LOCAL_KIND[(table, miss)], parts.data_ptr(), ptr("ac", i),
        ptr("ac", j), ptr("valid", i), ptr("valid", j), *an, *nh, *win,
        window, _CLS[cls], B, cfg["n_samples"], *bounds,
        int(need_nonzero), int(bool(diag)), mask.data_ptr(),
        None if counts is None else counts.data_ptr(),
        torch.cuda.current_stream(mask.device).cuda_stream)
    _build.check(rc, "tile_epilogue launch")
    _build.count(_build.LAUNCHES, "tile_epilogue", device=mask.device)
    return out
