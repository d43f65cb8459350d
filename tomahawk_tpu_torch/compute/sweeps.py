"""Tile sweeps on one device: counts and survivor compaction.

Counterpart of tomahawk_tpu/compute/sweeps.py for every sweep group,
with or without a distance window and D' bounds. The JAX
package scans a jitted body over the tile list; here, on a card, one C
call (`_launch_sweep`, csrc/sweep.cu) walks the segment's tile list and
enqueues, per tile, the fused tile kernel (ops/tiles.py) and the
survivor compaction (`compact_survivors`, csrc/compact.cu), with every
input checked once a sweep. The CPU's plain versions, the
samples-sharded sweep (an all-reduce between its kernels) and
`count_sweep` keep a Python loop over the tiles. The compaction keeps
the running offset on the device, so a segment of tiles runs without a
host sync and the host reads the counts once, after the whole segment
(`host_counts`, which also raises where a compaction reported a fault).
A sweep allocates the tile's output buffers, the compaction's scratch
and the per-segment counts buffer the tile kernels write (the fused
kernels, or the samples-sharded sweep's epilogue) once and reuses them
for every tile; with the counts the compaction reads the mask only where
a segment has a survivor.

Survivor rows are [flat index k*B + l, payload...] int32 in the layout
of the JAX package's `_pack_cols`: while the parts fit uint16
(`pack16_ok`) they ride two per column as `lo | hi << 16`, an odd last
part unshifted; otherwise one part per column. `unpack_payload` is the
host inverse, as the JAX package has it. A phased fused sweep with
`fisher` set adds the in-sweep Fisher bracket of its survivors
(`append_fisher_col`, csrc/fisher_bracket.cu, behind the compactions on
the same stream): bf16 in the top 16 bits of the payload column
(`fisher_packed`), or an f32 column after the payload (`fisher_cols`,
`out_cols`), when the segment holds FISHER_MIN_ROWS survivors.

Samples-sharded sweeps (`make_cfg(..., psum_group=...)`, the counterpart
of the JAX sweeps under a mesh with a 'samples' axis): every rank of the
group holds a word slice of the planes (`planes_to_device(...,
word_slice=(s, S))`) and walks the same tile list; per tile it runs
`tile_local_parts`, sums the parts over the group in place
(`parallel.all_reduce_parts`, the JAX `psum`) and runs `tile_epilogue`
on the global counts, which writes the mask and its per-segment counts,
then the same compaction. Counts and survivor rows are then identical on
every rank. The group is a process group (`--mesh dcn`), or the
`parallel.SamplesGroup` of one row of a local mesh, whose peers' local
parts the sweep computes beside its own, each on its device, before the
sum (an add on the row's first device). A pairs shard of a mesh is one
sweep on its row's devices: the engine splits the tile list.
"""

import ctypes

import numpy as np
import torch

from ..device import on_device
from ..ops import _build
from ..ops import fisher_dev as F
from ..ops import ld_kernels as K
from ..ops.tiles import (SEG, _check_inputs, _check_screen, counts_buffer,
                         kernel_name, payload_cols, plane_keys, sweep_args,
                         tile_buffers, tile_epilogue, tile_local_parts,
                         tile_prefilter)
from ..parallel.distributed import all_reduce_parts

#: device tensors the sweeps may read: uint32 planes (as int32),
#: positions and contig ids (window sweeps), per-variant allele,
#: missing-allele and genotype-class counts, and the real-row flags
DEV_KEYS = ("alt_bits", "miss_bits", "het_bits", "hom_bits", "valid_bits",
            "pos", "rid", "ac", "an", "n_het", "n_hom", "valid")
#: the packed-word planes: what a samples-sharded run slices over ranks
WORD_KEYS = ("alt_bits", "miss_bits", "het_bits", "hom_bits", "valid_bits")


def dev_keys_for(cfg) -> tuple:
    """The subset of DEV_KEYS a sweep config reads (the JAX package's
    `dev_keys_for`): pos and rid upload only for window sweeps."""
    keys = {"ac", "valid", *plane_keys(cfg["table"], cfg["has_missing"])}
    if cfg["table"] == "unphased":
        keys |= {"n_het", "n_hom"}
    if cfg["window"] > 0:
        keys |= {"pos", "rid"}
    if cfg["cls"] != "all":
        keys.add("an")
    return tuple(k for k in DEV_KEYS if k in keys)


def pad_words(a, k: str, S: int) -> np.ndarray:
    """Array `a` of key `k` with a word plane's word axis padded to a
    multiple of S: with zeros, and with ones for `miss_bits` (padding is
    "missing"), as the JAX engine pads for a 'samples' mesh axis."""
    W = a.shape[-1]
    Wp = -(-W // S) * S
    if k not in WORD_KEYS or Wp == W:
        return a
    pad = np.zeros((*a.shape[:-1], Wp - W), a.dtype)
    return np.concatenate([a, ~pad if k == "miss_bits" else pad], axis=-1)


def host_plane(a, k: str, word_slice=None) -> np.ndarray:
    """Array `a` of key `k` as the device holds it: contiguous, uint32
    planes as int32 views of the same bits and, with `word_slice=(s, S)`,
    a word plane cut to the s-th of S equal slices of its word axis, the
    axis first padded to a multiple of S (`pad_words`)."""
    if word_slice is not None and k in WORD_KEYS:
        s, S = word_slice
        a = pad_words(a, k, S)
        wl = a.shape[-1] // S
        a = a[..., s * wl:(s + 1) * wl]
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def planes_to_device(stacked: dict, device, keys=DEV_KEYS,
                     word_slice=None) -> dict:
    """The port's device tensors for `keys`, from the numpy plane dict
    (`bitpack.stack_planes` output; `host_plane` of each): the
    counterpart of the JAX engine's band upload (`LdEngine._upload` /
    `_band_dev_get`)."""
    return {k: torch.from_numpy(host_plane(stacked[k], k, word_slice))
            .to(device) for k in keys}


def make_cfg(table: str, has_missing: bool, cls: str, B: int,
             n_samples: int, window: int, min_r2: float, max_r2: float,
             min_dprime: float = 0.0, max_dprime: float = 100.0,
             psum_group=None, fisher: bool = False) -> dict:
    """Sweep configuration. D' bounds other than (0, 100) add the
    in-sweep D' filter to the prefilter of every tile. `psum_group` (a
    parallel.ProcessGroup) makes the sweeps samples-sharded: the parts of
    every tile are summed over its ranks. `fisher` asks the fused sweep
    for the in-sweep Fisher bracket (`fisher_on`)."""
    if table not in ("phased", "unphased") or cls not in ("all", "clean",
                                                          "missing"):
        raise ValueError(f"no sweep group ({table!r}, {cls!r})")
    if not 0 <= window < 1 << 31:
        raise ValueError(f"window {window} outside [0, 2**31) bp")
    return dict(table=table, has_missing=has_missing, cls=cls, B=B,
                n_samples=n_samples, window=window, min_r2=min_r2,
                max_r2=max_r2, psum_group=psum_group, min_dprime=min_dprime,
                max_dprime=max_dprime, fisher=fisher)


def pack16_ok(cfg) -> bool:
    """Whether survivor payload parts fit uint16 so two can ride one
    int32 buffer column. Phased parts are haplotype-level counts
    (<= 2N), unphased genotype-level (<= N)."""
    lim = (2 if cfg["table"] == "phased" else 1) * cfg["n_samples"]
    return lim < (1 << 16)


def buf_cols(cfg) -> int:
    """Survivor buffer columns: 1 index col + (possibly pair-packed)
    payload cols."""
    p = payload_cols(cfg["table"], cfg["has_missing"])
    return 1 + ((p + 1) // 2 if pack16_ok(cfg) else p)


def fisher_on(cfg) -> bool:
    """Whether the fused sweep carries the in-sweep Fisher bracket
    (phased tables; the unphased EM path keeps Fisher on the host)."""
    return bool(cfg.get("fisher")) and cfg["table"] == "phased"


def fisher_packed(cfg) -> bool:
    """Whether the bracket rides the unused top 16 bits of the single
    payload column as bf16 instead of a column of its own: phased, no
    missing data, parts that fit uint16. Safe only where the device can
    bound P < 1e-4 (bf16's 2**-9 relative error is then < 2e-7 absolute);
    larger-P lanes are flagged for the exact host recompute."""
    return fisher_on(cfg) and not cfg["has_missing"] and pack16_ok(cfg)


def fisher_cols(cfg) -> int:
    """Columns the Fisher bracket adds to the fused sweep's buffer."""
    return 1 if fisher_on(cfg) and not fisher_packed(cfg) else 0


def out_cols(cfg) -> int:
    """Columns of the fused sweep's survivor buffer: `buf_cols`, then the
    Fisher column where there is one (the repair sweep's rows have none)."""
    return buf_cols(cfg) + fisher_cols(cfg)


#: segment survivors below which the fused sweep leaves the bracket out:
#: the host's exact Fisher of a sparse segment costs less than a walk
#: over the buffer. The host mirrors the rule from the same integer
#: n_pass (the JAX package's FISHER_MIN_ROWS), so both sides agree on
#: which rows carry a bracket
FISHER_MIN_ROWS = 16384


def unpack_payload(cols, table: str, has_missing: bool,
                   n_samples: int):
    """Host inverse of the payload packing: [K, buf_cols-1] int32
    buffer columns -> [K, payload_cols] int64 parts."""
    p = payload_cols(table, has_missing)
    cfg = dict(table=table, n_samples=n_samples)
    if not pack16_ok(cfg):
        return cols.astype(np.int64)
    out = np.empty((len(cols), p), np.int64)
    for k in range(cols.shape[1]):
        v = cols[:, k].astype(np.int64) & 0xFFFFFFFF
        out[:, 2 * k] = v & 0xFFFF
        if 2 * k + 1 < p:
            out[:, 2 * k + 1] = (v >> 16) & 0xFFFF
    return out


def _payload_layout(P: int, ncol: int) -> bool:
    """Whether a [*, ncol] buffer holds P parts pair-packed (True) or
    one per column (False); with one part the two layouts agree."""
    if ncol == 1 + (P + 1) // 2:
        return True
    if ncol == 1 + P:
        return False
    raise ValueError(f"a survivor buffer of {ncol} columns holds neither "
                     f"layout of {P} parts")


def compact_survivors_plain(mask, parts, off, buf, n_pass, n_cand,
                            t: int, cap: int, ncol: int = None):
    outcap = buf.shape[0]
    ncol = ncol or buf.shape[1]
    packed = _payload_layout(parts.shape[0], ncol)
    n, idx = K.compact_indices_small(mask == 2, cap)
    n = int(n)
    o = int(off[0])
    k = min(n, cap)
    if k:
        base = min(o, outcap - cap)
        idx = idx[:k].long()
        vals = [p.reshape(-1)[idx] for p in parts]
        if packed:
            vals = [vals[q] | (vals[q + 1] << 16) if q + 1 < len(vals)
                    else vals[q] for q in range(0, len(vals), 2)]
        buf[base:base + k, 0] = idx.to(torch.int32)
        buf[base:base + k, 1:ncol] = torch.stack(vals, dim=1)
    n_pass[t] = n
    n_cand[t] = int((mask != 0).sum())
    off[0] = min(o + n, outcap)


def sweep_bytes(cfg, outcap: int) -> int:
    """Device bytes one fused sweep of a segment allocates beside the
    planes: its tile buffers (mask and parts), the counts buffer, the
    compaction's scratch and the survivor buffer of `outcap` rows."""
    B = cfg["B"]
    P = payload_cols(cfg["table"], cfg["has_missing"])
    return (B * B * (1 + 4 * P) + 4 * B * -(-B // SEG)
            + 4 * _scratch_len(B) + 4 * outcap * out_cols(cfg))


def compact_scratch(B: int, device):
    """The compaction's scratch for tiles of B rows: int32 row totals,
    row offsets and the scan's two results. A sweep allocates it once."""
    return torch.empty(_scratch_len(B), dtype=torch.int32, device=device)


def _scratch_len(B: int) -> int:
    return 2 * B + 2


#: the scan's ticket counter of each (device, stream): one int32 that the
#: kernel finds 0 and leaves 0, so it is zeroed once, here. Found not 0,
#: the kernel sets it to 0 and marks the tile's n_pass with TICKET_FAULT
_TICKETS = {}
#: n_pass of a tile whose compaction found its scan's ticket not 0 (a
#: scan on the stream died midway): its count, offset and rows are wrong
TICKET_FAULT = -1


def _ticket(device, stream: int):
    key = (device, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _TICKETS[key]


def compact_survivors(mask, parts, off, buf, n_pass, n_cand, t: int,
                      cap: int, counts=None, scratch=None, ncol=None):
    """Write the first min(n, cap) survivors (mask == 2) of one tile,
    ascending in flat index, as [k*B + l, payload...] rows at buffer row
    min(off, outcap - cap), outcap = len(buf); set n_pass[t] and
    n_cand[t]; advance off to min(off + n, outcap). `parts` is i32
    [P, B, B]; the payload layout follows `ncol`, the buffer's width by
    default (buf_cols: pair-packed or one part per column), and columns
    past it (the Fisher column) are left alone. `off` is an int32 [1] tensor
    updated in place. `counts` are the mask's per-segment counts that its
    producer wrote (tiles.counts_buffer), which the kernel reads in place
    of the mask: a CUDA mask without them raises ValueError, and the
    plain version counts its own mask. `scratch` (compact_scratch) is
    allocated here when not given. Launches csrc/compact.cu for CUDA
    tensors, the plain version for CPU tensors. The kernel reports a
    stale scan ticket as n_pass[t] = TICKET_FAULT, which `host_counts`
    raises for where the host reads the counts."""
    if mask.is_cuda:
        if counts is None:
            raise ValueError("the compaction kernel reads the mask's "
                             "per-segment counts (tiles.counts_buffer), "
                             "which the tile kernels write; none given")
        return _launch_compact(mask, parts, off, buf, n_pass, n_cand, t,
                               cap, counts, scratch, ncol)
    if mask.device.type != "cpu":
        raise ValueError(f"no compaction kernel for device {mask.device}")
    _build.count(_build.PLAIN_CALLS, "compact")
    return compact_survivors_plain(mask, parts, off, buf, n_pass, n_cand,
                                   t, cap, ncol)


def _check_compact(mask, parts, off, buf, n_pass, n_cand, cap, counts,
                   scratch, n_off=1, ncol=None):
    """Check every tensor the compaction reads and writes: dtype, shape,
    contiguity and device. `off` holds `n_off` offsets; the payload
    layout has `ncol` columns (the buffer's width by default). Returns
    ncol."""
    B = mask.shape[0]
    P = parts.shape[0]
    outcap, ld = buf.shape
    ncol = ncol or ld
    _payload_layout(P, ncol)
    if ncol > ld:
        raise ValueError(f"a payload of {ncol} columns in a buffer of {ld}")
    checks = [
        (mask, torch.uint8, (B, B)), (parts, torch.int32, (P, B, B)),
        (off, torch.int32, (n_off,)), (buf, torch.int32, (outcap, ld)),
        (n_pass, torch.int32, tuple(n_pass.shape)),
        (n_cand, torch.int32, tuple(n_pass.shape)),
        (scratch, torch.int32, (_scratch_len(B),)),
        (counts, torch.int32, (B, -(-B // SEG)))]
    for x, dtype, shape in checks:
        if x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous() or x.device != mask.device:
            raise ValueError(f"compaction input {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}: expected {shape} "
                             f"{dtype}, contiguous, on {mask.device}")
    if n_pass.dim() != 1:
        raise ValueError("n_pass must be one-dimensional")
    if not 0 < cap <= outcap or B * B >= 1 << 31:
        raise ValueError(f"bad compaction shape: B={B} cap={cap} "
                         f"outcap={outcap}")
    return ncol


def _launch_compact(mask, parts, off, buf, n_pass, n_cand, t, cap, counts,
                    scratch, ncol=None):
    B = mask.shape[0]
    P = parts.shape[0]
    outcap, ld = buf.shape
    if scratch is None:
        scratch = compact_scratch(B, mask.device)
    ncol = _check_compact(mask, parts, off, buf, n_pass, n_cand, cap, counts,
                          scratch, ncol=ncol)
    if not 0 <= t < n_pass.shape[0]:
        raise ValueError(f"tile index {t} outside n_pass")
    lib = _build.library()
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    rc = lib.twk_compact(
        mask.data_ptr(), parts.data_ptr(),
        counts.data_ptr(), P, ncol, ld, B,
        off.data_ptr(), cap, outcap, n_pass.data_ptr(), n_cand.data_ptr(), t,
        scratch.data_ptr(), _ticket(mask.device, stream).data_ptr(),
        buf.data_ptr(), stream)
    _build.check(rc, "compact launch")
    _build.count(_build.LAUNCHES, "compact", device=mask.device)


def host_counts(n_pass, n_cand):
    """(n_pass, n_cand) of a sweep as int64 numpy arrays: the sweep's one
    host sync. Raises RuntimeError where a compaction marked a tile with
    TICKET_FAULT: the sweep's rows and offsets are not to be trusted (the
    ticket is 0 again, so the stream can run the next sweep)."""
    n = n_pass.cpu().numpy().astype(np.int64)
    bad = np.flatnonzero(n == TICKET_FAULT)
    if len(bad):
        raise RuntimeError(f"the compaction of tiles {bad.tolist()} found "
                           f"its scan's ticket not 0 (an earlier compaction "
                           f"on this stream died midway); the sweep's "
                           f"survivor rows are not to be trusted")
    return n, n_cand.cpu().numpy().astype(np.int64)


def _zeros(dev, *shape):
    return torch.zeros(shape, dtype=torch.int32, device=dev["valid"].device)


def _tile(dev, i, j, diag, cfg, out, counts=None, screen=None):
    """(mask, parts) of one tile into `out`, and the mask's counts into
    `counts` when given: the fused tile kernel, or in a samples-sharded
    sweep the local parts (of this device's slice and of the group's
    peers, the other slices of a local mesh's row, each on its own
    device), their sum over the group and the epilogue. `screen`: the
    fused kernel's screen counts (tiles.tile_prefilter); the
    samples-sharded epilogue adds none."""
    group = cfg["psum_group"]
    if group is None:
        return tile_prefilter(dev, i, j, diag, cfg, out, counts, screen)
    tile_local_parts(dev, i, j, cfg, out)
    for peer_dev, peer_out in group.peers:
        with on_device(peer_out[1].device):
            tile_local_parts(peer_dev, i, j, cfg, peer_out)
    all_reduce_parts(out[1], group)
    return tile_epilogue(dev, i, j, diag, cfg, out, counts)


def _sweep_buffers(cfg, device):
    """What a sweep allocates once and hands to every tile: the tile's
    output buffers, the counts buffer its tile kernels fill and the
    compaction's scratch."""
    return (tile_buffers(cfg, device), counts_buffer(cfg, device),
            compact_scratch(cfg["B"], device))


def fused_sweep(dev, pi, pj, dg, live, *, cfg, cap, outcap, screen=None):
    """Per-tile counts AND capped survivor extraction at a running
    offset over a tile list: (n_pass [T], n_cand [T], buf [outcap,
    out_cols]) on the planes' device. Writes clamp at outcap - cap; rows
    at or beyond the clamp boundary are garbage whenever the total spills
    (detectable from n_pass), and tiles with more than `cap` survivors
    keep only their first `cap` rows -- the caller repairs both with
    `extract_sweep`. Dead tiles (live False) count zero. The fused tile
    kernel, or the samples-sharded sweep's epilogue, hands its
    per-segment counts to the compaction. With `fisher_on(cfg)`
    the rows of the tiles the caller keeps carry the Fisher bracket
    (`append_fisher_col`) when the segment has FISHER_MIN_ROWS survivors.
    `screen` (int64 [2], unphased table only) is added the candidates the
    unphased prefilter's screen saw and those it left undecided, over
    every live tile (tiles.tile_prefilter). Read the counts with
    `host_counts`."""
    T = len(pi)
    n_pass, n_cand, off = _zeros(dev, T), _zeros(dev, T), _zeros(dev, 1)
    buf = _zeros(dev, outcap, out_cols(cfg))
    out, cnt, scratch = _sweep_buffers(cfg, buf.device)
    _loop(cfg, buf)(dev, pi, pj, dg, live, cfg, cap, out, cnt, scratch, off,
                    buf, n_pass, n_cand, ncol=buf_cols(cfg), screen=screen)
    if fisher_on(cfg) and T:
        append_fisher_col(dev, n_pass, buf, pi, pj, cfg, cap)
    return n_pass, n_cand, buf


def fisher_rows(n_pass, cap: int, outcap: int):
    """(rows, tiles) int64: the survivor rows that carry a bracket and
    each one's tile, or None below the volume gate. Tile t's rows are
    [ends[t] - n_pass[t], ends[t]), ends the inclusive sum of n_pass, for
    the tiles the caller keeps from the fused pass (n_pass[t] <= cap,
    ends[t] <= outcap - cap, as `LdEngine._run_segment` decides)."""
    n = n_pass.to(torch.int64)
    total = int(n.sum())
    if total < FISHER_MIN_ROWS:
        return None
    ends = torch.cumsum(n, 0)
    rows = torch.arange(min(total, outcap), device=n.device)
    t = torch.searchsorted(ends, rows, right=True)
    keep = (n[t] <= cap) & (ends[t] <= outcap - cap)
    return rows[keep], t[keep]


def fisher_cells(dev, buf, rows, t, pi, pj, cfg):
    """(REFREF, REFALT, ALTREF, ALTALT) int64 of survivor rows `rows` of
    tiles `t` (indices into pi, pj), decoded from the fused buffer's
    payload as ld_kernels.phased_cells does: the 4 parts with missing
    data, else ALTALT and the allele counts of both variants."""
    r = buf[rows].to(torch.int64) & 0xFFFFFFFF
    if cfg["has_missing"]:
        if pack16_ok(cfg):
            aa, alt_val = r[:, 1] & 0xFFFF, r[:, 1] >> 16
            val_alt, val_val = r[:, 2] & 0xFFFF, r[:, 2] >> 16
        else:
            aa, alt_val, val_alt, val_val = (buf[rows, c].to(torch.int64)
                                             for c in range(1, 5))
        ar = alt_val - aa
        ra = val_alt - aa
        return val_val - aa - ar - ra, ra, ar, aa
    B = cfg["B"]
    k, l = r[:, 0] // B, r[:, 0] % B
    aa = r[:, 1] & 0xFFFF if pack16_ok(cfg) else buf[rows, 1].to(torch.int64)
    tiles = torch.as_tensor(np.stack([pi, pj]).astype(np.int64),
                            device=buf.device)[:, t]
    ac_a = dev["ac"][tiles[0], k].to(torch.int64)
    ac_b = dev["ac"][tiles[1], l].to(torch.int64)
    return (2 * cfg["n_samples"] - ac_a - ac_b + aa, ac_b - aa, ac_a - aa,
            aa)


def append_fisher_col_plain(dev, n_pass, buf, pi, pj, cfg, cap):
    """The plain PyTorch version of `append_fisher_col`; returns (steps,
    work) over the rows (fisher_dev.fisher_bracket_search: the walk's
    steps, the probes and tail steps of the search), (0, 0) below the
    gate."""
    sel = fisher_rows(n_pass, cap, buf.shape[0])
    if sel is None:
        return 0, 0
    rows, t = sel
    br, log2_pb, steps, work = F.fisher_bracket_search(
        *fisher_cells(dev, buf, rows, t, pi, pj, cfg), 2 * cfg["n_samples"])
    if fisher_packed(cfg):
        bits = F.packed_bits(br, log2_pb)
        buf[rows, 1] = (buf[rows, 1] & 0xFFFF) | (bits << 16)
    else:
        buf[rows, buf_cols(cfg)] = br.view(torch.int32)
    return int(steps.sum()), int(work.sum())


def append_fisher_col(dev, n_pass, buf, pi, pj, cfg, cap, steps=None):
    """Write the Fisher bracket of every survivor row of a fused sweep's
    buffer that the caller keeps (`fisher_rows`), in place: with
    `fisher_packed(cfg)` as bf16 in the top 16 bits of payload column 1,
    else as the f32 bits of column `buf_cols(cfg)`. Nothing below the
    volume gate (FISHER_MIN_ROWS survivors in the segment). The
    counterpart of the JAX package's append_fisher_col behind the gate of
    its fused_sweep. Launches csrc/fisher_bracket.cu on the sweep's
    stream for CUDA tensors (the gate read on the device, no host sync;
    `steps`, a uint64 [2] tensor, adds up the walk's steps and the
    search's probes and tail steps), the plain version for CPU tensors.
    Repair rows carry no bracket."""
    if buf.is_cuda:
        return _launch_fisher(dev, n_pass, buf, pi, pj, cfg, cap, steps)
    if buf.device.type != "cpu":
        raise ValueError(f"no Fisher kernel for device {buf.device}")
    _build.count(_build.PLAIN_CALLS, "fisher_bracket")
    return append_fisher_col_plain(dev, n_pass, buf, pi, pj, cfg, cap)


def _launch_fisher(dev, n_pass, buf, pi, pj, cfg, cap, steps=None):
    outcap, ld = buf.shape
    T, B = len(pi), cfg["B"]
    miss = cfg["has_missing"]
    device = buf.device
    ac = dev["ac"]
    n_hap = 2 * cfg["n_samples"]
    lf = F.device_table(n_hap, device)
    for name, x, dtype, shape in (
            ("buf", buf, torch.int32, (outcap, ld)),
            ("n_pass", n_pass, torch.int32, (T,)),
            ("ac", ac, torch.int32, (ac.shape[0], B)),
            ("lf", lf, torch.float64, (n_hap + 2,))):
        if x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous() or x.device != device:
            raise ValueError(f"Fisher input {name} {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}: expected {shape} "
                             f"{dtype}, contiguous, on {device}")
    if ld != out_cols(cfg) or not fisher_on(cfg) or not 0 < cap <= outcap:
        raise ValueError(f"no Fisher column for a [{outcap}, {ld}] buffer "
                         f"of this sweep group (cap {cap})")
    if steps is not None and (steps.dtype != torch.uint64
                              or steps.numel() != 2
                              or steps.device != device):
        raise ValueError("steps must be two uint64 on the buffer's device")
    tl = None
    if not miss:
        pij = np.stack([np.asarray(pi, np.int32), np.asarray(pj, np.int32)])
        if T and not (0 <= pij.min() and pij.max() < ac.shape[0]):
            raise ValueError(f"a tile of the list lies outside "
                             f"[{ac.shape[0]}]")
        # pinned, so the copy queues behind the sweep without a host sync
        tl = torch.from_numpy(pij).pin_memory().to(device, non_blocking=True)
    ends = torch.empty(T + 1, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _build.library().twk_fisher_bracket(
        buf.data_ptr(), ld, int(miss), int(pack16_ok(cfg)),
        int(fisher_packed(cfg)), buf_cols(cfg), B, n_hap, cap, outcap,
        n_pass.data_ptr(), T, ends.data_ptr(),
        None if miss else ac.data_ptr(),
        None if miss else tl[0].data_ptr(),
        None if miss else tl[1].data_ptr(), FISHER_MIN_ROWS, F.MAX_STEPS,
        lf.data_ptr(), lf.numel(), *F.search_cuts(n_hap),
        None if steps is None else steps.data_ptr(), stream)
    _build.check(rc, "fisher_bracket launch")
    _build.count(_build.LAUNCHES, "fisher_bracket", device=device)


def extract_sweep(dev, pi, pj, dg, off, *, cfg, cap, outcap):
    """Re-sweep tiles, writing each one's survivor rows at the exact
    caller-computed offset `off[t]` into one [outcap, ncol] buffer
    (repair of cap and buffer overflows; `cap` must cover every tile's
    survivors). Repair rows carry no Fisher bracket."""
    n_pass, n_cand = _zeros(dev, len(pi)), _zeros(dev, len(pi))
    buf = _zeros(dev, outcap, buf_cols(cfg))
    out, cnt, scratch = _sweep_buffers(cfg, buf.device)
    # a copy: the compaction advances each slot in place
    offs = torch.tensor(np.asarray(off), dtype=torch.int32, device=buf.device)
    _loop(cfg, buf)(dev, pi, pj, dg, None, cfg, cap, out, cnt, scratch, offs,
                    buf, n_pass, n_cand)
    return buf


def _loop(cfg, buf):
    """The tile loop of a sweep: the C entry on a card, the Python loop
    on the CPU and in a samples-sharded sweep."""
    if buf.is_cuda and cfg["psum_group"] is None:
        return _launch_sweep
    return _tile_loop


def _tile_loop(dev, pi, pj, dg, live, cfg, cap, out, cnt, scratch, off, buf,
               n_pass, n_cand, ncol=None, screen=None):
    """The tile loop in Python, with `_launch_sweep`'s arguments: for each
    live tile the tile (`_tile`: the fused kernel, or the samples-sharded
    steps with their all-reduce) and its compaction, at the one running
    offset, or with `live` None at offset `off[t]`."""
    for t in range(len(pi)):
        if live is None or live[t]:
            mask, parts = _tile(dev, int(pi[t]), int(pj[t]), bool(dg[t]),
                                cfg, out, cnt, screen)
            compact_survivors(mask, parts,
                              off if live is not None else off[t:t + 1],
                              buf, n_pass, n_cand, t, cap, cnt, scratch,
                              ncol)


def _launch_sweep(dev, pi, pj, dg, live, cfg, cap, out, cnt, scratch, off,
                  buf, n_pass, n_cand, ncol=None, screen=None):
    """The tile loop of `fused_sweep` (live given, one running offset) or
    of `extract_sweep` (live None, `off` an offset a tile) as one call of
    csrc/sweep.cu's `twk_sweep`, on the current stream: every tensor is
    checked here once, and the C loop launches each live tile's fused
    tile kernel and its compaction in tile order. Each kernel's launches
    are counted as the C loop reports them, parts_tile's wide ones in
    `_build.WIDE_LAUNCHES` too. `ncol`: the payload layout's
    columns, when the buffer has more (the Fisher column). `screen`: as
    tiles.tile_prefilter takes it, checked here."""
    NB, B, _ = _check_inputs(dev, cfg, out)
    _check_screen(cfg, screen, buf.device)
    mask, parts = out
    T = len(pi)
    ncol = _check_compact(mask, parts, off, buf, n_pass, n_cand, cap, cnt,
                          scratch, n_off=1 if live is not None else T,
                          ncol=ncol)
    if tuple(n_pass.shape) != (T,):
        raise ValueError(f"n_pass holds {n_pass.shape[0]} tiles, not {T}")
    pi = np.ascontiguousarray(pi, np.int32)
    pj = np.ascontiguousarray(pj, np.int32)
    dg = np.ascontiguousarray(dg, np.uint8)
    if T and not (0 <= min(pi.min(), pj.min())
                  and max(pi.max(), pj.max()) < NB):
        raise ValueError(f"a tile of the list lies outside [{NB}]")
    if live is not None:
        live = np.ascontiguousarray(live, np.uint8)
    if not all(len(a) == T for a in (pj, dg) + (() if live is None
                                                 else (live,))):
        raise ValueError("the tile arrays differ in length")
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    done = (ctypes.c_int32 * 3)()
    rc = _build.library().twk_sweep(
        *sweep_args(dev, cfg), T, pi.ctypes.data, pj.ctypes.data,
        dg.ctypes.data, None if live is None else live.ctypes.data,
        mask.data_ptr(), parts.data_ptr(), cnt.data_ptr(),
        None if screen is None else screen.data_ptr(), parts.shape[0],
        ncol, buf.shape[1], off.data_ptr(), int(live is None), cap,
        buf.shape[0],
        n_pass.data_ptr(), n_cand.data_ptr(), scratch.data_ptr(),
        _ticket(buf.device, stream).data_ptr(), buf.data_ptr(), stream,
        done)
    _build.count(_build.LAUNCHES, kernel_name(cfg), done[0], buf.device)
    _build.count(_build.LAUNCHES, "compact", done[1], buf.device)
    _build.count(_build.WIDE_LAUNCHES, "parts_tile", done[2])
    _build.check(rc, "sweep launch")


def count_sweep(dev, pi, pj, dg, live, *, cfg):
    """Per-tile (survivor count, candidate count) over a tile list."""
    n, nc = _zeros(dev, len(pi)), _zeros(dev, len(pi))
    out = tile_buffers(cfg, n.device)
    for t in range(len(pi)):
        if live[t]:
            mask, _ = _tile(dev, int(pi[t]), int(pj[t]), bool(dg[t]), cfg,
                            out)
            n[t] = (mask == 2).sum()
            nc[t] = (mask != 0).sum()
    return n, nc
