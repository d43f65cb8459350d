"""All-vs-all LD on one GPU: phased (-p), unphased (-u) and mixed.

The PyTorch port of the single-device path of
tomahawk_tpu/compute/engine.py. Variant blocks regroup into super-blocks
of up to `tile_rows` variants whose packed bit planes live on the
device, and the block-pair tile grid is swept in segments, one
(table, has_missing, cls) group at a time in the order of the JAX
engine's `group_tiles` (mixed mode: the reference's per-pair dispatch,
ld_engine.cpp:2737-2880). For each
segment the device runs the tile kernel and the survivor compaction on
every tile (sweeps.fused_sweep) with no host sync in between; the host
then reads the per-tile counts once, pulls the survivor rows, re-sweeps
the rare tiles that overflowed the per-tile cap or spilled the buffer
at exact offsets (sweeps.extract_sweep), runs the exact f64 statistics
and Fisher P in the shared native record pipeline (ld_math.ld_records)
and emits .two records. One segment is in flight at a time.

Host code is shared with the JAX package by import. What that engine
also does and this slice does not yet -- window sweeps, banded
streaming, checkpoints, multi-process runs, the CPU route, the in-sweep
Fisher, D' bounds -- raises NotImplementedError naming the
ROADMAP.md item that adds it. A kernel that fails to build or launch is
an error: there is no fallback path.
"""

import datetime
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tomahawk_tpu.compute.balancer import Balancer
from tomahawk_tpu.compute.engine import LdEngine as _JaxLdEngine
from tomahawk_tpu.compute.engine import (CalcResult, CalcSettings, _bucket,
                                         _pair_meta_from, _plan_loads,
                                         _reverse_records, _round_up,
                                         _super_ranges, group_tiles,
                                         report_performance)
from tomahawk_tpu.io.twk import TwkReader
from tomahawk_tpu.io.two import TwoWriter
from tomahawk_tpu.ops.bitpack import block_to_planes, stack_planes
from tomahawk_tpu.ops.ld_math import (LdFilters, ld_records, phased_math,
                                     unphased_math)
from tomahawk_tpu.utils import Timer, log, pretty_int
from tomahawk_tpu.utils.progress import ProgressTicker

from .. import __version__
from ..device import resolve_device
from . import sweeps

__all__ = ["CalcResult", "CalcSettings", "LdEngine", "compute_ld"]


class LdEngine:
    """Device planes and the segment loop for one run configuration on
    one device. `LdEngine(stacked, n_samples, settings, device)` makes
    `stacked` (bitpack.stack_planes output) the single resident band."""

    # survivors extracted per tile inside the fused sweep; tiles with
    # more go through the exact-offset repair pass, and the cap adapts
    # upward when a run's tiles overflow it
    FUSED_CAP = 256
    FUSED_CAP_MAX = 32768
    # initial survivor-buffer rows per segment, grown when it spills
    OUTCAP0 = 1 << 18
    # target segments per tile group (progress advances between them)
    PIPELINE_SEGMENTS = 8
    # the JAX engine's host tables from survivor parts (shared host
    # code: they read only self.stacked and self.n_samples)
    _phased_counts_from_parts = _JaxLdEngine._phased_counts_from_parts
    _unphased_table_from_parts = _JaxLdEngine._unphased_table_from_parts

    def __init__(self, stacked: dict, n_samples: int,
                 settings: CalcSettings, device):
        self.settings = settings
        self.n_samples = n_samples
        self.device = resolve_device(device)
        self.window = settings.l_window if settings.window else 0
        self.ticker = None           # optional ProgressTicker
        self._outcap = self.OUTCAP0
        self._fused_cap = self.FUSED_CAP
        # per-config dispatch statistics (report_performance reads them)
        self.stats = {}
        self.set_load([("all", stacked)])

    def set_load(self, bands):
        """Make the one band in `bands` ([(band_id, stacked)]) resident;
        its planes upload on first use."""
        if len(bands) != 1 or bands[0][1] is None:
            raise NotImplementedError(
                "banded streaming (more than one resident band) is not "
                "ported yet (ROADMAP.md queue 1 item 10)")
        self.stacked = bands[0][1]
        self.B = self.stacked["alt_bits"].shape[1]
        self._dev = {}

    def _dev_for(self, cfg) -> dict:
        """The resident band's device tensors, uploading on first use
        the keys this sweep config reads and no others."""
        keys = [k for k in sweeps.dev_keys_for(cfg) if k not in self._dev]
        if keys:
            self._dev.update(sweeps.planes_to_device(self.stacked,
                                                     self.device, keys))
        return self._dev

    def _cfg(self, table, has_missing, cls):
        s = self.settings
        return sweeps.make_cfg(table, has_missing, cls, self.B,
                               self.n_samples, self.window, s.min_r2,
                               s.max_r2, s.min_dprime, s.max_dprime)

    def _stat(self, cfg):
        key = (f"{cfg['table']}/{'miss' if cfg['has_missing'] else 'nomiss'}"
               f"/{cfg['cls']}")
        return self.stats.setdefault(key, dict(
            n_tiles=0, n_cand=0, n_pass=0, n_records=0, count_s=0.0,
            extract_s=0.0, math_s=0.0, n_repair=0))

    def _segment_size(self, n_tiles: int) -> int:
        """Tiles per segment: at most settings.sweep_segment, at least
        16, and small enough to split the group into about
        PIPELINE_SEGMENTS pieces (the JAX engine's rule)."""
        seg = max(self.settings.sweep_segment, 16)
        want = _round_up(-(-n_tiles // self.PIPELINE_SEGMENTS), 16)
        return max(16, min(seg, want))

    # -- public API ------------------------------------------------------
    def run_group(self, tiles, table, has_missing, cls, filt, emit) -> int:
        """Sweep one (table, missing, cls) tile group in segments.
        Returns the number of candidate pairs evaluated."""
        cfg = self._cfg(table, has_missing, cls)
        seg = self._segment_size(len(tiles))
        return sum(self._run_segment(tiles[s:s + seg], cfg, filt, emit)
                   for s in range(0, len(tiles), seg))

    def run_phased_pairs(self, pairs, has_missing, filt, emit):
        return self.run_group(pairs, "phased", has_missing, "all", filt,
                              emit)

    def run_unphased_pairs(self, pairs, has_missing, filt, emit):
        return self.run_group(pairs, "unphased", has_missing, "all", filt,
                              emit)

    def run_mixed_pairs(self, pairs, filt, emit):
        """Reference mixed-mode Calculate() semantics on tiles that
        contain missing data: clean pairs take the phased math, pairs
        with missing alleles take the unphased math
        (reference: ld_engine.cpp:2737-2880)."""
        n = self.run_group(pairs, "phased", False, "clean", filt, emit)
        n += self.run_group(pairs, "unphased", True, "missing", filt, emit)
        return n

    # -- one segment -----------------------------------------------------
    def _dispatch_fused(self, tiles, cfg) -> dict:
        """Enqueue one segment's fused sweep; nothing waits for it."""
        pi = np.array([t[0] for t in tiles], np.int32)
        pj = np.array([t[1] for t in tiles], np.int32)
        dg = np.array([t[2] for t in tiles], bool)
        dev = self._dev_for(cfg)
        cap = min(self._fused_cap, self.B * self.B)
        outcap = max(self._outcap, 2 * cap)
        n_pass, n_cand, buf = sweeps.fused_sweep(
            dev, pi, pj, dg, np.ones(len(tiles), bool), cfg=cfg, cap=cap,
            outcap=outcap)
        return dict(n_pass=n_pass, n_cand=n_cand, buf=buf, dev=dev, pi=pi,
                    pj=pj, dg=dg, cap=cap, outcap=outcap)

    def _run_segment(self, tiles, cfg, filt, emit) -> int:
        """Dispatch one segment, read its counts, pull the survivor rows
        (repairing what the fused pass could not hold), run the exact
        host math and emit records."""
        if not tiles:
            return 0
        stat = self._stat(cfg)
        stat["n_tiles"] += len(tiles)
        B = self.B
        t0 = time.perf_counter()
        st = self._dispatch_fused(tiles, cfg)
        pi, pj, dg, buf = st["pi"], st["pj"], st["dg"], st["buf"]
        cap, outcap = st["cap"], st["outcap"]
        # the one host sync of the sweep: per-tile counts
        n_pass = st["n_pass"].cpu().numpy().astype(np.int64)
        n_cand = st["n_cand"].cpu().numpy().astype(np.int64)
        stat["count_s"] += time.perf_counter() - t0
        total_cand = int(n_cand.sum())
        stat["n_cand"] += total_cand
        if int(n_pass.sum()) == 0:
            if self.ticker:
                self.ticker.add(pairs=total_cand)
            return total_cand
        stat["n_pass"] += int(n_pass.sum())

        # the fused rows of intact tiles: below the spill boundary and
        # within the per-tile cap; the rest are repaired
        t0 = time.perf_counter()
        offs = np.cumsum(n_pass) - n_pass
        ok = (n_pass <= cap) & (offs + n_pass <= outcap - cap)
        rows_by_tile = {}
        sel = np.flatnonzero(ok & (n_pass > 0))
        if len(sel):
            end = int(offs[sel[-1]] + n_pass[sel[-1]])
            host = buf[:end].cpu().numpy()
            for t in sel:
                rows_by_tile[int(t)] = host[offs[t]:offs[t] + n_pass[t]]
        bad = np.flatnonzero((n_pass > 0) & ~ok)
        if len(bad):
            rows_by_tile.update(self._repair(st["dev"], cfg, stat, pi, pj,
                                             dg, bad, n_pass[bad], cap))
        stat["extract_s"] += time.perf_counter() - t0

        # exact host math, batched into one native call per segment
        hit = np.array(sorted(rows_by_tile), np.int64)
        rows = np.concatenate([rows_by_tile[int(t)] for t in hit])
        idx = rows[:, 0].astype(np.int64)
        k, l = idx // B, idx % B
        tile_of = np.repeat(np.arange(len(hit)), n_pass[hit])
        bi = pi[hit][tile_of].astype(np.int64)
        bj = pj[hit][tile_of].astype(np.int64)
        meta = _pair_meta_from(self.stacked, bi, bj, k, l)
        table = cfg["table"]
        parts = sweeps.unpack_payload(rows[:, 1:], table,
                                      cfg["has_missing"], self.n_samples)
        t0 = time.perf_counter()
        if table == "phased":
            data = self._phased_counts_from_parts(parts, meta)
        else:
            data = self._unphased_table_from_parts(parts, bi, bj, k, l)
        out = ld_records(table, data, meta, filt)
        if out is not None:
            recs, rev = out[0], out[1]
        elif table == "phased":
            recs, _ = phased_math(data, meta, filt)
            rev = None
        else:
            recs = unphased_math(data, meta, filt)
            rev = None
        stat["math_s"] += time.perf_counter() - t0
        stat["n_records"] += len(recs)
        emit(recs, rev)
        if self.ticker:
            self.ticker.add(pairs=total_cand, records=len(recs))
        return total_cand

    def _repair(self, dev, cfg, stat, pi, pj, dg, bad, ns_bad, cap):
        """Re-sweep the tiles that overflowed the cap or spilled the
        buffer, at exact offsets; adapt the caps so later segments of
        this regime compact in the fused pass."""
        B = self.B
        stat["n_repair"] += len(bad)
        if (ns_bad <= cap).any():
            # a tile spilled the shared buffer: grow it
            self._outcap = min(self._outcap * 4, 1 << 23)
        over = int(ns_bad.max())
        if over > cap:
            self._fused_cap = min(_bucket(over, self.FUSED_CAP),
                                  self.FUSED_CAP_MAX, B * B)
        rcap = min(_bucket(over, 1024), B * B)
        total = int(ns_bad.sum())
        hoff = np.cumsum(ns_bad) - ns_bad
        rbuf = sweeps.extract_sweep(dev, pi[bad], pj[bad], dg[bad], hoff,
                                    cfg=cfg, cap=rcap,
                                    outcap=_bucket(total + rcap, 16384))
        host = rbuf[:total].cpu().numpy()
        return {int(t): host[o:o + n]
                for t, o, n in zip(bad, hoff, ns_bad)}


def _check_settings(settings: CalcSettings):
    """Raise for run options outside this slice of the port, naming the
    ROADMAP.md queue 1 item that adds each."""
    unported = (
        (settings.window, "window mode (-w)", 9),
        ((settings.min_dprime, settings.max_dprime) != (0.0, 100.0),
         "D' bounds (-d/-D)", 16),
        (settings.checkpoint, "--checkpoint", 11),
        (settings.distributed, "--distributed", 15),
        (settings.sort_shards, "--sort-shards", 15),
        (settings.mesh not in ("auto", "off", ""),
         f"--mesh {settings.mesh}", 15),
        (settings.backend == "cpu", "--backend cpu", 14),
    )
    for on, what, item in unported:
        if on:
            raise NotImplementedError(
                f"{what} is not ported to the GPU engine yet "
                f"(ROADMAP.md queue 1 item {item})")
    if settings.tile_backend != "auto":
        raise ValueError("--tile-backend selects a JAX tile path; the "
                         "port has one: its CUDA kernels")


def compute_ld(settings: CalcSettings, device="cuda") -> CalcResult:
    """`calc` on one device (`cuda`, or `cpu` for the plain versions)."""
    device = resolve_device(device)
    _check_settings(settings)
    timer = Timer()
    log("LOG", f"Opening {settings.input}...", sub="READER")
    reader = TwkReader(settings.input)
    try:
        return _compute(settings, device, reader, timer)
    finally:
        reader.close()


def _compute(settings, device, reader, timer) -> CalcResult:
    n_samples = reader.header.n_samples
    log("LOG", f"Samples: {pretty_int(n_samples)}...")
    block_ids = list(range(reader.index.n))
    if settings.intervals:
        from tomahawk_tpu.post.intervals import blocks_for_intervals
        block_ids = list(blocks_for_intervals(reader, settings.intervals))
    tile_rows = settings.tile_rows or 4096
    supers = _super_ranges(reader.index.ent, block_ids, tile_rows)
    balancer = Balancer.build(len(supers), settings.n_chunks,
                              settings.c_chunk)
    super_ids = balancer.block_ids()
    B = max((supers[s]["n"] for s in super_ids), default=0)
    if B == 0:
        raise ValueError("no valid data available")
    # padding rows carry valid=0, so rounding up changes no result
    B = _round_up(B, 128)
    pairs = balancer.tile_pairs()

    # the JAX engine's plane budget: one band must hold every super
    Wh = (2 * n_samples + 127) // 128 * 4
    Ws = (n_samples + 127) // 128 * 4
    per_super = B * (2 * Wh + 3 * Ws) * 4
    budget = max(2, int(settings.memory_gb * (1 << 30) / 2 / per_super))
    bands, _ = _plan_loads(super_ids, pairs, budget)
    if len(bands) > 1:
        raise NotImplementedError(
            f"the planes exceed --memory-gb {settings.memory_gb}: banded "
            f"streaming is not ported yet (ROADMAP.md queue 1 item 10)")

    n_threads = settings.threads if settings.threads > 0 \
        else (os.cpu_count() or 1)
    blocks = []
    for s in super_ids:
        sup = supers[s]
        blk = reader.read_block(sup["ids"][0])
        for b in sup["ids"][1:]:
            for rec in reader.read_block(b).rcds:
                blk.add(rec)
        blocks.append(blk)
    with ThreadPoolExecutor(n_threads) as pool:
        stacked = stack_planes(list(pool.map(
            lambda blk: block_to_planes(blk, n_samples, pad_to=B), blocks)))
    slot = {g: s for s, g in enumerate(super_ids)}
    tiles = [(slot[i], slot[j], d) for i, j, d in pairs]
    mode = ("phased" if settings.force_phased else
            "unphased" if settings.forced_unphased else "mixed")
    groups = [g for g in group_tiles(tiles, mode,
                                     stacked["has_missing"].any(axis=1))
              if g[3]]

    engine = LdEngine(stacked, n_samples, settings, device)
    for table, has_missing, cls, _ in groups:
        engine._cfg(table, has_missing, cls)   # reject before any output
    filt = LdFilters(min_p=settings.min_p, min_r2=settings.min_r2,
                     max_r2=settings.max_r2, min_dprime=settings.min_dprime,
                     max_dprime=settings.max_dprime)
    out = settings.output
    if out != "-" and not out.endswith(".two"):
        out += ".two"
    hdr = reader.header
    hdr.literals += (f"\n##tomahawk_tpu_torch_calcVersion={__version__}\n"
                     f"##tomahawk_tpu_torch_calcCommand=calc; "
                     f"Date={datetime.datetime.now().isoformat()}\n")
    result = CalcResult()
    est = sum(B * (B - 1) // 2 if d else B * B for _, _, d in pairs)
    engine.ticker = ProgressTicker(total_pairs=est,
                                   n_samples=n_samples).start()
    writer = TwoWriter(out, hdr, c_level=settings.c_level,
                       block_limit=settings.b_size, async_blocks=True)

    def emit(recs, rev=None):
        if len(recs) == 0:
            return
        writer.add(recs)
        writer.add(rev if rev is not None else _reverse_records(recs))
        result.n_records += 2 * len(recs)

    try:
        for table, has_missing, cls, group in groups:
            result.n_pairs += engine.run_group(group, table, has_missing,
                                               cls, filt, emit)
    finally:
        writer.close()
        engine.ticker.finalize()
    result.elapsed = timer.elapsed()
    log("LOG", f"Computed {pretty_int(result.n_pairs)} pairs -> "
        f"{pretty_int(result.n_records)} records in "
        f"{timer.elapsed_string()} "
        f"({pretty_int(int(result.pairs_per_sec))} pairs/s)",
        sub="PROGRESS")
    if settings.performance:
        report_performance(engine.stats)
    return result
