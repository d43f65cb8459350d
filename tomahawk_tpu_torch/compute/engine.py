"""LD on one GPU per process, all-vs-all or windowed (-w): phased (-p),
unphased (-u) and mixed, in one process or several (--distributed).

The PyTorch port of tomahawk_tpu/compute/engine.py: its single-device
path, and its multi-process run modes over `torch.distributed`
(parallel/distributed.py has the mapping from the JAX mesh). Variant
blocks regroup into super-blocks of up to `tile_rows` variants whose
packed bit planes live on the device, and the block-pair tile grid --
every pair, or in window mode the pairs `Balancer.window_pairs` keeps --
is swept in segments, one (table, has_missing, cls) group at a time in
the order of `group_tiles` (mixed mode: the reference's per-pair dispatch,
ld_engine.cpp:2737-2880). For each
segment the device runs the tile kernel and the survivor compaction on
every tile (sweeps.fused_sweep) with no host sync in between; the host
then reads the per-tile counts once, pulls the survivor rows, re-sweeps
the rare tiles that overflowed the per-tile cap or spilled the buffer
at exact offsets (sweeps.extract_sweep), runs the exact f64 statistics
and Fisher P in the native record pipeline (ld_math.ld_records)
and emits .two records. One segment is in flight at a time.

`--distributed` runs one process per device. By default the tile list is
partitioned round-robin: rank k of N sweeps `pairs[k::N]`, loads only
the super-blocks those touch and writes `out.pKofN.two`
(`parallel.merge_shards` folds the shards). With `--mesh dcn` the
packed-word axis spans the ranks instead: every rank holds 1/N of every
word plane, all sweep every tile jointly (local parts, all-reduce,
epilogue: sweeps.py), every rank derives the same records and rank 0
alone writes the one output. Every rank walks the same tiles in the same
order with the same caps and repair decisions, because those follow from
the global counts, so the collectives stay aligned.

The host layer (file formats, balancer, exact statistics, the native
library) is this package's own. What the JAX engine also does and this
port does not yet -- banded streaming, checkpoints, P x S device
meshes, the CPU route, the in-sweep Fisher, D' bounds -- raises
NotImplementedError naming the
ROADMAP.md item that adds it. A kernel that fails to build or launch is
an error: there is no fallback path.
"""

import datetime
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List

import numpy as np

from .. import __version__
from ..device import resolve_device
from ..io.twk import TwkReader
from ..io.two import TwoWriter
from ..ops.bitpack import block_to_planes, stack_planes
from ..ops.ld_math import (LdFilters, PairMeta, ld_records, phased_math,
                           unphased_math)
from ..parallel import distributed as dist
from ..utils import Timer, log, pretty_int
from ..utils.progress import ProgressTicker
from . import sweeps
from .balancer import Balancer

__all__ = ["CalcResult", "CalcSettings", "LdEngine", "compute_ld"]


@dataclass
class CalcSettings:
    """The run options of `calc`, with the reference twk_ld_settings
    defaults (reference: lib/core.cpp:297-306) and the fields of the JAX
    package's CalcSettings, so one settings object describes a run to
    either engine. Options this port does not run yet are rejected by
    `_check_settings`."""
    input: str = ""
    output: str = "-"
    force_phased: bool = False
    forced_unphased: bool = False
    window: bool = False
    l_window: int = 1_000_000
    min_p: float = 1.0
    min_r2: float = 0.1
    max_r2: float = 100.0
    min_dprime: float = 0.0
    max_dprime: float = 100.0
    n_chunks: int = 1
    c_chunk: int = 0
    c_level: int = 1
    b_size: int = 10_000          # output block record limit
    intervals: List[str] = field(default_factory=list)
    # accepted and unused, as in the JAX package
    batch_pairs: int = 16
    cap_fraction: float = 0.25
    # upper limit of tiles per segment; the progress ticker advances
    # between segments
    sweep_segment: int = 4096
    performance: bool = False
    # consecutive .twk blocks regroup into super-blocks of up to this
    # many variants (never spanning a contig change); 0 = 4096
    tile_rows: int = 0
    # "auto", "off" or "": one device per process; "dcn" (with
    # distributed): the packed-word axis spans the processes; anything
    # else is rejected
    mesh: str = "auto"
    # device-memory budget for the packed planes; inputs that exceed it
    # need banded streaming, which is rejected
    memory_gb: float = 12.0
    # host threads for block decompression and plane inflation; 0 = all
    threads: int = 0
    # one process per device over torch.distributed: tile partition
    # with per-process shards, or with mesh "dcn" the samples-sharded
    # sweep; needs coordinator (host:port), num_processes, process_id
    distributed: bool = False
    coordinator: str = ""
    num_processes: int = -1
    process_id: int = -1
    tile_backend: str = "auto"    # anything but "auto" is rejected
    backend: str = "auto"         # "cpu" is rejected
    checkpoint: str = ""          # rejected
    checkpoint_interval: float = 60.0
    stage_prefetch: bool = True
    # position-sort the output (this process's shard) in place after
    # the run, so merge_shards only merges
    sort_shards: bool = False


@dataclass
class CalcResult:
    n_pairs: int = 0
    n_records: int = 0
    elapsed: float = 0.0

    @property
    def pairs_per_sec(self) -> float:
        return self.n_pairs / self.elapsed if self.elapsed else 0.0


def _pair_meta_from(stacked, bi, bj, k, l) -> PairMeta:
    return PairMeta(
        pos_a=stacked["pos"][bi, k].astype(np.int64),
        pos_b=stacked["pos"][bj, l].astype(np.int64),
        rid_a=stacked["rid"][bi, k].astype(np.int64),
        rid_b=stacked["rid"][bj, l].astype(np.int64),
        ac_a=stacked["ac"][bi, k].astype(np.int64),
        ac_b=stacked["ac"][bj, l].astype(np.int64),
        an_a=stacked["an"][bi, k].astype(np.int64),
        an_b=stacked["an"][bj, l].astype(np.int64),
        hwe_a=stacked["hwe"][bi, k].astype(np.float64),
        hwe_b=stacked["hwe"][bj, l].astype(np.float64),
    )


def _reverse_records(recs: np.ndarray) -> np.ndarray:
    """The (B, A) mirror of each record: swap rid and position tuples;
    statistics and counts stay in the original orientation
    (reference: ld_engine.cpp:1290-1298)."""
    rev = recs.copy()
    # rev shares no memory with recs after the copy, so the swapped
    # field writes need no intermediate copies
    rev["ridA"], rev["ridB"] = recs["ridB"], recs["ridA"]
    rev["packA"], rev["packB"] = recs["packB"], recs["packA"]
    return rev


def _bucket(n: int, lo: int) -> int:
    """Round n up to a power of two (>= lo)."""
    b = lo
    while b < n:
        b *= 2
    return b


def _round_up(n: int, q: int) -> int:
    """Round n up to a multiple of q."""
    return ((n + q - 1) // q) * q


def _auto_tile_rows(entries, block_ids, settings) -> int:
    """Resolve tile_rows=0: 4096 rows in every mode, the JAX engine's
    rule, so both engines plan the same tiles and emit records in the
    same order. Whether a smaller tile serves a short window better on
    the GPU is not measured yet; tile_rows remains an explicit
    override."""
    return 4096


def _super_ranges(entries, block_ids, tile_rows: int):
    """Greedily pack consecutive block ids into super-blocks of up to
    tile_rows records, never crossing a contig boundary or a gap in the
    id list. Returns a list of dicts with keys ids/n/rid/minpos/maxpos."""
    out = []
    cur = None
    for b in block_ids:
        e = entries[b]
        if cur is not None and (
                cur["rid"] != e.rid or cur["n"] + e.n > tile_rows
                or cur["ids"][-1] + 1 != b):
            out.append(cur)
            cur = None
        if cur is None:
            cur = dict(ids=[b], n=e.n, rid=e.rid, minpos=e.minpos,
                       maxpos=e.maxpos)
        else:
            cur["ids"].append(b)
            cur["n"] += e.n
            cur["minpos"] = min(cur["minpos"], e.minpos)
            cur["maxpos"] = max(cur["maxpos"], e.maxpos)
    if cur is not None:
        out.append(cur)
    return out


def group_tiles(pairs, mode: str, blk_missing):
    """Deterministic (table, has_missing, cls, tiles) sweep groups for
    one load: the dispatch order. 'mixed' follows the reference's
    default per-pair dispatch (reference: ld_engine.cpp:2737-2880
    Calculate(): pairs with missing alleles use unphased math)."""
    nomiss = [p for p in pairs
              if not (blk_missing[p[0]] or blk_missing[p[1]])]
    withmiss = [p for p in pairs
                if blk_missing[p[0]] or blk_missing[p[1]]]
    if mode == "phased":
        return [("phased", False, "all", nomiss),
                ("phased", True, "all", withmiss)]
    if mode == "unphased":
        return [("unphased", False, "all", nomiss),
                ("unphased", True, "all", withmiss)]
    # blocks without any missing variant: pure phased fast path
    return [("phased", False, "all", nomiss),
            ("phased", False, "clean", withmiss),
            ("unphased", True, "missing", withmiss)]


def _plan_loads(super_ids, pairs, budget_supers: int, parts: int = 2):
    """Partition the run into device loads. If all supers fit the
    budget, one load covers everything; otherwise supers split into
    bands of budget/`parts` and every band pair becomes a load
    containing its slice of the tile list (blocked streaming).
    Returns (bands, loads): bands is a list of super-id lists; each
    load is ((p, q), tiles) over band indices."""
    if len(super_ids) <= budget_supers:
        return [list(super_ids)], [((0, 0), list(pairs))]
    band = max(1, budget_supers // parts)
    bands = [list(super_ids[k:k + band])
             for k in range(0, len(super_ids), band)]
    of_band = {}
    for bi, ids in enumerate(bands):
        for g in ids:
            of_band[g] = bi
    by_pair = {}
    for i, j, d in pairs:
        key = (of_band[i], of_band[j])
        by_pair.setdefault(key, []).append((i, j, d))
    return bands, [((p, q), by_pair[(p, q)]) for p, q in sorted(by_pair)]


def report_performance(stats):
    """Per-sweep-group dispatch and timing report, the analogue of the
    reference's ComputePerformance / n_method counters
    (reference: lib/ld/ld.cpp:878-1057, ld_engine.h:171-174,313), from
    an engine's `stats` dict."""
    log("LOG", f"{'config':<24}{'tiles':>8}{'cand pairs':>14}"
        f"{'prefilter pass':>15}{'count s':>9}{'extract s':>10}"
        f"{'math s':>8}{'records':>9}{'repair':>7}{'supp':>5}",
        sub="PERF")
    for key, s in sorted(stats.items()):
        log("LOG", f"{key:<24}{s['n_tiles']:>8}{s['n_cand']:>14,}"
            f"{s['n_pass']:>15,}{s['count_s']:>9.3f}"
            f"{s['extract_s']:>10.3f}{s['math_s']:>8.3f}"
            f"{s['n_records']:>9,}{s.get('n_repair', 0):>7}"
            f"{s.get('n_supp', 0):>5}", sub="PERF")
        cs = s["count_s"]
        if cs > 0 and s["n_cand"]:
            log("LOG", f"{'':<24}count-sweep rate "
                f"{pretty_int(int(s['n_cand'] / cs))} pairs/s", sub="PERF")


class LdEngine:
    """Device planes and the segment loop for one run configuration on
    one device. `LdEngine(stacked, n_samples, settings, device)` makes
    `stacked` (bitpack.stack_planes output) the single resident band.
    With `group` (a parallel.ProcessGroup) the engine is one rank of a
    samples-sharded run: it uploads slice `samples_rank` of
    `samples_size` of every word plane and its sweeps sum each tile's
    parts over the group; every rank of the group must then make the
    same calls in the same order."""

    # survivors extracted per tile inside the fused sweep; tiles with
    # more go through the exact-offset repair pass, and the cap adapts
    # upward when a run's tiles overflow it
    FUSED_CAP = 256
    FUSED_CAP_MAX = 32768
    # initial survivor-buffer rows per segment, grown when it spills
    OUTCAP0 = 1 << 18
    # target segments per tile group (progress advances between them)
    PIPELINE_SEGMENTS = 8

    def __init__(self, stacked: dict, n_samples: int,
                 settings: CalcSettings, device, group=None,
                 samples_rank: int = 0, samples_size: int = 1):
        if (group is None) != (samples_size == 1) \
                or not 0 <= samples_rank < samples_size:
            raise ValueError(
                f"samples slice {samples_rank} of {samples_size} "
                f"{'with' if group is not None else 'without'} a process "
                f"group: a sharded engine needs both")
        self.group = group
        self.word_slice = ((samples_rank, samples_size)
                           if samples_size > 1 else None)
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
            self._dev.update(sweeps.planes_to_device(
                self.stacked, self.device, keys, self.word_slice))
        return self._dev

    def _cfg(self, table, has_missing, cls):
        s = self.settings
        return sweeps.make_cfg(table, has_missing, cls, self.B,
                               self.n_samples, self.window, s.min_r2,
                               s.max_r2, s.min_dprime, s.max_dprime,
                               psum_group=self.group)

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
        n_pass, n_cand = sweeps.host_counts(st["n_pass"], st["n_cand"])
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

    def _phased_counts_from_parts(self, parts, meta) -> np.ndarray:
        """[K, 4] (REFREF, REFALT, ALTREF, ALTALT) int64 from the raw
        device contractions (mirrors ops.ld_kernels.phased_cells)."""
        if parts.shape[1] == 4:
            altalt, alt_val, val_alt, val_val = parts.T
            altref = alt_val - altalt
            refalt = val_alt - altalt
            refref = val_val - altalt - altref - refalt
        else:
            altalt = parts[:, 0]
            altref = meta.ac_a - altalt
            refalt = meta.ac_b - altalt
            refref = 2 * self.n_samples - (meta.ac_a + meta.ac_b) + altalt
        return np.stack([refref, refalt, altref, altalt], axis=1)

    def _unphased_table_from_parts(self, parts, bi, bj, k, l) -> np.ndarray:
        """[K, 3, 3] int64 genotype tables from the raw device
        contractions (mirrors ops.ld_kernels.unphased_cells)."""
        st = self.stacked
        if parts.shape[1] == 9:
            T11, T12, T21, T22, hv, vh, ov, vo, vv = parts.T
        else:
            T11, T12, T21, T22 = parts.T
            hv = st["n_het"][bi, k].astype(np.int64)
            vh = st["n_het"][bj, l].astype(np.int64)
            ov = st["n_hom"][bi, k].astype(np.int64)
            vo = st["n_hom"][bj, l].astype(np.int64)
            vv = np.full(len(T11), self.n_samples, np.int64)
        T10 = hv - T11 - T12
        T20 = ov - T21 - T22
        T01 = vh - T11 - T21
        T02 = vo - T12 - T22
        T00 = vv - (T01 + T02 + T10 + T11 + T12 + T20 + T21 + T22)
        # column fills into one [K, 9] buffer: np.stack's temporary
        # costs real fault time at millions of survivors per segment
        rows = np.empty((len(T11), 9), np.int64)
        for c, col in enumerate((T00, T01, T02, T10, T11, T12,
                                 T20, T21, T22)):
            rows[:, c] = col
        return rows.reshape(-1, 3, 3)

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
    mesh = settings.mesh or "off"
    unported = (
        ((settings.min_dprime, settings.max_dprime) != (0.0, 100.0),
         "D' bounds (-d/-D)", 16),
        (settings.checkpoint, "--checkpoint", 11),
        (mesh not in ("auto", "off", "dcn"),
         f"--mesh {settings.mesh} (device meshes beyond one device per "
         f"process, P x S rank grids)", 15),
        (settings.backend == "cpu", "--backend cpu", 14),
    )
    for on, what, item in unported:
        if on:
            raise NotImplementedError(
                f"{what} is not ported to the GPU engine yet "
                f"(ROADMAP.md queue 1 item {item})")
    if mesh == "dcn" and not settings.distributed:
        raise ValueError("mesh 'dcn' needs a multi-process run "
                         "(use --distributed)")
    if settings.tile_backend != "auto":
        raise ValueError("--tile-backend selects a JAX tile path; the "
                         "port has one: its CUDA kernels")


def compute_ld(settings: CalcSettings, device="cuda") -> CalcResult:
    """`calc` on one device per process (`cuda`, or `cpu` for the plain
    versions). With `settings.distributed` this process is one rank of
    the run: `cuda` is then the rank's share of the visible cards
    (`parallel.rank_device`)."""
    _check_settings(settings)
    if settings.window and settings.n_chunks != 1:
        raise ValueError("cannot use chunking in window mode")
    timer = Timer()
    proc_id, n_procs = 0, 1
    if settings.distributed:
        device = resolve_device(dist.rank_device(device,
                                                 settings.process_id))
        proc_id, n_procs = dist.init_distributed(
            settings.coordinator, settings.num_processes,
            settings.process_id, device)
    else:
        device = resolve_device(device)
    try:
        log("LOG", f"Opening {settings.input}...", sub="READER")
        reader = TwkReader(settings.input)
        try:
            return _compute(settings, device, reader, timer, proc_id,
                            n_procs)
        finally:
            reader.close()
    finally:
        if settings.distributed:
            dist.shutdown()


def _load_engine(settings, device, reader, supers, super_ids, pairs, B,
                 dcn, proc_id, n_procs):
    """(engine, sweep groups) for this process's tiles: inflate the
    super-blocks `super_ids` into planes, make them the engine's band
    and group the tiles in dispatch order. A dcn rank shares the
    process group and holds slice `proc_id` of `n_procs` of the words."""
    n_samples = reader.header.n_samples
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

    engine = LdEngine(stacked, n_samples, settings, device,
                      group=dist.group() if dcn else None,
                      samples_rank=proc_id if dcn else 0,
                      samples_size=n_procs if dcn else 1)
    for table, has_missing, cls, _ in groups:
        engine._cfg(table, has_missing, cls)   # reject before any output
    return engine, groups


def _compute(settings, device, reader, timer, proc_id,
             n_procs) -> CalcResult:
    n_samples = reader.header.n_samples
    log("LOG", f"Samples: {pretty_int(n_samples)}...")
    block_ids = list(range(reader.index.n))
    if settings.intervals:
        from ..post.intervals import blocks_for_intervals
        block_ids = list(blocks_for_intervals(reader, settings.intervals))
    tile_rows = settings.tile_rows or _auto_tile_rows(
        reader.index.ent, block_ids, settings)
    supers = _super_ranges(reader.index.ent, block_ids, tile_rows)
    balancer = Balancer.build(len(supers), settings.n_chunks,
                              settings.c_chunk)
    super_ids = balancer.block_ids()
    B = max((supers[s]["n"] for s in super_ids), default=0)
    if B == 0:
        raise ValueError("no valid data available")
    # padding rows carry valid=0, so rounding up changes no result
    B = _round_up(B, 128)
    if settings.window:
        minpos = {s: supers[s]["minpos"] for s in super_ids}
        maxpos = {s: supers[s]["maxpos"] for s in super_ids}
        rid = {s: supers[s]["rid"] for s in super_ids}
        pairs = balancer.window_pairs(minpos, maxpos, rid, settings.l_window)
    else:
        pairs = balancer.tile_pairs()
    # dcn: the packed-word axis spans the processes and every process
    # sweeps every tile jointly, one output file written by process 0.
    # Otherwise a distributed run partitions the tile grid, one shard
    # per process.
    dcn = settings.mesh == "dcn"
    if dcn and n_procs < 2:
        raise ValueError("mesh 'dcn' needs a multi-process run "
                         "(--num-processes >= 2)")
    if n_procs > 1 and not dcn:
        pairs, touched = dist.partition_tiles(pairs, proc_id, n_procs)
        # only this process's supers need loading
        super_ids = [s for s in super_ids if s in touched]
        log("LOG", f"Process {proc_id}: {len(pairs)} tiles over "
            f"{len(super_ids)} super-blocks", sub="DIST")
    log("LOG", f"Using {len(pairs)} tiles of {len(supers)} super-blocks "
        f"(<= {tile_rows} variants each) in "
        f"{'window' if settings.window else 'square'} mode...",
        sub="BALANCING")

    # the JAX engine's plane budget: one band must hold every super
    Wh = (2 * n_samples + 127) // 128 * 4
    Ws = (n_samples + 127) // 128 * 4
    per_super = B * (2 * Wh + 3 * Ws) * 4
    # a dcn rank holds only 1/S of every word plane
    n_samp_shards = n_procs if dcn else 1
    per_super = -(-per_super // n_samp_shards)
    budget = max(2, int(settings.memory_gb * (1 << 30) / 2 / per_super))
    bands, _ = _plan_loads(super_ids, pairs, budget)
    if len(bands) > 1:
        raise NotImplementedError(
            f"the planes exceed --memory-gb {settings.memory_gb}: banded "
            f"streaming is not ported yet (ROADMAP.md queue 1 item 10)")

    engine, groups = None, []
    if pairs:
        engine, groups = _load_engine(settings, device, reader, supers,
                                      super_ids, pairs, B, dcn, proc_id,
                                      n_procs)
    filt = LdFilters(min_p=settings.min_p, min_r2=settings.min_r2,
                     max_r2=settings.max_r2, min_dprime=settings.min_dprime,
                     max_dprime=settings.max_dprime)
    out = settings.output
    if n_procs > 1 and not dcn:
        out = dist.shard_output_path(out, proc_id, n_procs)
    elif dcn and out == "-":
        raise ValueError("distributed calc needs a file output")
    if out != "-" and not out.endswith(".two"):
        out += ".two"
    hdr = reader.header
    hdr.literals += (f"\n##tomahawk_tpu_torch_calcVersion={__version__}\n"
                     f"##tomahawk_tpu_torch_calcCommand=calc; "
                     f"Date={datetime.datetime.now().isoformat()}\n")
    result = CalcResult()
    # upper bound of the pairs the (windowed) tile list holds
    est = sum(B * (B - 1) // 2 if d else B * B for _, _, d in pairs)
    ticker = ProgressTicker(total_pairs=est, n_samples=n_samples).start()
    if engine is not None:
        engine.ticker = ticker
    # dcn: every process derives identical records (the counts are the
    # same on every rank); only process 0 writes the single output
    writer = None
    if not (dcn and proc_id != 0):
        writer = TwoWriter(out, hdr, c_level=settings.c_level,
                           block_limit=settings.b_size, async_blocks=True)

    def emit(recs, rev=None):
        if len(recs) == 0:
            return
        if writer is not None:
            writer.add(recs)
            writer.add(rev if rev is not None else _reverse_records(recs))
        result.n_records += 2 * len(recs)

    try:
        for table, has_missing, cls, group in groups:
            result.n_pairs += engine.run_group(group, table, has_missing,
                                               cls, filt, emit)
    finally:
        if writer is not None:
            writer.close()
        ticker.finalize()
    if writer is not None and settings.sort_shards and out != "-":
        from ..post.sort import sort_two
        tmp_sorted = out[:-4] + ".sorting.two"
        sort_two(out, tmp_sorted, threads=settings.threads)
        os.replace(tmp_sorted, out)
        log("LOG", f"Shard {out} sorted in place (presorted merge ready)",
            sub="SORT")
    if n_procs > 1:
        # every shard exists before any process returns, so a driving
        # script can merge right after rank 0 finishes
        dist.sync_shards()
        if not dcn:
            log("LOG", f"Shard {out} complete; merge the shards with "
                f"parallel.merge_shards", sub="DIST")
    result.elapsed = timer.elapsed()
    log("LOG", f"Computed {pretty_int(result.n_pairs)} pairs -> "
        f"{pretty_int(result.n_records)} records in "
        f"{timer.elapsed_string()} "
        f"({pretty_int(int(result.pairs_per_sec))} pairs/s)",
        sub="PROGRESS")
    if settings.performance:
        report_performance(engine.stats if engine is not None else {})
    return result
