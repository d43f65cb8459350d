"""LD on the GPUs, all-vs-all or windowed (-w): phased (-p), unphased
(-u) and mixed, on one device or a mesh of them, in one process or
several (--distributed), or for small workloads on the CPU.

The PyTorch port of tomahawk_tpu/compute/engine.py: its device path with
its memory and pipeline layer, its device meshes (parallel/mesh.py), its
multi-process run modes over `torch.distributed` (parallel/
distributed.py has the mapping from the JAX mesh) and its small-workload
CPU route. Variant blocks regroup into super-blocks of up to
`tile_rows` variants whose packed bit planes live on the device, and the
block-pair tile grid -- every pair, or in window mode the pairs
`Balancer.window_pairs` keeps -- is swept in segments, one (table,
has_missing, cls) group at a time in the order of `group_tiles` (mixed
mode: the reference's per-pair dispatch, ld_engine.cpp:2737-2880).

Memory: when the planes of all super-blocks exceed `memory_gb` (half of
it, since a load's planes are also concatenated), the super-blocks split
into bands and every band pair is one load (`_plan_loads`, `run_loads`):
the engine keeps bands resident across loads, and a staging worker
inflates and uploads the next load's band from pinned memory on a stream
of its own while the current load computes (compute/bands.py).

Pipeline: for each segment the device runs the tile kernel and the
survivor compaction on every tile (sweeps.fused_sweep, one C call that
enqueues them all), for phased tables the in-sweep Fisher bracket of its
survivors (sweeps.append_fisher_col, when the segment holds
FISHER_MIN_ROWS of them) and, behind them on the same stream, copies the
per-tile counts, a prefix of the survivor rows and, for unphased
tables, the prefilter screen's two counts (candidates screened, left to
the exact statement) into pinned host memory. A consumer thread waits
on that copy's event, pulls the rest of the rows, re-sweeps the rare tiles that overflowed the per-tile cap or
spilled the buffer at exact offsets (sweeps.extract_sweep, on its own
stream), runs the exact f64 statistics and Fisher P in the native record
pipeline (ld_math.ld_records; P from the bracket times the exact q where
the row has one) and emits .two records in segment order,
while the main thread has the next segment's sweep in flight: two
segments at a time where the card has room for a second sweep's buffers.

Meshes (`--mesh auto` over several cards, `PxS`, `cpu:PxS`; `mesh=` a
parallel.Mesh): the pairs axis splits each segment's tile list, padded
to a multiple of 16 * P, into P contiguous slices that each shard sweeps
on its own device into its own survivor buffer, and the host reads the
shards' survivors in shard order, so the record stream is a single
device's; the samples axis gives each device of a shard's row a slice of
every word plane, and the row sums its local parts on its first device
(parallel.SamplesGroup: the peers' parts copied there, over NVLink where
the cards reach each other) before the epilogue and the compaction there.
Every kernel of a shard or slice runs on its own card, on that card's
current stream (the consumer's and the staging worker's streams are one
a card).
With S = 1 each shard's tiles run through the C tile loop on its own
card; with S > 1 the tile loop is Python's.

The CPU route (`_route_backend`): `--backend cpu`, or `auto` where the
run's work (candidate pairs x haplotypes) is below the card's measured
crossover (CPU_ROUTE_WORK, TWK_CPU_ROUTE_WORK overrides it), is decided
once, before any device work, and runs the whole tile plan through the
native CPU tile engine (compute/cpu_engine.py); a checkpointed routed
run keeps the segment engine, on the CPU. It is not a fallback: a
kernel that fails still raises.

`--distributed` runs one process per device. By default the tile list is
partitioned round-robin: rank k of N sweeps `pairs[k::N]`, loads only
the super-blocks those touch (banded over them when they exceed the
budget) and writes `out.pKofN.two` (`parallel.merge_shards` folds the
shards). With `--mesh dcn` the packed-word axis spans the ranks instead:
every rank holds 1/N of every word plane, all sweep every tile jointly
(local parts, all-reduce, epilogue: sweeps.py); each rank runs the host
math of its slice of every segment's survivors, the records are gathered
over gloo (`_dcn_records`), and rank 0 alone writes the one output.
`--mesh dcn:P` gives each rank P cards, a local pairs axis: pairs shard p
reduces over row p's device group, which joins card p of every rank
(`parallel.ProcessGroup.rows`; NCCL where the cards are the ranks' own).
Every rank walks
the same loads and tiles in the same order with the same caps and
repair decisions, because those follow from the global counts, so the
collectives stay aligned; such a run neither stages nor pipelines.

Checkpoints (`--checkpoint PATH`, compute/resume.py): a run resumes
after its last whole segment. Tile-partition runs keep a sidecar a
process (`PATH.pKofN`); a dcn run keeps rank 0's, whose state every rank
receives (`parallel.broadcast_resume`).

The host layer (file formats, balancer, exact statistics, the native
library) is this package's own. The JAX engine's XLA degradation ladder
is not ported: a kernel that fails to build or launch is an error, and
so is a compaction fault: there is no fallback path. Only
the card running out of memory with two segments in flight is retried,
one segment at a time on the same kernels.
"""

import contextlib
import datetime
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from .. import __version__, spans
from ..device import on_device, resolve_device
from ..io.twk import TwkReader
from ..io.two import TWO_DTYPE
from ..ops.fisher_dev import host_p_from_bracket, log_factorial_table
# one call a super-block: the name ldbench's `calc.inflate` wrap times
from ..ops.inflate import decode_super as block_to_planes
from ..ops.inflate import new_planes, read_super
from ..ops.ld_math import (LdFilters, PairMeta, _meta_subset, ld_records,
                           phased_math, unphased_math)
from ..ops.tiles import tile_buffers
from ..parallel import distributed as dist
from ..parallel.mesh import SamplesGroup
from ..utils import Timer, log, pretty_int
from ..utils.progress import ProgressTicker
from . import sweeps
from .balancer import Balancer
from .bands import Bands
from .cpu_engine import run_native_cpu
from .resume import Checkpoint
from .two_pool import PooledTwoWriter

__all__ = ["CalcResult", "CalcSettings", "LdEngine", "compute_ld"]

#: the unphased prefilter screen's counts over every sweep group of the
#: process, as each segment's read-back brings them: candidates screened
#: and those left to the exact statement (a group's own are its
#: `engine.group` span's `screened` and `undecided`)
SCREEN_TOTALS = {"screened": 0, "undecided": 0}
_screen_lock = threading.Lock()


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
    # upper limit of tiles per segment; the progress ticker advances
    # between segments
    sweep_segment: int = 4096
    performance: bool = False
    # consecutive .twk blocks regroup into super-blocks of up to this
    # many variants (never spanning a contig change); 0 = TILE_ROWS
    tile_rows: int = 0
    # "auto": every visible card as the pairs axis when there is more
    # than one (one card a process under --distributed); "off" or "":
    # one device; "PxS", "cuda:PxS", "cpu:PxS": an explicit ('pairs',
    # 'samples') mesh; "dcn" / "dcn:P" (with distributed): the
    # packed-word axis spans the processes, P cards each
    mesh: str = "auto"
    # the user's budget for the packed planes on the device, GB (the
    # reference's calc -M); inputs whose planes exceed half of it stream
    # in band-pair loads. The JAX package's default: an 80 GB card can
    # take a larger value
    memory_gb: float = 12.0
    # host threads for block decompression and plane inflation, and the
    # .two writer's block compressors; 0 = all
    threads: int = 0
    # one process per device over torch.distributed: tile partition
    # with per-process shards, or with mesh "dcn" the samples-sharded
    # sweep; needs coordinator (host:port), num_processes, process_id
    distributed: bool = False
    coordinator: str = ""
    num_processes: int = -1
    process_id: int = -1
    tile_backend: str = "auto"    # anything but "auto" is rejected
    # "auto": workloads below the card's crossover run on the CPU
    # (`_route_backend`); "device" / "cpu" force one side
    backend: str = "auto"
    # in-run checkpoint/resume: the sidecar's path ("" = off) and the
    # seconds between its writes
    checkpoint: str = ""
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
    # banded-run staging telemetry (LdEngine.stage_stats, with n_bands,
    # n_loads and n_uploads): upload time hidden behind the sweeps vs
    # exposed on the main thread, bytes moved, bands prefetched by the
    # staging worker vs loaded on demand
    stage_stats: dict = None

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


def _host_records(table, data, meta: PairMeta, filt, p_pre):
    """(records, their reverses or None, the kept survivor indices or
    None) of a segment's survivors: the native record pipeline
    (`ld_records`, with the in-sweep P where given), or the plain math on
    a host without the native library."""
    out = ld_records(table, data, meta, filt, p_pre=p_pre)
    if out is not None:
        return out
    if table == "phased":
        recs, kept_idx = phased_math(data, meta, filt)
        return recs, None, kept_idx
    return unphased_math(data, meta, filt), None, None


def _bucket(n: int, lo: int) -> int:
    """Round n up to a power of two (>= lo)."""
    b = lo
    while b < n:
        b *= 2
    return b


def _round_up(n: int, q: int) -> int:
    """Round n up to a multiple of q."""
    return ((n + q - 1) // q) * q


#: the tile rows of `tile_rows=0`, in every mode: the JAX engine's rule,
#: so both engines plan the same tiles and emit records in the same
#: order. Whether a smaller tile serves a short window better on the GPU
#: is not measured yet; tile_rows remains an explicit override
TILE_ROWS = 4096


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
    """Per-kernel-config dispatch and timing report, the analogue of the
    reference's ComputePerformance / n_method counters
    (reference: lib/ld/ld.cpp:878-1057, ld_engine.h:171-174,313).
    Accepts an LdEngine or a stats dict; with an engine, also prints
    the per-allele-count histogram (the reference prints per-AC mean
    cycles at ld.cpp:1047-1052; here: prefilter survivors and kept
    records per log2 bucket of min(ac_a, ac_b), the same AC-resolved
    view its kernel-crossover fits came from)."""
    ac_hist = None
    if isinstance(stats, LdEngine):
        ac_hist = stats.ac_hist or None
        stats = stats.stats
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
    if ac_hist:
        log("LOG", f"{'min(ac) bucket':<18}{'survivors':>12}"
            f"{'records':>10}{'kept %':>8}", sub="PERF")
        for b in sorted(ac_hist):
            s, k = ac_hist[b]
            log("LOG", f"[{1 << b:>6}, {2 << b:>6}) "
                f"{s:>15,}{k:>10,}{100.0 * k / max(s, 1):>7.1f}%",
                sub="PERF")


class LdEngine:
    """Device planes and the segment pipeline for one run configuration
    on one device or a mesh of them. `LdEngine(stacked, n_samples,
    settings, device)` makes `stacked` (bitpack.stack_planes output) the
    single resident band; `LdEngine(None, ..., B=B)` starts empty for
    banded streaming, where `set_load` names the bands of each load.
    With `mesh` (a parallel.Mesh) the engine drives the mesh's devices
    (the module docstring says how); `device` is then not needed. With a
    mesh that carries a process group (`parallel.make_dcn_mesh`) the
    engine is one rank of a samples-sharded run: it uploads its rank's
    slice of every word plane and its sweeps sum each tile's parts over
    the group; every rank of the group must then make the same calls in
    the same order, so such an engine neither stages bands nor pipelines
    segments.

    Device planes are held per band (`bands`, compute/bands.py); the
    sweep's kernels run on the stream that is current where the engine
    is called. Call `stage_close` when done: it joins the staging worker
    and the segment consumer."""

    # survivors extracted per tile inside the fused sweep; tiles with
    # more go through the exact-offset repair pass, and the cap adapts
    # upward when a run's tiles overflow it
    FUSED_CAP = 256
    FUSED_CAP_MAX = 32768
    # initial survivor-buffer rows per segment, grown when it spills
    OUTCAP0 = 1 << 18
    # target segments per tile group: the consumer handles segment k's
    # host work while the device sweeps k+1, so a group swept as one
    # segment would serialise its host work behind the sweep
    PIPELINE_SEGMENTS = 8
    # survivor-buffer rows copied to the host right behind each sweep,
    # before its counts are known; adapts per sweep group
    PREFIX_ROWS0 = 4096

    def __init__(self, stacked: dict, n_samples: int,
                 settings: CalcSettings, device=None, B: int = None,
                 mesh=None):
        self.group = mesh.group if dist.mesh_is_multiprocess(mesh) else None
        if self.group is not None:
            # a dcn mesh: this process is its samples column `rank`
            rank, S = self.group.rank, self.group.size
            grid = [[(d, (rank, S))] for d in mesh.devices[:, rank]]
        else:
            devices = mesh.devices if mesh is not None else [[device]]
            S = len(devices[0])
            grid = [[(d, (s, S) if S > 1 else None)
                     for s, d in enumerate(row)] for row in devices]
        # (device, word slice) of every position of the mesh, by pairs
        # shard: slice (s, S) of the samples axis, or None for whole planes
        self._grid = [[(resolve_device(d), ws) for d, ws in row]
                      for row in grid]
        self._positions = [pos for row in self._grid for pos in row]
        self.n_pair_shards = len(self._grid)
        self.settings = settings
        self.n_samples = n_samples
        self.device = self._grid[0][0][0]
        self.window = settings.l_window if settings.window else 0
        self.ticker = None           # optional ProgressTicker
        # the adaptive survivor caps, per tile in the fused sweep and per
        # segment's buffer; a resumed run sets them to its sidecar's
        self.caps = dict(fused_cap=self.FUSED_CAP, outcap=self.OUTCAP0)
        # in-sweep Fisher (phased tables): the fused sweep carries a
        # bracket per survivor and the host multiplies by the exact f64 q.
        # Above 2**15 haplotypes the walk's distance to the mirror
        # crossing (about D * 2N cells) overruns its step cap, so most
        # lanes would flag for the host anyway: wide cohorts keep Fisher
        # on the host, as does TWK_DEVICE_FISHER=0 (the JAX package's
        # switch)
        self._device_fisher = \
            os.environ.get("TWK_DEVICE_FISHER", "1") == "1" \
            and 2 * n_samples <= (1 << 15)
        self._lf_host = None
        # per-config dispatch statistics (report_performance reads them)
        self.stats = {}
        # per-allele-count histogram (log2 buckets of min(ac_a, ac_b)):
        # survivors and kept records per bucket, the analogue of the
        # reference's AC-keyed twk_ld_perf cycle arrays
        # (ld_engine.h:171-174, printed at ld.cpp:1047-1052). Filled only
        # under settings.performance
        self.ac_hist = {}
        # samples-sharded runs: the survivor rows whose host math this
        # rank ran, of all the survivor rows, and the seconds of math_s
        # spent in the records' gathers (`_dcn_records`)
        self.math_rows = 0
        self.survivor_rows = 0
        self.gather_s = 0.0
        # segment pipeline (run_group): one consumer thread handles the
        # dispatched segments in order while the main thread keeps the
        # device queue fed. After a consumer ran out of device memory
        # the run goes serial; this many clean serial segments in a row
        # re-enable the pipeline (each disable doubles it)
        self._pipeline_enabled = True
        self._pipeline_retry_after = 8
        self._serial_ok_streak = 0
        self._seg_error = None       # first consumer failure, if any
        self._seg_pool_ = None       # the consumer, a 1-thread pool
        self._seg_streams = {}       # its stream on each card
        # survivor-buffer prefix rows per sweep group (_submit_segment)
        self._prefix_rows = {}
        # the depth gate's answers in the current group, by caps
        self._headroom = {}
        # the current group's screen counts (unphased tables)
        self._screen = dict(screened=0, undecided=0)
        # checkpoint/resume (compute/resume.py): the first `ckpt_skip`
        # segments are skipped (their records are in the checkpointed
        # output); `units_done` counts segments completed or skipped,
        # `_units_planned` those skipped or dispatched, `cand_total` the
        # candidate pairs of the run; `on_segment` is called after each
        # segment's records are emitted
        self.ckpt_skip = 0
        self.units_done = 0
        self._units_planned = 0
        self.cand_total = 0
        self.on_segment = None
        self.bands = Bands(self._grid, S, B)
        self.stage_stats = self.bands.stats
        self.stacked = None
        self.B = B
        # a window no sweep takes raises here, before any output
        self._cfg("phased", False, "all")
        if stacked is not None:
            self.set_load([("all", stacked)])
        elif B is None:
            raise ValueError("need either stacked planes or explicit B")

    # -- bands, caps and the segment count --------------------------------
    def set_load(self, bands, limit: int = 2):
        """`Bands.set_load`, the load's host arrays becoming `stacked`."""
        self.stacked = self.bands.set_load(bands, limit)
        self.B = self.bands.B

    def stage_band_async(self, band_id, provider):
        """`Bands.stage_async`. A samples-sharded engine does not stage:
        every rank uploads in program order on its main thread."""
        if self.group is None:
            self.bands.stage_async(band_id, provider)

    def stage_wait(self):
        """`Bands.stage_wait`."""
        self.bands.stage_wait()

    def stage_close(self):
        """Drain and join the staging worker and the segment consumer."""
        self.bands.close()
        if self._seg_pool_ is not None:
            self._seg_pool_.shutdown(wait=True)
            self._seg_pool_ = None

    @property
    def n_band_uploads(self) -> int:
        return self.bands.n_uploads

    def skip_to(self, units: int):
        """Count the segments up to the `units`-th as done and planned
        without dispatching them: a resumed run's skip of a whole load."""
        self.units_done = max(self.units_done, units)
        self._units_planned = max(self._units_planned, units)

    def _row_cfg(self, cfg, p: int, row: list) -> dict:
        """The sweep config of pairs shard `p`, whose samples slices hold
        `row` (a `Bands.dev_for` row): under a dcn mesh, row p's device
        group (`ProcessGroup.rows`: card p of every rank); with S > 1 on a
        local mesh, the row's SamplesGroup, with tile buffers of its own on
        each peer's device."""
        if self.group is not None:
            return dict(cfg, psum_group=self.group.rows[p])
        if len(row) == 1:
            return cfg
        return dict(cfg, psum_group=SamplesGroup(
            (d, tile_buffers(cfg, d["valid"].device)) for d in row[1:]))

    def _cfg(self, table, has_missing, cls):
        s = self.settings
        return sweeps.make_cfg(table, has_missing, cls, self.B,
                               self.n_samples, self.window, s.min_r2,
                               s.max_r2, s.min_dprime, s.max_dprime,
                               psum_group=self.group,
                               fisher=self._device_fisher)

    def _lf_host_get(self) -> np.ndarray:
        """Host f64 log-factorial table: the exact q of the in-sweep
        Fisher split P = q * bracket (ops/fisher_dev.py)."""
        if self._lf_host is None:
            self._lf_host = log_factorial_table(2 * self.n_samples + 1)
        return self._lf_host

    def _stat(self, cfg):
        key = (f"{cfg['table']}/{'miss' if cfg['has_missing'] else 'nomiss'}"
               f"/{cfg['cls']}")
        return self.stats.setdefault(key, dict(
            n_tiles=0, n_cand=0, n_pass=0, n_records=0, count_s=0.0,
            extract_s=0.0, math_s=0.0, n_supp=0, n_repair=0))

    def _segment_size(self, n_tiles: int) -> int:
        """Tiles per segment: at most settings.sweep_segment, at least one
        quantum of 16 a pairs shard, and small enough to split the group
        into about PIPELINE_SEGMENTS pieces (the JAX engine's rule; the
        checkpoint key holds the same quantum)."""
        quant = 16 * self.n_pair_shards
        seg = max(self.settings.sweep_segment, quant)
        want = _round_up(-(-n_tiles // self.PIPELINE_SEGMENTS), quant)
        return max(quant, min(seg, want))

    # -- the segment pipeline --------------------------------------------
    def _seg_pool(self):
        if self._seg_pool_ is None:
            self._seg_pool_ = ThreadPoolExecutor(
                1, thread_name_prefix="twk-seg")
            if self.device.type == "cuda":
                self._seg_streams = {d: torch.cuda.Stream(d)
                                     for d in self.bands.cards}
        return self._seg_pool_

    def _pipeline_depth(self, cfg) -> int:
        """Segments in flight: 1 is serial (dispatch, consume, dispatch,
        ...); 2 keeps the device sweeping segment k+1 while the consumer
        thread reads back, repairs, does the host math of and emits
        segment k. Gated on device memory for a second sweep's buffers
        and on the survivor buffer's size. An engine whose samples axis
        spans processes stays serial: its collectives are issued from one
        thread in program order on every rank. A local mesh pipelines."""
        if self.group is not None or not self._pipeline_enabled:
            return 1
        if self.caps["outcap"] > (1 << 21):
            return 1
        # the free memory is read once a group and again when the caps
        # grow: `run_group` asks before every dispatch, and one read of
        # it took 17-326 us on the card's host (chip_smoke.py)
        key = (self.caps["outcap"], self.caps["fused_cap"])
        if key not in self._headroom:
            self._headroom[key] = self._prefetch_headroom_ok(cfg)
        return 2 if self._headroom[key] else 1

    def _prefetch_headroom_ok(self, cfg) -> bool:
        """Whether every card can hold a second sweep in flight: its tile
        buffers, counts buffer, compaction scratch and survivor buffer
        (sweeps.sweep_bytes) for each position of the mesh on the card,
        with a 2.5x margin, against the free device memory and what
        PyTorch's allocator holds unused. The CPU has no such limit
        here."""
        if self.device.type != "cuda":
            return True
        cap = min(self.caps["fused_cap"], self.B * self.B)
        need = sweeps.sweep_bytes(cfg, max(self.caps["outcap"], 2 * cap))
        for dev in self.bands.cards:
            free, _ = torch.cuda.mem_get_info(dev)
            free += torch.cuda.memory_reserved(dev) \
                - torch.cuda.memory_allocated(dev)
            n = sum(d == dev for d, _ in self._positions)
            if free <= 2.5 * need * n:
                return False
        return True

    def run_group(self, tiles, table, has_missing, cls, filt, emit) -> int:
        """Sweep one (table, missing, cls) tile group in segments; returns
        the number of candidate pairs evaluated.

        Segments are dispatched ahead of consumption: `_submit_segment`
        enqueues the sweep and, behind it on the same stream, the copies
        of its counts and a prefix of its survivor rows into pinned host
        memory, and one consumer thread reads them back, repairs, runs the
        exact host math and emits the records in segment order. A
        consumer failure skips the segments still in flight (nothing of a
        later segment is emitted) and raises, but for the card running out
        of memory: the run then goes serial on the same kernels from the
        failed segment on, with a warning. Returns only when nothing of
        the group is in flight. A resumed run skips the segments before
        `ckpt_skip` here: they dispatch nothing, on any route."""
        cfg = self._cfg(table, has_missing, cls)
        seg = self._segment_size(len(tiles))
        todo = []
        for s in range(0, len(tiles), seg):
            self._units_planned += 1
            if self._units_planned <= self.ckpt_skip:
                # its records are in the checkpointed output
                self.units_done += 1
                continue
            todo.append(tiles[s:s + seg])
        n = 0
        inflight = deque()       # (todo index, future)
        k = 0
        self._seg_error = None
        self._headroom = {}
        # the job of library use; the main thread's time in the group is
        # engine.dispatch, engine.wait or a serial engine.consume. `fisher`:
        # 1 where the sweep carries the in-sweep bracket, 0 where every P
        # is the host's exact scan; `screened`, `undecided`: the group's
        # screen counts (0 for phased tables), set when it ends
        self._screen = dict(screened=0, undecided=0)
        group = spans.span("engine.group", job=True, tiles=len(tiles),
                           segments=len(todo),
                           fisher=int(sweeps.fisher_on(cfg))).start()
        try:
            while k < len(todo) or inflight:
                depth = self._pipeline_depth(cfg)
                if k < len(todo) and len(inflight) < depth:
                    if depth == 1 and not inflight:
                        n += self._run_segment(todo[k], cfg, filt, emit)
                        self._note_serial_ok()
                        k += 1
                        continue
                    try:
                        st = self._submit_segment(todo[k], cfg)
                    except torch.cuda.OutOfMemoryError as e:
                        # no room for a second sweep: finish the ones in
                        # flight, then go on serially
                        self._go_serial(e)
                        continue
                    inflight.append((k, self._seg_pool().submit(
                        self._seg_job, todo[k], cfg, filt, emit, st)))
                    k += 1
                    continue
                j, fut = inflight.popleft()
                try:
                    with spans.span("engine.wait"):
                        got = fut.result()
                    n += got
                except torch.cuda.OutOfMemoryError as e:
                    # the later segments in flight skipped themselves;
                    # re-run from j serially, on the same kernels
                    self._drain(inflight)
                    self._seg_error = None
                    self._go_serial(e)
                    n += self._run_segment(todo[j], cfg, filt, emit)
                    k = j + 1
        except BaseException as e:
            if self._seg_error is None:
                self._seg_error = e
            self._drain(inflight)
            raise
        finally:
            self._seg_error = None
            group.set(**self._screen)
            group.stop()
        return n

    @staticmethod
    def _drain(inflight):
        """Wait for every segment still in flight; each skips itself once
        `_seg_error` is set, so only the first failure is raised."""
        for _, fut in inflight:
            try:
                fut.result()
            except BaseException:   # noqa: BLE001 - the first error raises
                pass
        inflight.clear()

    def _go_serial(self, err):
        self._pipeline_enabled = False
        self._serial_ok_streak = 0
        self._pipeline_retry_after = min(self._pipeline_retry_after * 2,
                                         1 << 12)
        log("WARNING", f"the card ran out of memory in the segment pipeline "
            f"({str(err)[:160]}); running the same kernels one segment at a "
            f"time", sub="ENGINE")

    def _note_serial_ok(self):
        """A segment ran cleanly without overlap; after enough in a row,
        try the pipeline again."""
        if self._pipeline_enabled:
            return
        self._serial_ok_streak += 1
        if self._serial_ok_streak >= self._pipeline_retry_after:
            log("LOG", f"re-enabling the segment pipeline after "
                f"{self._serial_ok_streak} clean serial segments",
                sub="ENGINE")
            self._pipeline_enabled = True
            self._serial_ok_streak = 0

    def _seg_job(self, tiles, cfg, filt, emit, state):
        """The consumer thread's wrapper of `_run_segment`: skip (without
        emitting) when an earlier segment failed, so emission stays in
        segment order. Its device work (the supplementary rows, repairs)
        goes on the consumer's own stream of each card, so it never
        waits behind the next segment's sweep."""
        if self._seg_error is not None:
            return 0
        try:
            with contextlib.ExitStack() as ctx:
                ctx.enter_context(on_device(self.device))
                for stream in self._seg_streams.values():
                    ctx.enter_context(torch.cuda.stream(stream))
                return self._run_segment(tiles, cfg, filt, emit, state=state)
        except BaseException as e:
            self._seg_error = e
            raise

    # -- one segment -----------------------------------------------------
    def _dispatch_fused(self, tiles, cfg) -> dict:
        """Enqueue one segment's fused sweep on every pairs shard; nothing
        waits for it. With P > 1 shards the tile list is padded to a
        multiple of 16 * P with dead tiles (the JAX engine's padding) and
        shard p sweeps the p-th of P contiguous slices on its row's
        devices, into its own survivor buffer."""
        with spans.span("engine.dispatch.tiles"):
            P = self.n_pair_shards
            T = len(tiles)
            Tpad = T if P == 1 else _round_up(T, 16 * P)
            pad = Tpad - T
            pi = np.array([t[0] for t in tiles] + [0] * pad, np.int32)
            pj = np.array([t[1] for t in tiles] + [0] * pad, np.int32)
            dg = np.array([t[2] for t in tiles] + [True] * pad, bool)
            live = np.arange(Tpad) < T
            devs = self.bands.dev_for(cfg)
            cap = min(self.caps["fused_cap"], self.B * self.B)
            outcap = max(self.caps["outcap"], 2 * cap)
            per = Tpad // P
        shards = []
        with spans.span("engine.dispatch.sweep"):
            for p, row in enumerate(devs):
                sl = slice(p * per, (p + 1) * per)
                with on_device(self._grid[p][0][0]):
                    screen = (torch.zeros(2, dtype=torch.int64,
                                          device=row[0]["valid"].device)
                              if cfg["table"] == "unphased" else None)
                    n_pass, n_cand, buf = sweeps.fused_sweep(
                        row[0], pi[sl], pj[sl], dg[sl], live[sl],
                        cfg=self._row_cfg(cfg, p, row), cap=cap,
                        outcap=outcap, screen=screen)
                shards.append(dict(n_pass=n_pass, n_cand=n_cand, buf=buf,
                                   screen=screen))
        return dict(shards=shards, devs=devs, pi=pi, pj=pj, dg=dg, per=per,
                    cap=cap, outcap=outcap, stacked=self.stacked)

    def _submit_segment(self, tiles, cfg) -> dict:
        """Dispatch one segment's fused sweep and, on each shard's stream
        right behind it, copy its counts, the first X rows of its
        survivor buffer and its screen counts (unphased tables) into
        pinned host memory (X from this group's
        recent survivor volume, so the copies depend on nothing the host
        has yet to read), then record one event a shard. The consumer
        waits on those events, not on the streams: a host read issued
        after the next segment is enqueued would wait for that whole
        sweep. Rows past the prefix are pulled with one exact
        supplementary copy once the counts are known. The segment's span
        (`engine.dispatch`) is the parent of its `engine.consume`."""
        with spans.span("engine.dispatch", tiles=len(tiles)) as sp:
            st = self._dispatch_fused(tiles, cfg)
            key = (cfg["table"], cfg["has_missing"], cfg["cls"])
            X = st["X"] = min(self._prefix_rows.get(key, self.PREFIX_ROWS0),
                              st["outcap"])
            with spans.span("engine.dispatch.readback"):
                for sh, row in zip(st["shards"], self._grid):
                    src = (sh["n_pass"], sh["n_cand"], sh["buf"][:X]) + (
                        () if sh["screen"] is None else (sh["screen"],))
                    sh["event"] = None
                    if sh["buf"].is_cuda:
                        host = [torch.empty(x.shape, dtype=x.dtype,
                                            pin_memory=True) for x in src]
                        for h, x in zip(host, src):
                            h.copy_(x, non_blocking=True)
                        sh["event"] = torch.cuda.Event()
                        sh["event"].record(
                            torch.cuda.current_stream(row[0][0]))
                        src = host
                    sh["host"] = src
        st["span"] = sp.ctx
        return st

    def _run_segment(self, tiles, cfg, filt, emit, state=None) -> int:
        """Read a dispatched segment's counts, pull its survivor rows
        (prefix, supplementary rows, and the exact-offset repair of what
        the fused pass could not hold), run the exact host math and emit
        records. Runs on the consumer thread in pipelined mode, inline
        otherwise; `state=None` dispatches the sweep here (serial: the
        segment's `engine.dispatch` then lies inside its `engine.count`).
        The pairs shards' rows are taken in shard order, each at the
        offsets of its own running sum. Its span, `engine.consume`, is a
        child of the segment's `engine.dispatch`, with the steps
        `engine.count`, `engine.extract` (`engine.repair` inside it),
        `engine.math` and `engine.emit`; the first three feed `stats`."""
        if not tiles:
            return 0
        with spans.span("engine.consume", tiles=len(tiles),
                        parent=state and state["span"]) as sp:
            return self._consume(tiles, cfg, filt, emit, state, sp)

    def _consume(self, tiles, cfg, filt, emit, state, sp) -> int:
        """`_run_segment`'s work inside its span `sp`."""
        stat = self._stat(cfg)
        stat["n_tiles"] += len(tiles)
        B = self.B
        with spans.timed("engine.count") as count:
            st = state if state is not None \
                else self._submit_segment(tiles, cfg)
            pi, pj, dg, per = st["pi"], st["pj"], st["dg"], st["per"]
            cap, outcap, X = st["cap"], st["outcap"], st["X"]
            for sh in st["shards"]:
                if sh["event"] is not None:
                    sh["event"].synchronize()
            # the segment's one wait: its counts, read from the pinned
            # copies
            counts = [sweeps.host_counts(*sh["host"][:2])
                      for sh in st["shards"]]
            n_pass = np.concatenate([c[0] for c in counts])
            n_cand = np.concatenate([c[1] for c in counts])
        stat["count_s"] += count.seconds
        total_cand = int(n_cand.sum())
        stat["n_cand"] += total_cand
        self.cand_total += total_cand
        sp.set(candidates=total_cand,
               survivors=int(n_pass.sum()), supp=0, repaired=0, records=0)
        if int(n_pass.sum()) == 0:
            if self.ticker:
                self.ticker.add(pairs=total_cand)
            self._finish_segment(st["shards"])
            return total_cand
        stat["n_pass"] += int(n_pass.sum())

        # the fused rows of intact tiles: below the spill boundary of
        # their shard's buffer and within the per-tile cap; the rest are
        # repaired
        n_supp = 0
        with spans.timed("engine.extract") as extract:
            shard_of = np.arange(len(n_pass)) // per
            offs = np.cumsum(n_pass) - n_pass
            offs -= np.concatenate([[0], np.cumsum(n_pass)])[shard_of * per]
            ok = (n_pass <= cap) & (offs + n_pass <= outcap - cap)
            rows_by_tile = {}
            max_end = 0
            for p, sh in enumerate(st["shards"]):
                sel = np.flatnonzero(ok[p * per:(p + 1) * per]
                                     & (n_pass[p * per:(p + 1) * per] > 0))
                if not len(sel):
                    continue
                sel += p * per
                end = int(offs[sel[-1]] + n_pass[sel[-1]])
                max_end = max(max_end, end)
                host = sh["host"][2].numpy()[:end]
                if end > X:
                    n_supp += 1
                    host = np.concatenate([host,
                                           sh["buf"][X:end].cpu().numpy()])
                for t in sel:
                    rows_by_tile[int(t)] = host[offs[t]:offs[t] + n_pass[t]]
            # adapt the prefix so the next segments of this group fit it:
            # grow at once, shrink by halves
            key = (cfg["table"], cfg["has_missing"], cfg["cls"])
            cur = self._prefix_rows.get(key, self.PREFIX_ROWS0)
            want = min(_round_up(max(2048, max_end + (max_end >> 4)), 8192),
                       1 << 20)
            self._prefix_rows[key] = max(want, cur // 2)
            bad = np.flatnonzero((n_pass > 0) & ~ok)
            ncol = sweeps.buf_cols(cfg)
            if len(bad):
                with spans.span("engine.repair", tiles=len(bad)):
                    rep = self._repair(st["devs"], cfg, stat, pi, pj, dg,
                                       bad, n_pass[bad], cap, per)
                if sweeps.fisher_cols(cfg):
                    # repair rows carry no bracket: pad them to the fused
                    # width
                    rep = {t: np.concatenate(
                        [r, np.zeros((len(r), 1), np.int32)], axis=1)
                        for t, r in rep.items()}
                rows_by_tile.update(rep)
        stat["n_supp"] += n_supp
        stat["extract_s"] += extract.seconds
        sp.set(supp=n_supp, repaired=len(bad))

        # exact host math, batched into one native call per segment
        stacked = st["stacked"]
        hit = np.array(sorted(rows_by_tile), np.int64)
        rows = np.concatenate([rows_by_tile[int(t)] for t in hit])
        idx = rows[:, 0].astype(np.int64)
        k, l = idx // B, idx % B
        tile_of = np.repeat(np.arange(len(hit)), n_pass[hit])
        bi = pi[hit][tile_of].astype(np.int64)
        bj = pj[hit][tile_of].astype(np.int64)
        meta = _pair_meta_from(stacked, bi, bj, k, l)
        table = cfg["table"]
        parts = sweeps.unpack_payload(rows[:, 1:ncol], table,
                                      cfg["has_missing"], self.n_samples)
        with spans.timed("engine.math") as math:
            if table == "phased":
                data = self._phased_counts_from_parts(parts, meta)
            else:
                data = self._unphased_table_from_parts(stacked, parts, bi,
                                                       bj, k, l)
            p_pre = self._fisher_p(cfg, rows, data, n_pass, hit[tile_of],
                                   bad, filt, per)
            kept_idx = None
            if self.group is not None:
                # every rank holds the same survivor rows: each runs the
                # math of its slice and the records are gathered
                recs, rev = self._dcn_records(table, data, meta, filt, p_pre)
            else:
                recs, rev, kept_idx = _host_records(table, data, meta, filt,
                                                    p_pre)
        stat["math_s"] += math.seconds
        if self.settings.performance:
            self._tally_ac(meta, kept_idx)
        stat["n_records"] += len(recs)
        sp.set(records=len(recs))
        with spans.span("engine.emit"):
            emit(recs, rev)
        if self.ticker:
            self.ticker.add(pairs=total_cand, records=len(recs))
        self._finish_segment(st["shards"])
        return total_cand

    def _add_screen(self, shards):
        """Add the read-back screen counts of a segment's shards to the
        group's and to SCREEN_TOTALS."""
        got = [sh["host"][3] for sh in shards if len(sh["host"]) > 3]
        if not got:
            return
        scr, und = (int(x) for x in sum(g.to(torch.int64) for g in got))
        with _screen_lock:
            for key, v in (("screened", scr), ("undecided", und)):
                self._screen[key] += v
                SCREEN_TOTALS[key] += v

    def _fisher_p(self, cfg, rows, data, n_pass, row_tile, bad, filt,
                  per=None):
        """P of each row from its in-sweep Fisher bracket (NaN: the native
        kernel computes it), or None where the segment carries none. The
        device's volume gate of each pairs shard (its `per` tiles; one
        shard by default) mirrored from the same integer n_pass; rows of
        repaired tiles carry no bracket."""
        if not sweeps.fisher_on(cfg):
            return None
        per = per or len(n_pass)
        shard_ok = n_pass.reshape(-1, per).sum(axis=1) \
            >= sweeps.FISHER_MIN_ROWS
        valid = shard_ok[row_tile // per] & ~np.isin(row_tile, bad)
        if not valid.any():
            return None
        if sweeps.fisher_packed(cfg):
            u = np.ascontiguousarray(rows[:, 1]).view(np.uint32)
            bits = (u & np.uint32(0xFFFF0000)).view(np.float32)
        else:
            bits = np.ascontiguousarray(
                rows[:, sweeps.buf_cols(cfg)]).view(np.float32)
        p_pre = host_p_from_bracket(data, bits, self._lf_host_get(),
                                    filt.min_p)
        p_pre[~valid] = np.nan
        return p_pre

    def _finish_segment(self, shards):
        """Segment bookkeeping, on whichever thread handled the segment,
        after its records were emitted: its screen counts (read back with
        its counts from each of its `shards`), once."""
        self._add_screen(shards)
        self.units_done += 1
        if self.on_segment is not None:
            self.on_segment()

    def _tally_ac(self, meta: PairMeta, kept_idx):
        """Accumulate the per-allele-count histogram: log2 bucket of
        min(ac_a, ac_b) -> [survivors, records]. See ac_hist."""
        mn = np.asarray(np.minimum(meta.ac_a, meta.ac_b), np.int64)
        if len(mn) == 0:
            return
        buck = np.frexp(np.maximum(mn, 1).astype(np.float64))[1] - 1
        surv = np.bincount(buck)
        kept = (np.bincount(buck[np.asarray(kept_idx, np.int64)],
                            minlength=len(surv))
                if kept_idx is not None and len(kept_idx)
                else np.zeros(len(surv), np.int64))
        for i in range(len(surv)):
            if surv[i]:
                h = self.ac_hist.setdefault(int(i), [0, 0])
                h[0] += int(surv[i])
                h[1] += int(kept[i])

    def _dcn_records(self, table, data, meta: PairMeta, filt, p_pre=None):
        """The host math of a samples-sharded segment split over the
        ranks: each runs the survivor -> record pipeline on its
        contiguous slice of the K rows (and of the in-sweep P), and the
        variable-length record chunks and their reverses are gathered in
        rank order over the host group (`parallel.allgather_records`), so
        every rank ends with the record stream one process would have
        made. A rank whose slice is empty still joins the gathers."""
        grp = self.group
        K = len(data)
        step = -(-K // grp.size)
        lo = min(K, grp.rank * step)
        hi = min(K, lo + step)
        self.math_rows += hi - lo
        self.survivor_rows += K
        if hi <= lo:
            recs = rev = np.empty(0, TWO_DTYPE)
        else:
            sl = slice(lo, hi)
            recs, rev, _ = _host_records(
                table, data[sl], _meta_subset(meta, sl), filt,
                None if p_pre is None else p_pre[sl])
            if rev is None:
                rev = _reverse_records(recs)
        with spans.timed("engine.gather") as gather:
            out = dist.allgather_records((recs, rev), grp)
        self.gather_s += gather.seconds
        return out

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

    def _unphased_table_from_parts(self, st, parts, bi, bj, k,
                                   l) -> np.ndarray:
        """[K, 3, 3] int64 genotype tables from the raw device
        contractions (mirrors ops.ld_kernels.unphased_cells); `st` holds
        the load's per-variant arrays."""
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

    def _repair(self, devs, cfg, stat, pi, pj, dg, bad, ns_bad, cap, per):
        """Re-sweep the tiles that overflowed the cap or spilled the
        buffer, at exact offsets, each on the devices of the pairs shard
        that owns it (`per` tiles a shard); adapt the caps so later
        segments of this regime compact in the fused pass."""
        B = self.B
        stat["n_repair"] += len(bad)
        if (ns_bad <= cap).any():
            # a tile spilled its shard's buffer: grow it
            self.caps["outcap"] = min(self.caps["outcap"] * 4, 1 << 23)
        over = int(ns_bad.max())
        if over > cap:
            self.caps["fused_cap"] = min(_bucket(over, self.FUSED_CAP),
                                         self.FUSED_CAP_MAX, B * B)
        rcap = min(_bucket(over, 1024), B * B)
        out = {}
        for p in np.unique(bad // per):
            sel = bad // per == p
            tiles, ns = bad[sel], ns_bad[sel]
            total = int(ns.sum())
            hoff = np.cumsum(ns) - ns
            with on_device(self._grid[p][0][0]):
                rbuf = sweeps.extract_sweep(
                    devs[p][0], pi[tiles], pj[tiles], dg[tiles], hoff,
                    cfg=self._row_cfg(cfg, p, devs[p]), cap=rcap,
                    outcap=_bucket(total + rcap, 16384))
            host = rbuf[:total].cpu().numpy()
            out.update({int(t): host[o:o + n]
                        for t, o, n in zip(tiles, hoff, ns)})
        return out

    # -- public API ------------------------------------------------------
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


def dispatch_pairs(engine: LdEngine, pairs, mode: str, filt: LdFilters,
                   emit, stacked) -> int:
    """Route block pairs through the group_tiles dispatch plan."""
    blk_missing = stacked["has_missing"].any(axis=1)
    n = 0
    for table, has_missing, cls, tiles in group_tiles(pairs, mode,
                                                      blk_missing):
        n += engine.run_group(tiles, table, has_missing, cls, filt, emit)
    return n


def run_loads(engine: LdEngine, bands, loads, provider, mode: str,
              filt: LdFilters, emit, prefetch: bool = False,
              resume: Checkpoint = None) -> int:
    """Sweep a `_plan_loads` plan: for each load, the band pair (p, q) is
    made resident (`provider(b)` gives band b's stacked host planes, for
    a band not resident yet) and its tiles are dispatched. With
    `prefetch` the staging worker inflates and uploads the next load's
    new band while the current load computes (a third resident band).
    `resume` (a resume.Checkpoint) takes the engine's segments done after
    each load, and a resumed run skips the loads it completed whole.
    Returns the candidate pairs evaluated."""
    def done_before(li):
        return resume is not None and resume.load_done(li)

    n = 0
    for li, ((p, q), load_tiles) in enumerate(loads):
        if done_before(li):
            # the segment count follows, or later loads would skip
            # against the wrong base
            engine.skip_to(resume.load_cum[li])
            continue
        engine.stage_wait()
        resident = engine.bands.resident()
        engine.set_load([(b, None if b in resident else provider(b))
                         for b in dict.fromkeys((p, q))],
                        limit=3 if prefetch else 2)
        if prefetch and li + 1 < len(loads) and not done_before(li + 1):
            for b in set(loads[li + 1][0]):
                engine.stage_band_async(b, lambda b=b: provider(b))
        load_ids = bands[p] if p == q else bands[p] + bands[q]
        slot = {g: s for s, g in enumerate(load_ids)}
        tiles = [(slot[i], slot[j], d) for i, j, d in load_tiles]
        n += dispatch_pairs(engine, tiles, mode, filt, emit, engine.stacked)
        if resume is not None:
            resume.load_cum.append(engine.units_done)
    return n


def _check_settings(settings: CalcSettings):
    """Raise for run options this engine does not take."""
    if _is_dcn(settings) and not settings.distributed:
        raise ValueError("mesh 'dcn' needs a multi-process run "
                         "(use --distributed)")
    if settings.tile_backend != "auto":
        raise ValueError("--tile-backend selects a JAX tile path; the "
                         "port has one: its CUDA kernels")


def _is_dcn(settings: CalcSettings) -> bool:
    return (settings.mesh or "off").split(":")[0] == "dcn"


#: the work (candidate pairs x haplotypes) below which `--backend auto`
#: runs `calc` on the CPU: the lower of the two crossovers measured,
#: where the native CPU tile engine's compute_ld wall in a fresh `calc
#: --backend cpu` process meets the card's (`--backend device`), medians
#: of three at 2,504 samples, NVIDIA H100 80GB HBM3 at 700.00 W beside 8
#: host cores (`python3 chip_smoke.py crossover`): the mixed dispatch on
#: archives with missing data, 7.75e9 (1,024 and 2,048 sites either
#: side), and `calc -p` on phased archives without, 5.72e10 (4,096 and
#: 8,192 sites). Below the lower one the CPU finished first in both; a
#: phased run between the two takes the card at up to ~0.6 s more
CPU_ROUTE_WORK = 7.7e9


def _route_backend(settings: CalcSettings, est_pairs: int, n_samples: int,
                   n_procs: int, dcn: bool = False, device="cuda",
                   mesh=None) -> bool:
    """True when this run should execute on the CPU: the JAX engine's
    rule with the device in place of its platform check. The card pays a
    fixed price (the process's CUDA start, the kernel library's load,
    the planes' upload) that small workloads never amortize, and the
    native CPU tile engine computes about est_pairs * 2N pair-haplotype
    operations, so below the crossover CPU_ROUTE_WORK (the
    TWK_CPU_ROUTE_WORK environment variable overrides it) the CPU
    finishes first. `--backend device` / `cpu` force one side; an
    explicit mesh (a spec other than auto and off, or `mesh`, a
    parallel.Mesh) stays on its devices; a run on the CPU is there
    already; a dcn mesh never routes, and raises for `--backend cpu`.
    `device` is the run's device, so a route can be decided for a card
    that is not there."""
    b = getattr(settings, "backend", "auto")
    if dcn:
        # the dcn mesh's purpose is device planes sharded over
        # processes; routing to host CPU would defeat it
        if b == "cpu":
            raise ValueError("--backend cpu is incompatible with a dcn "
                             "mesh (its device planes span processes); "
                             "use the default distributed mode")
        return False
    if b == "cpu":
        return True
    if b != "auto":
        return False
    if mesh is not None or settings.mesh not in ("auto", "off", ""):
        return False          # an explicit device mesh wins
    if torch.device(device).type != "cuda":
        return False          # already on the host
    work = est_pairs * 2 * n_samples
    limit = float(os.environ.get("TWK_CPU_ROUTE_WORK", CPU_ROUTE_WORK))
    return work < limit


def compute_ld(settings: CalcSettings, device="cuda",
               mesh=None) -> CalcResult:
    """`calc` on `device` (`cuda`, or `cpu` for the plain versions), or
    on the mesh `settings.mesh` names (`parallel.resolve_mesh`), or on
    `mesh`, a parallel.Mesh (over an explicit device list: a device may
    repeat), which takes the place of settings.mesh in a single-process
    run. Small workloads may run on the CPU (`_route_backend`). With
    `settings.distributed` this process is one rank of the run: `cuda`
    is then the rank's share of the visible cards
    (`parallel.process_devices`). The job is the span `calc.job`
    (`spans`); `settings.performance` records its spans and logs their
    table after the run's report."""
    dropped = spans.dropped()
    with (spans.recording() if settings.performance
          else contextlib.nullcontext()):
        with spans.span("calc.job", job=True) as job:
            result = _compute_ld(settings, device, mesh)
    if settings.performance:
        spans.log_table(spans.collect(job=job.job),
                        dropped=spans.dropped() - dropped)
    return result


def _compute_ld(settings, device, mesh) -> CalcResult:
    """`compute_ld` inside its span."""
    _check_settings(settings)
    if settings.window and settings.n_chunks != 1:
        raise ValueError("cannot use chunking in window mode")
    if mesh is not None and settings.distributed:
        raise ValueError("an explicit mesh is a single-process run's; "
                         "under --distributed give settings.mesh")
    timer = Timer()
    proc_id, n_procs = 0, 1
    if settings.backend == "cpu":
        device = "cpu"        # needs no card
    if settings.distributed:
        # the rank's own card: the first of its share under the mesh spec;
        # under dcn:P its share is its card of each of the P rows
        cards = [resolve_device(d) for d in dist.process_devices(
            device, settings.process_id, settings.mesh)]
        device = cards[0]
        proc_id, n_procs = dist.init_distributed(
            settings.coordinator, settings.num_processes,
            settings.process_id, device,
            rows=cards if _is_dcn(settings) else None)
    else:
        device = resolve_device(device)
    try:
        log("LOG", f"Opening {settings.input}...", sub="READER")
        with spans.span("calc.open"):
            reader = TwkReader(settings.input)
        try:
            with contextlib.ExitStack() as on_card:
                return _compute(settings, device, reader, timer, proc_id,
                                n_procs, mesh, on_card)
        finally:
            reader.close()
    finally:
        if settings.distributed:
            dist.shutdown()


def _plane_budget(settings, n_samples, B, n_samp_shards):
    """(super-blocks a load may hold, bytes of one super-block's planes
    on a rank): the JAX engine's budget. The device holds the resident
    bands plus the per-load concatenation, so a load may take half of
    `memory_gb`; a samples-sharded rank holds 1/S of every word plane."""
    Wh = (2 * n_samples + 127) // 128 * 4
    Ws = (n_samples + 127) // 128 * 4
    per_super = -(-B * (2 * Wh + 3 * Ws) * 4 // n_samp_shards)
    return (max(2, int(settings.memory_gb * (1 << 30) / 2 / per_super)),
            per_super)


def _compute(settings, device, reader, timer, proc_id, n_procs, mesh,
             on_card) -> CalcResult:
    """The run of `compute_ld`; `on_card` (an ExitStack) takes the card
    as the current device once the route is decided, so a run routed to
    the CPU never starts CUDA. Its set-up, from the archive's header to
    the writer's open, is the span `calc.plan`."""
    plan = spans.span("calc.plan").start()
    n_samples = reader.header.n_samples
    log("LOG", f"Samples: {pretty_int(n_samples)}...")
    block_ids = list(range(reader.index.n))
    if settings.intervals:
        from ..post.intervals import blocks_for_intervals
        block_ids = list(blocks_for_intervals(reader, settings.intervals))
    tile_rows = settings.tile_rows or TILE_ROWS
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
    dcn = _is_dcn(settings)
    if dcn and n_procs < 2:
        raise ValueError("mesh 'dcn' needs a multi-process run "
                         "(--num-processes >= 2)")
    if settings.checkpoint and settings.output == "-":
        raise ValueError("checkpointing needs a file output")
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
    # upper bound of the pairs the (windowed) tile list holds
    est = sum(B * (B - 1) // 2 if d else B * B for _, _, d in pairs)
    # the route is decided once, here, before any device work
    cpu_route = _route_backend(settings, est, n_samples, n_procs, dcn,
                               device, mesh)
    if cpu_route:
        log("LOG", f"Workload below the device crossover "
            f"(~{pretty_int(est)} pairs x {pretty_int(2 * n_samples)} "
            f"haplotypes): running on the CPU (--backend device overrides)",
            sub="ENGINE")
        device, mesh = torch.device("cpu"), None
    elif mesh is None:
        mesh = dist.resolve_mesh(settings.mesh, local_only=n_procs > 1,
                                 device=device, rank=proc_id)
    if mesh is not None:
        log("LOG", f"Device mesh: {mesh.shape}", sub="MESH")
    on_card.enter_context(on_device(device))
    # the native CPU tile engine takes the whole tile plan at once; a
    # checkpointed routed run keeps the segment engine (its resume unit),
    # on the CPU
    native = cpu_route and not settings.checkpoint and bool(pairs)

    # band the super-blocks when their planes exceed the budget
    # (low-memory streaming, the reference's calc -M); the staging worker
    # needs a third resident band, so bands shrink to a third of it
    budget, per_super = _plane_budget(
        settings, n_samples, B, mesh.shape["samples"] if mesh else 1)
    prefetch_on = settings.stage_prefetch and not dcn \
        and len(super_ids) > budget
    bands, loads = _plan_loads(super_ids, pairs, budget,
                               parts=3 if prefetch_on else 2)
    if len(loads) > 1:
        log("LOG", f"Streaming {len(super_ids)} super-blocks in "
            f"{len(loads)} band-pair loads over {len(bands)} bands "
            f"(~{per_super * budget / 2**30:.1f} GB plane budget)...",
            sub="MEMORY")
    mode = ("phased" if settings.force_phased else
            "unphased" if settings.forced_unphased else "mixed")

    def make_engine():
        return LdEngine(None, n_samples, settings, device, B=B, mesh=mesh)
    engine = make_engine() if pairs and not native else None
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
    ckpt = (Checkpoint(settings, proc_id, n_procs, dcn,
                       mesh.shape["pairs"] if mesh else 1)
            if settings.checkpoint else None)
    result = CalcResult()
    if ckpt is not None:
        ckpt.restore(result, engine)
    ticker = ProgressTicker(total_pairs=est, n_samples=n_samples).start()
    if engine is not None:
        engine.ticker = ticker
    # the reference's one -t count: the inflate pool's threads and the
    # writer's compressors
    n_threads = settings.threads if settings.threads > 0 \
        else (os.cpu_count() or 1)
    # dcn: every process derives identical records (the counts are the
    # same on every rank); only process 0 writes the single output.
    # The segment consumer is the writer's one caller while segments are
    # in flight.
    writer = None
    if not (dcn and proc_id != 0):
        if ckpt is not None and ckpt.state is not None:
            writer = PooledTwoWriter.resume(out, hdr, ckpt.state["writer"],
                                            n_threads,
                                            c_level=settings.c_level,
                                            block_limit=settings.b_size)
        else:
            writer = PooledTwoWriter(out, hdr, n_threads,
                                     c_level=settings.c_level,
                                     block_limit=settings.b_size)
    if ckpt is not None and writer is not None and engine is not None:
        # dcn ranks other than 0 own no writer and no sidecar: their
        # resume state came from rank 0's
        engine.on_segment = lambda: ckpt.write_due(engine, result, writer)
    plan.stop()

    def emit(recs, rev=None):
        if len(recs) == 0:
            return
        if writer is not None:
            with spans.span("write.add", records=len(recs)):
                writer.add(recs)
            with spans.span("write.add", records=len(recs)):
                writer.add(rev if rev is not None
                           else _reverse_records(recs))
        result.n_records += 2 * len(recs)

    pool = ThreadPoolExecutor(n_threads, thread_name_prefix="twk-inflate")

    def inflate(ids):
        """The stacked host planes of super-blocks `ids`, each decoded
        into its slot by one `block_to_planes` call on `pool`'s threads
        (the staging worker calls this for the next load's band). Spans:
        `calc.read` a super-block (its blocks' frames read),
        `calc.inflate_wait` (the caller on the pool), `calc.inflate` a
        super-block decompressed and decoded on the pool (attributes
        `records`, `runs` and `fallback`, the records the per-record
        path decoded)."""
        frames = []
        for s in ids:
            sup = supers[s]
            with spans.span("calc.read", blocks=len(sup["ids"])):
                frames.append(read_super(reader, sup["ids"]))
        out = new_planes(len(ids), B, n_samples)
        with spans.span("calc.inflate_wait", blocks=len(ids)) as wait:
            def planes(k):
                with spans.span("calc.inflate", parent=wait.ctx) as sp:
                    sp.set(**block_to_planes(frames[k], n_samples, out, k))
            list(pool.map(planes, range(len(ids))))
        return out

    native_stats = None
    try:
        if native:
            slot = {g: s for s, g in enumerate(super_ids)}
            stacked = inflate(super_ids)
            groups = group_tiles([(slot[i], slot[j], d) for i, j, d in pairs],
                                 mode, stacked["has_missing"].any(axis=1))
            native_stats = {}
            with spans.span("calc.native"):
                n = run_native_cpu(stacked, groups, filt, emit, ticker,
                                   n_samples, settings, native_stats)
            if n is not None:
                result.n_pairs += n
            else:
                log("LOG", "No native CPU tile engine: running the plain "
                    "engine on the CPU", sub="ENGINE")
                native_stats = None
                engine = make_engine()
                engine.ticker = ticker
        if engine is not None:
            result.n_pairs += run_loads(engine, bands, loads,
                                        lambda b: inflate(bands[b]), mode,
                                        filt, emit, prefetch_on, ckpt)
    finally:
        if engine is not None:
            engine.stage_close()
        pool.shutdown()
        if writer is not None:
            with spans.span("write.close"):
                writer.close()
        ticker.finalize()
    if engine is not None:
        result.stage_stats = dict(engine.stage_stats, n_bands=len(bands),
                                  n_loads=len(loads),
                                  n_uploads=engine.n_band_uploads)
        if len(loads) > 1:
            ss = engine.stage_stats
            log("LOG", f"Band uploads: {engine.n_band_uploads} device plane "
                f"transfers over {len(loads)} loads "
                f"({ss['bytes'] / 2**20:.0f} MB; "
                f"{ss['hidden_s']:.1f}s overlapped with compute, "
                f"{ss['exposed_s'] + ss['wait_s']:.1f}s exposed)",
                sub="MEMORY")
    if ckpt is not None:
        # removed before the in-place sort: a crash in the sort must
        # start over, not resume a writer offset into the rewritten file
        ckpt.remove()
    if writer is not None and settings.sort_shards and out != "-":
        from ..post.sort import sort_two
        tmp_sorted = out[:-4] + ".sorting.two"
        sort_two(out, tmp_sorted, threads=settings.threads)
        os.replace(tmp_sorted, out)
        log("LOG", f"Shard {out} sorted in place (presorted merge ready)",
            sub="SORT")
    if dcn and engine is not None:
        log("LOG", f"Process {proc_id}: host math of "
            f"{pretty_int(engine.math_rows)} of "
            f"{pretty_int(engine.survivor_rows)} survivor rows (gathers "
            f"{engine.gather_s:.3f}s)", sub="DIST")
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
        report_performance(engine if engine is not None
                           else native_stats or {})
    return result
