#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (tomahawk_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. report the card (torch's name and nvidia-smi's name and power limit);
2. build the hand kernels from tomahawk_tpu_torch/csrc with nvcc (one
   process per source) and print ptxas's registers and spills for each
   kernel instance (a spill fails the run); check with `cuobjdump -sass`
   that every instance of phased_tile, parts_tile and local_parts
   issues the 1-bit MMA (BMMA.168256.AND.POPC); build the port's native
   host library with g++; time the MMA probe (csrc/mma_probe.cu): the
   rates at which the card runs the 1-bit AND+POPC MMA and the int8
   MMAs (mma.sync, wgmma);
3. compare each kernel with its plain PyTorch version at the main
   paths' shapes (B = 4096 variants per tile, 2,504 samples):
   phased_tile (P = 1, W = 160 words) with its counts buffer (against
   tile_counts_plain of the mask) and compact, with the counts given;
   every fused group (phased_tile, parts_tile), its counts,
   local_parts and compact at odd shapes (63 words a row, so rows are
   not 16-byte aligned; 100, 192 and 320 rows, so the tile's edge cuts a
   thread block and, at scalc's 100 rows, MMA fragments; window 0 and
   250,000 bp, a diagonal and an off-diagonal tile); every parts_tile
   instance and phased_tile's clean class on planes with ~2% missing genotypes, packed as bitpack.block_to_planes
   packs them, on a diagonal and an off-diagonal tile, with their counts
   and compact on their masks with the counts; the unphased parts_tile
   instances on a tile near the r2 floor by construction, where the
   prefilter's division-free screen leaves some pairs to the exact
   statement, with the screen's counter against its plain twin; the
   unphased parts_tile's wide instance (clusters sharing TMA stages) and
   today's (on planes 4 bytes off alignment) against the plain version
   bit for bit at 15,264 / 2,032 / 2,031 / kWideWords words, 4,096 and
   4,000 rows, with its launch counter and through the C tile loop;
   compact with 4- and
   9-part payloads, pair-packed (2,504 samples) and one part per column
   (70,000 unphased samples), the counts given; a
   compaction on a stale scan ticket (it must raise at sweeps.host_counts
   and leave the ticket 0, and the next compaction must be right); the
   time per call of each, and of the unphased P = 4 instance at
   tools/probe_pallas.py's shape (random het/hom words, W = 80). Beside
   each contraction, torch._int_mm once a part on the operands unpacked
   to int8 beforehand (`library_ms`: cuBLAS's int8 GEMM, the library's
   yardstick of the contraction alone, each product equal to the
   kernel's part; the port never calls it). Outputs must be
   bit-identical. Then the window instances: all six sweep groups at
   windows of 250,000 and 1,000,000 bp over positions ~275 bp apart, on
   a diagonal and the neighbouring off-diagonal tile, and two groups on a
   super-block with two contigs and invalid rows: the mask and the counts
   equal on every lane, the parts equal wherever the mask is not 0, the
   set of thread blocks the kernel skipped equal to
   ld_kernels.block_live's; the share of live thread blocks and of
   candidates, the time per call, the card's bound of the live blocks
   and the CUDA-core ceiling. Then the two kernels of the samples-sharded
   sweep: local_parts in its four instances on word slices S = 2 and S =
   3 of the planes (every lane equal to its plain version; the slices'
   sum equal to the plain full-width parts on every lane and to the
   fused kernel's parts where its mask is not 0) and tile_epilogue on
   that sum with its counts buffer, for every pair class, windows 0,
   250,000 and 1,000,000 bp, a diagonal and the neighbouring tile (mask
   and counts equal to its plain version, tile_counts_plain, and the
   fused kernel's on every lane; also at 100 and 99 rows in the
   odd-shape check and with D' bounds in the D' check); the time per
   call of each instance beside its bound: tile_epilogue's the larger of
   its bytes and the f32 SASS instructions of the prefilter path each
   candidate takes (`prefilter_ops`) over the CUDA cores' 33.5e12/s.
   Then the segment's tile loop below Python: sweeps.fused_sweep and
   extract_sweep through the C entry (csrc/sweep.cu, one call a sweep)
   against the same sweeps made of
   per-tile launches, bit for bit in n_pass, n_cand and the survivor
   buffer, for every fused group at windows 0 and 250,000 bp, with room
   for every survivor and with the per-tile cap overflowing and the
   buffer spilling. Then the in-sweep D' filter (-d 0.9 -D 0.95, a term of
   csrc/prefilter.cuh) in phased_tile, every parts_tile instance and
   tile_epilogue, bit for bit in the mask, the parts, the counts and the
   compacted survivors, and the time per call of phased_tile and
   parts_tile with the bounds and without, in turns. Then the in-sweep
   Fisher bracket (csrc/fisher_bracket.cu, a search of the log-factorial
   table) on the survivor rows of a fused sweep of 10 LD-grouped tiles,
   in the bf16-packed layout and the f32 column, and on 16,988 synthetic
   tables at 2N = 32,768: against the plain walk (fisher_dev's
   fisher_bracket) the kernel flags no lane the walk does not, the other
   brackets agree within 1e-6 relative, a packed payload's low 16 bits
   are unchanged, every unflagged P is within 1e-5 of the native
   fisher_exact, two launches are equal; against its plain version (the
   search, fisher_bracket_search) the flags and packed bits are equal
   and the f32 brackets within 1e-12 relative; the walk's step count the
   kernel reports equals the walk's own. Its time per call, and its
   bound, the larger of 12 bytes a row over the HBM rate and the
   search's probes and tail steps x 4 f64 operations over the
   card's FP64 rate (34e12/s, NVIDIA's data sheet); then relationship's
   kinship GEMM (X4, ops/kinship.py: torch._int_mm, a library call) on
   a 512 x 2,504 block in {-1, 0, +1} against its plain version on the
   card, exact, its ms per block beside torch._int_mm alone and its
   bound, the larger of its bytes (the block read once, the int32
   accumulator read and written once) over the HBM rate and 2 x 512 x
   2,504^2 operations over the int8 tensor-core peak;
   Bounds: each contraction's is the card's, the larger of 64
   operations a pair-word over the rate the card runs the 1-bit AND+POPC
   MMA at (10.2e15/s, the MMA probe's lowest reading) and its bytes over
   the HBM rate; beside it `int8_ms`, the same operations over the
   published int8 tensor-core peak (1.979e15/s), which a bit contraction
   need not pay, and `cuda_core_ms`, over the POPC rate of the CUDA cores
   (4.2e12/s), the ceiling of the AND + __popc route the tile kernels
   took before the tensor cores. compact's times are the device's, the
   calls queued ahead of it; its time at the host's pace is printed
   beside them, and its library yardstick: torch.nonzero of the
   survivors, then index_select of the parts;
4. run `calc` through the user's entry points (`python -m
   tomahawk_tpu_torch import`, then `python -m tomahawk_tpu_torch calc`
   in this process, so its kernel launch counts are visible; every path
   but q with `--backend device`, so none depends on the CPU route's
   limit), each path with the counts set to 0 just before it and read
   just after, and
   hold its .two record multiset against the port's native C++ CPU tile
   engine's on the same archive, field by field, P within the
   reference's 1e-5 guard (a phased path's P comes from the in-sweep
   Fisher bracket where a segment holds 16,384 survivors):
   a. `calc -p -r 0.1` on a 2,504-sample x 16,384-site phased VCF with
      LD groups and no missing genotypes;
   b. `calc -r 0.1` (the default mixed dispatch) on a 2,504 x 16,384
      phased VCF with ~1% of genotypes missing: half the sites of the
      first three super-blocks miss 2.5% of their genotypes, the last
      super-block none, so the clean and missing halves of the mixed
      dispatch and its no-missing phased group all run;
   c. `calc -u -r 0.1` on a 2,504 x 8,192 unphased VCF, ~1% missing
      (first super-block 2% per site, the second none): 9- and 4-part
      tables;
   d. `calc -p -r 0.1` on the archive of b: 4-part phased tables;
   e. `calc -p -w 500000 -r 0.1` on the archive of a, and
   f. `calc -w 500000 -r 0.1` (mixed) on the archive of b: the four
      super-blocks span ~1.1 Mb each, so the window drops the tiles of
      super-blocks that are not neighbours and thread blocks die inside
      the tiles it keeps; every record must lie on one contig within
      the window;
   then `calc --distributed` in two processes that share the card
   (spawned as `python3 chip_smoke.py rank <job>`, each with a wall
   limit; collectives over gloo; each rank reports its launch and plain
   counts on its last line):
   g. `calc -p --distributed --mesh dcn` on the archive of a and
   h. `calc --distributed --mesh dcn` (mixed) on the archive of b: each
      rank holds half of every word plane, sweeps every tile through
      local_parts, the all-reduce, tile_epilogue and compact; only
      rank 0's file exists and equals the native engine's records;
   i. `calc --distributed` (tile partition) on the archive of b: each
      rank sweeps every second tile into its own shard through the fused
      kernels; `merge_shards` of both equals the native engine's;
   and, banded (in this process, between f and g):
   j. `calc -p -r 0.1 -M 0.03` on the archive of a: a plane budget of 2
      of its 4 super-blocks, so 4 bands and 10 band-pair loads with the
      staging worker; its records also equal a's;
   k. `calc -r 0.1 -M 0.03 --no-stage-prefetch` (mixed) on the archive of
      b: the same plan with every band uploaded on demand;
   l. `calc -p -d 0.9 -D 0.95 -r 0.1` on the archive of a and
   m. `calc -d 0.3 -r 0.1` (mixed) on the archive of b: the in-sweep D'
      filter in phased_tile and parts_tile, against the native engine with
      the same D' bounds;
   n. `scalc -I <300 sites>` on the archive of b: targets and their
      neighbours within 500 kb in blocks of 100 rows, the mixed dispatch
      over target x target and target x neighbour tiles; its reference is
         the native engine over the same tiles, kept by the same rule (the A
      side a target);
   o. `calc -p -r 0.1 -M 0.03 --checkpoint <work>/o.two.ckpt
      --checkpoint-interval 0` on the archive of a (path j's plan, one
      tile a load), crashed on entering its fifth segment by a stand-in
      for LdEngine._run_segment set up here (the phase fails if the run
      ends first), then started again, which resumes: 4 loads skipped
      whole; the resumed run's launch counts set to 0 just before it and
      read just after; its records equal path j's record for record and
      in order (P within the guard), the sidecar gone, j's tiles swept
      but the skipped ones, with at least as many fewer phased_tile
      launches; the crashed and resumed walls against j's, and a
      segment's end (the writer's flush and fsync and the sidecar) at
      interval 0;
   p. compute_ld on meshes built from an explicit device list, 2x1, 1x2
      and 2x2 over the one card repeated, on the archives of a (`-p`) and
      b (mixed): S = 1 through the fused kernels, S = 2 through
      local_parts, the sum on the card, tile_epilogue and compact; then
      `calc -p --mesh 1x1` and `--mesh auto` through the CLI (one card);
   q. the CPU route: `calc -p --backend cpu` on a's archive (records
      equal a's), `calc -p --backend auto` on a 2,504 x 1,024 archive
      below the route's limit, both launching nothing, and the same with
      TWK_CPU_ROUTE_WORK=0, which launches the fused kernels;
   then the post-processing subcommands through the CLI entry point:
   `relationship` on the archive of a on the card (its launch counts
   set to 0 just before it and read just after: one torch._int_mm a
   512-row block, no plain version), again, and with `--device cpu`, the
   kinship text of both routes equal; `view`, `sort`, `concat`,
   `aggregate`, `stats`, `decay` and `haplotype` on the .two of a and b
   (and a's archive) through the zstd binding the host has, each
   exiting 0, sorted records the input's multiset, concat's of a and a
   twice a's;
   each calc path prints its bands, loads, stage_stats and band uploads;
5. time `LdEngine.run_phased_pairs` on the sparse and records-dense
   workloads (64 x 4096 random variants; 16 x 4096 LD-grouped
   variants), the sparse planes again over `Balancer.window_pairs` at
   windows of 250,000 and 1,000,000 bp, `LdEngine.run_unphased_pairs`
   on 16 x 4096 random genotype variants without missing data (P = 4)
   and with 2% (P = 9), and `LdEngine.run_mixed_pairs` on 16 x 4096
   LD-grouped genotype variants, half of them missing 2%; after the
   timed reps of each, one more rep under
   torch.profiler (wall, device busy, idle share, ms by kernel), with
   the pipeline depth each row took and its segments a rep; beside the
   dense and mixed rows one timed and one traced rep with the segment
   pipeline off (one segment at a time), beside the 250 kb window two
   such reps, then two pipelined reps without the Fisher launch, two
   with it again and two with the interpreter's GIL switch interval at
   0.1 ms; beside the sparse and 250 kb rows two reps with the tile
   loop in Python (the per-tile launches); the sparse planes banded by `-M
   1.0` (58 of 64 super-blocks: 4 bands, 10 loads) through the engine's
   load loop (`run_loads`) with the staging worker, timed and traced,
   with its stage_stats; the dense and mixed rows again on fresh engines
   with the in-sweep Fisher bracket on and off (TWK_DEVICE_FISHER=0), in
   turns: wall, the host's math_s a rep and the traced idle share; and
   `LdEngine.run_phased_pairs` over the first 16 blocks of the sparse
   planes (136 tiles) as two samples-sharded ranks on the one card,
   with the time per tile of local_parts, the all-reduce, tile_epilogue
   and compact (handed the epilogue's counts) from CUDA events and each
   rank's host math_s on its half of the survivor rows; then, in the same
   two ranks, the first 8 blocks of the records-dense planes (36 tiles)
   with the host math split over the ranks and whole on each (a
   stand-in for what the split replaced), in turns: each run's wall,
   math_s and its gathers' share; beside them the sparse tiles on a 1 x
   2 mesh over the one card in this process (the parts summed on the
   card), its walls and its time per tile of each step;
6. check that each calc path launched each of its kernels, and never a
   plain version, that the native host library is loaded, and that
   neither jax nor the JAX package was imported.

Before them, JSON lines of X4 (`library_calls`, in the kernels line's
keys), path o and the post phase. The last two lines are a JSON summary
of the kernels and the device line. Everything here comes from
tomahawk_tpu_torch, torch and numpy.

`python3 chip_smoke.py crossover [phased|mixed]` is a measurement of its
own (~10 minutes for phased, ~8 for mixed, both when neither is named;
the default run would not fit its limit with it): the card, the builds,
then the CPU route's crossover: phased archives of 2,504 samples x 1,024
to 32,768 sites, each a fresh `python -m tomahawk_tpu_torch calc -p`
process with `--backend cpu` and with `--backend device`, three times in
turns, the build cache warm; `mixed`, archives of 1,024 to 16,384 sites
with path b's missing data through `calc` (the mixed dispatch); the
process walls, each process's compute_ld wall, the work (candidate pairs
x haplotypes) and where the medians of the compute_ld walls cross
(compute/engine.py CPU_ROUTE_WORK holds the phased one); its last line
is the device line.

`python3 chip_smoke.py multi`, with exactly four cards visible (a
4-card host; fewer or more exits 1 with a message), runs `calc` on
several distinct cards: the cards' UUIDs and
which pairs reach each other (`can_device_access_peer`), the builds;
on each card in turn, every wrapper the paths below launch (phased_tile,
parts_tile, local_parts at S = 2 and 4, tile_epilogue, compact,
fisher_bracket) torch.equal to its plain version at 1,024 and 4,096
rows a tile, each card launching them all and no other card any; then,
each with the counts set to 0 just before it and read just after,
the records held against the native CPU engine's and the launches
checked card by card (`_build.LAUNCHES_BY_CARD`; a rank's cards by UUID):
r. `calc --mesh auto` (a 4 x 1 mesh), `--mesh 2x2` and `--mesh 1x4` in
   this process on a's archive (`-p`) and b's (mixed), at 1,024 rows a
   tile, so every pairs shard of a segment has live tiles: with S = 1
   every card its fused kernels and compact, with S > 1 every card
   local_parts and each row's first card the epilogue and compact;
s. `calc --distributed` as four ranks, one card each, device
   collectives over NCCL: the tile partition (b's archive, then
   `merge_shards`), `--mesh dcn` with `-p` (a's) and mixed (b's), and
   `--mesh dcn -p` once more with each rank started under
   `CUDA_VISIBLE_DEVICES=k` (all four call their card cuda:0); every
   rank's `[DIST]` line must say nccl;
t. `--mesh dcn:2` as two ranks on four cards of their own (rank 0 on
   cards 0-1, rank 1 on 2-3), one NCCL group a row, `-p` and mixed at
   1,024 rows a tile;
then `multi_idle`, a JSON line: `--mesh auto -p` and `--mesh 2x2 -p -M
0.03` at the default 4,096 rows (10 tiles), records checked, with the
tile launches of each pairs shard and the cards of shards that ran no
tile, measured and not required (a segment is padded to 16 tiles a shard and
cut in contiguous slices, so small loads leave later shards idle);
then the timed rows, each a JSON line: `multi_sparse` (the sparse
planes through `LdEngine.run_phased_pairs` on one card and on the 4 x 1
mesh, in turns), `multi_dcn` (the engine dcn row, 136 tiles, on four
NCCL ranks and on two ranks x `dcn:2`: walls, and ms a tile of
local_parts, the all-reduce, tile_epilogue and compact from CUDA
events) and `multi_mesh` (the same tiles on a 1 x 4 mesh in this
process: walls, the copies into card 0 and the sum there as the engine
ran them, and the other cuts a tile: local_parts on each card,
tile_epilogue, compact); then `multi_launches_by_card`; its last
line is the device line, count 4.

`python3 chip_smoke.py dcn2`, with exactly two cards visible
(`CUDA_VISIBLE_DEVICES=0,1` on a larger host), runs paths g and h with
`--mesh dcn:2`: two ranks that share both cards, each rank's pairs
shard p on card p, collectives over gloo; records and launches checked
as in the default run; its last line is the device line.
"""

import json
import math
import os
import runpy
import shutil
import socket
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_SAMPLES = 2504
B = 4096
MIN_R2 = 0.1
#: windows of the kernel checks and the engine rate, bp
WINDOWS = (250_000, 1_000_000)
#: window of the two windowed calc paths, bp: shorter than a
#: super-block's span (~1.1 Mb) and than the gap between the first and
#: the third
CALC_WINDOW = 500_000
#: rate of the 1-bit tensor-core MMA (mma.sync.m16n8k256.b1.and.popc, SASS
#: BMMA.168256.AND.POPC) on one NVIDIA H100 80GB HBM3 at 700 W, operations
#: per second: the lowest of this script's MMA-probe readings there
#: (10.2-10.5e15; no data sheet lists it). The rate the contractions'
#: bound is stated against. An operation is one AND or one add, so a
#: pair-word is 64.
B1_OPS_PER_S = 10.2e15
#: dense int8 tensor-core peak of one H100 SXM, operations per second
#: (NVIDIA's H100 data sheet: 1,979 TOP/s without sparsity): what the
#: contractions would cost unpacked to int8 (`int8_ms`), not their bound
INT8_OPS_PER_S = 1.979e15
#: POPC rate of the CUDA cores of one H100 SXM, per second: 132 SMs x 16
#: a clock x ~1.98 GHz. Not the card's bound: the ceiling of the AND +
#: __popc route the tile kernels took before the tensor cores
#: (`cuda_core_ms`), kept to read their earlier times against
POPC_PER_S = 4.2e12
#: HBM3 rate of the H100 SXM, bytes per second (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
#: the planes of each part of a tile, (side i, side j), in the column
#: order of pallas_tiles._chunk_parts (csrc/mma_tile.cuh's Products)
PRODUCTS = ((0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 0), (1, 2), (2, 1),
            (2, 2))
#: SASS of the 1-bit MMA (mma.sync.m16n8k256.b1.and.popc)
BMMA = "BMMA.168256.AND.POPC"
#: the kernels that contract on the tensor cores, and their instances
MMA_KERNELS = {"phased_tile_kernel": 1, "parts_tile_kernel": 4,
               "local_parts_kernel": 4}
#: seconds a spawned rank may take before it is killed
RANK_LIMIT = 300
#: `calc -M` of the banded paths j and k, GB: a plane budget of 2 of the
#: archives' 4 super-blocks (9.17 MB of planes each at 2,504 samples), so
#: 4 bands and 10 band-pair loads
BANDED_GB = 0.03
#: `-M` of the banded sparse engine row: 58 of its 64 super-blocks, so
#: with the staging worker 4 bands of 19 / 19 / 19 / 7 and 10 loads, the
#: plan shape the default 12 GB gives above 2.87M variants
BANDED_ROW_GB = 1.0
#: super-blocks of the sparse planes the two-rank engine timing sweeps
DCN_BLOCKS = 16
#: super-blocks of the records-dense planes the two ranks sweep with the
#: host math split and whole (36 tiles, ~0.5M records)
DCN_DENSE_BLOCKS = 8
#: D' bounds (-d, -D) of the D' kernel checks and of calc path l: the
#: LD groups' 2% noise puts most of their pairs' D' between 0.5 and 0.9,
#: so these bounds cut most survivors of a phased tile
DPRIME = (0.9, 0.95)
#: f64 operations the Fisher kernel's bound counts for each of its probes
#: and tail steps (its work counter), a floor: a probe's d(k) is seven
#: additions and a comparison, a tail step the ratio's division, the sum,
#: the product and the comparison
F64_OPS_PER_STEP = 4
#: FP64 rate of one H100 SXM outside the tensor cores, operations per
#: second (NVIDIA's H100 data sheet: 34 TFLOP/s)
F64_OPS_PER_S = 34e12
#: P agrees with the native kernel's within the reference's rounding
#: guard (TWK_ALLOWED_ROUNDING_ERROR) where it comes from the in-sweep
#: Fisher bracket
P_GUARD = 1e-5
#: scalc's target interval (path n), as positions of the archive of b: 300
#: sites in the middle of its second super-block
SCALC_TARGETS = (6000, 6300)
#: path o (checkpointed j) is crashed on entering its segment after this
#: many: j's plan sweeps one tile a load, so 4 of its 10 loads are done
CKPT_CRASH_AFTER = 4
#: tiles of paths j and o: 4 super-blocks of 4,096 variants, all pairs
PATH_J_TILES = 10
#: rows of a block of relationship's kinship GEMM (X4): its default
KIN_BLOCK_ROWS = 512
#: wall of each calc path in this process, s (run_calc)
CALC_WALLS = {}
#: the launch count of relationship's kinship GEMM (ops/_build.KINSHIP)
KINSHIP_COUNT = "kinship_int_mm"
#: every calc path but q's pins the card: `--backend auto` would send a
#: workload below the CPU route's limit to the CPU
ON_CARD = ["--backend", "device"]
#: path p's meshes over the one card repeated: (pairs, samples)
MESH_SHAPES = ((2, 1), (1, 2), (2, 2))
#: the crossover timing's archives (2,504 samples x sites) of each
#: dispatch, the fresh `calc` processes a backend and size, and path q's
#: archive
CROSS_SITES = {"phased": (1024, 2048, 4096, 8192, 16384, 32768),
               "mixed": (1024, 2048, 4096, 8192, 16384)}
CROSS_REPS = 3
ROUTE_SITES = 1024
#: timed runs of the 1 x 2 mesh row
MESH_REPS = 3
#: `multi`: the visible cards it needs; path r's meshes over them (spec,
#: P, S); the rows a tile of paths r and t, so that every pairs shard of
#: a segment holds live tiles (136 tiles of a 16,384-site archive; at
#: 4096 rows, 10 tiles would all fall to the first shard); reps of its
#: timed rows
MULTI_CARDS = 4
MULTI_MESHES = (("auto", 4, 1), ("2x2", 2, 2), ("1x4", 1, 4))
MULTI_TILE_ROWS = 1024
MULTI_REPS = 3
#: path r's banded run on 2x2: a plane budget of 15 of the 16 super-blocks
#: at 1,024 rows and half the words a card, so bands of 5, 5, 5, 1 and 10
#: loads, staged; its off-diagonal loads of 25 tiles put live tiles on
#: the second pairs shard (path j's `-M 0.03` gives loads of at most 16)
MULTI_BANDED_GB = 0.0325
#: `multi`'s idle row: meshes at the default tile rows (spec, P, S, flags),
#: where a's archive has 10 tiles; 2x2 banded by path j's plane budget
MULTI_IDLE = (("auto", 4, 1, ["-p"]), ("2x2", 2, 2, ["-p", "-M", "0.03"]))


def _say(msg):
    print(msg, flush=True)


def _cuda_ms(fn, reps=10, queued=True, rounds=3):
    """Device milliseconds per call of fn, after one warm-up: the mean
    over `reps` calls, the least of `rounds` such means (the machine's
    cores are shared, and a host that stalls for a few ms inside a round
    of short calls would otherwise show as device time). With `queued`
    the calls of a round are enqueued behind ~4 ms of other device work
    (the MMA probe), so the host is ahead of the device throughout and
    the time is the device's, launch gaps included: neither the host's
    pace of enqueueing a call that is shorter than its own enqueue, nor the
    first launch's latency spread over a few short calls."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(rounds):
        if queued:
            _launch_probe(0, 20000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def report_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _say(f"device: {torch.cuda.get_device_name(0)} "
         f"(count {torch.cuda.device_count()}, torch {torch.__version__}, "
         f"CUDA {torch.version.cuda})")
    _say(f"nvidia-smi: {smi}")


#: operations of one MMA of each probe kind, and MMAs a block runs per
#: round (csrc/mma_probe.cu)
PROBE_KINDS = (
    (0, "mma.sync.m16n8k256.b1.and.popc", 2 * 16 * 8 * 256, 8 * 8),
    (1, "mma.sync.m16n8k32.s8", 2 * 16 * 8 * 32, 8 * 8),
    (2, "wgmma.m64n128k32.s8", 2 * 64 * 128 * 32, 2 * 4))
_probe_out = []


def _launch_probe(kind, iters, blocks=528):
    import torch
    from tomahawk_tpu_torch.ops import _build
    if not _probe_out:
        _probe_out.append(torch.zeros(528 * 256, dtype=torch.int32,
                                      device="cuda"))
    rc = _build.library().twk_mma_probe(
        kind, blocks, iters, _probe_out[0].data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mma_probe launch")


def mma_probe():
    """The rate of the tensor-core instructions a bit contraction
    could use (csrc/mma_probe.cu): back-to-back MMAs from every SM, in
    operations per second, where an operation is one AND/multiply or one
    add. Returns {instruction: operations per second}."""
    import torch
    rates = {}
    for kind, name, ops, per_round in PROBE_KINDS:
        blocks = 528 if kind < 2 else 264
        iters = 20000
        ms = _cuda_ms(lambda: _launch_probe(kind, iters, blocks), reps=3,
                      rounds=1)
        rates[name] = blocks * per_round * iters * ops / (ms * 1e-3)
    torch.cuda.synchronize()
    _say("mma probe, operations per second: "
         + ", ".join(f"{k} {v:.4g}" for k, v in rates.items())
         + f" (data sheet, int8 dense: {INT8_OPS_PER_S:.4g})")
    _say(json.dumps({"mma_probe_ops_per_s": rates}))
    return rates


def build_kernels():
    """Build the kernel library and the native host library; print
    ptxas's registers and spills of every kernel instance (none may
    spill) and check in the library's SASS that every tensor-core
    instance issues the 1-bit MMA."""
    import re
    from tomahawk_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    _say(f"kernels built in {time.perf_counter() - t0:.1f}s "
         f"({_build._lib_path()})")
    for line in _build.build_log.splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            _say(f"  ptxas: {line.strip()}")
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        _build.build_log)
    if not spills or any(int(a) or int(b) for a, b in spills):
        raise SystemExit("a kernel instance spills (or ptxas printed no "
                         "report)")
    check_sass(_build)
    from tomahawk_tpu_torch import native
    t0 = time.perf_counter()
    if not native.available():
        raise SystemExit("the port's native host library did not build "
                         "(g++ missing?)")
    _say(f"native host library built in {time.perf_counter() - t0:.1f}s "
         f"({native._SO})")


def check_sass(_build):
    """cuobjdump -sass of the built library: each instance of each kernel
    in MMA_KERNELS issues BMMA (the 1-bit MMA), counted by function."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", _build._lib_path()],
                          capture_output=True, text=True, check=True).stdout
    found = {}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split()[0]
        for kernel in MMA_KERNELS:
            if kernel in name:
                found.setdefault(kernel, []).append(chunk.count(BMMA))
    for kernel, n in MMA_KERNELS.items():
        got = found.get(kernel, [])
        if len(got) != n or 0 in got:
            raise SystemExit(f"SASS: {kernel} has {len(got)} instances "
                             f"(expected {n}) with {got} {BMMA} each")
    _say("SASS: " + ", ".join(f"{k} {len(v)} instances, {v} {BMMA}"
                               for k, v in found.items()))


def _check_counts_buffer(label, counts, mask):
    """The counts a tile kernel wrote equal tile_counts_plain of its
    mask."""
    import torch
    from tomahawk_tpu_torch.ops import tiles
    if not torch.equal(counts, tiles.tile_counts_plain(mask)):
        raise SystemExit(f"{label}: the counts buffer differs from "
                         f"tile_counts_plain of the mask")


def _compact_all_ways(tiles_out, ncol, cap, n_tiles, device="cuda"):
    """compact over `n_tiles` (mask, parts, counts) triples at a running
    offset on `device`, two ways: the kernel with the counts given, the
    plain version. Returns the two [buf, n_pass, n_cand, off] lists."""
    import torch
    from tomahawk_tpu_torch.compute import sweeps
    outs = []
    for way in ("counts", "plain"):
        buf = torch.zeros((1 << 18, ncol), dtype=torch.int32, device=device)
        n_pass = torch.zeros(n_tiles, dtype=torch.int32, device=device)
        n_cand = torch.zeros(n_tiles, dtype=torch.int32, device=device)
        off = torch.zeros(1, dtype=torch.int32, device=device)
        for t in range(n_tiles):
            mask, parts, counts = tiles_out[t % len(tiles_out)]
            if way == "plain":
                sweeps.compact_survivors_plain(mask, parts, off, buf, n_pass,
                                               n_cand, t, cap)
            else:
                sweeps.compact_survivors(
                    mask, parts, off, buf, n_pass, n_cand, t, cap, counts)
        if buf.is_cuda:
            torch.cuda.synchronize(buf.device)
        outs.append([x.long() for x in (buf, n_pass, n_cand, off)])
    return outs


def _unpack_int8(words):
    """int32 packed words [B, W] -> int8 0/1 [B, 32 * W]."""
    import torch
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    return ((words.unsqueeze(-1) >> shifts) & 1).to(torch.int8) \
        .reshape(words.shape[0], -1)


def _int8_operands(dev, s, keys):
    """The planes `keys` of super-block s unpacked to int8 0/1 [B, 32 W],
    the miss plane as valid = ~miss: the operands of a tile's parts."""
    return [_unpack_int8(~dev[k][s] if k == "miss_bits" else dev[k][s])
            for k in keys]


def library_call(dev, i, j, keys, P):
    """A function computing the P parts of tile (i, j) with torch._int_mm
    (cuBLAS's int8 GEMM on the card) once a part, on the planes `keys`
    unpacked to int8 beforehand: the library's yardstick of the
    contraction alone (no mask, no prefilter), which the port never
    calls."""
    import torch
    a = _int8_operands(dev, i, keys)
    b = [x.t() for x in _int8_operands(dev, j, keys)]
    return lambda: [torch._int_mm(a[x], b[y]) for x, y in PRODUCTS[:P]]


def library_parts(dev, i, j, keys, parts):
    """The ms per call of `library_call` for tile (i, j), after checking
    each product against the kernel's parts (i32 [P, B, B])."""
    import torch
    run = library_call(dev, i, j, keys, parts.shape[0])
    for p, got in enumerate(run()):
        if not torch.equal(got, parts[p]):
            raise SystemExit(f"torch._int_mm of part {p} {PRODUCTS[p]} "
                             f"differs from the kernel's parts")
    return _cuda_ms(run)


def compare_kernels():
    """phased_tile (P = 1, cls "all") with its counts buffer, and compact
    (one payload part; with the counts given) against their
    plain versions at the -p main path's shape; the time per call of
    each, and of torch._int_mm on the pre-unpacked operands (cuBLAS's
    int8 GEMM: the contraction alone, the yardstick the port never
    calls). Returns {kernel: (max_abs_err, ms, plain_ms)} and a dict of
    the other times."""
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import tiles

    cfg = sweeps.make_cfg("phased", False, "all", B, N_SAMPLES, 0, MIN_R2,
                          100.0)
    planes = {"random": workloads.build_planes(2, B, N_SAMPLES, seed=0),
              "grouped": workloads.build_planes_grouped(1, B, N_SAMPLES)}
    keys = sweeps.dev_keys_for(cfg)
    devs = {k: sweeps.planes_to_device(v, "cuda", keys)
            for k, v in planes.items()}
    W = devs["random"]["alt_bits"].shape[-1]
    _say(f"kernel check: B={B}, {N_SAMPLES} samples, W={W} words")
    tile_err = 0
    masks = []
    for name, i, j, diag in (("random", 0, 0, True), ("random", 0, 1, False),
                             ("grouped", 0, 0, True)):
        dev = devs[name]
        counts = tiles.counts_buffer(cfg, "cuda").fill_(-1)
        mask, parts = tiles.tile_prefilter(dev, i, j, diag, cfg,
                                           counts=counts)
        want_m, want_p = tiles.tile_prefilter_plain(dev, i, j, diag, cfg)
        err = max(int((mask.int() - want_m.int()).abs().max()),
                  int((parts - want_p).abs().max()))
        _say(f"  phased_tile {name} ({i},{j}) diag={diag}: "
             f"{int((mask == 2).sum())} survivors, "
             f"{int((mask != 0).sum())} candidates, max |diff| {err}, "
             f"counts equal")
        if err:
            raise SystemExit("phased_tile disagrees with its plain version")
        _check_counts_buffer(f"phased_tile {name} ({i},{j})", counts, mask)
        tile_err = max(tile_err, err)
        masks.append((mask, parts, counts))

    comp_err = 0
    for cap in (32768, 256):
        outs = _compact_all_ways(masks, 2, cap, 3)
        err = max(int((a - b).abs().max()) for a, b in zip(*outs))
        _say(f"  compact cap={cap}, counts given: n_pass "
             f"{outs[0][1].tolist()}, n_cand {outs[0][2].tolist()}, max "
             f"|diff| {err}")
        if err:
            raise SystemExit("compact disagrees with its plain version")
        comp_err = max(comp_err, err)

    dev = devs["random"]
    out = tiles.tile_buffers(cfg, "cuda")
    counts = tiles.counts_buffer(cfg, "cuda")
    tile_ms = _cuda_ms(lambda: tiles.tile_prefilter(dev, 0, 1, False, cfg,
                                                    out, counts))
    tile_plain = _cuda_ms(
        lambda: tiles.tile_prefilter_plain(dev, 0, 1, False, cfg))
    library_ms = library_parts(dev, 0, 1, ("alt_bits",), masks[1][1])
    mask, parts, counts = masks[2]
    times = _time_compact(mask, parts, 2, counts)
    _say(f"  ms per call: phased_tile {tile_ms:.4f} (plain "
         f"{tile_plain:.4f}; torch._int_mm of the pre-unpacked int8 "
         f"operands, contraction only, {library_ms:.4f}); compact, 1 part, "
         f"{int((mask == 2).sum())} survivors: counts given "
         f"{times['ms']:.4f}, at the host's pace "
         f"{times['host_paced_ms']:.4f} (plain "
         f"{times['plain_ms']:.4f}; torch.nonzero of the survivors and "
         f"index_select of the parts {times['library_ms']:.4f})")
    return ({"phased_tile": (tile_err, tile_ms, tile_plain),
             "compact": (comp_err, times["ms"], times["plain_ms"])},
            dict(times, library_ms=library_ms,
                 compact_library_ms=times["library_ms"],
                 kept=min(int((mask == 2).sum()), 32768)))


def _time_compact(mask, parts, ncol, counts):
    """Times per call of one tile's compaction at cap 32768 into an
    [2**18, ncol] buffer, the scratch allocated once: `ms` on the
    device's clock with the calls queued ahead of it; `host_paced_ms`,
    the same call enqueued as fast as the host can, with the offset reset
    before each (how it was timed before the calls were queued); and
    `plain_ms`."""
    import torch
    from tomahawk_tpu_torch.compute import sweeps
    bufs = [torch.zeros((1 << 18, ncol), dtype=torch.int32, device="cuda"),
            torch.zeros(1, dtype=torch.int32, device="cuda"),
            torch.zeros(1, dtype=torch.int32, device="cuda"),
            torch.zeros(1, dtype=torch.int32, device="cuda")]
    scratch = sweeps.compact_scratch(mask.shape[0], "cuda")

    def kernel(cnt, reset=False):
        if reset:
            bufs[3].zero_()
        sweeps.compact_survivors(mask, parts, bufs[3], bufs[0], bufs[1],
                                 bufs[2], 0, 32768, cnt, scratch)

    def plain():
        bufs[3].zero_()
        sweeps.compact_survivors_plain(mask, parts, bufs[3], bufs[0],
                                       bufs[1], bufs[2], 0, 32768)

    flat = parts.view(parts.shape[0], -1)

    def library():
        # the same function in two PyTorch calls (nonzero waits for the
        # host to learn the count): the survivors' flat indices in
        # ascending order, and each one's parts
        idx = torch.nonzero(mask.flatten() == 2).flatten()
        return torch.index_select(flat, 1, idx)

    return dict(
        ms=_cuda_ms(lambda: kernel(counts), reps=50),
        host_paced_ms=_cuda_ms(lambda: kernel(counts, reset=True),
                               queued=False),
        plain_ms=_cuda_ms(plain), library_ms=_cuda_ms(library))


#: odd shapes of the tile kernel checks: (tile rows, words kept of the 64
#: a row has: 2,000 haplotypes of 1,000 samples phased, 2,000 samples
#: unphased). 63 words hold every bit and make rows that are not 16-byte
#: aligned; 27, 52 and 54 are the word slices of a three-rank
#: samples-sharded run; 192 and 320 rows are 1.5 and 2.5 thread blocks of
#: phased_tile, 3 and 5 of parts_tile
ODD_SHAPES = ((192, 63), (320, 63), (192, 64), (192, 27), (192, 52),
              (192, 54), (100, 63), (100, 32), (99, 63))
#: the odd-shape check's groups: every (table, has_missing, cls), with the
#: samples of its planes
ODD_GROUPS = {(table, miss, cls): 1000 if table == "phased" else 2000
              for table in ("phased", "unphased") for miss in (False, True)
              for cls in ("all", "clean", "missing")}


def compare_odd_shapes():
    """phased_tile and parts_tile with their counts, local_parts, and
    tile_epilogue with its counts on the plain parts, against the plain
    versions where the staging cannot use 16-byte copies (W % 4 != 0),
    where the last K step is partial (W % 8 != 0), where the tile's edge
    cuts a thread block and where rows are an odd number of bytes (99
    rows): every instance and pair class (ODD_GROUPS), window 0 and 250
    kb, a diagonal and an off-diagonal tile; then compact on those masks,
    with their counts. Equal on every lane (the parts where the
    mask is not 0 in window mode); the epilogue's mask and counts also
    equal the fused kernel's."""
    import torch
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import tiles
    for Bt, W in ODD_SHAPES:
        devs = {}
        for n_samples in (1000, 2000):
            st = workloads.genotype_planes(2, Bt, n_samples, 0.02,
                                           group=math.gcd(Bt, 16))
            st = {k: v[..., :W] if k.endswith("_bits") else v
                  for k, v in st.items()}
            devs[n_samples] = sweeps.planes_to_device(st, "cuda")
        n = 0
        for group, n_samples in ODD_GROUPS.items():
            dev = devs[n_samples]
            for window in (0, WINDOWS[0]):
                cfg = sweeps.make_cfg(*group, Bt, n_samples, window, MIN_R2,
                                      100.0)
                got = []
                for i, j, diag in ((1, 1, True), (0, 1, False)):
                    label = (f"{tiles.kernel_name(cfg)} "
                             f"{'/'.join(map(str, group))} B={Bt} W={W} "
                             f"w={window} ({i},{j})")
                    counts = tiles.counts_buffer(cfg, "cuda").fill_(-1)
                    mask, parts = tiles.tile_prefilter(dev, i, j, diag, cfg,
                                                       counts=counts)
                    want_m, want_p = tiles.tile_prefilter_plain(dev, i, j,
                                                                diag, cfg)
                    on = (want_m != 0).unsqueeze(0) if window else 1
                    if not torch.equal(mask, want_m) \
                            or not torch.equal(parts * on, want_p * on):
                        raise SystemExit(f"{label} differs from its plain "
                                         f"version")
                    _check_counts_buffer(label, counts, mask)
                    emask = torch.empty_like(mask)
                    ecounts = tiles.counts_buffer(cfg, "cuda").fill_(-1)
                    tiles.tile_epilogue(dev, i, j, diag, cfg,
                                        (emask, want_p), ecounts)
                    if not torch.equal(emask, mask) \
                            or not torch.equal(ecounts, counts):
                        raise SystemExit(f"tile_epilogue at {label} differs "
                                         f"from the fused kernel's mask or "
                                         f"counts")
                    if window == 0 and group[2] == "all":
                        out = tiles.tile_buffers(cfg, "cuda")
                        lp = tiles.tile_local_parts(dev, i, j, cfg, out)
                        if not torch.equal(lp, want_p):
                            raise SystemExit(f"local_parts at {label} "
                                             f"differs from its plain "
                                             f"version")
                    got.append((mask, parts, counts))
                    n += int((mask == 2).sum())
                outs = _compact_all_ways(got, sweeps.buf_cols(cfg), 256, 2)
                if any(not torch.equal(a, b) for a, b in zip(*outs)):
                    raise SystemExit(f"compact {group} B={Bt} w={window} "
                                     f"differs from its plain version")
        _say(f"  phased_tile, parts_tile, local_parts, tile_epilogue, "
             f"counts and compact at "
             f"B={Bt}, W={W}: {len(ODD_GROUPS)} groups x window 0 / "
             f"{WINDOWS[0]} x two tiles, {n} survivors, equal")


def genotype_planes(n_blocks, *args, **kw):
    """workloads.genotype_planes at this script's tile shape."""
    from tomahawk_tpu_torch import workloads
    return workloads.genotype_planes(n_blocks, B, N_SAMPLES, *args, **kw)


#: the sweep groups beyond phased / no missing / cls "all",
#: (table, has_missing, cls)
GROUPS = (("phased", False, "clean"), ("phased", True, "all"),
          ("unphased", False, "all"), ("unphased", True, "all"),
          ("unphased", True, "missing"))
#: the instance the kernels line reports for parts_tile: the default
#: (mixed) dispatch's sweep of tiles with missing data
MAIN_GROUP = ("unphased", True, "missing")


def compare_groups():
    """Every parts_tile instance and phased_tile's clean class against
    their plain versions on planes with ~2% missing genotypes, on an
    off-diagonal and a diagonal tile, with the counts buffer (against
    tile_counts_plain) and compact on their masks (with the counts,
    against the plain version); then the time per call of each,
    and of torch._int_mm once a part on the pre-unpacked operands.
    Returns {group: (max_abs_err, ms, plain_ms, library_ms)}."""
    import torch
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import tiles
    t0 = time.perf_counter()
    st = genotype_planes(2)
    dev = sweeps.planes_to_device(st, "cuda")
    _say(f"group check: B={B}, {N_SAMPLES} samples, "
         f"{float(st['an'].sum()) / st['an'].size / (2 * N_SAMPLES):.4f} "
         f"of genotypes missing, planes built in "
         f"{time.perf_counter() - t0:.1f}s")
    res = {}
    for group in GROUPS:
        cfg = sweeps.make_cfg(*group, B, N_SAMPLES, 0, MIN_R2, 100.0)
        name = tiles.kernel_name(cfg)
        label = f"{name} {'/'.join(map(str, group))}"
        got = []
        for i, j, diag in ((0, 1, False), (1, 1, True)):
            counts = tiles.counts_buffer(cfg, "cuda").fill_(-1)
            mask, parts = tiles.tile_prefilter(dev, i, j, diag, cfg,
                                               counts=counts)
            want_m, want_p = tiles.tile_prefilter_plain(dev, i, j, diag, cfg)
            err = max(int((mask.int() - want_m.int()).abs().max()),
                      int((parts - want_p).abs().max()))
            _say(f"  {label} ({i},{j}): P={parts.shape[0]}, "
                 f"{int((mask == 2).sum())} survivors, "
                 f"{int((mask != 0).sum())} candidates, max |diff| {err}, "
                 f"counts equal")
            if err:
                raise SystemExit(f"{label} disagrees with its plain version")
            _check_counts_buffer(f"{label} ({i},{j})", counts, mask)
            got.append((mask, parts, counts))
            del want_m, want_p
        ncol = sweeps.buf_cols(cfg)
        for cap in (32768, 256):
            outs = _compact_all_ways(got, ncol, cap, 2)
            if any(not torch.equal(a, b) for a, b in zip(*outs)):
                raise SystemExit(f"compact on the masks of {label} differs "
                                 f"from its plain version")
        out = tiles.tile_buffers(cfg, "cuda")
        counts = tiles.counts_buffer(cfg, "cuda")
        ms = _cuda_ms(lambda: tiles.tile_prefilter(dev, 0, 1, False, cfg,
                                                   out, counts))
        plain = _cuda_ms(
            lambda: tiles.tile_prefilter_plain(dev, 0, 1, False, cfg), reps=3)
        lib = library_parts(dev, 0, 1, tiles.plane_keys(*group[:2]),
                            got[0][1])
        _say(f"  ms per call: {label} {ms:.4f} (plain {plain:.4f}; "
             f"torch._int_mm x {got[0][1].shape[0]} on the pre-unpacked "
             f"operands, contraction only, {lib:.4f}); compact with the "
             f"counts equal to the plain version")
        res[group] = (0, ms, plain, lib)
        del got, out, outs
    return res


#: the screen check's groups: parts_tile's unphased instances (kinds 1 and
#: 2), the second also with D' bounds
SCREEN_GROUPS = ((("unphased", False, "all"), ()),
                 (("unphased", True, "all"), ()),
                 (("unphased", True, "all"), (0.5, 0.95)))


def compare_screen():
    """parts_tile's unphased instances on tiles near the r2 floor by
    construction (workloads.threshold_planes: a super-block with itself,
    off the diagonal and on it), where the division-free screen
    (csrc/prefilter.cuh unphased_screen) leaves some pairs to the exact
    statement: mask, parts and counts bit for bit their plain versions',
    and the kernel's screen counter (candidates screened, undecided)
    equal to the plain twin's (tiles.tile_screen_plain). Returns
    {group + (D' bounds,): (screened, undecided)}."""
    import torch
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import tiles
    dev = sweeps.planes_to_device(
        workloads.threshold_planes(1, B, N_SAMPLES), "cuda")
    res = {}
    for group, dp in SCREEN_GROUPS:
        cfg = sweeps.make_cfg(*group, B, N_SAMPLES, 0, MIN_R2, 100.0, *dp)
        label = f"parts_tile {'/'.join(map(str, group))} D' {dp or 'off'}"
        screen = torch.zeros(2, dtype=torch.int64, device="cuda")
        want_s = torch.zeros(2, dtype=torch.int64, device="cuda")
        n_pass = 0
        for diag in (False, True):
            counts = tiles.counts_buffer(cfg, "cuda").fill_(-1)
            mask, parts = tiles.tile_prefilter(dev, 0, 0, diag, cfg,
                                               counts=counts, screen=screen)
            want_m, want_p = tiles.tile_prefilter_plain(dev, 0, 0, diag, cfg)
            if not torch.equal(mask, want_m) or not torch.equal(parts,
                                                                want_p):
                raise SystemExit(f"{label} on the near-threshold tile "
                                 f"(diag {diag}) differs from its plain "
                                 f"version")
            _check_counts_buffer(f"{label} near-threshold", counts, mask)
            want_s += tiles.tile_screen_plain(dev, 0, 0, diag, cfg, want_p)
            n_pass += int((mask == 2).sum())
            del want_m, want_p
        if not torch.equal(screen, want_s):
            raise SystemExit(f"{label}: the screen counter "
                             f"{screen.tolist()} differs from the plain "
                             f"twin's {want_s.tolist()}")
        scr, und = screen.tolist()
        if not 0 < und < scr:
            raise SystemExit(f"{label}: the near-threshold tile left "
                             f"{und} of {scr} pairs undecided")
        _say(f"  {label}, near-threshold tile: {n_pass} survivors, "
             f"{scr} candidates screened, {und} undecided "
             f"({und / scr:.3e}); mask, parts, counts and counter equal")
        res[group + (dp,)] = (scr, und)
    return res


#: the wide instance's check: tile rows (whole clusters of 128 rows, and
#: ragged), and words a plane beside kWideWords (with 7 padding bits in
#: the last word): the ukb cell's, hrc's, and a W % 4 != 0 that must
#: take today's instance
WIDE_ROWS = (4096, 4000)
WIDE_WORDS = (15264, 2032, 2031)


def wide_words():
    """csrc/parts_tile.cu's kWideWords: the least W its wide instance
    serves."""
    import re
    with open(os.path.join(ROOT, "tomahawk_tpu_torch", "csrc",
                           "parts_tile.cu")) as fh:
        return int(re.search(r"constexpr int kWideWords = (\d+);",
                             fh.read()).group(1))


def _misaligned(t):
    """A copy of `t` whose data starts 4 bytes past a 16-byte boundary."""
    import torch
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def compare_wide():
    """parts_tile's wide instance (kind 2, clusters of 4 x 1 blocks that
    share their operand stages by TMA multicast, csrc/cluster_stage.cuh)
    against today's instance and the plain version, bit for bit: mask,
    parts, counts and both screen counters, on an off-diagonal tile (diag
    0) and a diagonal one (diag 1), cls all and missing, D' bounds off
    and on, at WIDE_ROWS rows and WIDE_WORDS + kWideWords words. Today's
    instance runs on a copy of the planes 4 bytes off 16-byte alignment,
    which the wide instance does not take; `_build.WIDE_LAUNCHES` must
    count the wide launches and no other. Returns {W: ms a call} of the
    aligned planes' off-diagonal tile, 4096 rows, cls all, D' off."""
    import torch
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import _build, tiles
    least = wide_words()
    res = {}
    for W in sorted(set(WIDE_WORDS + (least,)), reverse=True):
        n = 32 * W - 7
        t0 = time.perf_counter()
        full = workloads.genotype_planes_on("cuda", 2, max(WIDE_ROWS), n,
                                            seed=23 + W, W=W)
        wide = W % 4 == 0 and W >= least
        base = sweeps.make_cfg("unphased", True, "all", max(WIDE_ROWS), n, 0,
                               MIN_R2, 100.0)
        plain = {(i, j): torch.stack(tiles.tile_local_parts_plain(
            full, i, j, base)) for i, j in ((0, 1), (1, 1))}
        _say(f"wide check, W={W} ({n} samples): planes and plain parts in "
             f"{time.perf_counter() - t0:.1f}s")
        for rows in WIDE_ROWS:
            dev = {k: v[:, :rows].contiguous() for k, v in full.items()}
            off = {k: _misaligned(v) if k.endswith("_bits") else v
                   for k, v in dev.items()}
            for (i, j), diag in (((0, 1), False), ((1, 1), True)):
                parts = plain[i, j][:, :rows, :rows]
                for cls in ("all", "missing"):
                    for dp in ((), DPRIME):
                        cfg = sweeps.make_cfg("unphased", True, cls, rows, n,
                                              0, MIN_R2, 100.0, *dp)
                        label = (f"parts_tile W={W} B={rows} ({i},{j}) "
                                 f"{cls} D' {dp or 'off'}")
                        want = (tiles.tile_epilogue_plain(dev, i, j, diag,
                                                          cfg, parts),)
                        want += (parts, tiles.tile_counts_plain(want[0]),
                                 tiles.tile_screen_plain(dev, i, j, diag,
                                                         cfg, parts))
                        for planes, took in ((dev, wide), (off, False)):
                            counts = tiles.counts_buffer(cfg, "cuda")
                            screen = torch.zeros(2, dtype=torch.int64,
                                                 device="cuda")
                            w0 = _build.WIDE_LAUNCHES["parts_tile"]
                            mask, got_p = tiles.tile_prefilter(
                                planes, i, j, diag, cfg, counts=counts,
                                screen=screen)
                            n_wide = _build.WIDE_LAUNCHES["parts_tile"] - w0
                            inst = "wide" if took else "today's"
                            if n_wide != int(took):
                                raise SystemExit(f"{label}: {n_wide} wide "
                                                 f"launches, expected "
                                                 f"{int(took)}")
                            got = (mask, got_p, counts, screen)
                            for name, a, b in zip(
                                    ("mask", "parts", "counts", "screen"),
                                    got, want):
                                if not torch.equal(a, b):
                                    raise SystemExit(
                                        f"{label}, {inst} instance: {name} "
                                        f"differs from the plain version")
                        scr, und = want[3].tolist()
                        _say(f"  {label}: {int((want[0] == 2).sum())} "
                             f"survivors, {scr} screened, {und} undecided; "
                             f"{'wide and ' if wide else ''}today's "
                             f"instance equal the plain version")
            del dev, off
        # the C tile loop reports the wide launches it made
        pi, pj = np.array([0, 0, 1], np.int32), np.array([0, 1, 1], np.int32)
        dg, live = pi == pj, np.ones(3, bool)
        w0 = _build.WIDE_LAUNCHES["parts_tile"]
        got = sweeps.fused_sweep(full, pi, pj, dg, live, cfg=base,
                                 cap=32768, outcap=1 << 16)
        n_wide = _build.WIDE_LAUNCHES["parts_tile"] - w0
        want = _per_tile_sweep(full, pi, pj, dg, live, base, 32768, 1 << 16)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"the C sweep at W={W} differs from the "
                             f"per-tile launches")
        if n_wide != 3 * wide:
            raise SystemExit(f"the C sweep at W={W} reported {n_wide} wide "
                             f"launches of 3, expected {3 * wide}")
        _say(f"  C sweep at W={W}: equal the per-tile launches, {n_wide} "
             f"wide launches of 3")
        out = tiles.tile_buffers(base, "cuda")
        counts = tiles.counts_buffer(base, "cuda")
        screen = torch.zeros(2, dtype=torch.int64, device="cuda")
        res[W] = _cuda_ms(lambda: tiles.tile_prefilter(
            full, 0, 1, False, base, out, counts, screen), reps=5)
        inst = "the wide" if wide else "today's"
        _say(f"  parts_tile W={W}, {inst} instance: {res[W]:.4f} ms a call")
        del full, plain, out
        torch.cuda.empty_cache()
    _say(json.dumps({"wide_check": {"least_words": least, "ms": res}}))
    return res


def compare_payloads():
    """compact with 4- and 9-part payloads against its plain version, on
    random masks with the counts given (tile_counts_plain of the mask, as
    parts_tile writes them): pair-packed at 2,504 samples (B
    = 4096), one part per column at 70,000 unphased samples (a 512-row
    tile, where pack16_ok is false). Returns {P: (max_abs_err, ms with
    the counts, plain_ms, rows kept by the timed call, ms without the
    counts)} at 2,504 samples."""
    import torch
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import tiles
    gen = torch.Generator(device="cuda").manual_seed(5)
    res = {}
    for n_samples, Bt in ((N_SAMPLES, B), (70_000, 512)):
        for miss in (False, True):
            cfg = dict(table="unphased", has_missing=miss,
                       n_samples=n_samples)
            P = sweeps.payload_cols("unphased", miss)
            ncol = sweeps.buf_cols(cfg)
            r = torch.rand((Bt, Bt), device="cuda", generator=gen)
            mask = (r < 0.3).to(torch.uint8) + (r < 0.002).to(torch.uint8)
            parts = torch.randint(0, n_samples, (P, Bt, Bt),
                                  dtype=torch.int32, device="cuda",
                                  generator=gen)
            counts = tiles.tile_counts_plain(mask)
            err = 0
            for cap in (32768, 256):
                outs = _compact_all_ways([(mask, parts, counts)], ncol, cap,
                                         2)
                err = max([err] + [int((a - b).abs().max())
                                   for a, b in zip(*outs)])
            _say(f"  compact P={P}, {n_samples} samples, {ncol} columns, "
                 f"B={Bt}, counts given: {int(outs[0][1][0])} survivors, "
                 f"max |diff| {err}")
            if err:
                raise SystemExit("compact disagrees with its plain version")
            if n_samples == N_SAMPLES:
                tm = _time_compact(mask, parts, ncol, counts)
                kept = min(int(outs[0][1][0]), 32768)
                _say(f"  ms per call: compact, {P} parts, counts given "
                     f"{tm['ms']:.4f}, at the host's pace "
                     f"{tm['host_paced_ms']:.4f} (plain "
                     f"{tm['plain_ms']:.4f}; bound "
                     f"{compact_bound_ms(P, ncol, kept):.4f} by bytes, "
                     f"{kept} rows kept)")
                res[P] = (err, tm["ms"], tm["plain_ms"], kept)
    return res


def check_ticket_fault():
    """A compaction that finds its scan's ticket not 0 (as a scan that
    died midway leaves it) marks its tile, sweeps.host_counts raises for
    the mark, and the ticket is 0 again: the next compaction on the stream
    equals the plain version. Stale values under and over the scan's
    grid (32 blocks at B = 4096)."""
    import torch
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import tiles
    cfg = sweeps.make_cfg("phased", False, "all", B, N_SAMPLES, 0, MIN_R2,
                          100.0)
    dev = sweeps.planes_to_device(
        workloads.build_planes_grouped(1, B, N_SAMPLES), "cuda",
        sweeps.dev_keys_for(cfg))
    counts = tiles.counts_buffer(cfg, "cuda")
    mask, parts = tiles.tile_prefilter(dev, 0, 0, True, cfg, counts=counts)
    ticket = sweeps._ticket(mask.device,
                            torch.cuda.current_stream().cuda_stream)
    for stale in (5, 1 << 20):
        ticket.fill_(stale)
        n_pass = torch.zeros(1, dtype=torch.int32, device="cuda")
        n_cand = torch.zeros(1, dtype=torch.int32, device="cuda")
        off = torch.zeros(1, dtype=torch.int32, device="cuda")
        buf = torch.zeros((1 << 16, 2), dtype=torch.int32, device="cuda")
        sweeps.compact_survivors(mask, parts, off, buf, n_pass, n_cand, 0,
                                 32768, counts)
        try:
            sweeps.host_counts(n_pass, n_cand)
        except RuntimeError as e:
            msg = str(e)
        else:
            raise SystemExit(f"a compaction on a ticket left at {stale} "
                             f"raised nothing")
        if int(ticket.item()) != 0:
            raise SystemExit(f"the ticket is {int(ticket.item())} after the "
                             f"fault, not 0")
        outs = _compact_all_ways([(mask, parts, counts)], 2, 32768, 1)
        if any(not torch.equal(a, b) for a, b in zip(*outs)):
            raise SystemExit("the compaction after a ticket fault differs "
                             "from its plain version")
        _say(f"  ticket left at {stale}: host_counts raised ({msg[:60]}...);"
             f" the ticket is 0 again and the next compaction equals the "
             f"plain version ({int(outs[0][1][0])} survivors)")


#: the D' check's groups, with the planes each reads: the LD-grouped
#: phased planes, or the genotype planes with ~2% missing genotypes
DPRIME_GROUPS = ((("phased", False, "all"), "grouped"),
                 (("phased", False, "clean"), "genotypes"),
                 (("phased", True, "all"), "genotypes"),
                 (("unphased", False, "all"), "genotypes"),
                 (("unphased", True, "all"), "genotypes"),
                 (("unphased", True, "missing"), "genotypes"))


def compare_dprime():
    """The in-sweep D' filter (X6, a term of csrc/prefilter.cuh) in the
    three kernels that write masks, with D' bounds DPRIME, against their
    plain versions: phased_tile and every parts_tile instance with their
    counts, on a diagonal and an off-diagonal tile, bit for bit in the
    mask, the parts and the counts; compact on those masks with the
    counts, bit for bit in the survivor rows; tile_epilogue
    of every instance on the same parts, bit for bit in the mask and the
    counts. Then
    the time per call of phased_tile and of parts_tile's MAIN_GROUP
    instance with the D' bounds and without, in turns. Returns {kernel:
    (ms with the bounds, ms without, plain ms with the bounds)}."""
    import torch
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import tiles
    t0 = time.perf_counter()
    devs = {"grouped": sweeps.planes_to_device(
                workloads.build_planes_grouped(2, B, N_SAMPLES), "cuda"),
            "genotypes": sweeps.planes_to_device(genotype_planes(2),
                                                 "cuda")}
    _say(f"D' check: bounds {DPRIME}, B={B}, {N_SAMPLES} samples, planes "
         f"in {time.perf_counter() - t0:.1f}s")
    res = {}
    for group, planes in DPRIME_GROUPS:
        dev = devs[planes]
        cfg = sweeps.make_cfg(*group, B, N_SAMPLES, 0, MIN_R2, 100.0,
                              *DPRIME)
        base = sweeps.make_cfg(*group, B, N_SAMPLES, 0, MIN_R2, 100.0)
        name = tiles.kernel_name(cfg)
        label = f"{name} {'/'.join(map(str, group))} with D' {DPRIME}"
        got, cut = [], []
        for i, j, diag in ((0, 1, False), (1, 1, True)):
            counts = tiles.counts_buffer(cfg, "cuda").fill_(-1)
            mask, parts = tiles.tile_prefilter(dev, i, j, diag, cfg,
                                               counts=counts)
            want_m, want_p = tiles.tile_prefilter_plain(dev, i, j, diag, cfg)
            if not torch.equal(mask, want_m) or not torch.equal(parts,
                                                                want_p):
                raise SystemExit(f"{label} ({i},{j}) differs from its "
                                 f"plain version")
            _check_counts_buffer(f"{label} ({i},{j})", counts, mask)
            # the same parts through tile_epilogue (the dcn sweep's mask
            # and counts)
            out = (torch.empty_like(mask), parts)
            ecounts = tiles.counts_buffer(cfg, "cuda").fill_(-1)
            tiles.tile_epilogue(dev, i, j, diag, cfg, out, ecounts)
            if not torch.equal(out[0], want_m) \
                    or not torch.equal(ecounts, counts):
                raise SystemExit(f"tile_epilogue at {label} ({i},{j}) "
                                 f"differs from its plain version or from "
                                 f"the fused kernel's counts")
            m0 = tiles.tile_prefilter_plain(dev, i, j, diag, base)[0]
            cut.append((int((mask == 2).sum()), int((m0 == 2).sum())))
            got.append((mask, parts, counts))
            del want_m, want_p, m0
        for cap in (32768, 256):
            outs = _compact_all_ways(got, sweeps.buf_cols(cfg), cap, 2)
            if any(not torch.equal(a, b) for a, b in zip(*outs)):
                raise SystemExit(f"compact on the masks of {label} differs "
                                 f"from its plain version")
        _say(f"  {label}: survivors with / without the bounds "
             f"{cut}; mask, parts, counts, tile_epilogue and compact "
             f"equal")
        if group[0] == "phased" and sum(a for a, _ in cut) \
                >= sum(b for _, b in cut):
            raise SystemExit(f"{label}: the bounds cut no survivor")
        del got, outs
        if group in (("phased", False, "all"), MAIN_GROUP):
            out = tiles.tile_buffers(cfg, "cuda")
            counts = tiles.counts_buffer(cfg, "cuda")
            ms = {}
            for tag in ("off", "on", "on2", "off2"):
                c = cfg if tag.startswith("on") else base
                ms[tag] = _cuda_ms(lambda: tiles.tile_prefilter(
                    dev, 0, 1, False, c, out, counts))
            plain = _cuda_ms(lambda: tiles.tile_prefilter_plain(
                dev, 0, 1, False, cfg), reps=3)
            res[name] = (min(ms["on"], ms["on2"]), min(ms["off"], ms["off2"]),
                         plain)
            _say(f"  ms per call, {label}: {ms['on']:.4f} / {ms['on2']:.4f} "
                 f"(without the bounds, before and after: {ms['off']:.4f} / "
                 f"{ms['off2']:.4f}; plain {plain:.4f})")
            del out
    del devs
    return res


def _bracket_bits(buf, cfg):
    """(bracket f32, flagged) of every row of a fused buffer: the bf16 in
    the top 16 bits of payload column 1, flagged as bf16 NaN, or the f32
    column, flagged as -1."""
    import torch
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import fisher_dev as F
    if sweeps.fisher_packed(cfg):
        bits = (buf[:, 1] >> 16) & 0xFFFF
        return (bits << 16).view(torch.float32), bits == F.BF16_NAN
    br = buf[:, sweeps.buf_cols(cfg)].contiguous().view(torch.float32)
    return br, br < 0


def _walk_col(dev, n_pass, buf, pi, pj, cfg, cap):
    """The bracket of the plain walk (fisher_dev.fisher_bracket, the JAX
    package's algorithm in f64) written into `buf` as append_fisher_col
    writes the kernel's; returns the walk's steps over the rows."""
    import torch
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import fisher_dev as F
    rows, t = sweeps.fisher_rows(n_pass, cap, buf.shape[0])
    br, log2_pb, steps = F.fisher_bracket(
        *sweeps.fisher_cells(dev, buf, rows, t, pi, pj, cfg))
    if sweeps.fisher_packed(cfg):
        bits = F.packed_bits(br, log2_pb)
        buf[rows, 1] = (buf[rows, 1] & 0xFFFF) | (bits << 16)
    else:
        buf[rows, sweeps.buf_cols(cfg)] = br.view(torch.int32)
    return int(steps.sum())


def _hold_fisher(label, dev, n_pass, buf, pi, pj, cfg, cap, n_hap):
    """The Fisher kernel on the survivor rows of `buf` (a fused sweep's
    buffer, its bracket column cleared) against the plain walk and
    against its plain version, the search (fisher_dev.fisher_bracket_search).
    Against the walk, as since the kernel was ported: it flags no lane
    the walk does not, the brackets of the lanes neither flags agree
    within 1e-6 relative, a packed payload's low 16 bits are unchanged,
    every unflagged P is within P_GUARD of the native fisher_exact, two
    launches are equal. Against the search: the same flags, the same
    packed bits, f32 brackets within 1e-12 relative; and the walk's step
    count (the kernel's first counter) equal to the walk's own and the
    search's, its work (the second) equal to the search's. Returns a
    dict of the comparison's numbers."""
    import torch
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.native import fisher_exact
    from tomahawk_tpu_torch.ops import fisher_dev as F
    rows, t = sweeps.fisher_rows(n_pass, cap, buf.shape[0])
    walk = buf.clone()
    steps_walk = _walk_col(dev, n_pass, walk, pi, pj, cfg, cap)
    ref = buf.clone()
    steps_plain, work_plain = sweeps.append_fisher_col_plain(
        dev, n_pass, ref, pi, pj, cfg, cap)
    ker = buf.clone()
    counters = torch.zeros(2, dtype=torch.uint64, device=buf.device)
    sweeps.append_fisher_col(dev, n_pass, ker, pi, pj, cfg, cap, counters)
    again = buf.clone()
    sweeps.append_fisher_col(dev, n_pass, again, pi, pj, cfg, cap)
    torch.cuda.synchronize()
    if not torch.equal(ker, again):
        raise SystemExit(f"Fisher ({label}): two launches on the same rows "
                         f"differ")
    kb, kf = (x[rows] for x in _bracket_bits(ker, cfg))
    wb, wf = (x[rows] for x in _bracket_bits(walk, cfg))
    mb, mf = (x[rows] for x in _bracket_bits(ref, cfg))
    if bool((kf & ~wf).any()):
        raise SystemExit(f"Fisher ({label}): the kernel flags "
                         f"{int((kf & ~wf).sum())} lanes the walk does not")
    both = ~kf & ~wf

    def rel(x, y, sel):
        if not bool(sel.any()):
            return 0.0, 0.0
        diff = (x[sel] - y[sel]).abs()
        return (float(diff.max()),
                float((diff / y[sel].abs().clamp(min=1e-30)).max()))

    err_walk, rel_walk = rel(kb, wb, both)
    if rel_walk > 1e-6:
        raise SystemExit(f"Fisher ({label}): brackets differ from the "
                         f"walk's by {rel_walk} relative")
    # payload bits outside the bracket are the compaction's
    if sweeps.fisher_packed(cfg) and not torch.equal(ker[:, 1] & 0xFFFF,
                                                     buf[:, 1]):
        raise SystemExit(f"Fisher ({label}): the payload's low 16 bits "
                         f"changed")
    cells = torch.stack(sweeps.fisher_cells(dev, ker, rows, t, pi, pj, cfg),
                        1).cpu().numpy()
    br = torch.where(kf, float("nan"), kb).cpu().numpy()
    P = F.host_p_from_bracket(cells, br, F.log_factorial_table(n_hap + 1))
    Pn = fisher_exact(*(cells[:, q] for q in range(4)))
    sure = ~np.isnan(P)
    p_err = float(np.abs(P[sure] - Pn[sure]).max()) if sure.any() else 0.0
    if p_err > P_GUARD:
        raise SystemExit(f"Fisher ({label}): P differs from fisher_exact "
                         f"by {p_err}")
    # the kernel against its plain version
    if not torch.equal(kf, mf):
        raise SystemExit(f"Fisher ({label}): the kernel flags "
                         f"{int((kf != mf).sum())} lanes otherwise than the "
                         f"search's plain version")
    err, rel_plain = rel(kb, mb, ~kf)
    if sweeps.fisher_packed(cfg) and not torch.equal(ker, ref):
        raise SystemExit(f"Fisher ({label}): packed bits differ from the "
                         f"search's plain version in "
                         f"{int((ker != ref).any(1).sum())} rows")
    if rel_plain > 1e-12:
        raise SystemExit(f"Fisher ({label}): brackets differ from the "
                         f"search's plain version by {rel_plain} relative")
    steps, work = (int(x) for x in counters.cpu())
    if not steps == steps_walk == steps_plain or work != work_plain:
        raise SystemExit(f"Fisher ({label}): walk steps kernel {steps}, "
                         f"walk {steps_walk}, plain {steps_plain}; work "
                         f"kernel {work}, plain {work_plain}")
    _say(f"  fisher_bracket {label}: {len(rows)} rows of "
         f"{int(n_pass.sum())} survivors, flagged {int(kf.sum())} (walk "
         f"{int(wf.sum())}, plain search {int(mf.sum())}); against the "
         f"walk max |diff| {err_walk:.3g} ({rel_walk:.3g} relative), "
         f"against the search {err:.3g} ({rel_plain:.3g}); host-sure "
         f"{int(sure.sum())}, P max |diff| {p_err:.3g} from fisher_exact;"
         f" walk steps {steps} (walk's own {steps_walk}, "
         f"{steps_walk / max(len(rows), 1):.0f} a row), work {work} "
         f"({work / max(len(rows), 1):.1f} a row)")
    return dict(rows=len(rows), max_abs_err=err, err_walk=err_walk,
                flagged=int(kf.sum()), walk_flagged=int(wf.sum()),
                walk_steps=steps_walk, work=work, p_err=p_err, ker=ker,
                ref=ref)


def _fisher_bound(rows, work):
    """(bound_ms, bound_by, bytes_ms, operations_ms) of a Fisher call: 12
    bytes a row over the HBM rate, against the search's probes and tail
    steps (`work`) at F64_OPS_PER_STEP f64 operations each over the
    card's FP64 rate."""
    bound_b = 12 * rows / HBM_BYTES_PER_S * 1e3
    bound_o = work * F64_OPS_PER_STEP / F64_OPS_PER_S * 1e3
    by = "bytes" if bound_b >= bound_o else "operations"
    return max(bound_b, bound_o), by, bound_b, bound_o


def compare_fisher():
    """The in-sweep Fisher bracket (X2, csrc/fisher_bracket.cu) on the
    survivor rows of a fused sweep of the dense workload's tiles (10
    tiles of 4 LD-grouped super-blocks; ~120,000 survivors, so the volume
    gate opens as it does in the engine), in both layouts: bf16 packed
    (phased, no missing data) and the f32 column (phased with missing
    data, on the genotype planes), held against the walk and against its
    plain version (`_hold_fisher`); then a synthetic set of 2x2 tables at
    2N = 32,768, the widest cohort the engine sends to the card (16,384
    LD tables and edge cases in the 4-part layout), straight through the
    kernel. Then the time per call of each, the plain version's, and
    the bound. Returns {layout:
    (max_abs_err, ms, plain_ms, bound_ms, bound_by, walk_steps, rows,
    extra)}."""
    import torch
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute import sweeps
    res = {}
    nb = 4
    pairs = [(i, j, i == j) for i in range(nb) for j in range(i, nb)]
    pi = np.array([p[0] for p in pairs], np.int32)
    pj = np.array([p[1] for p in pairs], np.int32)
    dg = np.array([p[2] for p in pairs])
    n_hap = 2 * N_SAMPLES
    for layout, build, group in (
            ("packed", lambda: workloads.build_planes_grouped(
                nb, B, N_SAMPLES), ("phased", False, "all")),
            ("column", lambda: genotype_planes(nb, 0.02, seed=13),
             ("phased", True, "all"))):
        dev = sweeps.planes_to_device(build(), "cuda")
        cfg = sweeps.make_cfg(*group, B, N_SAMPLES, 0, MIN_R2, 100.0,
                              fisher=True)
        cap, outcap = 32768, 1 << 20
        n_pass, _, buf = sweeps.fused_sweep(dev, pi, pj, dg,
                                            np.ones(len(pairs), bool),
                                            cfg=cfg, cap=cap, outcap=outcap)
        if sweeps.fisher_rows(n_pass, cap, outcap) is None:
            raise SystemExit(f"Fisher check ({layout}): "
                             f"{int(n_pass.sum())} survivors do not open "
                             f"the gate at {sweeps.FISHER_MIN_ROWS}")
        cleared = buf.clone()
        if sweeps.fisher_packed(cfg):
            cleared[:, 1] &= 0xFFFF
        else:
            cleared[:, sweeps.buf_cols(cfg)] = 0
        got = _hold_fisher(layout, dev, n_pass, cleared, pi, pj, cfg, cap,
                           n_hap)
        # the fused sweep's own launch wrote the same column
        if not torch.equal(got.pop("ker"), buf):
            raise SystemExit(f"Fisher ({layout}): the fused sweep's launch "
                             f"and a launch on the cleared rows differ")
        ref = got.pop("ref")
        ker = cleared.clone()
        call = lambda: sweeps.append_fisher_col(dev, n_pass, ker, pi, pj,
                                                cfg, cap)
        ms = _cuda_ms(call)
        plain = _cuda_ms(lambda: sweeps.append_fisher_col_plain(
            dev, n_pass, ref, pi, pj, cfg, cap), reps=1, rounds=1)
        bound = _fisher_bound(got["rows"], got["work"])
        _say(f"  fisher_bracket {layout}: {ms:.4f} ms a call (plain "
             f"{plain:.1f}), bound {bound[0]:.4f} ms ({bound[1]}: "
             f"{bound[2]:.4f} bytes, {bound[3]:.4f} operations)")
        res[layout] = (got["max_abs_err"], ms, plain, *bound[:2],
                       got["walk_steps"], got["rows"],
                       dict(got, bytes_ms=bound[2], operations_ms=bound[3]))
        del dev, buf, ker, ref, cleared
    res["wide"] = compare_fisher_wide()
    return res


def compare_fisher_wide():
    """The kernel at 2N = 32,768 haplotypes: workloads.fisher_tables in
    the 4-part layout of a phased sweep with missing data (pair-packed
    parts and the f32 column) as one tile's survivor rows
    (workloads.fisher_buffer), held as `_hold_fisher` holds the dense
    tiles' (the walk's step count too). Returns the `fisher` entry of
    this instance."""
    import torch
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute import sweeps
    n_samples = 16384
    n_hap = 2 * n_samples
    C = workloads.fisher_tables(n_hap, sweeps.FISHER_MIN_ROWS, seed=17)
    K = len(C)
    cfg = sweeps.make_cfg("phased", True, "all", B, n_samples, 0, MIN_R2,
                          100.0, fisher=True)
    buf = torch.from_numpy(workloads.fisher_buffer(
        C, sweeps.out_cols(cfg))).cuda()
    n_pass = torch.tensor([K], dtype=torch.int32, device="cuda")
    dev = {"ac": torch.zeros((1, B), dtype=torch.int32, device="cuda")}
    pi = pj = np.zeros(1, np.int32)
    got = _hold_fisher("2N = 32,768", dev, n_pass, buf, pi, pj, cfg, K,
                       n_hap)
    got.pop("ker")
    ref = got.pop("ref")
    ker = buf.clone()
    ms = _cuda_ms(lambda: sweeps.append_fisher_col(dev, n_pass, ker, pi, pj,
                                                   cfg, K))
    plain = _cuda_ms(lambda: sweeps.append_fisher_col_plain(
        dev, n_pass, ref, pi, pj, cfg, K), reps=1, rounds=1)
    bound = _fisher_bound(got["rows"], got["work"])
    _say(f"  fisher_bracket 2N = 32,768: {ms:.4f} ms a call (plain "
         f"{plain:.1f}), bound {bound[0]:.4f} ms ({bound[1]})")
    return (got["max_abs_err"], ms, plain, *bound[:2], got["walk_steps"],
            got["rows"], dict(got, bytes_ms=bound[2],
                              operations_ms=bound[3]))



def _per_tile_sweep(dev, pi, pj, dg, live, cfg, cap, outcap, offs=None):
    """A sweep as the per-tile launches make it (`sweeps._tile_loop`, the
    tile loop in Python: tiles.tile_prefilter and sweeps.compact_survivors,
    one call each a tile): the fused sweep with one running offset, or
    with `offs` the repair sweep at those offsets. Returns (n_pass,
    n_cand, buf)."""
    import torch
    from tomahawk_tpu_torch.compute import sweeps
    T = len(pi)
    n_pass = torch.zeros(T, dtype=torch.int32, device="cuda")
    n_cand = torch.zeros(T, dtype=torch.int32, device="cuda")
    buf = torch.zeros((outcap, sweeps.buf_cols(cfg)), dtype=torch.int32,
                      device="cuda")
    out, cnt, scratch = sweeps._sweep_buffers(cfg, "cuda")
    off = (torch.zeros(1, dtype=torch.int32, device="cuda") if offs is None
           else torch.tensor(offs, dtype=torch.int32, device="cuda"))
    sweeps._tile_loop(dev, pi, pj, dg, live if offs is None else None, cfg,
                      cap, out, cnt, scratch, off, buf, n_pass, n_cand)
    return n_pass, n_cand, buf


#: (cap, outcap) of the C-sweep check: room for every survivor, and a cap
#: and buffer small enough that tiles overflow the cap and the buffer
#: spills (rows written at the clamp boundary over one another)
SWEEP_CAPS = ((32768, 1 << 20), (256, 4096))


def compare_c_sweep():
    """sweeps.fused_sweep and extract_sweep through the C tile loop
    (csrc/sweep.cu, one call a sweep) against the same sweeps made of
    per-tile launches, bit for bit in n_pass, n_cand and the whole
    survivor buffer: every fused group, windows 0 and 250 kb, a tile list
    with diagonal, off-diagonal and dead tiles, with room for every
    survivor and with the cap overflowing and the buffer spilling; the
    repair sweep at the exact offsets of the fused counts. Returns the
    number of sweeps compared."""
    import torch
    from tomahawk_tpu_torch.compute import sweeps
    st = genotype_planes(3)
    dev = sweeps.planes_to_device(st, "cuda")
    pi = np.array([0, 0, 1, 1, 2, 0], np.int32)
    pj = np.array([0, 1, 1, 2, 2, 2], np.int32)
    dg = pi == pj
    live = np.array([1, 1, 1, 1, 1, 0], bool)
    n = 0
    for group in ALL_GROUPS:
        for window in (0, WINDOWS[0]):
            cfg = sweeps.make_cfg(*group, B, N_SAMPLES, window, MIN_R2,
                                  100.0)
            label = f"{'/'.join(map(str, group))} w={window}"
            for cap, outcap in SWEEP_CAPS:
                got = sweeps.fused_sweep(dev, pi, pj, dg, live, cfg=cfg,
                                         cap=cap, outcap=outcap)
                want = _per_tile_sweep(dev, pi, pj, dg, live, cfg, cap,
                                       outcap)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise SystemExit(f"C sweep {label} cap={cap} "
                                     f"outcap={outcap} differs from the "
                                     f"per-tile launches")
                n_pass = got[0].cpu().numpy()
                total = int(n_pass.sum())
                n += 1
            # the repair sweep of every live tile at exact offsets
            offs = (np.cumsum(n_pass) - n_pass).astype(np.int32)
            rcap = max(int(n_pass.max()), 1)
            routcap = total + rcap
            got = sweeps.extract_sweep(dev, pi[:5], pj[:5], dg[:5], offs[:5],
                                       cfg=cfg, cap=rcap, outcap=routcap)
            want = _per_tile_sweep(dev, pi[:5], pj[:5], dg[:5], None, cfg,
                                   rcap, routcap, offs[:5])[2]
            if not torch.equal(got, want):
                raise SystemExit(f"C extract sweep {label} differs from the "
                                 f"per-tile launches")
            n += 1
            _say(f"  C sweep {label}: fused (caps {SWEEP_CAPS}) and repair "
                 f"sweeps equal the per-tile launches; n_pass "
                 f"{n_pass.tolist()}")
            del got, want
    torch.cuda.empty_cache()
    return n


#: pairs per thread block edge of each tile kernel, (rows, cols) by P
BLOCK_SHAPE = {1: (128, 128), 4: (64, 64), 9: (32, 64)}
#: all six sweep groups, (table, has_missing, cls)
ALL_GROUPS = (("phased", False, "all"),) + GROUPS


def _check_window_tile(dev, host, i, j, diag, cfg, label):
    """One window instance on one tile against its plain version: mask
    on every lane, parts where mask >= 1, and the kernel's skipped
    thread blocks (parts left at the -1 they were filled with) against
    ld_kernels.block_live; the counts buffer, dead blocks' cells
    included, against tile_counts_plain. Returns (live blocks, all
    blocks, candidates)."""
    import torch
    from tomahawk_tpu_torch.ops import ld_kernels as K
    from tomahawk_tpu_torch.ops import tiles
    out = tiles.tile_buffers(cfg, "cuda")
    out[1].fill_(-1)
    counts = tiles.counts_buffer(cfg, "cuda").fill_(-1)
    mask, parts = tiles.tile_prefilter(dev, i, j, diag, cfg, out, counts)
    want_m, want_p = tiles.tile_prefilter_plain(dev, i, j, diag, cfg)
    torch.cuda.synchronize()
    if not torch.equal(mask, want_m):
        raise SystemExit(f"{label}: mask differs from the plain version")
    _check_counts_buffer(label, counts, mask)
    on = (want_m != 0).unsqueeze(0)
    if not torch.equal(parts * on, want_p * on):
        raise SystemExit(f"{label}: parts differ from the plain version "
                         f"where mask >= 1")
    P = parts.shape[0]
    rows, cols = BLOCK_SHAPE[P]
    live = K.block_live(host["valid"][i], host["valid"][j], host["pos"][i],
                        host["pos"][j], host["rid"][i], host["rid"][j],
                        cfg["window"], rows, cols, diag)
    skipped = (parts[0].view(B // rows, rows, B // cols, cols) == -1) \
        .all(dim=3).all(dim=1).cpu().numpy()
    if not np.array_equal(~skipped, live):
        raise SystemExit(f"{label}: the kernel skipped "
                         f"{int(skipped.sum())} thread blocks, "
                         f"block_live marks {int((~live).sum())} dead")
    dead_cand = int((want_m.view(B // rows, rows, B // cols, cols) != 0)
                    .any(dim=3).any(dim=1).cpu().numpy()[~live].sum())
    if dead_cand:
        raise SystemExit(f"{label}: a dead block holds a candidate")
    return int(live.sum()), live.size, int((mask != 0).sum())


def compare_window():
    """Every window instance against its plain version (see the module
    docstring, phase 3). Returns {(group, window, diag): dict(ms,
    plain_ms, bound_ms, live, blocks, cand)}."""
    import torch
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import tiles
    st = genotype_planes(2)
    dev = sweeps.planes_to_device(st, "cuda")
    span = [int(st["pos"][b][-1] - st["pos"][b][0]) for b in range(2)]
    _say(f"window check: B={B}, {N_SAMPLES} samples, super-blocks span "
         f"{span} bp on one contig")
    res = {}
    for group in ALL_GROUPS:
        for window in WINDOWS:
            cfg = sweeps.make_cfg(*group, B, N_SAMPLES, window, MIN_R2,
                                  100.0)
            name = tiles.kernel_name(cfg)
            P = tiles.payload_cols(group[0], group[1])
            rows, cols = BLOCK_SHAPE[P]
            W = dev[tiles.plane_keys(group[0], group[1])[0]].shape[-1]
            for i, j, diag in ((1, 1, True), (0, 1, False)):
                label = (f"{name} {'/'.join(map(str, group))} w={window} "
                         f"({i},{j})")
                live, blocks, cand = _check_window_tile(dev, st, i, j, diag,
                                                        cfg, label)
                out = tiles.tile_buffers(cfg, "cuda")
                ms = _cuda_ms(lambda: tiles.tile_prefilter(dev, i, j, diag,
                                                           cfg, out))
                plain = _cuda_ms(lambda: tiles.tile_prefilter_plain(
                    dev, i, j, diag, cfg), reps=3)
                # the live blocks' contraction; the mask is written for
                # every pair, parts for the live blocks' pairs
                words = live * P * rows * cols * W
                bound, by = _bound(words, B * B + live * rows * cols * 4 * P)
                core = _cuda_core_ms(words)
                _say(f"  {label}: live blocks {live}/{blocks} "
                     f"({live / blocks:.4f}), candidates {cand} "
                     f"({cand / (B * B):.4f} of B^2), {ms:.4f} ms (plain "
                     f"{plain:.4f}; of the live blocks: bound {bound:.4f} "
                     f"by {by}, as int8 {_int8_ms(words):.4f}, CUDA-core "
                     f"ceiling {core:.4f}), equal")
                res[group, window, diag] = dict(
                    ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                    int8_ms=_int8_ms(words), cuda_core_ms=core, live=live,
                    blocks=blocks, cand=cand)
                del out
    # two contigs inside one super-block, invalid rows: whole row groups
    # (a side of a block with no valid row) and scattered ones, whose
    # positions must not reach the extrema
    rng = np.random.default_rng(17)
    st2 = {k: v.copy() for k, v in st.items()}
    half = B // 2
    st2["rid"][:, half:] = 1
    st2["pos"][:, half:] -= st2["pos"][:, half:half + 1] - 1000
    bad = rng.random((2, B)) < 0.05
    bad[:, 256:512] = True
    bad[1, B - 384:] = True
    st2["valid"] = st2["valid"] & ~bad
    st2["pos"][bad] = rng.integers(0, 2**31 - 1, int(bad.sum()))
    st2["rid"][bad] = rng.integers(0, 3, int(bad.sum()))
    dev2 = sweeps.planes_to_device(st2, "cuda")
    for group in (("phased", False, "all"), ("unphased", True, "missing")):
        cfg = sweeps.make_cfg(*group, B, N_SAMPLES, WINDOWS[0], MIN_R2,
                              100.0)
        for i, j, diag in ((0, 0, True), (0, 1, False)):
            label = (f"{tiles.kernel_name(cfg)} {'/'.join(map(str, group))}"
                     f" w={WINDOWS[0]} two contigs ({i},{j})")
            live, blocks, cand = _check_window_tile(dev2, st2, i, j, diag,
                                                    cfg, label)
            _say(f"  {label}: live blocks {live}/{blocks}, candidates "
                 f"{cand}, equal")
    torch.cuda.empty_cache()
    return res


#: the (table, has_missing) instances of local_parts and tile_epilogue
INSTANCES = (("phased", False), ("phased", True), ("unphased", False),
             ("unphased", True))
#: the instance the kernels line reports for both: the -p dcn path's
MAIN_INSTANCE = ("phased", False)
#: pair classes of the mixed dispatch
CLASSES = ("all", "clean", "missing")
#: f32 operations a second of the CUDA cores of one H100 SXM without FMA
#: (the kernels build with -fmad=false): 132 SMs x 128 FP32 lanes x ~1.98
#: GHz, one instruction a lane a clock. MUFU and conversions issue slower,
#: so counting each as one operation at this rate keeps a bound a floor
F32_OPS_PER_S = 33.5e12
#: kernels that run one pair's f32 prefilter a thread, each path of it
#: alone, from csrc/prefilter.cuh: their SASS gives the f32 instructions
#: of a pair on that path (`prefilter_ops`)
OPS_PROBE = r"""
#include "prefilter.cuh"
#define PROBE(name, expr) \
  extern "C" __global__ void name(const int* in, twk::Bounds b, int* out) { \
    const int* T = in + 9 * threadIdx.x; \
    out[threadIdx.x] = (expr); \
  }
PROBE(op_phased, twk::phased_prefilter<false>(T[0], T[1], T[2], T[3], b))
PROBE(op_phased_dp, twk::phased_prefilter<true>(T[0], T[1], T[2], T[3], b))
PROBE(op_head, twk::table9(T).n >= 5.0f)
PROBE(op_fold, twk::table9(T).n >= 5.0f &&
               twk::unphased_fold_ok<false>(twk::table9(T), b))
PROBE(op_fold_dp, twk::table9(T).n >= 5.0f &&
                  twk::unphased_fold_ok<true>(twk::table9(T), b))
PROBE(op_em, twk::table9(T).n >= 5.0f &&
             twk::unphased_em_ok(twk::table9(T), b))
"""
#: SASS opcodes of f32 work: arithmetic, comparisons, selections, the
#: division's check and reciprocal, int -> f32 conversions
F32_OPCODES = ("FADD", "FMUL", "FFMA", "FSETP", "FSET", "FMNMX", "FSEL",
               "FCHK", "MUFU", "I2F", "I2FP", "F2I", "FRND")


def prefilter_ops():
    """{path: f32 SASS instructions of one pair} for each kernel of
    OPS_PROBE, built with the library's flags: the instructions of the
    function before the first subroutine it calls (the IEEE division's
    slow path, laid out after the function's EXIT, which a quotient of
    normal range does not take)."""
    import re
    from tomahawk_tpu_torch.ops import _build
    work = os.path.join(ROOT, "build", "chip_smoke_ops")
    os.makedirs(work, exist_ok=True)
    src, cubin = os.path.join(work, "ops.cu"), os.path.join(work, "ops.cubin")
    with open(src, "w") as fh:
        fh.write(OPS_PROBE)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC",
                                                        "-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-I", _build.CSRC, "-cubin",
                    "-o", cubin, src], check=True, capture_output=True)
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    ops = {}
    for chunk in sass.split("Function : ")[1:]:
        calls = [int(t, 16) for t in
                 re.findall(r"CALL\.REL\S*\s+0x([0-9a-f]+)", chunk)]
        end = min(calls, default=1 << 62)
        ops[chunk.split()[0]] = sum(
            int(addr, 16) < end and op.split(".")[0] in F32_OPCODES
            for addr, op in re.findall(
                r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                chunk))
    shutil.rmtree(work, ignore_errors=True)
    want = {"op_phased", "op_phased_dp", "op_head", "op_fold", "op_fold_dp",
            "op_em"}
    if set(ops) != want or not all(ops.values()):
        raise SystemExit(f"prefilter SASS probe: {ops}")
    return ops


def epilogue_work(cfg, mask, parts, ops):
    """(bytes, f32 operations) the epilogue of a tile needs at least:
    each candidate's P parts read once, the mask and the counts written
    once, ~13 bytes of metadata a variant a side; the f32 instructions of
    the prefilter path each candidate takes (`prefilter_ops`): the phased
    prefilter; the unphased table's head alone where it holds fewer than 5
    samples, else its fold (no double heterozygote) or its EM half."""
    B, P = cfg["B"], parts.shape[0]
    cand = mask != 0
    n_cand = int(cand.sum())
    nbytes = 4 * P * n_cand + B * B + 4 * B * -(-B // 128) + 2 * B * 13
    dp = "_dp" if (cfg["min_dprime"], cfg["max_dprime"]) != (0.0, 100.0) \
        else ""
    if cfg["table"] == "phased":
        return nbytes, n_cand * ops["op_phased" + dp]
    low = cand & ((parts[8] if cfg["has_missing"] else cfg["n_samples"])
                  < 5)
    fold = cand & ~low & (parts[0] == 0)
    n_low, n_fold = int(low.sum()), int(fold.sum())
    return nbytes, (n_low * ops["op_head"] + n_fold * ops["op_fold" + dp]
                    + (n_cand - n_low - n_fold) * ops["op_em"])


def compare_dcn_kernels():
    """The kernels of the samples-sharded sweep against their plain
    versions and against the fused tile kernels (see the module
    docstring, phase 3). Returns ({instance: (ms, plain_ms, bound_ms,
    bound_by, int8_ms, cuda_core_ms, library_ms)} for local_parts at S =
    2, and for tile_epilogue {instance: (ms, plain_ms, bound_ms,
    bound_by, None, None, None, bytes_ms, ops_ms, f32 operations a
    candidate)}, its time with the counts buffer given, as the sweep
    calls it)."""
    import torch
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import tiles
    st = genotype_planes(2)
    full = sweeps.planes_to_device(st, "cuda")
    ops = prefilter_ops()
    _say(f"samples-sharded kernel check: B={B}, {N_SAMPLES} samples, word "
         f"slices S=2 and S=3; f32 SASS instructions of one pair's "
         f"prefilter, by path: {ops}")
    local, epi = {}, {}
    for instance in INSTANCES:
        cfg0 = sweeps.make_cfg(*instance, "all", B, N_SAMPLES, 0, MIN_R2,
                               100.0)
        keys = tiles.plane_keys(*instance)
        P = tiles.payload_cols(*instance)
        W = full[keys[0]].shape[-1]
        slices = {S: [sweeps.planes_to_device(st, "cuda", keys,
                                              word_slice=(s, S))
                      for s in range(S)] for S in (2, 3)}
        name = "/".join(map(str, instance))
        out = tiles.tile_buffers(cfg0, "cuda")
        counts = tiles.counts_buffer(cfg0, "cuda")
        fused_c = tiles.counts_buffer(cfg0, "cuda")
        for i, j, diag in ((1, 1, True), (0, 1, False)):
            want = torch.stack(tiles.tile_local_parts_plain(full, i, j,
                                                            cfg0))
            fused_m, fused_p = tiles.tile_prefilter(full, i, j, diag, cfg0)
            on = (fused_m != 0).unsqueeze(0)
            for S, devs in slices.items():
                total = torch.zeros_like(want)
                for s, dev in enumerate(devs):
                    got = tiles.tile_local_parts(dev, i, j, cfg0, out)
                    plain = torch.stack(tiles.tile_local_parts_plain(
                        dev, i, j, cfg0))
                    if not torch.equal(got, plain):
                        raise SystemExit(
                            f"local_parts {name} slice {s}/{S} ({i},{j}) "
                            f"differs from its plain version")
                    total += got
                    del plain
                if not torch.equal(total, want):
                    raise SystemExit(f"local_parts {name} ({i},{j}): the "
                                     f"{S} slices do not sum to the plain "
                                     f"full-width parts")
                if not torch.equal(total * on, fused_p * on):
                    raise SystemExit(f"local_parts {name} ({i},{j}): the "
                                     f"{S} slices do not sum to the fused "
                                     f"kernel's parts")
                _say(f"  local_parts {name} ({i},{j}) S={S}: "
                     f"{devs[0][keys[0]].shape[-1]} of {W} words a rank, "
                     f"P={P}, every slice and the sum equal")
            del fused_p
            # the epilogue on the global parts (the sum of the 3 slices)
            out[1].copy_(total)
            for cls in CLASSES:
                for window in (0,) + WINDOWS:
                    cfg = sweeps.make_cfg(*instance, cls, B, N_SAMPLES,
                                          window, MIN_R2, 100.0)
                    counts.fill_(-1)
                    mask, _ = tiles.tile_epilogue(full, i, j, diag, cfg,
                                                  out, counts)
                    want_m = tiles.tile_epilogue_plain(full, i, j, diag, cfg,
                                                       total)
                    fused_m, _ = tiles.tile_prefilter(full, i, j, diag, cfg,
                                                      counts=fused_c)
                    torch.cuda.synchronize()
                    label = (f"tile_epilogue {name}/{cls} w={window} "
                             f"({i},{j})")
                    if not torch.equal(mask, want_m):
                        raise SystemExit(f"{label} differs from its plain "
                                         f"version")
                    _check_counts_buffer(label, counts, mask)
                    if not torch.equal(mask, fused_m) \
                            or not torch.equal(counts, fused_c):
                        raise SystemExit(f"{label} differs from the fused "
                                         f"kernel's mask or counts")
                    _say(f"  {label}: {int((mask == 2).sum())} survivors, "
                         f"{int((mask != 0).sum())} candidates; mask and "
                         f"counts equal to the plain version and the fused "
                         f"kernel")
            del want, total, fused_m, want_m
        # ms per call: local_parts on slice 0 of 2, the epilogue on the
        # off-diagonal tile, cls "all", no window, with its counts
        dev = slices[2][0]
        Wl = dev[keys[0]].shape[-1]
        ms = _cuda_ms(lambda: tiles.tile_local_parts(dev, 0, 1, cfg0, out))
        plain = _cuda_ms(lambda: tiles.tile_local_parts_plain(dev, 0, 1,
                                                              cfg0), reps=3)
        lib = library_parts(dev, 0, 1, keys,
                            tiles.tile_local_parts(dev, 0, 1, cfg0, out))
        local[instance] = (ms, plain) + _bound(
            P * B * B * Wl, 2 * len(keys) * B * Wl * 4 + P * B * B * 4) \
            + (_int8_ms(P * B * B * Wl), _cuda_core_ms(P * B * B * Wl), lib)
        tiles.tile_local_parts(full, 0, 1, cfg0, out)
        ms = _cuda_ms(lambda: tiles.tile_epilogue(full, 0, 1, False, cfg0,
                                                  out, counts))
        plain = _cuda_ms(lambda: tiles.tile_epilogue_plain(
            full, 0, 1, False, cfg0, out[1]), reps=3)
        nbytes, nops = epilogue_work(cfg0, out[0], out[1], ops)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / F32_OPS_PER_S * 1e3
        n_cand = int((out[0] != 0).sum())
        epi[instance] = (ms, plain, max(bytes_ms, ops_ms),
                         "bytes" if bytes_ms >= ops_ms else "operations",
                         None, None, None, bytes_ms, ops_ms, nops / n_cand)
        for kname, r in (("local_parts", local), ("tile_epilogue", epi)):
            v = r[instance]
            _say(f"  ms per call: {kname} {name} P={P}"
                 f"{f', {Wl} words' if kname == 'local_parts' else ''} "
                 f"{v[0]:.4f} (plain {v[1]:.4f}, bound {v[2]:.4f} by "
                 f"{v[3]}"
                 + (f": bytes {v[7]:.4f}, f32 operations {v[8]:.4f} "
                    f"({v[9]:.1f} a candidate, {n_cand} candidates)"
                    if v[4] is None else
                    f", as int8 {v[4]:.4f}, CUDA-core ceiling {v[5]:.4f}; "
                    f"torch._int_mm x {P} {v[6]:.4f}")
                 + ")")
        del out, slices
        torch.cuda.empty_cache()
    return local, epi


def _bound(pair_words, nbytes):
    """(bound_ms, bound_by) of a contraction of `pair_words` = P * B * B
    * W packed words ANDed and counted: the card's bound, the larger of
    its 2 * 32 operations a pair-word over the 1-bit MMA's rate and its
    bytes, each moved once, over the HBM rate."""
    ops_ms = 64 * pair_words / B1_OPS_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, byte_ms),
            "operations" if ops_ms >= byte_ms else "bytes")


def _int8_ms(pair_words):
    """The same operations over the published int8 tensor-core peak: the
    cost of the contraction unpacked to int8. Not a bound of the card,
    whose 1-bit MMA is faster."""
    return 64 * pair_words / INT8_OPS_PER_S * 1e3


def _cuda_core_ms(pair_words):
    """The ceiling of the AND + __popc route on the CUDA cores: one POPC
    a pair-word. Not a bound of the card; the kernels still on that
    route are read against it."""
    return pair_words / POPC_PER_S * 1e3


def probe_shape():
    """The unphased P = 4 instance at tools/probe_pallas.py's shape:
    random het/hom words [4096, 80] on each side (the TPU probe's toy
    epilogue is replaced by the real prefilter), and torch._int_mm x 4 on
    the same operands. Returns (max_abs_err, ms, plain_ms, library_ms)."""
    import torch
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops.bitpack import _popcount_rows
    from tomahawk_tpu_torch.ops import tiles
    W = 80
    rng = np.random.default_rng(0)
    words = {k: rng.integers(0, 2**32, (2, B, W), dtype=np.uint32)
             for k in ("het_bits", "hom_bits")}
    count = lambda w: _popcount_rows(w.reshape(-1, W)).reshape(2, B)
    host = dict(words, n_het=count(words["het_bits"]),
                n_hom=count(words["hom_bits"]))
    host["ac"] = (host["n_het"] + 2 * host["n_hom"]).astype(np.int32)
    host["valid"] = np.ones((2, B), bool)
    dev = sweeps.planes_to_device(host, "cuda", list(host))
    cfg = sweeps.make_cfg("unphased", False, "all", B, 32 * W, 0, MIN_R2,
                          100.0)
    mask, parts = tiles.tile_prefilter(dev, 0, 1, False, cfg)
    want_m, want_p = tiles.tile_prefilter_plain(dev, 0, 1, False, cfg)
    err = max(int((mask.int() - want_m.int()).abs().max()),
              int((parts - want_p).abs().max()))
    out = tiles.tile_buffers(cfg, "cuda")
    ms = _cuda_ms(lambda: tiles.tile_prefilter(dev, 0, 1, False, cfg, out))
    plain = _cuda_ms(lambda: tiles.tile_prefilter_plain(dev, 0, 1, False,
                                                        cfg), reps=3)
    lib = library_parts(dev, 0, 1, ("het_bits", "hom_bits"), parts)
    _say(f"K3 probe shape (B={B}, W={W}, random het/hom words): "
         f"parts_tile unphased P=4 {ms:.4f} ms (plain {plain:.4f}; "
         f"torch._int_mm x 4 {lib:.4f}), {int((mask == 2).sum())} "
         f"survivors, max |diff| {err}")
    if err:
        raise SystemExit("parts_tile disagrees with its plain version at "
                         "the probe shape")
    return err, ms, plain, lib


def write_vcf(path, n_sites, seed=7, group=16, flip=0.02, phased=True,
              miss_sites=0, miss_step=1, miss_frac=0.0):
    """VCF with LD: every `group` consecutive sites are noisy copies of
    one haplotype template (as workloads.build_planes_grouped), genotypes
    `a|b` (or `a/b` when not phased). Of the first `miss_sites` sites,
    every `miss_step`-th misses `miss_frac` of its genotypes (`.|.`)."""
    rng = np.random.default_rng(seed)
    n_grp = n_sites // group
    maf = np.minimum(rng.beta(0.5, 2.0, size=n_grp) * 0.4 + 0.05, 0.5)
    base = rng.random((n_grp, 2 * N_SAMPLES)) < maf[:, None]
    alt = np.repeat(base, group, axis=0)
    alt ^= rng.random(alt.shape) < flip
    # "a|b\t" per sample, the last tab a newline
    cells = np.empty((n_sites, N_SAMPLES, 4), np.uint8)
    cells[:, :, 0] = ord("0") + alt[:, 0::2]
    cells[:, :, 1] = ord("|" if phased else "/")
    cells[:, :, 2] = ord("0") + alt[:, 1::2]
    cells[:, :, 3] = ord("\t")
    cells[:, -1, 3] = ord("\n")
    pos = 1000 + np.cumsum(rng.integers(50, 500, n_sites))
    if miss_sites:
        miss = rng.random((n_sites, N_SAMPLES)) < miss_frac
        keep = np.zeros(n_sites, bool)
        keep[:miss_sites:miss_step] = True
        miss &= keep[:, None]
        cells[miss, 0] = ord(".")
        cells[miss, 2] = ord(".")
    with open(path, "wb") as fh:
        fh.write(b"##fileformat=VCFv4.2\n##contig=<ID=20,length=63025520>\n"
                 b'##FORMAT=<ID=GT,Number=1,Type=String,Description="GT">\n'
                 b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(f"S{i}" for i in range(N_SAMPLES)).encode()
                 + b"\n")
        for s in range(n_sites):
            fh.write(f"20\t{pos[s]}\t.\tA\tC\t.\tPASS\t.\tGT\t".encode())
            fh.write(cells[s].tobytes())


#: native_reference's results by its arguments: several paths share one
_NATIVE = {}


def native_reference(twk, mode, window=0, dprime=(0.0, 100.0)):
    """The port's native C++ CPU tile engine's records for `calc -r 0.1`
    (`-w window` when window > 0, `-d -D` with `dprime`) on the same
    archive under the engine's dispatch for `mode` ("phased", "unphased"
    or "mixed"), with the engine's super-block and tile plan; computed
    once for each set of arguments."""
    key = (twk, mode, window, tuple(dprime))
    if key not in _NATIVE:
        _NATIVE[key] = _native_reference(twk, mode, window, dprime)
    return _NATIVE[key]


def _native_reference(twk, mode, window, dprime):
    from tomahawk_tpu_torch.compute.balancer import Balancer
    from tomahawk_tpu_torch.compute.cpu_engine import run_native_cpu
    from tomahawk_tpu_torch.compute.engine import (CalcSettings, _round_up,
                                                   _super_ranges,
                                                   group_tiles)
    from tomahawk_tpu_torch.io.twk import TwkReader
    from tomahawk_tpu_torch.ops.bitpack import block_to_planes, stack_planes
    from tomahawk_tpu_torch.ops.ld_math import LdFilters
    reader = TwkReader(twk)
    supers = _super_ranges(reader.index.ent, list(range(reader.index.n)),
                           B)
    Bp = _round_up(max(s["n"] for s in supers), 128)
    blocks = []
    for sup in supers:
        blk = reader.read_block(sup["ids"][0])
        for b in sup["ids"][1:]:
            for rec in reader.read_block(b).rcds:
                blk.add(rec)
        blocks.append(blk)
    stacked = stack_planes([block_to_planes(b, N_SAMPLES, pad_to=Bp)
                            for b in blocks])
    reader.close()
    balancer = Balancer.build(len(supers))
    if window:
        ids = range(len(supers))
        tiles = balancer.window_pairs(
            {s: supers[s]["minpos"] for s in ids},
            {s: supers[s]["maxpos"] for s in ids},
            {s: supers[s]["rid"] for s in ids}, window)
    else:
        tiles = balancer.tile_pairs()
    groups = group_tiles(tiles, mode, stacked["has_missing"].any(axis=1))
    out = []
    filt = LdFilters(min_r2=MIN_R2, min_dprime=dprime[0],
                     max_dprime=dprime[1])
    n = run_native_cpu(stacked, groups, filt,
                       lambda f, r: out.extend([f.copy(), r.copy()]), None,
                       N_SAMPLES, CalcSettings(min_r2=MIN_R2,
                                               window=bool(window),
                                               l_window=window or 1), {})
    if n is None:
        raise SystemExit("the native CPU tile engine is unavailable")
    return np.concatenate(out), [(g[0], g[1], g[2], len(g[3]))
                                 for g in groups]


def make_archive(work, name, n_sites, **kw):
    """Write a VCF and import it with the port's CLI (512-variant
    blocks, so super-blocks hold 4096 variants)."""
    vcf = os.path.join(work, f"{name}.vcf")
    twk = os.path.join(work, f"{name}.twk")
    t0 = time.perf_counter()
    write_vcf(vcf, n_sites, **kw)
    subprocess.run([sys.executable, "-m", "tomahawk_tpu_torch", "import",
                    "-i", vcf, "-o", twk, "-b", "512"], cwd=ROOT, check=True)
    _say(f"archive {name}: {N_SAMPLES} x {n_sites} "
         f"{'phased' if kw.get('phased', True) else 'unphased'} VCF, "
         f"{kw.get('miss_frac', 0.0)} of genotypes missing at every "
         f"{kw.get('miss_step', 1)}th of the first {kw.get('miss_sites', 0)} "
         f"sites; written and imported in {time.perf_counter() - t0:.1f}s")
    return twk


def _run_cli(argv):
    """The port's CLI entry point (`python -m tomahawk_tpu_torch ...`)
    in this process, so its kernel launch counts are visible. Returns the
    CalcResult of a `calc` (its stage_stats), which the CLI drops."""
    from tomahawk_tpu_torch.compute import engine
    real, kept = engine.compute_ld, []

    def keep(*a, **kw):
        kept.append(real(*a, **kw))
        return kept[-1]
    saved, sys.argv = sys.argv, argv
    engine.compute_ld = keep
    try:
        runpy.run_module("tomahawk_tpu_torch", run_name="__main__")
    except SystemExit as e:
        if e.code not in (0, None):
            raise
    finally:
        sys.argv = saved
        engine.compute_ld = real
    return kept[-1] if kept else None


def _check_counts(label, launches, plain, need, idle=()):
    """Each kernel in `need` launched, none in `idle` did, and no plain
    version ran."""
    missing = sorted(k for k in need if launches[k] == 0)
    if missing:
        raise SystemExit(f"calc {label} did not launch {missing}: "
                         f"{launches}")
    stray = sorted(k for k in idle if launches[k] != 0)
    if stray:
        raise SystemExit(f"calc {label} launched {stray}, which its path "
                         f"does not hold: {launches}")
    if any(plain.values()):
        raise SystemExit(f"calc {label} took a plain version on CUDA: "
                         f"{plain}")


def run_calc(label, twk, two, flags, mode, need, window=0, plan=None,
             dprime=(0.0, 100.0)):
    """One calc path through the CLI entry point, in this process: the
    launch counts are set to 0 just before it and read just after; each
    kernel in `need` must have launched and no plain version run. The
    records must equal the native CPU engine's under `mode`, and with a
    window each must lie on one contig within it. `plan` = (bands, loads,
    staged) is the banded plan the run must have taken (staged: whether
    the staging worker prefetched bands). Returns the launch counts."""
    from tomahawk_tpu_torch.ops import _build
    argv = ["tomahawk_tpu_torch", "calc", "-i", twk, "-o", two,
            "-r", str(MIN_R2), *flags, *ON_CARD]
    _build.reset_counts()
    t0 = time.perf_counter()
    res = _run_cli(argv)
    dt = CALC_WALLS[label] = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    plain = dict(_build.PLAIN_CALLS)
    _say(f"main path {label}: `calc {' '.join(flags + ['-r', str(MIN_R2)])}`"
         f" {dt:.2f}s wall, launches {launches}, plain {plain}")
    ss = res.stage_stats
    _say(f"  plan: {ss['n_bands']} bands, {ss['n_loads']} loads, "
         f"{ss['n_uploads']} band plane uploads (n_band_uploads); "
         f"stage_stats {json.dumps(ss)}")
    if plan is not None and (ss["n_bands"], ss["n_loads"],
                             ss["n_prefetched"] > 0) != plan:
        raise SystemExit(f"calc {label}: banded plan {ss} is not {plan}")
    _check_counts(label, launches, plain, need,
                  ("local_parts", "tile_epilogue"))
    check_records(label, two, twk, mode, window, dprime)
    return launches


def _same_fields(got, want):
    """The fields in which two sorted record arrays differ: every field
    but P must be equal, P within P_GUARD (a P from the in-sweep Fisher
    bracket is the exact kernel's within the reference's guard). Returns
    (fields that differ, max |P difference|)."""
    bad = [f for f in got.dtype.names
           if f != "P" and not np.array_equal(got[f], want[f])]
    p_err = float(np.abs(got["P"] - want["P"]).max()) if len(got) else 0.0
    if p_err > P_GUARD:
        bad.append("P")
    return bad, p_err


def _sort(recs):
    """Records in the order of every field but P (which may differ within
    P_GUARD between two equal record multisets)."""
    return np.sort(recs, order=[f for f in recs.dtype.names if f != "P"])


def check_records(label, two, twk, mode, window=0, dprime=(0.0, 100.0)):
    """The records of `two` equal the native CPU engine's for `calc -r
    0.1` (with D' bounds `dprime`) on `twk` under `mode`, field by field
    (P within P_GUARD), and with a window each lies on one contig within
    it."""
    from tomahawk_tpu_torch.io.two import TwoReader
    r = TwoReader(two)
    got = r.records()
    r.close()
    t0 = time.perf_counter()
    want, groups = native_reference(twk, mode, window, dprime)
    _say(f"  native CPU engine reference ({mode}: {groups}) in "
         f"{time.perf_counter() - t0:.1f}s")
    _check_same(label, got, want)
    if dprime != (0.0, 100.0):
        dp = np.abs(got["Dprime"])
        _say(f"  |D'| in [{dp.min():.3f}, {dp.max():.3f}] under -d "
             f"{dprime[0]} -D {dprime[1]}")
    if window:
        dist = np.abs((got["packA"] >> 2).astype(np.int64)
                      - (got["packB"] >> 2).astype(np.int64))
        if (got["ridA"] != got["ridB"]).any() or int(dist.max()) > window:
            raise SystemExit(f"calc {label}: a record lies outside the "
                             f"{window} bp window")
        _say(f"  every record on one contig, max |pos_a - pos_b| "
             f"{int(dist.max())} <= {window}")


def _check_same(label, got, want):
    """`got` equals the native CPU engine's records `want` as multisets:
    every field, P within P_GUARD; all statistics finite."""
    got, want = _sort(got), _sort(want)
    if len(got) != len(want) or len(got) == 0:
        raise SystemExit(f"{label}: record count {len(got)} != reference "
                         f"{len(want)}")
    bad, p_err = _same_fields(got, want)
    if bad:
        raise SystemExit(f"{label}: .two fields {bad} differ from the "
                         f"native CPU engine (P by {p_err})")
    for f in ("D", "Dprime", "R", "R2", "P"):
        if not np.isfinite(got[f]).all():
            raise SystemExit(f"non-finite {f} in the output")
    _say(f"  {len(got)} records equal the native CPU engine's field by "
         f"field, P within {p_err:.3g} (limit {P_GUARD}); R2 in "
         f"[{got['R2'].min():.3f}, {got['R2'].max():.3f}]")


def same_records(label, two, ref_label, ref):
    """The record multisets of two .two files are equal, field by field
    (P within P_GUARD)."""
    from tomahawk_tpu_torch.io.two import TwoReader
    got = []
    for path in (two, ref):
        r = TwoReader(path)
        got.append(_sort(r.records()))
        r.close()
    a, b = got
    bad, p_err = _same_fields(a, b) if len(a) == len(b) else (["len"], 0.0)
    if bad:
        raise SystemExit(f"calc {label}'s records differ from {ref_label}'s "
                         f"in {bad}")
    _say(f"  path {label}'s {len(a)} records equal path {ref_label}'s field "
         f"by field, P within {p_err:.3g}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(label, jobs, envs=None):
    """Run one `python3 chip_smoke.py rank <job>` process per job, all
    at once, each with the wall limit and with `envs[k]` (if given) added
    to rank k's environment; a rank that fails or outlives the limit
    fails the run with every rank's output. Returns each rank's report
    (the JSON object on its last line), with its `[DIST]` backend line
    under "dist"."""
    import torch
    torch.cuda.empty_cache()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "rank", json.dumps(job)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, **(envs[k] if envs else {})))
        for k, job in enumerate(jobs)]
    outs, late = [], False
    try:
        deadline = time.perf_counter() + RANK_LIMIT
        for p in procs:
            try:
                outs.append(p.communicate(
                    timeout=max(deadline - time.perf_counter(), 1))[0])
            except subprocess.TimeoutExpired:
                late = True
                p.kill()
                outs.append(p.communicate()[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if late or any(p.returncode != 0 for p in procs):
        for r, (p, out) in enumerate(zip(procs, outs)):
            _say(f"--- {label} rank {r}: exit {p.returncode}\n{out[-4000:]}")
        raise SystemExit(f"{label}: a rank failed"
                         f"{' or outlived its limit' if late else ''}")
    reports = []
    for r, out in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith('{"rank"')]
        if not lines:
            raise SystemExit(f"{label}: rank {r} printed no report:\n"
                             f"{out[-2000:]}")
        reports.append(json.loads(lines[-1]))
        reports[-1]["dist"] = next((ln for ln in out.splitlines()
                                    if "device collectives over" in ln), "")
    return reports


def run_ranked_calc(label, twk, out, flags, mode, need, idle, dcn, n=2,
                    envs=None, cards=None, backend="gloo", tally=None):
    """One `calc --distributed` path as `n` ranks (two by default, which
    share the card or the cards), rank k with `envs[k]` added to its
    environment. Every rank must launch each kernel in `need`, none in
    `idle`, and no plain version, and its `[DIST]` line must name
    `backend`; with `cards` ({card index: kernels}, cards by this
    process's numbering, matched by UUID) each card must have launched
    its kernels and no other card anything, and the launches by card are
    added to `tally` where given. dcn, a `--mesh` spec ('dcn' or
    'dcn:P'): only rank 0's file exists; otherwise (None) every shard
    exists and they are merged. The records must equal the native CPU
    engine's. Returns the launches summed over the ranks."""
    from tomahawk_tpu_torch.parallel import merge_shards, shard_paths
    coordinator = f"127.0.0.1:{_free_port()}"
    flags = flags + (["--mesh", dcn] if dcn else [])
    jobs = [dict(kind="calc", rank=r, argv=[
        "tomahawk_tpu_torch", "calc", "-i", twk, "-o", out, "-r",
        str(MIN_R2), *flags, *ON_CARD, "--distributed", "--coordinator",
        coordinator, "--num-processes", str(n), "--process-id", str(r)])
        for r in range(n)]
    shards = shard_paths(out, n)
    for path in [out] + shards:
        if os.path.exists(path):
            os.remove(path)
    t0 = time.perf_counter()
    reports = spawn_ranks(label, jobs, envs)
    dt = time.perf_counter() - t0
    total = {}
    for rep in reports:
        _check_counts(f"{label} rank {rep['rank']}", rep["launches"],
                      rep["plain"], need, idle)
        if f"device collectives over {backend}" not in rep["dist"]:
            raise SystemExit(f"{label} rank {rep['rank']}: expected device "
                             f"collectives over {backend}: {rep['dist']!r}")
        for k, v in rep["launches"].items():
            total[k] = total.get(k, 0) + v
    if cards is not None:
        by_card = _by_index([rep["cards"] for rep in reports])
        _check_cards(label, by_card, cards, idle)
        _add_cards(tally, by_card)
    cmd = " ".join(["calc", *flags, "--distributed"])
    env = f" (each under {sorted(envs[0])})" if envs else ""
    _say(f"main path {label}: `{cmd}` as {n} ranks{env}, device "
         f"collectives over {backend}: {dt:.2f}s wall (processes' start "
         f"included), launches per rank "
         f"{[rep['launches'] for rep in reports]}, no plain version")
    for rep in reports:
        _say(f"  rank {rep['rank']}: {rep['dist'].split('] ')[-1]}")
    have = [os.path.exists(path) for path in shards]
    if dcn:
        if any(have) or not os.path.exists(out):
            raise SystemExit(f"calc {label}: expected the one file {out} "
                             f"and no shard")
        check_records(label, out, twk, mode)
    else:
        if not all(have):
            raise SystemExit(f"calc {label}: a shard is missing: {shards}")
        n_rec = merge_shards(shards, out)
        _say(f"  merge_shards folded {n_rec} records of {shards}")
        check_records(label, out, twk, mode)
    return total


def run_mesh_paths(ld, miss, two):
    """Path p: compute_ld on meshes built from an explicit device list,
    2x1, 1x2 and 2x2 over the one card repeated, on a's archive (`-p`)
    and b's (mixed), each with the counts set to 0 just before it and
    read just after: S = 1 launches the fused kernels, S = 2 local_parts,
    tile_epilogue and compact (handed the epilogue's counts), never a
    plain version; then the CLI with `--mesh 1x1` and `--mesh auto`,
    which resolve to the one card. Every run's records equal the native
    CPU engine's. Returns the launches summed over them."""
    from tomahawk_tpu_torch.compute.engine import CalcSettings, compute_ld
    from tomahawk_tpu_torch.ops import _build
    from tomahawk_tpu_torch.parallel import make_mesh
    total = {}
    fused = {"phased": ("phased_tile", "compact"),
             "mixed": ("phased_tile", "parts_tile", "compact")}
    split = ("local_parts", "tile_epilogue", "compact")
    for P, S in MESH_SHAPES:
        for tag, twk, mode in (("a", ld, "phased"), ("b", miss, "mixed")):
            label = f"p {P}x{S} on {tag}'s archive"
            out = two.format(f"p{P}x{S}{tag}")
            _build.reset_counts()
            t0 = time.perf_counter()
            compute_ld(CalcSettings(input=twk, output=out, min_r2=MIN_R2,
                                    force_phased=mode == "phased",
                                    backend="device"), device="cuda",
                       mesh=make_mesh(P, S, ["cuda:0"] * (P * S)))
            dt = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            _say(f"main path {label}: compute_ld(mesh=make_mesh({P}, {S}, "
                 f"[cuda:0] x {P * S})) {dt:.2f}s wall, launches {launches}")
            if S == 1:
                need, idle = fused[mode], split[:2]
            else:
                need, idle = split, ("phased_tile", "parts_tile")
            _check_counts(label, launches, dict(_build.PLAIN_CALLS), need,
                          idle)
            check_records(label, out, twk, mode)
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
    for spec in ("1x1", "auto"):
        launches = run_calc(f"p --mesh {spec}", ld, two.format(f"p{spec}"),
                            ["-p", "--mesh", spec], "phased",
                            fused["phased"])
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def _est_pairs(twk):
    """The candidate-pair estimate `calc` routes by, for an archive: the
    engine's super-blocks of B variants and its all-vs-all tile list."""
    from tomahawk_tpu_torch.compute.balancer import Balancer
    from tomahawk_tpu_torch.compute.engine import _round_up, _super_ranges
    from tomahawk_tpu_torch.io.twk import TwkReader
    reader = TwkReader(twk)
    supers = _super_ranges(reader.index.ent, list(range(reader.index.n)), B)
    reader.close()
    Bp = _round_up(max(s["n"] for s in supers), 128)
    return sum(Bp * (Bp - 1) // 2 if d else Bp * Bp
               for _, _, d in Balancer.build(len(supers)).tile_pairs())


def run_route_paths(ld, small, two):
    """Path q, the CPU route, through the CLI entry point, each run with
    the counts set to 0 just before it and read just after: `-p --backend
    cpu` on a's archive (its records equal path a's), `-p --backend auto`
    on an archive of ROUTE_SITES sites, whose work is below the default
    limit (records equal the native CPU engine's), both launching no
    kernel and taking no plain version; then the same `auto` run with
    TWK_CPU_ROUTE_WORK=0, which goes to the card and launches the fused
    kernels. Returns the launches summed over them."""
    from tomahawk_tpu_torch.compute.engine import CPU_ROUTE_WORK
    from tomahawk_tpu_torch.ops import _build
    work = _est_pairs(small) * 2 * N_SAMPLES
    if work >= CPU_ROUTE_WORK:
        raise SystemExit(f"path q's archive has work {work:.3g}, not below "
                         f"the route's limit {CPU_ROUTE_WORK:.3g}")
    total = {}
    for label, twk, backend, env in (
            ("q cpu", ld, "cpu", None), ("q auto", small, "auto", None),
            ("q auto, limit 0", small, "auto", "0")):
        out = two.format(label.replace(" ", "").replace(",", ""))
        argv = ["tomahawk_tpu_torch", "calc", "-i", twk, "-o", out, "-r",
                str(MIN_R2), "-p", "--backend", backend]
        if env is not None:
            os.environ["TWK_CPU_ROUTE_WORK"] = env
        _build.reset_counts()
        t0 = time.perf_counter()
        try:
            _run_cli(argv)
        finally:
            os.environ.pop("TWK_CPU_ROUTE_WORK", None)
        dt = time.perf_counter() - t0
        launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
        _say(f"main path {label}: `calc -p --backend {backend}`"
             f"{' with TWK_CPU_ROUTE_WORK=' + env if env else ''} "
             f"{dt:.2f}s wall, launches {launches}, plain {plain}")
        if env is None and (any(launches.values()) or any(plain.values())):
            raise SystemExit(f"calc {label}: a routed run launched a kernel "
                             f"or a plain version")
        if env is not None:
            _check_counts(label, launches, plain, ("phased_tile", "compact"),
                          ("local_parts", "tile_epilogue"))
        if twk == ld:
            same_records(label, out, "a", two.format("a"))
        else:
            check_records(label, out, twk, "phased")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    _say(f"  path q's archive: {ROUTE_SITES} sites, work {work:.4g} "
         f"pair-haplotypes, the limit {CPU_ROUTE_WORK:.4g}")
    return total


def _calc_wall(log_text):
    """Seconds of compute_ld from a `calc` process's log: its
    "Computed ... in <elapsed>" line (s, m:s or h:m:s)."""
    line = next(ln for ln in log_text.splitlines()
                if "[PROGRESS] Computed" in ln)
    text = line.rsplit(" in ", 1)[1].split()[0].rstrip("s")
    secs = 0.0
    for unit, scale in (("h", 3600), ("m", 60)):
        if unit in text:
            head, text = text.split(unit)
            secs += scale * float(head)
    return secs + float(text)


def crossover(work, mode="phased"):
    """The CPU route's crossover on the card for one dispatch: `phased`,
    LD-grouped phased archives of 2,504 samples x CROSS_SITES sites run
    by `calc -p`; `mixed`, the same with path b's missing data (2.5% of
    the genotypes of every second site of the first three quarters) run
    by `calc` (the default mixed dispatch). Each as a fresh `python -m
    tomahawk_tpu_torch calc` process with `--backend cpu` and with
    `--backend device`, CROSS_REPS times in turns, after the kernels and
    the native library are built (the build cache is warm). Prints the
    process walls beside each archive's work (candidate pairs x
    haplotypes), each run's compute_ld wall (its "Computed ... in" line:
    the process but for the interpreter's start and the imports, which
    both routes pay alike) and the work where the medians of the
    compute_ld walls cross, interpolated in log-log between the sizes on
    either side. Returns the JSON row."""
    rows = []
    flags = ["-p"] if mode == "phased" else []
    for n in CROSS_SITES[mode]:
        miss = {} if mode == "phased" else dict(
            miss_sites=3 * n // 4, miss_step=2, miss_frac=0.025)
        twk = make_archive(work, f"{mode}{n}", n, **miss)
        est = _est_pairs(twk)
        walls = {"cpu": [], "device": [], "cpu_calc": [], "device_calc": []}
        for rep in range(CROSS_REPS):
            for backend in ("cpu", "device"):
                t0 = time.perf_counter()
                r = subprocess.run(
                    [sys.executable, "-m", "tomahawk_tpu_torch", "calc",
                     "-i", twk, "-o", os.path.join(work, "x.two"), *flags,
                     "-r", str(MIN_R2), "--backend", backend], cwd=ROOT,
                    check=True, capture_output=True, text=True)
                walls[backend].append(time.perf_counter() - t0)
                walls[f"{backend}_calc"].append(_calc_wall(r.stderr))
        row = dict(sites=n, pairs=est, work=est * 2 * N_SAMPLES,
                   cpu_s=walls["cpu"], device_s=walls["device"],
                   cpu_calc_s=walls["cpu_calc"],
                   device_calc_s=walls["device_calc"])
        rows.append(row)
        _say(f"  crossover {mode} {n} sites: work {row['work']:.4g}; "
             f"process walls --backend cpu {walls['cpu']} s, --backend device "
             f"{walls['device']} s; compute_ld walls {walls['cpu_calc']} / "
             f"{walls['device_calc']} s")
    med = [(r["work"], float(np.median(r["cpu_calc_s"])),
            float(np.median(r["device_calc_s"]))) for r in rows]
    at = None
    for (w0, c0, d0), (w1, c1, d1) in zip(med, med[1:]):
        if c0 <= d0 and c1 > d1:
            # log(cpu / device) crosses 0 between w0 and w1
            g0, g1 = math.log(c0 / d0), math.log(c1 / d1)
            at = math.exp(math.log(w0) + (math.log(w1) - math.log(w0))
                          * g0 / (g0 - g1))
    res = dict(mode=mode, rows=rows, crossover_work=at,
               cpu_count=os.cpu_count(),
               build_cache="warm: kernels and native library built before",
               note=f"process walls of `calc {' '.join(flags)}`, fresh "
                    f"processes")
    _say(f"CPU route crossover, {mode}: "
         f"{at if at is None else f'{at:.4g}'} pair-haplotypes "
         f"(os.cpu_count() {os.cpu_count()})")
    _say(json.dumps({"crossover": res}))
    return res


def main_paths(work):
    """The calc paths of phase 4: those in this process (p and q among
    them), and three as two ranks. Returns the launch counts summed over
    them, and path l's and m's."""
    ld = make_archive(work, "ld", 16384)
    miss = make_archive(work, "miss", 16384, miss_sites=12288, miss_step=2,
                        miss_frac=0.025)
    unph = make_archive(work, "unph", 8192, seed=8, phased=False,
                        miss_sites=4096, miss_frac=0.02)
    two = os.path.join(work, "{}.two")
    # the phased paths carry the in-sweep Fisher bracket (fisher_bracket)
    every = ("phased_tile", "parts_tile", "compact", "fisher_bracket")
    phased = ("phased_tile", "compact", "fisher_bracket")
    win = ["-w", str(CALC_WINDOW)]
    banded = ["-M", str(BANDED_GB)]
    dp = ["-d", str(DPRIME[0]), "-D", str(DPRIME[1])]
    paths = (
        ("a", ld, ["-p"], "phased", phased, 0, None, None),
        ("b", miss, [], "mixed", every, 0, None, None),
        ("c", unph, ["-u"], "unphased", ("parts_tile", "compact"), 0, None,
         None),
        ("d", miss, ["-p"], "phased", every, 0, None, None),
        ("e", ld, ["-p"] + win, "phased", phased, CALC_WINDOW, None, None),
        ("f", miss, win, "mixed", every, CALC_WINDOW, None, None),
        ("j", ld, ["-p"] + banded, "phased", phased, 0, (4, 10, True), None),
        ("k", miss, banded + ["--no-stage-prefetch"], "mixed", every, 0,
         (4, 10, False), None),
        ("l", ld, ["-p"] + dp, "phased", phased, 0, None, DPRIME),
        ("m", miss, ["-d", "0.3"], "mixed", every, 0, None, (0.3, 100.0)))
    total, dprime_launches = {}, {}
    for label, twk, flags, mode, need, window, plan, dprime in paths:
        launches = run_calc(label, twk, two.format(label), flags, mode, need,
                            window, plan, dprime or (0.0, 100.0))
        if dprime:
            dprime_launches[label] = launches
        if label == "j":
            total_j = launches
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    same_records("j", two.format("j"), "a", two.format("a"))
    small = make_archive(work, f"x{ROUTE_SITES}", ROUTE_SITES)
    for launches in (run_mesh_paths(ld, miss, two),
                     run_route_paths(ld, small, two)):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    launches = run_scalc("n", miss, two.format("n"))
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    launches, POST["checkpoint"] = run_checkpointed(
        "o", ld, two.format("o"), two.format("j"), total_j)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    launches, POST["subcommands"] = post_phase(
        work, ld, two.format("a"), two.format("b"))
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    two = two.format("ranked")
    dcn = ("local_parts", "tile_epilogue", "compact")
    fused = ("phased_tile", "parts_tile")
    ranked = (("g", ld, ["-p"], "phased", dcn, fused, "dcn"),
              ("h", miss, [], "mixed", dcn, fused, "dcn"),
              ("i", miss, [], "mixed", every, dcn[:2], None))
    for label, twk, flags, mode, need, idle, is_dcn in ranked:
        launches = run_ranked_calc(label, twk, two, flags, mode, need, idle,
                                   is_dcn)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total, dprime_launches


class _Crash(RuntimeError):
    """Path o's deliberate crash."""


def _records_of(two):
    from tomahawk_tpu_torch.io.two import TwoReader
    r = TwoReader(two)
    recs = r.records()
    r.close()
    return recs


def run_checkpointed(label, twk, two, ref_two, ref_launches):
    """Path o: path j's `calc -p -M` with `--checkpoint <two>.ckpt
    --checkpoint-interval 0` through the CLI entry point, crashed on
    entering its segment after CKPT_CRASH_AFTER (a stand-in for
    LdEngine._run_segment set up here; the phase fails if the run ends
    first), then run again, which resumes. The resumed run's launch
    counts are set to 0 just before it and read just after. Its records
    must equal path j's record for record and in order (P within
    P_GUARD), the sidecar must be gone, and the resumed run must sweep
    j's tiles but those of the skipped segments, with as many fewer
    phased_tile launches at least. Times the crashed and the resumed
    legs against j's wall, and a segment's end (`_finish_segment`: the
    writer's flush and fsync, then the sidecar) at interval 0."""
    from tomahawk_tpu_torch.compute import engine
    from tomahawk_tpu_torch.ops import _build
    ckpt = two + ".ckpt"
    for path in (two, ckpt):
        if os.path.exists(path):
            os.remove(path)
    flags = ["-p", "-M", str(BANDED_GB), "--checkpoint", ckpt,
             "--checkpoint-interval", "0"]
    argv = ["tomahawk_tpu_torch", "calc", "-i", twk, "-o", two, "-r",
            str(MIN_R2), *flags, *ON_CARD]
    E = engine.LdEngine
    real = dict(seg=E._run_segment, fin=E._finish_segment,
                disp=E._dispatch_fused)
    done, ends, swept = [], [], []

    def crashing(self, tiles, *a, **kw):
        if len(done) >= CKPT_CRASH_AFTER:
            raise _Crash(f"path {label}: crash after {len(done)} segments")
        done.append(len(tiles))
        return real["seg"](self, tiles, *a, **kw)

    def timed_end(self, shards):
        t0 = time.perf_counter()
        real["fin"](self, shards)
        ends.append(time.perf_counter() - t0)

    def counting(self, tiles, cfg):
        swept.append(len(tiles))
        return real["disp"](self, tiles, cfg)
    E._finish_segment = timed_end
    try:
        E._run_segment = crashing
        t0 = time.perf_counter()
        try:
            _run_cli(argv)
        except _Crash:
            pass
        else:
            raise SystemExit(f"calc {label} ended before its crash point")
        finally:
            E._run_segment = real["seg"]
        crash_s = time.perf_counter() - t0
        if not os.path.exists(ckpt):
            raise SystemExit(f"calc {label}: no sidecar after the crash")
        with open(ckpt) as fh:
            ck = json.load(fh)
        if ck["units"] != CKPT_CRASH_AFTER:
            raise SystemExit(f"calc {label}: the sidecar holds {ck['units']}"
                             f" segments, not {CKPT_CRASH_AFTER}")
        n_crash_ends = len(ends)
        E._dispatch_fused = counting
        _build.reset_counts()
        t0 = time.perf_counter()
        _run_cli(argv)
        resume_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        plain = dict(_build.PLAIN_CALLS)
    finally:
        E._finish_segment = real["fin"]
        E._dispatch_fused = real["disp"]
    _check_counts(label, launches, plain, ("phased_tile", "compact"),
                  ("parts_tile", "local_parts", "tile_epilogue"))
    if os.path.exists(ckpt):
        raise SystemExit(f"calc {label}: the sidecar outlived the run")
    skipped = sum(done[:ck["units"]])
    fewer = ref_launches["phased_tile"] - launches["phased_tile"]
    if sum(swept) != PATH_J_TILES - skipped or fewer < skipped:
        raise SystemExit(
            f"calc {label}: the resumed run swept {sum(swept)} tiles and "
            f"launched phased_tile {launches['phased_tile']} times; path j "
            f"{PATH_J_TILES} / {ref_launches['phased_tile']}, {skipped} "
            f"skipped")
    got, want = _records_of(two), _records_of(ref_two)
    bad, p_err = (_same_fields(got, want) if len(got) == len(want)
                  else (["len"], 0.0))
    if bad:
        raise SystemExit(f"calc {label}'s records differ from path j's, in "
                         f"order, in {bad}")
    wall_j = CALC_WALLS["j"]
    end_ms = 1e3 * float(np.mean(ends))
    _say(f"main path {label}: `calc {' '.join(flags)}` crashed after "
         f"{ck['units']} segments ({ck['load_cum']} segments at the end of "
         f"each whole load) in {crash_s:.2f}s, resumed in {resume_s:.2f}s "
         f"(path j {wall_j:.2f}s); resumed launches {launches}, path j's "
         f"phased_tile {ref_launches['phased_tile']}: {fewer} fewer, "
         f"{skipped} tiles skipped; {sum(swept)} of {PATH_J_TILES} tiles "
         f"swept; {len(got)} records equal path j's in order, P within "
         f"{p_err:.3g}; the sidecar is gone; a segment's end with the "
         f"checkpoint {end_ms:.2f} ms on average over {len(ends)} "
         f"({n_crash_ends} in the crashed leg)")
    return launches, dict(
        crash_s=crash_s, resume_s=resume_s, uninterrupted_s=wall_j,
        segments_before_crash=ck["units"], load_cum=ck["load_cum"],
        tiles_skipped=skipped, tiles_swept=sum(swept),
        phased_tile_launches=launches["phased_tile"],
        phased_tile_launches_j=ref_launches["phased_tile"],
        records=len(got), p_max_diff=p_err, segment_end_ms=end_ms,
        segment_end_ms_max=1e3 * float(np.max(ends)),
        segment_ends=len(ends))


def _run_post(argv):
    """One subcommand through the port's CLI entry point in this process
    (`python -m tomahawk_tpu_torch ...`); its wall, s. Exit 0 or
    raise."""
    saved, sys.argv = sys.argv, ["tomahawk_tpu_torch", *argv]
    t0 = time.perf_counter()
    try:
        runpy.run_module("tomahawk_tpu_torch", run_name="__main__")
    except SystemExit as e:
        if e.code not in (0, None):
            raise SystemExit(f"`{' '.join(argv)}` exited {e.code}")
    finally:
        sys.argv = saved
    return time.perf_counter() - t0


def kinship_bound(n):
    """(bound ms, what bounds it) of one X4 block at n samples: the
    larger of its bytes -- the int8 block read once, the int32
    accumulator read and written once -- over the HBM rate, and its
    2 x rows x n^2 operations over the int8 tensor-core peak."""
    nbytes = KIN_BLOCK_ROWS * n + 2 * 4 * n * n
    ops = 2 * KIN_BLOCK_ROWS * n * n
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT8_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops \
        else "operations"


def compare_kinship():
    """X4, relationship's kinship GEMM: the wrapper (torch._int_mm) on one
    512 x 2,504 block in {-1, 0, +1} against its plain version on the same
    card, exact; ms per block of each, of torch._int_mm alone (the GEMM
    without the accumulation), and the bound."""
    import torch
    from tomahawk_tpu_torch.ops import kinship
    rng = np.random.default_rng(23)
    block = rng.integers(-1, 2, (KIN_BLOCK_ROWS, N_SAMPLES)).astype(np.int8)
    g = kinship.block_to_device(block, "cuda")
    kin = kinship.new_accumulator(N_SAMPLES, "cuda")
    kin += torch.randint(-1000, 1000, kin.shape, dtype=torch.int32,
                         device="cuda")
    got = kinship.gram_accumulate(kin.clone(), g)
    want = kinship.gram_plain(kin.clone(), g)
    err = int((got - want).abs().max())
    if err:
        raise SystemExit(f"kinship GEMM: torch._int_mm differs from the "
                         f"plain version by {err}")
    gt = g.t().contiguous()
    ms = _cuda_ms(lambda: kinship.gram_accumulate(kin, g))
    plain_ms = _cuda_ms(lambda: kinship.gram_plain(kin, g))
    library_ms = _cuda_ms(lambda: torch._int_mm(gt, gt.t()))
    bound, by = kinship_bound(kinship.padded_samples(N_SAMPLES))
    _say(f"kinship GEMM (X4, torch._int_mm) on a {KIN_BLOCK_ROWS} x "
         f"{N_SAMPLES} block: equal to its plain version; {ms:.4f} ms a "
         f"block (torch._int_mm alone {library_ms:.4f}), plain "
         f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=library_ms)


def post_phase(work, twk, two_a, two_b):
    """The post-processing subcommands through the CLI entry point, in
    this process: `relationship` on the archive of path a on the card
    (the launch counts set to 0 just before it and read just after: one
    torch._int_mm a 512-row block, no plain version), twice, and on the
    CPU route, the kinship text of both routes equal; then view, sort,
    concat, aggregate, stats, decay and haplotype on paths a's and b's
    .two (and a's .twk), each exiting 0: sorted records equal to the
    input's multiset, concat's records those of both inputs. Returns the
    relationship run's launch counts and the walls."""
    import zstandard
    from tomahawk_tpu_torch.io.twk import TwkReader
    from tomahawk_tpu_torch.ops import _build
    with TwkReader(twk) as r:
        n_variants = sum(e.n for e in r.index.ent)
    n_blocks = -(-n_variants // KIN_BLOCK_ROWS)
    kin = {k: os.path.join(work, f"kin_{k}.txt") for k in ("cuda", "cpu")}
    _build.reset_counts()
    walls = dict(relationship_cuda=_run_post(
        ["relationship", "-i", twk, "-o", kin["cuda"]]))
    launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
    if launches[_build.KINSHIP] != n_blocks or any(plain.values()):
        raise SystemExit(f"relationship: {launches} launches, {plain} plain "
                         f"calls; want {n_blocks} torch._int_mm")
    walls["relationship_cuda_again"] = _run_post(
        ["relationship", "-i", twk, "-o", kin["cuda"]])
    walls["relationship_cpu"] = _run_post(
        ["relationship", "-i", twk, "-o", kin["cpu"], "--device", "cpu"])
    text = {}
    for k, path in kin.items():
        with open(path) as fh:
            text[k] = fh.read()
    if text["cuda"] != text["cpu"] or text["cuda"].count("\n") != N_SAMPLES:
        raise SystemExit("relationship: the card's kinship differs from "
                         "the CPU route's")
    _say(f"post: relationship on {N_SAMPLES} x {n_variants} ({n_blocks} "
         f"blocks of {KIN_BLOCK_ROWS}): {walls['relationship_cuda']:.2f}s / "
         f"{walls['relationship_cuda_again']:.2f}s on the card, "
         f"{walls['relationship_cpu']:.2f}s on the CPU route, kinship text "
         f"equal; launches {launches[_build.KINSHIP]}")
    out = {k: os.path.join(work, f"post_{k}") for k in (
        "view.txt", "view_b.two", "sort_a.two", "sort_b.two", "concat.two",
        "agg.twa", "hap.txt")}
    a, b = _records_of(two_a), _records_of(two_b)
    with TwkReader(twk) as r:
        region = f"{r.header.contigs[int(a['ridA'][0])].name}:1-400000"
    runs = (
        ("view", ["view", "-i", two_a, "-o", out["view.txt"], "-r", "0.5"]),
        ("view -O b", ["view", "-i", two_b, "-O", "b", "-o",
                       out["view_b.two"], "-r", "0.5"]),
        ("sort a", ["sort", "-i", two_a, "-o", out["sort_a.two"]]),
        ("sort b", ["sort", "-i", two_b, "-o", out["sort_b.two"]]),
        ("concat", ["concat", "-i", two_a, "-i", two_a, "-o",
                    out["concat.two"]]),
        ("aggregate", ["aggregate", "-i", two_a, "-o", out["agg.twa"]]),
        ("stats", ["stats", "-i", two_b]),
        ("decay", ["decay", "-i", two_a, "-b", "100"]),
        ("haplotype", ["haplotype", "-i", twk, "-I", region, "-o",
                       out["hap.txt"]]))
    for name, argv in runs:
        with open(os.devnull, "w") as sink:
            saved, sys.stdout = sys.stdout, sink
            try:
                walls[name] = _run_post(argv)
            finally:
                sys.stdout = saved
    for name, src, sorted_two in (("a", a, out["sort_a.two"]),
                                  ("b", b, out["sort_b.two"])):
        got = _records_of(sorted_two)
        if not np.array_equal(_sort(got), _sort(src)):
            raise SystemExit(f"sort: the sorted records of {name} are not "
                             f"its records")
    n_concat = len(_records_of(out["concat.two"]))
    if n_concat != 2 * len(a):
        raise SystemExit(f"concat: {n_concat} records, not 2 x {len(a)}")
    for k in ("view.txt", "agg.twa", "hap.txt"):
        if os.path.getsize(out[k]) == 0:
            raise SystemExit(f"post: {k} is empty")
    _say(f"post: view, sort (a: {len(a)}, b: {len(b)} records, multisets "
         f"kept), concat ({n_concat}), aggregate, stats, decay, haplotype "
         f"({region}) exit 0; walls "
         f"{json.dumps({k: round(v, 3) for k, v in walls.items()})}; "
         f"zstandard from {zstandard.__file__}")
    return launches, dict(walls, n_variants=n_variants, kin_blocks=n_blocks,
                          kin_launches=launches[_build.KINSHIP])


#: what path o and the post phase report (main_paths fills it)
POST = {}


def run_scalc(label, twk, two):
    """`scalc` through the CLI entry point, in this process, on the
    archive of b: the SCALC_TARGETS sites are the targets, 100-row blocks
    of targets and of their neighbours within 500 kb, the mixed dispatch
    over target x target and target x neighbour tiles, with the launch
    counts set to 0 just before it and read just after. Its records
    equal the native CPU engine's over the same tiles of the same blocks
    (captured from scalc's call of dispatch_pairs), kept by the same rule:
    rows whose A side is a target. Returns the launch counts."""
    from tomahawk_tpu_torch.compute import scalc
    from tomahawk_tpu_torch.compute.cpu_engine import run_native_cpu
    from tomahawk_tpu_torch.compute.engine import CalcSettings, group_tiles
    from tomahawk_tpu_torch.io.two import TwoReader
    from tomahawk_tpu_torch.io.twk import TwkReader
    from tomahawk_tpu_torch.ops import _build
    with TwkReader(twk) as r:
        per = r.index.ent[0].n
        pos = [r.read_block(s // per).rcds[s % per].pos
               for s in (SCALC_TARGETS[0], SCALC_TARGETS[1] - 1)]
    interval = f"20:{pos[0] + 1}-{pos[1] + 1}"
    seen = {}
    real = scalc.dispatch_pairs

    def capture(engine, pairs, mode, filt, emit, stacked):
        seen.update(pairs=pairs, filt=filt, stacked=stacked)
        return real(engine, pairs, mode, filt, emit, stacked)
    argv = ["tomahawk_tpu_torch", "scalc", "-i", twk, "-o", two, "-I",
            interval]
    _build.reset_counts()
    scalc.dispatch_pairs = capture
    t0 = time.perf_counter()
    try:
        _run_cli(argv)
    finally:
        scalc.dispatch_pairs = real
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    st, pairs = seen["stacked"], seen["pairs"]
    _say(f"main path {label}: `scalc -I {interval}` {dt:.2f}s wall, "
         f"{len(pairs)} tiles of {st['alt_bits'].shape[1]} rows, launches "
         f"{launches}, plain {dict(_build.PLAIN_CALLS)}")
    _check_counts(label, launches, dict(_build.PLAIN_CALLS),
                  ("phased_tile", "parts_tile", "compact", "fisher_bracket"),
                  ("local_parts", "tile_epilogue"))
    targets = sorted({i for i, _, _ in pairs})
    target_pos = st["pos"][targets][st["valid"][targets]].astype(np.int64)
    rid = int(st["rid"][targets[0]][0])
    out = []

    def keep(f, rv):
        m = (f["ridA"] == rid) \
            & np.isin((f["packA"] >> 2).astype(np.int64), target_pos)
        out.extend([f[m].copy(), rv[m].copy()])
    t0 = time.perf_counter()
    groups = group_tiles(pairs, "mixed", st["has_missing"].any(axis=1))
    run_native_cpu(st, groups, seen["filt"], keep, None, N_SAMPLES,
                   CalcSettings(min_r2=0.0), {})
    _say(f"  native CPU engine reference over the same {len(pairs)} tiles "
         f"in {time.perf_counter() - t0:.1f}s ({len(target_pos)} targets)")
    r = TwoReader(two)
    got = r.records()
    r.close()
    _check_same(f"scalc {label}", got, np.concatenate(out))
    return launches


def _time_engine(work, tag, run, n_pairs, stat_key, engine,
                 reps=("warmup", "rep0", "rep1")):
    """Reps of one engine workload into .two files (by default a warm-up
    and two more); prints pairs/s per rep and returns the walls, s.
    `engine` is the LdEngine whose stats to print, or a function giving
    it."""
    from tomahawk_tpu_torch.compute.engine import _reverse_records
    from tomahawk_tpu_torch.io.header import VcfContig, VcfHeader
    from tomahawk_tpu_torch.io.two import TwoWriter
    hdr = VcfHeader(samples=[f"S{i}" for i in range(N_SAMPLES)],
                    contigs=[VcfContig(idx=0, name="bench")])
    walls = []
    for rep in reps:
        writer = TwoWriter(os.path.join(work, f"{tag}_{rep}.two"), hdr)
        n_rec = [0]

        def emit(recs, rev=None):
            writer.add(recs)
            writer.add(rev if rev is not None else _reverse_records(recs))
            n_rec[0] += 2 * len(recs)

        t0 = time.perf_counter()
        run(emit)
        writer.close()
        dt = time.perf_counter() - t0
        walls.append(dt)
        _say(f"  {rep}: {dt:.3f}s, {n_pairs / dt:.0f} pairs/s, "
             f"{n_rec[0]} records")
    if callable(engine):
        engine = engine()
    st = engine.stats[stat_key]
    _say(f"  stats (all reps): count {st['count_s']:.2f}s, extract "
         f"{st['extract_s']:.2f}s, math {st['math_s']:.2f}s, repair "
         f"tiles {st['n_repair']}, supplementary copies {st['n_supp']}, "
         f"fused cap {engine.caps['fused_cap']}")
    return walls


def _python_loop_reps(work, tag, run, n_pairs, stat_key, engine):
    """Two timed reps with the segment's tile loop in Python
    (`sweeps._tile_loop`: per tile the tile kernel's and the compaction's
    wrappers, each checking its inputs) in place of the C entry, so the C
    loop's gain is read in one call. Returns the walls."""
    from tomahawk_tpu_torch.compute import sweeps
    c_loop = sweeps._launch_sweep
    sweeps._launch_sweep = sweeps._tile_loop
    try:
        return _time_engine(work, tag, run, n_pairs, stat_key, engine,
                            reps=("python loop", "python loop 2"))
    finally:
        sweeps._launch_sweep = c_loop


def _watch_depth(engine):
    """Record each pipeline depth `run_group` takes (it asks before every
    dispatch); returns the list it fills."""
    seen = []
    real = engine._pipeline_depth

    def depth(cfg):
        seen.append(real(cfg))
        return seen[-1]
    engine._pipeline_depth = depth
    return seen


def _serial(engine):
    """The engine's segment pipeline off for the rest of its runs: one
    segment at a time (without the retry limit a clean serial streak
    would turn the pipeline back on)."""
    engine._pipeline_enabled = False
    engine._pipeline_retry_after = 1 << 30


def _profile_engine(tag, run, n_tiles):
    """One more rep of an engine workload under torch.profiler: wall,
    the device's busy time (the sum of every kernel's and copy's device
    time), its idle share of the wall, and the time by kernel name.
    Returns the numbers as a dict."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(lambda recs, rev=None: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            by_name[name] = by_name.get(name, 0.0) \
                + e.self_device_time_total / 1e3
    busy = sum(by_name.values())
    if busy == 0:
        raise SystemExit(f"torch.profiler saw no device time in {tag}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # the host side: the CUDA runtime and torch calls with the most time of
    # their own on the host's clock, summed over the threads
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU
                   and e.self_cpu_time_total > 0),
                  key=lambda kv: -kv[1])[:6]
    res = dict(workload=tag, tiles=n_tiles, wall_ms=wall * 1e3,
               device_busy_ms=busy, idle_share=1 - busy / (wall * 1e3),
               ms_by_kernel=dict(top),
               host_ms_by_call={k: [ms, n] for k, ms, n in host})
    _say(f"  traced rep: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} "
         f"ms, idle share {res['idle_share']:.4f}; ms by kernel: "
         + ", ".join(f"{k} {v:.2f} ({v / n_tiles:.4f} a tile)"
                     for k, v in top))
    _say("  host calls (ms of their own, calls): "
         + ", ".join(f"{k} {ms:.2f} x{n}" for k, ms, n in host))
    _say(json.dumps({"engine_trace": res}))
    return res


def engine_rates(work):
    """The sparse and records-dense workloads through
    LdEngine.run_phased_pairs; the sparse planes again in window mode,
    over Balancer.window_pairs; random genotype variants through
    LdEngine.run_unphased_pairs with no missing data (P = 4) and 2%
    missing genotypes (P = 9); LD-grouped genotype variants, half of them
    missing 2% of their genotypes, through LdEngine.run_mixed_pairs (the
    default dispatch: phased_tile's clean class and parts_tile P = 9).
    After the timed reps of each workload, one more rep under
    torch.profiler; pipeline depth and segments of each row; a serial rep
    beside dense, mixed and the 250 kb window, reps with the tile loop in
    Python beside sparse and the 250 kb window; the banded sparse row
    (`banded_engine`). No plain version may run."""
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute.balancer import Balancer
    from tomahawk_tpu_torch.compute.engine import CalcSettings, LdEngine
    from tomahawk_tpu_torch.ops import _build
    from tomahawk_tpu_torch.ops.ld_math import LdFilters

    import torch
    filt = LdFilters(min_r2=MIN_R2)
    t0 = time.perf_counter()
    for _ in range(200):
        torch.cuda.mem_get_info()
    _say(f"torch.cuda.mem_get_info (the pipeline's depth gate): "
         f"{(time.perf_counter() - t0) / 200 * 1e6:.1f} us a call")
    jobs = (
        ("sparse", lambda: workloads.build_planes(64, B, N_SAMPLES), 64,
         "phased", False),
        ("dense", lambda: workloads.build_planes_grouped(16, B, N_SAMPLES),
         16, "phased", False),
        ("unphased P=4", lambda: genotype_planes(
            16, 0.0, seed=11, group=1, flip=0.0), 16, "unphased", False),
        ("unphased P=9", lambda: genotype_planes(
            16, 0.02, seed=12, group=1, flip=0.0, miss_rows=1.0), 16,
         "unphased", True),
        ("mixed", lambda: genotype_planes(16, 0.02, seed=13), 16, "mixed",
         True))
    _build.reset_counts()
    rows = []
    for tag, build, nb, table, miss in jobs:
        t0 = time.perf_counter()
        stacked = build()
        engine = LdEngine(stacked, N_SAMPLES, CalcSettings(min_r2=MIN_R2),
                          "cuda")
        depths = _watch_depth(engine)
        pairs = [(i, j, i == j) for i in range(nb) for j in range(i, nb)]
        n_pairs = nb * B * (nb * B - 1) // 2
        _say(f"engine {tag}: {nb} x {B} variants built in "
             f"{time.perf_counter() - t0:.1f}s, {len(pairs)} tiles, "
             f"{n_pairs} pairs")
        if table == "mixed":
            sweep = lambda emit: engine.run_mixed_pairs(pairs, filt, emit)
            stat_key = "unphased/miss/missing"
        else:
            run = (engine.run_phased_pairs if table == "phased"
                   else engine.run_unphased_pairs)
            sweep = lambda emit: run(pairs, miss, filt, emit)
            stat_key = f"{table}/{'miss' if miss else 'nomiss'}/all"
        name = tag.replace(" ", "_").replace("=", "")
        done0 = engine.units_done
        walls = _time_engine(work, name, sweep, n_pairs, stat_key, engine)
        row = dict(workload=tag, tiles=len(pairs), depth=sorted(set(depths)),
                   segments=(engine.units_done - done0) // len(walls),
                   wall_s=walls)
        _say(f"  pipeline depth taken {row['depth']}, {row['segments']} "
             f"segments a rep")
        row["traced"] = _profile_engine(tag, sweep, len(pairs))
        if tag == "sparse":
            row["python_loop_wall_s"] = _python_loop_reps(
                work, name, sweep, n_pairs, stat_key, engine)
            tr = row["traced"]
            _say(f"  sparse: wall {tr['wall_ms'] / len(pairs):.4f} ms a tile "
                 f"traced ({min(walls[1:]) * 1e3 / len(pairs):.4f} "
                 f"untraced) against device {tr['device_busy_ms'] / len(pairs):.4f} "
                 f"ms a tile; with the tile loop in Python "
                 f"{min(row['python_loop_wall_s']) * 1e3 / len(pairs):.4f}")
        if tag in ("dense", "mixed"):
            # the same engine with one segment at a time: the overlap,
            # read on one machine
            _serial(engine)
            del depths[:]
            row["serial_wall_s"] = _time_engine(work, name, sweep, n_pairs,
                                                stat_key, engine,
                                                reps=("serial",))
            row["serial_traced"] = _profile_engine(f"{tag} serial", sweep,
                                                   len(pairs))
            if set(depths) != {1}:
                raise SystemExit(f"engine {tag}: the serial rep took depth "
                                 f"{sorted(set(depths))}")
            row["fisher"] = _fisher_reps(work, tag, stacked, pairs, table,
                                         miss, n_pairs, filt)
        rows.append(row)
        del engine
        if tag != "sparse":
            continue
        rows.append(banded_engine(work, stacked, nb, filt))
        # the same planes in window mode: the tiles window_pairs keeps,
        # rated in candidate pairs (what the window leaves of each tile)
        ranges = workloads.super_ranges(stacked)
        for window in WINDOWS:
            wpairs = Balancer.build(nb).window_pairs(*ranges, window)
            engine = LdEngine(stacked, N_SAMPLES, CalcSettings(
                min_r2=MIN_R2, window=True, l_window=window), "cuda")
            depths = _watch_depth(engine)
            n_cand = engine.run_phased_pairs(wpairs, False, filt,
                                             lambda recs, rev=None: None)
            _say(f"engine sparse, window {window}: {len(wpairs)} of "
                 f"{len(pairs)} tiles swept, {n_cand} candidate pairs "
                 f"({n_cand / (len(wpairs) * B * B):.4f} of the swept "
                 f"tiles' pairs)")
            wsweep = lambda emit: engine.run_phased_pairs(wpairs, False,
                                                          filt, emit)
            done0 = engine.units_done
            walls = _time_engine(work, f"sparse_w{window}", wsweep, n_cand,
                                 stat_key, engine)
            row = dict(workload=f"sparse, window {window}",
                       tiles=len(wpairs), depth=sorted(set(depths)),
                       segments=(engine.units_done - done0) // len(walls),
                       wall_s=walls)
            _say(f"  pipeline depth taken {row['depth']}, {row['segments']} "
                 f"segments a rep")
            row["traced"] = _profile_engine(f"sparse, window {window}",
                                            wsweep, len(wpairs))
            if window == WINDOWS[0]:
                row["python_loop_wall_s"] = _python_loop_reps(
                    work, f"sparse_w{window}", wsweep, n_cand, stat_key,
                    engine)
                _serial(engine)
                row["serial_wall_s"] = _time_engine(
                    work, f"sparse_w{window}", wsweep, n_cand, stat_key,
                    engine, reps=("serial", "serial2"))
                # pipelined again, without the Fisher launch and then with
                # it: whether that launch is what holds the pipeline back
                engine._pipeline_enabled = True
                engine._device_fisher = False
                row["fisher_off_wall_s"] = _time_engine(
                    work, f"sparse_w{window}", wsweep, n_cand, stat_key,
                    engine, reps=("pipelined, Fisher off",
                                  "pipelined, Fisher off 2"))
                engine._device_fisher = True
                row["again_wall_s"] = _time_engine(
                    work, f"sparse_w{window}", wsweep, n_cand, stat_key,
                    engine, reps=("pipelined again", "pipelined again 2"))
                # and with the interpreter handing the GIL between the
                # two threads every 0.1 ms in place of every 5 ms
                interval = sys.getswitchinterval()
                sys.setswitchinterval(1e-4)
                try:
                    row["switch_0.1ms_wall_s"] = _time_engine(
                        work, f"sparse_w{window}", wsweep, n_cand,
                        stat_key, engine,
                        reps=("pipelined, GIL switch 0.1 ms",
                              "pipelined, GIL switch 0.1 ms 2"))
                finally:
                    sys.setswitchinterval(interval)
            rows.append(row)
            del engine
        del stacked
    _say(json.dumps({"engine_rows": rows}))
    if any(_build.PLAIN_CALLS.values()):
        raise SystemExit(f"an engine workload took a plain version on "
                         f"CUDA: {_build.PLAIN_CALLS}")


def _fisher_reps(work, tag, stacked, pairs, table, miss, n_pairs, filt):
    """The dense or mixed workload with the in-sweep Fisher bracket on (the
    default) and off (TWK_DEVICE_FISHER=0), each on a fresh engine, on
    then off: a warm-up rep and two timed reps, the host's math_s of each
    rep (summed over the sweep groups; the bracket spares the host's
    exact Fisher where a row has one), then one traced rep with its idle
    share. Returns {"on" / "off": dict}."""
    from tomahawk_tpu_torch.compute.engine import CalcSettings, LdEngine
    res = {}
    saved = os.environ.get("TWK_DEVICE_FISHER")
    for state, flag in (("on", "1"), ("off", "0")):
        os.environ["TWK_DEVICE_FISHER"] = flag
        try:
            engine = LdEngine(stacked, N_SAMPLES,
                              CalcSettings(min_r2=MIN_R2), "cuda")
        finally:
            if saved is None:
                os.environ.pop("TWK_DEVICE_FISHER")
            else:
                os.environ["TWK_DEVICE_FISHER"] = saved
        if table == "mixed":
            sweep = lambda emit: engine.run_mixed_pairs(pairs, filt, emit)
        else:
            sweep = lambda emit: engine.run_phased_pairs(pairs, miss, filt,
                                                         emit)
        math = lambda: sum(v["math_s"] for v in engine.stats.values())
        walls, maths = [], []
        _say(f"engine {tag}, in-sweep Fisher {state}:")
        for rep in ("warmup", "rep0", "rep1"):
            m0 = math()
            walls.append(_one_rep(work, f"{tag}_fisher_{state}", rep, sweep,
                                  n_pairs))
            maths.append(math() - m0)
        traced = _profile_engine(f"{tag}, in-sweep Fisher {state}", sweep,
                                 len(pairs))
        res[state] = dict(wall_s=walls, math_s=maths,
                          traced_wall_ms=traced["wall_ms"],
                          idle_share=traced["idle_share"],
                          device_busy_ms=traced["device_busy_ms"])
        _say(f"  Fisher {state}: wall {[round(w, 4) for w in walls]} s, "
             f"math_s {[round(m, 4) for m in maths]} s a rep, traced "
             f"{traced['wall_ms']:.1f} ms, idle {traced['idle_share']:.4f}")
        engine.stage_close()
        del engine
    return res


def _one_rep(work, tag, rep, run, n_pairs):
    """One rep of an engine workload into a .two file: the wall, s."""
    from tomahawk_tpu_torch.compute.engine import _reverse_records
    from tomahawk_tpu_torch.io.header import VcfContig, VcfHeader
    from tomahawk_tpu_torch.io.two import TwoWriter
    hdr = VcfHeader(samples=[f"S{i}" for i in range(N_SAMPLES)],
                    contigs=[VcfContig(idx=0, name="bench")])
    writer = TwoWriter(os.path.join(work, f"{tag}_{rep}.two"), hdr)

    def emit(recs, rev=None):
        writer.add(recs)
        writer.add(rev if rev is not None else _reverse_records(recs))
    t0 = time.perf_counter()
    run(emit)
    writer.close()
    dt = time.perf_counter() - t0
    _say(f"  {rep}: {dt:.3f}s, {n_pairs / dt:.0f} pairs/s")
    return dt


def banded_engine(work, stacked, nb, filt):
    """The sparse planes banded by `-M BANDED_ROW_GB` through the engine's
    load loop (`run_loads`, what `compute_ld` calls) with the staging
    worker: the plan `compute_ld` makes (4 bands, 10 loads), a fresh
    engine a rep, each band's planes cut from `stacked` by the provider
    (the archive's inflation in `calc`). Three timed reps with their
    stage_stats, then one traced. Returns the row."""
    from tomahawk_tpu_torch.compute.engine import (CalcSettings, LdEngine,
                                                   _plan_loads, _plane_budget,
                                                   run_loads)
    settings = CalcSettings(min_r2=MIN_R2, memory_gb=BANDED_ROW_GB)
    budget, per_super = _plane_budget(settings, N_SAMPLES, B, 1)
    pairs = [(i, j, i == j) for i in range(nb) for j in range(i, nb)]
    bands, loads = _plan_loads(list(range(nb)), pairs, budget, parts=3)
    sizes = [len(b) for b in bands]
    _say(f"engine sparse banded by -M {BANDED_ROW_GB}: budget {budget} of "
         f"{nb} super-blocks ({per_super} B of planes each), bands {sizes}, "
         f"{len(loads)} loads")
    if (budget, sizes, len(loads)) != (58, [19, 19, 19, 7], 10):
        raise SystemExit("the banded sparse row's plan is not 58: 19 / 19 / "
                         "19 / 7, 10 loads")
    # seconds and calls of the provider, by thread: the main thread's
    # (a band loaded on demand) against the staging worker's
    made, lock = {}, threading.Lock()

    def provider(b):
        t0 = time.perf_counter()
        out = {k: v[bands[b]] for k, v in stacked.items()}
        who = threading.current_thread().name.split("_")[0]
        with lock:
            s, n = made.get(who, (0.0, 0))
            made[who] = (s + time.perf_counter() - t0, n + 1)
        return out
    engines, depths = [], []

    def run(emit):
        engine = LdEngine(None, N_SAMPLES, settings, "cuda", B=B)
        depths.append(_watch_depth(engine))
        engines.append(engine)
        try:
            return run_loads(engine, bands, loads, provider, "phased", filt,
                             emit, prefetch=True)
        finally:
            engine.stage_close()
            ss = dict(engine.stage_stats, n_uploads=engine.n_band_uploads)
            _say(f"    stage_stats {json.dumps(ss)}; bands made (s, calls) "
                 f"by thread {made}")
            made.clear()
    n_pairs = nb * B * (nb * B - 1) // 2
    walls = _time_engine(work, "sparse_banded", run, n_pairs,
                         "phased/nomiss/all", lambda: engines[-1])
    traced = _profile_engine("sparse banded", run, len(pairs))
    depth = sorted({d for seen in depths for d in seen})
    _say(f"  pipeline depth taken {depth}")
    row = dict(workload=f"sparse banded -M {BANDED_ROW_GB}", tiles=len(pairs),
               bands=sizes, loads=len(loads), depth=depth, wall_s=walls,
               traced=traced,
               stage_stats=[dict(e.stage_stats, n_uploads=e.n_band_uploads)
                            for e in engines])
    return row


def dcn_engine():
    """`LdEngine.run_phased_pairs` over the first DCN_BLOCKS blocks of
    the sparse planes as two samples-sharded ranks on the one card, and
    the time per tile of each step of the sweep. Returns rank 0's
    report."""
    coordinator = f"127.0.0.1:{_free_port()}"
    reports = spawn_ranks("engine dcn", [
        dict(kind="engine", rank=r, coordinator=coordinator) for r in (0, 1)])
    for rep in reports:
        _check_counts(f"engine dcn rank {rep['rank']}", rep["launches"],
                      rep["plain"],
                      ("local_parts", "tile_epilogue", "compact"),
                      ("phased_tile", "parts_tile"))
    a, b = reports
    if (a["candidates"], a["records"]) != (b["candidates"], b["records"]):
        raise SystemExit(f"engine dcn: the ranks disagree: {a} {b}")
    if [r["records"] for r in a["dense"]["runs"]] \
            != [r["records"] for r in b["dense"]["runs"]]:
        raise SystemExit("engine dcn dense: the ranks disagree")
    _say(f"engine dcn, two ranks sharing one card, collectives over gloo: "
         f"{DCN_BLOCKS} x {B} sparse variants, {a['tiles']} tiles, "
         f"{a['pairs']} pairs")
    for rep in reports:
        _say(f"  rank {rep['rank']}: {rep['wall_s']:.3f}s, "
             f"{rep['pairs'] / rep['wall_s']:.0f} pairs/s, {rep['records']} "
             f"records; host math_s {rep['math_s']:.4f} (gathers "
             f"{rep['gather_s']:.4f}) on {rep['math_rows']} of "
             f"{rep['survivor_rows']} survivor rows; ms per tile "
             f"{rep['ms_per_tile']}")
    _say(f"engine dcn dense: {DCN_DENSE_BLOCKS} x {B} LD-grouped variants, "
         f"{a['dense']['tiles']} tiles, host math split over the ranks "
         f"and whole on each, in turns")
    for rep in reports:
        for r in rep["dense"]["runs"]:
            _say(f"  rank {rep['rank']} {r['way']}: {r['wall_s']:.3f}s, "
                 f"{r['records']} records; math_s {r['math_s']:.4f} "
                 f"(gathers {r['gather_s']:.4f}) on {r['math_rows']} of "
                 f"{r['survivor_rows']} rows")
    _say(json.dumps({"dcn_engine": reports}))
    return a


def mesh_engine(dcn):
    """`LdEngine.run_phased_pairs` over the dcn row's tiles (the first
    DCN_BLOCKS blocks of the sparse planes) on a 1 x 2 mesh over the one
    card repeated: each tile's two word slices through local_parts, their
    sum on the device (parallel.SamplesGroup, in place of the dcn row's
    gloo all-reduce), tile_epilogue and compact. A warm-up run, then
    MESH_REPS timed runs, the launches counted over them (local_parts,
    tile_epilogue and compact, no fused kernel, no plain version); their
    candidates and records equal the dcn row's; then the same tiles once
    more step by step between CUDA events. Returns the report."""
    import torch
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute.engine import CalcSettings, LdEngine
    from tomahawk_tpu_torch.ops import _build, tiles
    from tomahawk_tpu_torch.ops.ld_math import LdFilters
    from tomahawk_tpu_torch.parallel import all_reduce_parts, make_mesh
    stacked = workloads.build_planes(DCN_BLOCKS, B, N_SAMPLES)
    engine = LdEngine(stacked, N_SAMPLES, CalcSettings(min_r2=MIN_R2),
                      mesh=make_mesh(1, 2, ["cuda:0", "cuda:0"]))
    pairs = [(i, j, i == j) for i in range(DCN_BLOCKS)
             for j in range(i, DCN_BLOCKS)]
    filt = LdFilters(min_r2=MIN_R2)
    n_rec = [0]

    def emit(recs, rev=None):
        n_rec[0] += 2 * len(recs)

    try:
        engine.run_phased_pairs(pairs, False, filt, emit)
        torch.cuda.synchronize()
        _build.reset_counts()
        walls = []
        for _ in range(MESH_REPS):
            n_rec[0] = 0
            t0 = time.perf_counter()
            n_cand = engine.run_phased_pairs(pairs, False, filt, emit)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        _check_counts("engine 1x2 mesh", dict(_build.LAUNCHES),
                      dict(_build.PLAIN_CALLS),
                      ("local_parts", "tile_epilogue", "compact"),
                      ("phased_tile", "parts_tile"))
        if (int(n_cand), n_rec[0]) != (dcn["candidates"], dcn["records"]):
            raise SystemExit(f"engine 1x2 mesh: {int(n_cand)} candidates, "
                             f"{n_rec[0]} records; the dcn row "
                             f"{dcn['candidates']}, {dcn['records']}")
        cfg = engine._cfg("phased", False, "all")
        row = engine.bands.dev_for(cfg)[0]
        group = engine._row_cfg(cfg, 0, row)["psum_group"]
        peer_out = group.peers[0][1]
        ms = _step_times(cfg, row[0], pairs, (
            ("local_parts slice 0", lambda i, j, out:
             tiles.tile_local_parts(row[0], i, j, cfg, out)),
            ("local_parts slice 1", lambda i, j, out:
             tiles.tile_local_parts(row[1], i, j, cfg, peer_out)),
            ("sum on the card", lambda i, j, out:
             all_reduce_parts(out[1], group))))
    finally:
        engine.stage_close()
    tile_ms = sum(ms.values())
    nv = DCN_BLOCKS * B
    rep = dict(tiles=len(pairs), pairs=nv * (nv - 1) // 2,
               candidates=int(n_cand), records=n_rec[0], wall_s=walls,
               ms_per_tile=ms, ms_per_tile_sum=tile_ms,
               math_s=sum(s["math_s"] for s in engine.stats.values())
               / (MESH_REPS + 1))
    _say(f"engine 1x2 mesh on the one card: {DCN_BLOCKS} x {B} sparse "
         f"variants, {len(pairs)} tiles: walls {walls} s, "
         f"{rep['pairs'] / min(walls):.0f} pairs/s at best, {n_rec[0]} "
         f"records (the dcn row's); ms per tile {ms}, {tile_ms:.4f} in all "
         f"(the dcn row's all-reduce alone: "
         f"{dcn['ms_per_tile']['all_reduce']:.4f})")
    _say(json.dumps({"mesh_engine": rep}))
    return rep


def _step_times(cfg, dev, pairs, steps):
    """ms per tile of each step of a samples-sharded tile over `pairs`,
    CUDA events around each, the calls queued back to back: `steps`, the
    (name, fn(i, j, out)) that leave a tile's global parts in out[1],
    then the epilogue and the compaction on `dev`'s card, handed the
    epilogue's counts."""
    import torch
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import tiles
    device = dev["valid"].device
    out = tiles.tile_buffers(cfg, device)
    counts = tiles.counts_buffer(cfg, device)
    buf = torch.zeros((1 << 18, sweeps.buf_cols(cfg)), dtype=torch.int32,
                      device=device)
    n_pass, n_cnd = (torch.zeros(len(pairs), dtype=torch.int32, device=device)
                     for _ in range(2))
    off = torch.zeros(1, dtype=torch.int32, device=device)
    names = [name for name, _ in steps] + ["tile_epilogue", "compact"]
    marks = []
    for t, (i, j, diag) in enumerate(pairs):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(names) + 1)]
        ev[0].record()
        for k, (_, fn) in enumerate(steps):
            fn(i, j, out)
            ev[k + 1].record()
        tiles.tile_epilogue(dev, i, j, diag, cfg, out, counts)
        ev[-2].record()
        sweeps.compact_survivors(*out, off, buf, n_pass, n_cnd, t, 256,
                                 counts)
        ev[-1].record()
        marks.append(ev)
    torch.cuda.synchronize()
    return {name: sum(ev[k].elapsed_time(ev[k + 1]) for ev in marks)
            / len(marks) for k, name in enumerate(names)}


def rank_engine(job):
    """One rank of `dcn_engine` (or of `multi`'s dcn rows): the engine
    run on the clock, then the same tiles once more step by step between
    CUDA events on the rank's card of row 0, then (`dense`, by default)
    `rank_dense`. The job's `n` ranks (2 by default) mesh by its `spec`
    ('dcn' by default)."""
    import torch
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.compute.engine import CalcSettings, LdEngine
    from tomahawk_tpu_torch.ops import tiles
    from tomahawk_tpu_torch.ops.ld_math import LdFilters
    from tomahawk_tpu_torch.parallel import distributed as dist
    rank, spec = job["rank"], job.get("spec", "dcn")
    cards = dist.process_devices("cuda", rank, spec)
    device = cards[0]
    dist.init_distributed(job["coordinator"], job.get("n", 2), rank, device,
                          rows=cards)
    try:
        group = dist.group()
        row0 = group.rows[0]
        stacked = workloads.build_planes(DCN_BLOCKS, B, N_SAMPLES)
        engine = LdEngine(stacked, N_SAMPLES, CalcSettings(min_r2=MIN_R2),
                          mesh=dist.make_dcn_mesh(spec, "cuda"))
        pairs = [(i, j, i == j) for i in range(DCN_BLOCKS)
                 for j in range(i, DCN_BLOCKS)]
        n_rec = [0]

        def emit(recs, rev=None):
            n_rec[0] += 2 * len(recs)

        cfg = engine._cfg("phased", False, "all")
        dev = engine.bands.dev_for(cfg)[0][0]
        out = tiles.tile_buffers(cfg, device)
        counts = tiles.counts_buffer(cfg, device)
        # warm-up: one tile through every step, and a reduction on every
        # row (NCCL makes a row's communicator at its first collective)
        tiles.tile_local_parts(dev, 0, 1, cfg, out)
        dist.all_reduce_parts(out[1], row0)
        tiles.tile_epilogue(dev, 0, 1, False, cfg, out, counts)
        for row in group.rows[1:]:
            with torch.cuda.device(row.device):
                dist.all_reduce_parts(torch.zeros(
                    1, dtype=torch.int32, device=row.device), row)
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        dist.sync_shards()
        t0 = time.perf_counter()
        n_cand = engine.run_phased_pairs(pairs, False,
                                         LdFilters(min_r2=MIN_R2), emit)
        wall = time.perf_counter() - t0

        ms = _step_times(cfg, dev, pairs, (
            ("local_parts", lambda i, j, out:
             tiles.tile_local_parts(dev, i, j, cfg, out)),
            ("all_reduce", lambda i, j, out:
             dist.all_reduce_parts(out[1], row0))))
        dist.sync_shards()
        dense = rank_dense(device) if job.get("dense", True) else None
    finally:
        dist.shutdown()
    nv = DCN_BLOCKS * B
    return dict(tiles=len(pairs), pairs=nv * (nv - 1) // 2,
                candidates=int(n_cand), records=n_rec[0], wall_s=wall,
                ms_per_tile=ms,
                math_s=sum(s["math_s"] for s in engine.stats.values()),
                gather_s=engine.gather_s, math_rows=engine.math_rows,
                survivor_rows=engine.survivor_rows, dense=dense)


def rank_dense(device):
    """The second job of a `dcn_engine` rank: the first DCN_DENSE_BLOCKS
    blocks of the records-dense planes, run with the host math split
    over the ranks (`LdEngine._dcn_records`: each rank's slice of the
    survivor rows, the records gathered) and with a stand-in set up here
    for what the split replaced (every rank runs the math of every row
    and gathers nothing), in turns: split, whole, whole, split, after a
    warm-up. Each run's wall, math_s, the gathers' share of it and the
    rows this rank ran; the records of every run equal."""
    import torch
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute import engine as eng
    from tomahawk_tpu_torch.ops.ld_math import LdFilters
    from tomahawk_tpu_torch.parallel import distributed as dist
    stacked = workloads.build_planes_grouped(DCN_DENSE_BLOCKS, B, N_SAMPLES)
    engine = eng.LdEngine(stacked, N_SAMPLES,
                          eng.CalcSettings(min_r2=MIN_R2),
                          mesh=dist.make_dcn_mesh("dcn", device))
    pairs = [(i, j, i == j) for i in range(DCN_DENSE_BLOCKS)
             for j in range(i, DCN_DENSE_BLOCKS)]
    split = engine._dcn_records

    def whole(table, data, meta, filt, p_pre=None):
        engine.math_rows += len(data)
        engine.survivor_rows += len(data)
        out = eng.ld_records(table, data, meta, filt, p_pre=p_pre)
        if out is None:
            raise SystemExit("engine dcn dense: no native library")
        return out[0], out[1]

    def state():
        return (sum(s["math_s"] for s in engine.stats.values()),
                engine.gather_s, engine.math_rows, engine.survivor_rows)

    runs = []
    for way in ("warm-up", "split", "whole", "whole", "split"):
        engine._dcn_records = whole if way == "whole" else split
        n_rec = [0]

        def emit(recs, rev=None):
            n_rec[0] += 2 * len(recs)

        before = state()
        dist.sync_shards()
        t0 = time.perf_counter()
        engine.run_phased_pairs(pairs, False, LdFilters(min_r2=MIN_R2),
                                emit)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d = [b - a for a, b in zip(before, state())]
        runs.append(dict(way=way, wall_s=wall, math_s=d[0], gather_s=d[1],
                         math_rows=d[2], survivor_rows=d[3],
                         records=n_rec[0]))
    engine.stage_close()
    if len({r["records"] for r in runs}) != 1:
        raise SystemExit(f"engine dcn dense: the runs' records differ: "
                         f"{runs}")
    return dict(tiles=len(pairs), runs=runs[1:])


def rank_main(job):
    """`python3 chip_smoke.py rank <job>`: one rank of a two-rank phase.
    Runs the job with the counts set to 0 just before it and prints them
    just after, with the job's own results, as one JSON object on the
    last line."""
    from tomahawk_tpu_torch.ops import _build
    _build.reset_counts()
    extra = {}
    if job["kind"] == "calc":
        _run_cli(job["argv"])
    else:
        extra = rank_engine(job)
    from tomahawk_tpu_torch.parallel.distributed import card_id
    cards = {card_id(d): v for d, v in _build.LAUNCHES_BY_CARD.items()}
    print(json.dumps(dict(rank=job["rank"], launches=dict(_build.LAUNCHES),
                          plain=dict(_build.PLAIN_CALLS), cards=cards,
                          **extra)), flush=True)
    return 0


def tile_bytes(table, has_missing):
    """Bytes one fused tile kernel call moves at this script's shape,
    each input read once and each output written once: the word planes
    and 9 bytes of metadata a variant on both sides, the mask, the P
    parts and the counts buffer."""
    from tomahawk_tpu_torch.ops.bitpack import words_for
    from tomahawk_tpu_torch.ops.tiles import payload_cols, plane_keys
    P = payload_cols(table, has_missing)
    W = words_for((2 if table == "phased" else 1) * N_SAMPLES)
    return (2 * len(plane_keys(table, has_missing)) * B * W * 4 + 2 * B * 9
            + B * B * (1 + 4 * P) + B * (B // 128) * 4)


def kernel_bounds(n_survivors):
    """{kernel: (bound_ms, bound_by)} at the shapes the kernels line
    reports: the larger of operations over the 1-bit MMA's rate and bytes
    moved once over the HBM rate (`_bound`). phased_tile: the -p tile
    (P = 1, W = 160); parts_tile: the mixed dispatch's unphased 9-part
    tile (W = 80); compact: the timed 1-part call with the counts given,
    its mask and counts read once plus, for each of the `n_survivors`
    rows it keeps, one part gathered and 2 columns written (one
    comparison per mask byte is its arithmetic, far under the byte
    time)."""
    out = {"compact": (compact_bound_ms(1, 2, n_survivors), "bytes")}
    for name, group in (("phased_tile", ("phased", False)),
                        ("parts_tile", MAIN_GROUP[:2])):
        out[name] = _bound(contraction_pair_words(*group),
                           tile_bytes(*group))
    return out


def compact_bound_ms(P, ncol, n_survivors):
    """compact's bound at B = 4096 with the counts given, ms: the mask and
    the counts read once and, for each of the `n_survivors` rows it keeps,
    its P parts gathered and its `ncol` buffer columns written, over the
    HBM rate (one comparison a mask byte is its arithmetic, far under the
    byte time)."""
    return ((B * B + B * (B // 128) * 4 + n_survivors * (P + ncol) * 4)
            / HBM_BYTES_PER_S * 1e3)


def contraction_pair_words(table, has_missing, slices=1):
    """P * B * B * W of one tile of a sweep group at this script's shape,
    W the words a rank holds when the planes are cut in `slices`."""
    from tomahawk_tpu_torch.ops.bitpack import words_for
    from tomahawk_tpu_torch.ops.tiles import payload_cols
    W = words_for((2 if table == "phased" else 1) * N_SAMPLES)
    return payload_cols(table, has_missing) * B * B * -(-W // slices)


def report_cards():
    """Every visible card: torch's name and UUID, nvidia-smi's name and
    power limit (one line a card, the same query as `report_card`), and
    which pairs of cards reach each other's memory
    (`torch.cuda.can_device_access_peer`: the copies between cards of a
    local mesh go over NVLink, else through the host)."""
    import torch
    from tomahawk_tpu_torch.parallel.distributed import card_id
    n = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    nccl = torch.cuda.nccl.version()
    _say(f"devices: {n} x {torch.cuda.get_device_name(0)} (torch "
         f"{torch.__version__}, CUDA {torch.version.cuda}, NCCL "
         f"{'.'.join(map(str, nccl)) if isinstance(nccl, tuple) else nccl})")
    for i in range(n):
        _say(f"  card {i}: {card_id(i)}")
    for line in smi:
        _say(f"nvidia-smi: {line}")
    peer = [[i == j or torch.cuda.can_device_access_peer(i, j)
             for j in range(n)] for i in range(n)]
    _say(f"peer access (can_device_access_peer): {peer}")


def _local_by_card():
    """This process's launches by card since the counts were last set to
    0, by card index."""
    from tomahawk_tpu_torch.ops import _build
    return {int(d.split(":")[1]): dict(v)
            for d, v in _build.LAUNCHES_BY_CARD.items()}


def _by_index(card_reports):
    """Launches by card of one process or several ({card UUID: {kernel:
    n}} each), summed by this process's card index."""
    import torch
    from tomahawk_tpu_torch.parallel.distributed import card_id
    index = {card_id(i): i for i in range(torch.cuda.device_count())}
    out = {}
    for rep in card_reports:
        _add_cards(out, {index[ident]: counts
                         for ident, counts in rep.items()})
    return out


def _add_cards(tally, by_card):
    """Add launches by card into `tally` (nothing where it is None)."""
    for card, counts in by_card.items() if tally is not None else ():
        dst = tally.setdefault(card, {})
        for k, v in counts.items():
            dst[k] = dst.get(k, 0) + v


def _check_cards(label, by_card, need, idle):
    """Each card in `need` ({card index: kernels}) launched each of its
    kernels; no card launched a kernel of `idle`, and no card outside
    `need` launched anything."""
    for card, names in need.items():
        missing = sorted(k for k in names if not by_card.get(card, {}).get(k))
        if missing:
            raise SystemExit(f"{label}: card {card} did not launch "
                             f"{missing}: {by_card}")
    for card, counts in by_card.items():
        stray = sorted(k for k, v in counts.items()
                       if v and (k in idle or card not in need))
        if stray:
            raise SystemExit(f"{label}: card {card} launched {stray}, which "
                             f"its place in the mesh does not hold: "
                             f"{by_card}")
    _say(f"  launches by card: {by_card}")


def _local_cards(kind, P, S):
    """{card: kernels} a P x S mesh over cards 0 .. P*S - 1 must launch:
    with S = 1 every card its pairs shard's fused kernels (`kind`) and
    compact; with S > 1 every card local_parts, and each row's first
    card the epilogue and compact too."""
    if S == 1:
        return {c: kind + ("compact",) for c in range(P)}
    split = ("local_parts", "tile_epilogue", "compact")
    return {c: split if c % S == 0 else split[:1] for c in range(P * S)}


#: the sweep groups of `multi`'s paths: -p's, and the mixed dispatch's
MULTI_GROUPS = (("phased", False, "all"), ("phased", False, "clean"),
                ("unphased", True, "missing"))
#: the word slices of `multi`'s samples-sharded paths (2x2 and dcn:2, 1x4
#: and dcn over four ranks)
MULTI_SLICES = (2, 4)
#: every wrapper `multi`'s paths launch
MULTI_KERNELS = ("phased_tile", "parts_tile", "local_parts", "tile_epilogue",
                 "compact", "fisher_bracket")


def hold_kernels_on(device, rows):
    """Each wrapper `multi`'s paths launch, on `device`, against its plain
    version at tiles of `rows` rows and 2,504 samples, every result
    torch.equal to the plain one: for each group of MULTI_GROUPS, on a
    diagonal and an off-diagonal tile of the genotype planes, the fused
    tile kernel (phased_tile or parts_tile) and its counts; local_parts
    on every word slice of each S in MULTI_SLICES, the slices' sum equal
    to the full width's plain parts; tile_epilogue and its counts on that
    sum; compact on the fused tiles' masks (the counts given, caps 32768
    and 256). Then fisher_bracket on the survivor rows of a phased
    fused sweep (cls "all" and "clean") of 4 LD-grouped super-blocks,
    whose 10 tiles open the volume gate. Raises SystemExit on a
    difference."""
    import torch
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.device import on_device
    from tomahawk_tpu_torch.ops import tiles
    at = f"{device}, {rows} rows"
    st = workloads.genotype_planes(2, rows, N_SAMPLES)
    with on_device(device):
        full = sweeps.planes_to_device(st, device)
        for group in MULTI_GROUPS:
            cfg = sweeps.make_cfg(*group, rows, N_SAMPLES, 0, MIN_R2, 100.0)
            keys = tiles.plane_keys(*group[:2])
            label = f"{tiles.kernel_name(cfg)} {'/'.join(map(str, group))}"
            slices = {S: [sweeps.planes_to_device(st, device, keys,
                                                  word_slice=(s, S))
                          for s in range(S)] for S in MULTI_SLICES}
            out = tiles.tile_buffers(cfg, device)
            fused = []
            for i, j, diag in ((1, 1, True), (0, 1, False)):
                where = f"{label} ({i},{j}) on {at}"
                counts = tiles.counts_buffer(cfg, device).fill_(-1)
                mask, parts = tiles.tile_prefilter(full, i, j, diag, cfg,
                                                   counts=counts)
                want_m, want_p = tiles.tile_prefilter_plain(full, i, j, diag,
                                                            cfg)
                if not (torch.equal(mask, want_m)
                        and torch.equal(parts, want_p)):
                    raise SystemExit(f"{where} differs from its plain "
                                     f"version")
                _check_counts_buffer(where, counts, mask)
                fused.append((mask, parts, counts))
                want = torch.stack(tiles.tile_local_parts_plain(full, i, j,
                                                                cfg))
                for S, devs in slices.items():
                    total = torch.zeros_like(want)
                    for s, dev in enumerate(devs):
                        got = tiles.tile_local_parts(dev, i, j, cfg, out)
                        if not torch.equal(got, torch.stack(
                                tiles.tile_local_parts_plain(dev, i, j,
                                                             cfg))):
                            raise SystemExit(
                                f"local_parts slice {s}/{S} of {where} "
                                f"differs from its plain version")
                        total += got
                    if not torch.equal(total, want):
                        raise SystemExit(f"local_parts of {where}: the {S} "
                                         f"slices do not sum to the plain "
                                         f"full-width parts")
                out[1].copy_(want)
                counts.fill_(-1)
                mask, _ = tiles.tile_epilogue(full, i, j, diag, cfg, out,
                                              counts)
                if not torch.equal(mask, tiles.tile_epilogue_plain(
                        full, i, j, diag, cfg, want)):
                    raise SystemExit(f"tile_epilogue of {where} differs "
                                     f"from its plain version")
                _check_counts_buffer(f"tile_epilogue of {where}", counts,
                                     mask)
                del want, total, want_m, want_p
            for cap in (32768, 256):
                outs = _compact_all_ways(fused, sweeps.buf_cols(cfg), cap, 2,
                                         device)
                if any(not torch.equal(a, b) for a, b in zip(*outs)):
                    raise SystemExit(f"compact on the masks of {label} on "
                                     f"{at} differs from its plain version")
            del out, fused, outs, slices
        del full
        nb = 4
        dev = sweeps.planes_to_device(
            workloads.build_planes_grouped(nb, rows, N_SAMPLES), device)
        pairs = [(i, j, i == j) for i in range(nb) for j in range(i, nb)]
        pi = np.array([p[0] for p in pairs], np.int32)
        pj = np.array([p[1] for p in pairs], np.int32)
        dg = np.array([p[2] for p in pairs])
        cap, outcap = 32768, 1 << 20
        for cls in ("all", "clean"):
            cfg = sweeps.make_cfg("phased", False, cls, rows, N_SAMPLES, 0,
                                  MIN_R2, 100.0, fisher=True)
            where = f"fisher_bracket phased/False/{cls} on {at}"
            n_pass, _, buf = sweeps.fused_sweep(
                dev, pi, pj, dg, np.ones(len(pairs), bool), cfg=cfg, cap=cap,
                outcap=outcap)
            if sweeps.fisher_rows(n_pass, cap, outcap) is None:
                raise SystemExit(f"{where}: {int(n_pass.sum())} survivors "
                                 f"do not open the gate")
            cleared = buf.clone()
            cleared[:, 1] &= 0xFFFF
            ker, ref = cleared.clone(), cleared.clone()
            sweeps.append_fisher_col(dev, n_pass, ker, pi, pj, cfg, cap)
            sweeps.append_fisher_col_plain(dev, n_pass, ref, pi, pj, cfg, cap)
            if not (torch.equal(ker, ref) and torch.equal(ker, buf)):
                raise SystemExit(f"{where}: the kernel's column differs from "
                                 f"its plain version's or the fused "
                                 f"sweep's")
        del dev, buf, cleared, ker, ref
    if device != "cpu":
        torch.cuda.empty_cache()
    _say(f"kernel check on {at}: {', '.join(MULTI_KERNELS)} equal to "
         f"their plain versions (groups {MULTI_GROUPS}, word slices "
         f"S = {MULTI_SLICES})")


def multi_kernels():
    """`hold_kernels_on` each of the four cards at tiles of
    MULTI_TILE_ROWS rows (paths r and t) and of B (path s and the timed
    rows); every card launched every kernel of MULTI_KERNELS in its own
    check, and no other card did."""
    from tomahawk_tpu_torch.ops import _build
    for c in range(MULTI_CARDS):
        _build.reset_counts()
        for rows in (MULTI_TILE_ROWS, B):
            hold_kernels_on(f"cuda:{c}", rows)
        _check_cards(f"kernel check on cuda:{c}", _local_by_card(),
                     {c: MULTI_KERNELS}, ())
    _build.reset_counts()


def multi_archives(work):
    """a's archive (phased, no missing data) and b's (missing genotypes
    in half of the first 12,288 sites), 16,384 sites each."""
    return (make_archive(work, "ld", 16384),
            make_archive(work, "miss", 16384, miss_sites=12288, miss_step=2,
                         miss_frac=0.025))


def multi_paths(work, ld, miss):
    """Paths r, s and t of `multi` on a's archive `ld` and b's `miss`,
    each with the counts set to 0 just before it and read just after;
    every path's records equal the native CPU engine's, every card of its
    mesh launched its kernels and no card a plain version. Returns the
    launches by card summed over the paths."""
    from tomahawk_tpu_torch.ops import _build
    two = os.path.join(work, "{}.two")
    fused = {"phased": ("phased_tile",),
             "mixed": ("phased_tile", "parts_tile")}
    split = ("local_parts", "tile_epilogue", "compact")
    total = {}
    # r: one process, meshes over the four cards; B = 1024 rows a tile
    # (136 tiles), so that every pairs shard of a segment holds live tiles
    # (and 2x2 banded by -M, the staging worker a stream on each card)
    runs = [(spec, P, S, tag, twk, mode, flags)
            for spec, P, S in MULTI_MESHES
            for tag, twk, mode, flags in (("a", ld, "phased", ["-p"]),
                                          ("b", miss, "mixed", []))]
    runs.append(("2x2", 2, 2, "a", ld, "phased",
                 ["-p", "-M", str(MULTI_BANDED_GB)]))
    for spec, P, S, tag, twk, mode, flags in runs:
        label = f"r --mesh {spec} {' '.join(flags)} on {tag}'s archive"
        out = two.format(f"r{spec}{tag}{len(flags)}")
        argv = ["tomahawk_tpu_torch", "calc", "-i", twk, "-o", out, "-r",
                str(MIN_R2), *flags, "--mesh", spec, "--tile-rows",
                str(MULTI_TILE_ROWS), *ON_CARD]
        _build.reset_counts()
        t0 = time.perf_counter()
        ss = _run_cli(argv).stage_stats
        dt = time.perf_counter() - t0
        if "-M" in flags and not (ss["n_loads"] > 1
                                  and ss["n_prefetched"] > 0):
            raise SystemExit(f"calc {label}: not banded and staged: {ss}")
        launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
        by_card = _local_by_card()
        _say(f"main path {label}: `calc {' '.join(argv[6:])}` "
             f"{dt:.2f}s wall, launches {launches}; {ss['n_bands']} "
             f"bands, {ss['n_loads']} loads, {ss['n_prefetched']} "
             f"staged")
        need = _local_cards(fused[mode], P, S)
        idle = split[:2] if S == 1 else ("phased_tile", "parts_tile")
        _check_counts(label, launches, plain, (), idle)
        _check_cards(label, by_card, need, idle)
        check_records(label, out, twk, mode)
        _add_cards(total, by_card)
    # s: four ranks, one card each, NCCL
    every = ("phased_tile", "parts_tile", "compact")
    idle_dcn = ("phased_tile", "parts_tile")
    own = [dict(CUDA_VISIBLE_DEVICES=str(k)) for k in range(MULTI_CARDS)]
    ranked = (
        ("s tile partition", miss, [], "mixed", every,
         split[:2], None, None),
        ("s dcn -p", ld, ["-p"], "phased", split, idle_dcn, "dcn", None),
        ("s dcn", miss, [], "mixed", split, idle_dcn, "dcn", None),
        ("s dcn -p, CUDA_VISIBLE_DEVICES=k a rank", ld, ["-p"], "phased",
         split, idle_dcn, "dcn", own),
        # t: two ranks on two cards each (rank 0 on 0-1, rank 1 on 2-3),
        # one NCCL group a row
        ("t dcn:2 -p", ld, ["-p", "--tile-rows", str(MULTI_TILE_ROWS)],
         "phased", split, idle_dcn, "dcn:2", None),
        ("t dcn:2", miss, ["--tile-rows", str(MULTI_TILE_ROWS)], "mixed",
         split, idle_dcn, "dcn:2", None))
    for label, twk, flags, mode, need, idle, dcn, envs in ranked:
        run_ranked_calc(label, twk, two.format("ranked"), flags, mode, need,
                        idle, dcn, n=2 if dcn == "dcn:2" else MULTI_CARDS,
                        envs=envs, cards={c: need for c in range(MULTI_CARDS)},
                        backend="nccl", tally=total)
    return total


def _shard_work(by_card, P, S):
    """(tile launches of each pairs shard, the cards of the shards that
    launched none) of a P x S mesh over cards 0 .. P*S - 1 from its
    launches by card: a shard's fused tile kernels (S = 1) or its first
    card's epilogues (S > 1), repairs included. Every shard's card runs
    the Fisher launch, whose gate is read on the device, so a card's
    launches alone do not tell an idle shard."""
    kinds = ("phased_tile", "parts_tile") if S == 1 else ("tile_epilogue",)
    shard = [sum(by_card.get(p * S, {}).get(k, 0) for k in kinds)
             for p in range(P)]
    return shard, [p * S + s for p in range(P) if not shard[p]
                   for s in range(S)]


def multi_idle(work, ld):
    """The meshes of MULTI_IDLE on a's archive `ld` at the default tile
    rows (10 tiles), records against the native CPU engine's, no plain
    version: how the tiles fall to the pairs
    shards (a segment is padded to 16 tiles a shard and split into
    contiguous slices, so a small load leaves later shards only dead
    tiles) and which cards' shards ran no tile (`_shard_work`),
    measured, not required.
    Prints the `multi_idle` JSON line; returns its runs."""
    from tomahawk_tpu_torch.ops import _build
    runs = []
    for spec, P, S, flags in MULTI_IDLE:
        label = f"idle --mesh {spec} {' '.join(flags)} on a's archive"
        out = os.path.join(work, f"idle{spec}.two")
        argv = ["tomahawk_tpu_torch", "calc", "-i", ld, "-o", out, "-r",
                str(MIN_R2), *flags, "--mesh", spec, *ON_CARD]
        _build.reset_counts()
        t0 = time.perf_counter()
        ss = _run_cli(argv).stage_stats
        dt = time.perf_counter() - t0
        by_card = _local_by_card()
        _check_counts(label, dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS),
                      (), ())
        check_records(label, out, ld, "phased")
        shard, idle = _shard_work(by_card, P, S)
        runs.append(dict(mesh=spec, flags=flags, wall_s=dt,
                         bands=ss["n_bands"], loads=ss["n_loads"],
                         tile_launches_by_shard=shard, idle_cards=idle,
                         launches_by_card=by_card))
        _say(f"main path {label}: `calc {' '.join(argv[6:])}` {dt:.2f}s "
             f"wall, {ss['n_bands']} bands, {ss['n_loads']} loads; tile "
             f"launches by pairs shard {shard}, cards of shards that ran "
             f"no tile {idle}; launches by card {by_card}")
    _say(json.dumps({"multi_idle": runs}))
    return runs


def multi_sparse():
    """The sparse planes (64 x 4096 random phased variants, 2,080 tiles)
    through `LdEngine.run_phased_pairs` on one card and on a 4 x 1 mesh
    over the four cards, a warm-up each, then MULTI_REPS reps each in
    turns; candidates and records equal; every card of the mesh launched
    phased_tile and compact in the mesh's reps. Returns the row."""
    import torch
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute.engine import CalcSettings, LdEngine
    from tomahawk_tpu_torch.ops import _build
    from tomahawk_tpu_torch.ops.ld_math import LdFilters
    from tomahawk_tpu_torch.parallel import make_mesh
    stacked = workloads.build_planes(64, B, N_SAMPLES)
    pairs = [(i, j, i == j) for i in range(64) for j in range(i, 64)]
    filt = LdFilters(min_r2=MIN_R2)
    engines = {"one card": LdEngine(stacked, N_SAMPLES,
                                    CalcSettings(min_r2=MIN_R2), "cuda:0"),
               "4x1": LdEngine(stacked, N_SAMPLES,
                               CalcSettings(min_r2=MIN_R2),
                               mesh=make_mesh(MULTI_CARDS, 1))}
    walls = {k: [] for k in engines}
    got = {}
    by_card = {}
    try:
        # a warm-up each, then one card and 4x1 in turns
        turns = ("one card", "4x1", "4x1", "one card")
        order = list(turns[:2]) + [turns[k % 4]
                                   for k in range(2 * MULTI_REPS)]
        for k, tag in enumerate(order):
            n_rec = [0]

            def emit(recs, rev=None):
                n_rec[0] += 2 * len(recs)
            _build.reset_counts()
            t0 = time.perf_counter()
            n_cand = engines[tag].run_phased_pairs(pairs, False, filt, emit)
            for c in range(MULTI_CARDS):
                torch.cuda.synchronize(c)
            dt = time.perf_counter() - t0
            if k >= 2:
                walls[tag].append(dt)
            if tag == "4x1":
                _add_cards(by_card, _local_by_card())
            if any(_build.PLAIN_CALLS.values()):
                raise SystemExit(f"engine sparse {tag}: a plain version ran")
            got.setdefault(tag, set()).add((int(n_cand), n_rec[0]))
    finally:
        for e in engines.values():
            e.stage_close()
    if len(got["one card"] | got["4x1"]) != 1:
        raise SystemExit(f"engine sparse: one card and 4x1 disagree: {got}")
    _check_cards("engine sparse 4x1", by_card,
                 _local_cards(("phased_tile",), MULTI_CARDS, 1),
                 ("local_parts", "tile_epilogue"))
    n_cand, n_rec = got["4x1"].pop()
    row = dict(tiles=len(pairs), pairs=64 * B * (64 * B - 1) // 2,
               candidates=n_cand, records=n_rec,
               wall_s_one_card=walls["one card"], wall_s_4x1=walls["4x1"],
               speedup=min(walls["one card"]) / min(walls["4x1"]))
    _say(f"engine sparse on one card and on the 4 x 1 mesh, in turns: "
         f"{len(pairs)} tiles, {n_rec} records; one card "
         f"{walls['one card']} s, 4x1 {walls['4x1']} s: "
         f"{row['speedup']:.2f}x at best")
    _say(json.dumps({"multi_sparse": row}))
    return row


def multi_dcn():
    """The engine dcn row (the first DCN_BLOCKS blocks of the sparse
    planes, 136 tiles) on four ranks, one card each, and on two ranks of
    two cards each (`dcn:2`), both over NCCL: each rank's wall, and the
    ms a tile of local_parts, the all-reduce (row 0's group), the
    epilogue and the compaction from CUDA events on its card of row 0.
    The ranks' candidates and records agree within and across the two
    layouts. Returns both layouts' reports."""
    rows = {}
    for tag, n, spec in (("4 ranks, dcn", MULTI_CARDS, "dcn"),
                         ("2 ranks, dcn:2", 2, "dcn:2")):
        coordinator = f"127.0.0.1:{_free_port()}"
        reports = spawn_ranks(f"engine {tag}", [
            dict(kind="engine", rank=r, coordinator=coordinator, n=n,
                 spec=spec, dense=False) for r in range(n)])
        for rep in reports:
            _check_counts(f"engine {tag} rank {rep['rank']}",
                          rep["launches"], rep["plain"],
                          ("local_parts", "tile_epilogue", "compact"),
                          ("phased_tile", "parts_tile"))
            if "device collectives over nccl" not in rep["dist"]:
                raise SystemExit(f"engine {tag}: not NCCL: {rep['dist']}")
        _check_cards(f"engine {tag}",
                     _by_index([rep["cards"] for rep in reports]),
                     {c: ("local_parts", "tile_epilogue", "compact")
                      for c in range(MULTI_CARDS)},
                     ("phased_tile", "parts_tile"))
        if len({(r["candidates"], r["records"]) for r in reports}) != 1:
            raise SystemExit(f"engine {tag}: the ranks disagree: {reports}")
        for rep in reports:
            _say(f"engine {tag} rank {rep['rank']}: {rep['wall_s']:.4f}s, "
                 f"{rep['records']} records; ms per tile "
                 f"{rep['ms_per_tile']}")
        rows[tag] = [{k: v for k, v in rep.items() if k != "dense"}
                     for rep in reports]
    a, b = (v[0] for v in rows.values())
    if (a["candidates"], a["records"]) != (b["candidates"], b["records"]):
        raise SystemExit("engine dcn: the two layouts disagree")
    _say(json.dumps({"multi_dcn": rows}))
    return rows


def _mesh_cut_times(engine, cfg, pairs):
    """ms a tile of each cut of a 1 x S mesh's samples-sharded tile over
    `pairs` beside the reduction (the engine's run times its copies and
    its sum: `multi_mesh`), each cut a pass of its own over the tiles,
    bracketed by CUDA events on the card it runs on, the steps before it
    in the tile queued ahead of the first event: local_parts on each
    card (all cards in one pass), then tile_epilogue and compact (handed
    the epilogue's counts) on card 0, after the row's reduction."""
    import torch
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import tiles
    row = engine.bands.dev_for(cfg)[0]
    group = engine._row_cfg(cfg, 0, row)["psum_group"]
    devs = [d["valid"].device for d in row]
    out = tiles.tile_buffers(cfg, devs[0])
    outs = [out] + [o for _, o in group.peers]
    counts = tiles.counts_buffer(cfg, devs[0])
    buf = torch.zeros((1 << 18, sweeps.buf_cols(cfg)), dtype=torch.int32,
                      device=devs[0])
    n_pass, n_cnd = (torch.zeros(len(pairs), dtype=torch.int32,
                                 device=devs[0]) for _ in range(2))
    off = torch.zeros(1, dtype=torch.int32, device=devs[0])

    def local_on(c):
        def fn(t, i, j, diag):
            with torch.cuda.device(devs[c]):
                tiles.tile_local_parts(row[c], i, j, cfg, outs[c])
        return fn

    def local(t, i, j, diag):
        for c in range(len(devs)):
            local_on(c)(t, i, j, diag)

    def reduce(t, i, j, diag):
        with torch.cuda.device(devs[0]):
            group.all_reduce_parts(out[1])

    def epilogue(t, i, j, diag):
        with torch.cuda.device(devs[0]):
            tiles.tile_epilogue(row[0], i, j, diag, cfg, out, counts)

    def compact(t, i, j, diag):
        with torch.cuda.device(devs[0]):
            sweeps.compact_survivors(*out, off, buf, n_pass, n_cnd, t, 256,
                                     counts)

    def timed(steps, before=()):
        """Mean ms a tile of each (card, fn) in `steps`, its events
        recorded on its card's stream right around its own call."""
        marks = []
        for t, (i, j, diag) in enumerate(pairs):
            for step in before:
                step(t, i, j, diag)
            ev = []
            for c, fn in steps:
                ev.append([torch.cuda.Event(enable_timing=True)
                           for _ in "ab"])
                ev[-1][0].record(torch.cuda.current_stream(devs[c]))
                fn(t, i, j, diag)
                ev[-1][1].record(torch.cuda.current_stream(devs[c]))
            marks.append(ev)
        for d in devs:
            torch.cuda.synchronize(d)
        return [sum(m[k][0].elapsed_time(m[k][1]) for m in marks)
                / len(marks) for k in range(len(steps))]

    local(0, *pairs[0])          # warm-up
    ms = {f"local_parts card {c}": v for c, v in enumerate(
        timed([(c, local_on(c)) for c in range(len(devs))]))}
    ms["tile_epilogue"], = timed([(0, epilogue)], (local, reduce))
    ms["compact"], = timed([(0, compact)], (local, reduce, epilogue))
    return ms


def multi_mesh():
    """The dcn row's tiles (the first DCN_BLOCKS blocks of the sparse
    planes) on a 1 x 4 mesh over the four cards in this process: a
    warm-up, then MULTI_REPS timed runs, the first with the SamplesGroup's
    events on (the copies and the sum as the engine runs them); the
    launches by card (card 0: local_parts, tile_epilogue, compact; the
    others local_parts; no fused kernel, no plain version); candidates
    and records equal on every run; then the per-tile cuts
    (`_mesh_cut_times`). Returns the row."""
    import torch
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute.engine import CalcSettings, LdEngine
    from tomahawk_tpu_torch.ops import _build
    from tomahawk_tpu_torch.ops.ld_math import LdFilters
    from tomahawk_tpu_torch.parallel import SamplesGroup, make_mesh
    stacked = workloads.build_planes(DCN_BLOCKS, B, N_SAMPLES)
    engine = LdEngine(stacked, N_SAMPLES, CalcSettings(min_r2=MIN_R2),
                      mesh=make_mesh(1, MULTI_CARDS))
    pairs = [(i, j, i == j) for i in range(DCN_BLOCKS)
             for j in range(i, DCN_BLOCKS)]
    filt = LdFilters(min_r2=MIN_R2)
    got, walls = set(), []

    def sync():
        for c in range(MULTI_CARDS):
            torch.cuda.synchronize(c)
    try:
        for rep in range(MULTI_REPS + 1):
            n_rec = [0]

            def emit(recs, rev=None):
                n_rec[0] += 2 * len(recs)
            if rep == 1:
                _build.reset_counts()
                SamplesGroup.timing = []
            t0 = time.perf_counter()
            n_cand = engine.run_phased_pairs(pairs, False, filt, emit)
            sync()
            if rep:
                walls.append(time.perf_counter() - t0)
            if rep == 1:
                marks, SamplesGroup.timing = SamplesGroup.timing, None
                in_run = dict(
                    copies=sum(a.elapsed_time(b) for a, b, _ in marks)
                    / len(marks),
                    sum=sum(b.elapsed_time(c) for _, b, c in marks)
                    / len(marks), reductions=len(marks))
            got.add((int(n_cand), n_rec[0]))
        by_card = _local_by_card()
        _check_counts("engine 1x4 mesh", dict(_build.LAUNCHES),
                      dict(_build.PLAIN_CALLS), (), ())
        _check_cards("engine 1x4 mesh", by_card,
                     _local_cards((), 1, MULTI_CARDS),
                     ("phased_tile", "parts_tile"))
        if len(got) != 1:
            raise SystemExit(f"engine 1x4 mesh: the runs disagree: {got}")
        ms = _mesh_cut_times(engine, engine._cfg("phased", False, "all"),
                             pairs)
    finally:
        SamplesGroup.timing = None
        engine.stage_close()
    n_cand, n_rec = got.pop()
    row = dict(tiles=len(pairs), candidates=n_cand, records=n_rec,
               wall_s=walls, in_run_ms_per_tile=in_run, ms_per_tile=ms,
               parts_mb=4 * B * B / 1e6)
    _say(f"engine 1x4 mesh over four cards: {len(pairs)} tiles, {n_rec} "
         f"records: walls {walls} s; in the run, per tile on card 0: the "
         f"peers' copies {in_run['copies']:.4f} ms, the sum "
         f"{in_run['sum']:.4f} ms; cuts a tile {ms}")
    _say(json.dumps({"multi_mesh": row}))
    return row


def multi_main():
    """`python3 chip_smoke.py multi`, with exactly four cards visible:
    the kernels on each card against their plain versions
    (`multi_kernels`), paths r, s and t (`multi_paths`), the idle row
    (`multi_idle`), then the sparse planes on a 4 x 1
    mesh against one card (`multi_sparse`), the engine dcn row over NCCL
    (`multi_dcn`) and the 1 x 4 mesh's cuts (`multi_mesh`), each a JSON
    line; its last line is the device line, count 4."""
    import torch
    if torch.cuda.device_count() != MULTI_CARDS:
        print(f"chip_smoke multi: needs exactly {MULTI_CARDS} visible cards, "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    report_cards()
    build_kernels()
    work = os.path.join(ROOT, "build", "chip_smoke_multi")
    os.makedirs(work, exist_ok=True)
    try:
        multi_kernels()
        ld, miss = multi_archives(work)
        by_card = multi_paths(work, ld, miss)
        multi_idle(work, ld)
        multi_sparse()
        multi_dcn()
        multi_mesh()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    leaked = sorted(m for m, v in sys.modules.items()
                    if m.split(".")[0] in ("jax", "tomahawk_tpu", "bench")
                    and v is not None)
    if leaked:
        raise SystemExit(f"imported outside the port: {leaked}")
    _say(json.dumps({"multi_launches_by_card": by_card}))
    _say(f"multi: {time.perf_counter() - t_start:.0f}s in all")
    report_cards()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def dcn2_main():
    """`python3 chip_smoke.py dcn2`, on a host with two cards visible
    (e.g. CUDA_VISIBLE_DEVICES=0,1): paths g and h with `--mesh dcn:2`,
    two ranks that share both cards (each rank's pairs shard p on card
    p, collectives over gloo, each card's reductions through its own
    pinned host buffer), their records against the native CPU engine's
    and their launches checked as in the default run: `dcn:P` with
    P > 1 where the ranks share their cards (`multi` runs it on cards of
    the ranks' own, over NCCL)."""
    import torch
    if torch.cuda.device_count() != 2:
        print("chip_smoke dcn2: needs exactly two visible cards",
              file=sys.stderr)
        return 1
    report_card()
    build_kernels()
    work = os.path.join(ROOT, "build", "chip_smoke_dcn2")
    os.makedirs(work, exist_ok=True)
    try:
        ld = make_archive(work, "ld", 16384)
        miss = make_archive(work, "miss", 16384, miss_sites=12288,
                            miss_step=2, miss_frac=0.025)
        need = ("local_parts", "tile_epilogue", "compact")
        idle = ("phased_tile", "parts_tile")
        two = os.path.join(work, "ranked.two")
        for label, twk, flags, mode in (("g", ld, ["-p"], "phased"),
                                        ("h", miss, [], "mixed")):
            run_ranked_calc(f"{label} dcn:2", twk, two, flags, mode, need,
                            idle, "dcn:2")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    report_card()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def crossover_main(modes):
    """`python3 chip_smoke.py crossover [phased|mixed]`: the card, the
    builds, then the CPU route's crossover timing (`crossover`) of each
    of `modes` (both when none is named: ~10 minutes of fresh processes
    for phased, ~8 for mixed) on its own."""
    import torch
    report_card()
    build_kernels()
    work = os.path.join(ROOT, "build", "chip_smoke_crossover")
    os.makedirs(work, exist_ok=True)
    try:
        for mode in modes or ("phased", "mixed"):
            if mode not in CROSS_SITES:
                raise SystemExit(f"crossover: no dispatch {mode!r}")
            crossover(work, mode)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    report_card()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "tomahawk_tpu_torch")):
        print("chip_smoke: run from the root of a checkout",
              file=sys.stderr)
        return 1
    # nothing here may import jax or the JAX package
    sys.modules["jax"] = None
    sys.modules["tomahawk_tpu"] = None
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["rank"]:
        return rank_main(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["crossover"]:
        return crossover_main(sys.argv[2:])
    if sys.argv[1:2] == ["dcn2"]:
        return dcn2_main()
    if sys.argv[1:2] == ["multi"]:
        return multi_main()
    from tomahawk_tpu_torch import native
    from tomahawk_tpu_torch.device import kernel_report

    t_start = time.perf_counter()
    report_card()
    build_kernels()
    probe_rates = mma_probe()
    checks, times = compare_kernels()
    compare_odd_shapes()
    groups = compare_groups()
    compare_screen()
    compare_wide()
    torch.cuda.empty_cache()
    payloads = compare_payloads()
    check_ticket_fault()
    n_sweeps = compare_c_sweep()
    _say(f"C tile loop: {n_sweeps} sweeps equal the per-tile launches")
    probe = probe_shape()
    torch.cuda.empty_cache()
    windows = compare_window()
    local, epi = compare_dcn_kernels()
    dprime = compare_dprime()
    torch.cuda.empty_cache()
    fisher = compare_fisher()
    torch.cuda.empty_cache()
    kin = compare_kinship()
    # the kernels line: phased_tile and compact at the -p path's shape
    # (one part, the counts given); parts_tile at the default (mixed)
    # dispatch's 9-part sweep
    checks["parts_tile"] = (max(max(v[0] for v in groups.values()),
                                probe[0]),) + groups[MAIN_GROUP][1:]
    compact1 = checks["compact"]
    checks["compact"] = (max(compact1[0],
                             max(v[0] for v in payloads.values())),
                         ) + compact1[1:]
    bounds = kernel_bounds(times["kept"])
    # local_parts and tile_epilogue at the -p dcn path's instance
    for name, res in (("local_parts", local), ("tile_epilogue", epi)):
        checks[name] = (0,) + res[MAIN_INSTANCE][:2]
        bounds[name] = res[MAIN_INSTANCE][2:]
    # fisher_bracket in the -p path's layout (bf16 in the payload column)
    checks["fisher_bracket"] = fisher["packed"][:3]
    bounds["fisher_bracket"] = fisher["packed"][3:5]
    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    try:
        launches, dprime_launches = main_paths(work)
        engine_rates(work)
        dcn = dcn_engine()
        mesh_engine(dcn)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if native.get_lib() is None:
        raise SystemExit("the port's native host library is not loaded")
    leaked = sorted(m for m, v in sys.modules.items()
                    if m.split(".")[0] in ("jax", "tomahawk_tpu", "bench")
                    and v is not None)
    if leaked:
        raise SystemExit(f"imported outside the port: {leaked}")
    # every fused-kernel instance and payload timed above, so that the end
    # of the output carries each measured time
    def tile_row(kernel, group, v, table, miss, library_ms):
        words = contraction_pair_words(table, miss)
        bound, by = _bound(words, tile_bytes(table, miss))
        return dict(kernel=kernel, group=group, ms=v[1], plain_ms=v[2],
                    bound_ms=bound, bound_by=by, int8_ms=_int8_ms(words),
                    cuda_core_ms=_cuda_core_ms(words), library_ms=library_ms)

    _say(json.dumps({"tile_instances": [
        tile_row("phased_tile", "phased/False/all", checks["phased_tile"],
                 "phased", False, times["library_ms"])]
        + [tile_row("phased_tile" if g[:2] == ("phased", False)
                    else "parts_tile", "/".join(map(str, g)), v, g[0], g[1],
                    v[3])
           for g, v in groups.items()]
        + [tile_row("parts_tile", "unphased/False/all at the probe shape",
                    probe, "unphased", False, probe[3])]
        + [dict(kernel="compact", group="1 part, counts given",
                ms=compact1[1], plain_ms=compact1[2]),
           dict(kernel="compact", group="1 part, counts given, at the "
                "host's pace with the offset reset",
                ms=times["host_paced_ms"], plain_ms=compact1[2])]
        + [dict(kernel="compact", group=f"{P} parts, counts given",
                ms=v[1], plain_ms=v[2])
           for P, v in sorted(payloads.items())]}))
    # window rows: (group, window, diagonal) -> ms, plain, bound, shares
    _say(json.dumps({"window_instances": [
        dict(group="/".join(map(str, g)), window=w, diagonal=d, **v)
        for (g, w, d), v in windows.items()]}))
    # samples-sharded rows: instance -> ms, plain, bound, the int8 figure,
    # CUDA-core ceiling, torch._int_mm x P
    _say(json.dumps({"fisher_instances": [
        dict(v[7], layout=k, max_abs_err=v[0], ms=v[1], plain_ms=v[2],
             bound_ms=v[3], bound_by=v[4])
        for k, v in fisher.items()]}))
    _say(json.dumps({"dprime_instances": [
        dict(kernel=k, ms=v[0], ms_without_bounds=v[1], plain_ms=v[2])
        for k, v in dprime.items()]}))
    _say(json.dumps({"dcn_instances": [
        dict(kernel=name, instance="/".join(map(str, inst)), ms=v[0],
             plain_ms=v[1], bound_ms=v[2], bound_by=v[3], int8_ms=v[4],
             cuda_core_ms=v[5], library_ms=v[6],
             **(dict(bytes_ms=v[7], ops_ms=v[8], f32_ops_a_candidate=v[9])
                if len(v) > 7 else {}))
        for name, res in (("local_parts", local), ("tile_epilogue", epi))
        for inst, v in res.items()]}))
    # library_ms: torch._int_mm once a part on the pre-unpacked operands,
    # the contraction alone (no PyTorch call computes the mask or the
    # compaction)
    library = {"phased_tile": times["library_ms"],
               "parts_tile": groups[MAIN_GROUP][3],
               "local_parts": local[MAIN_INSTANCE][6],
               "compact": times["compact_library_ms"]}
    kernels = [dict(name=k["name"], route="cuda", source=k["source"],
                    replaces=k["replaces"], launches=launches[k["name"]],
                    max_abs_err=checks[k["name"]][0],
                    ms=checks[k["name"]][1], plain_ms=checks[k["name"]][2],
                    bound_ms=bounds[k["name"]][0],
                    bound_by=bounds[k["name"]][1],
                    library_ms=library.get(k["name"]))
               for k in kernel_report()]
    main_words = {"phased_tile": contraction_pair_words("phased", False),
                  "parts_tile": contraction_pair_words(*MAIN_GROUP[:2]),
                  "local_parts": contraction_pair_words(*MAIN_INSTANCE, 2)}
    for k in kernels:
        if k["name"] in main_words:
            k["int8_ms"] = _int8_ms(main_words[k["name"]])
            k["cuda_core_ms"] = _cuda_core_ms(main_words[k["name"]])
        if k["name"] == "phased_tile":
            # the operations at the rate the probe read in this run
            k["probe_b1_ms"] = 64 * main_words["phased_tile"] \
                / probe_rates[PROBE_KINDS[0][1]] * 1e3
        if k["name"] == "compact":
            k["library_note"] = ("torch.nonzero(mask.flatten() == 2) then "
                                 "index_select of the parts: the same rows "
                                 "without the buffer's running offset")
        elif k["name"] in library:
            k["library_note"] = ("torch._int_mm once a part: contraction "
                                 "only, operands pre-unpacked, no mask, no "
                                 "prefilter")
        if k["name"] == "compact":
            # the same call enqueued at the host's pace, as it was timed
            # before the calls were queued
            k["host_paced_ms"] = times["host_paced_ms"]
    # the D' instances (X6, a term of the prefilter): the kernels with D'
    # bounds, timed at DPRIME, launched on calc paths l (-p -d -D) and m
    # (mixed -d); bound and library call as without the bounds, the term
    # reads nothing more
    for name, group, path in (("phased_tile", ("phased", False, "all"), "l"),
                              ("parts_tile", MAIN_GROUP, "m")):
        base = next(k for k in kernels if k["name"] == name)
        kernels.append(dict(
            base, name=f"{name} with D' bounds",
            replaces="tomahawk_tpu/ops/ld_kernels.py:215",
            launches=dprime_launches[path][name], max_abs_err=0,
            ms=dprime[name][0], plain_ms=dprime[name][2],
            ms_without_bounds=dprime[name][1], launches_on=f"path {path}",
            instance="/".join(map(str, group)) + f", D' {DPRIME}"))
    # X4 is a library call (torch._int_mm), not a hand kernel: its own
    # line, in the kernels line's keys
    _say(json.dumps({"library_calls": [dict(
        name="kinship_int_mm", route="torch._int_mm",
        source="tomahawk_tpu_torch/ops/kinship.py",
        replaces="tomahawk_tpu/post/relationship.py:54",
        launches=launches[KINSHIP_COUNT], **kin,
        library_note="library_ms: torch._int_mm alone, without the "
        "accumulation")]}))
    _say(json.dumps({"checkpoint_path_o": POST["checkpoint"]}))
    _say(json.dumps({"post_subcommands": POST["subcommands"]}))
    _say(f"native host library loaded; no jax, no tomahawk_tpu in "
         f"sys.modules; {time.perf_counter() - t_start:.0f}s in all")
    report_card()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
