#!/usr/bin/env python3
"""Where the tile kernels' time goes, and what the compaction's redesign
gained.

    python3 -m tomahawk_tpu_torch.ops.time_variants [--old-compact FILE]
        [--old-tiles DIR]

A measurement, not part of the library or of chip_smoke.py; needs an
NVIDIA GPU and nvcc. It builds csrc/phased_tile.cu whole and once per
entry of CUTS, each from a copy with parts of the kernel edited out (the
outputs of those builds are wrong by design), and times each on the -p
tile (B = 4096, 2,504 samples, W = 160 words, off-diagonal). The
differences say what the staging + MMA loop, the prefilter's arithmetic
and the stores cost, and how far they overlap. It does the same for
csrc/parts_tile.cu (PARTS_CUTS) in its three instances, on the
off-diagonal tile of genotype planes with ~1% of genotypes missing, and
times PARTS_SHAPES, copies with another block shape or register budget
whose outputs are right.

With --old-compact FILE it also times the compaction of FILE, a compact.cu
with the interface the compaction had while it ran three dependent
launches and counted every mask itself (twk_compact without the `counts`
and `ticket` arguments, scratch of 3 * B + 2 words allocated per call),
against the library's on one mask (the LD-grouped diagonal tile, 30,720
survivors, one part), with the counts given and without.

It builds csrc/fisher_bracket.cu whole and once per entry of
FISHER_CUTS and times each on the survivor rows of the dense workload's
10 tiles (4 LD-grouped super-blocks) in both layouts and on
chip_smoke.py's 16,988 tables at 2N = 32,768 (the 4-part layout), and
the whole kernel with the volume gate closed (the `ends` launch and an
empty second launch): where the Fisher search spends its time. With
--fisher-designs it also builds and times FISHER_DESIGNS, the two designs
the kernel did not take (the table in shared memory, not at 2N = 32,768
where the array does not hold it; one launch).

It builds csrc/epilogue.cu whole and once per entry of EPILOGUE_CUTS and
times each on the summed parts of the off-diagonal genotype tile in its
four (table, has_missing) instances, with a counts buffer, and the whole
kernel without one: what the prefilter, the one half of the unphased
prefilter a pair, the pairs a lane and the rows a block cost.

With --old-tiles DIR it also builds phased_tile.cu, parts_tile.cu and
epilogue.cu of DIR, the csrc/ of an earlier tree, and times them against
the library's on the -p tile, the three parts_tile groups and the four
epilogue instances, in turns (old, new, new, old), each after checking
that both give the same mask; DIR's launchers may take the D' bounds or
predate them, and DIR's epilogue may predate its counts. Where DIR holds a
fisher_bracket.cu with the walk's interface (no search table), it times
that kernel against the library's on the same rows as the cuts, in
turns, after checking that the library's flags are a subset of its and
the other brackets agree within 1e-6 relative.

Every timed call is queued behind ~4 ms of other device work, so the host
stays ahead and the time is the device's, launch gaps included. Prints the
card's name and power limit, one line a variant, and one JSON object.
"""

import argparse
import ctypes
import itertools
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np

B, N_SAMPLES, MIN_R2 = 4096, 2504, 0.1

_LOOP = (r"  Tile::run\(smem, xa, xb, row0, col0, B, W, acc\);\n", "")
# the mask byte from two bits of the count, so that the stores still
# depend on the contraction
_PREFILTER = (r"    // twk::candidate on the hoisted metadata\n.*?"
              r"aa\[q\], s\.bnd\);\n",
              "    const bool m = (aa[q] & 2) != 0;\n"
              "    const bool pf = (aa[q] & 1) != 0;\n")
_ALTALT = (r"&aa4\[u\], row0 \+ first", "nullptr, row0 + first")
#: variant -> edits (regular expression, replacement) of phased_tile.cu
CUTS = {"whole": (), "no loop": (_LOOP,), "no prefilter": (_PREFILTER,),
        "no ALTALT stores": (_ALTALT,),
        "loop + mask stores only": (_PREFILTER, _ALTALT),
        "stores only": (_LOOP, _PREFILTER),
        "mask stores only": (_LOOP, _PREFILTER, _ALTALT)}

_P_LOOP = (r"  Tile::run\(smem, xa, xb, row0, col0, B, a\.W, acc\);\n", "")
# the mask byte from a bit of two parts, so that the stores still depend
# on the contraction
_P_PREFILTER = (r"pair_mask<KIND, DP>\(a, v, k, l0 \+ e, aci, vi\)",
                "(unsigned)(v[0] & 1) + (unsigned)(v[1] & 1)")
_P_PARTS = (r"__stcs\(reinterpret_cast<int2\*>\(a\.parts.*?\)\);\n",
            "(void)0;\n")
#: variant -> edits of parts_tile.cu, as CUTS
PARTS_CUTS = {"whole": (), "no loop": (_P_LOOP,),
              "no prefilter": (_P_PREFILTER,),
              "no parts stores": (_P_PARTS,),
              "loop + mask stores only": (_P_PREFILTER, _P_PARTS),
              "stores only": (_P_LOOP, _P_PREFILTER)}
_P9 = r"kParts = 9, kMi = 1, kNi = 2, kWords = 16;"
#: copies of parts_tile.cu whose outputs stay right: the P = 9 instance
#: (32 x 64 blocks, 16-word stages, two blocks an SM) with another block
#: shape, stage or register budget
PARTS_SHAPES = {
    "P=9, 64 x 32 blocks": ((_P9, "kParts = 9, kMi = 2, kNi = 1, "
                                  "kWords = 16;"),),
    "P=9, one block an SM": (
        (r"__launch_bounds__\(kThreads, 2\) parts_tile_kernel",
         "__launch_bounds__(kThreads, 1) parts_tile_kernel"),),
    "P=9, 32-word stages": ((_P9, "kParts = 9, kMi = 1, kNi = 2, "
                                  "kWords = 32;"),)}
# fisher_bracket.cu: the bisection of each side's run cut to none (the
# run taken to end at the support's end, so no tail either), or the
# tail's loop cut
_F_SEARCH = (r"long long lo = 0, hi = span \+ 1;",
             "long long lo = span, hi = span + 1;")
_F_TAIL = (r"        while \(used < rem\) \{\n", "        while (false) {\n")
# the table staged in shared memory by every block (right up to 6,142
# haplotypes), in place of the read-only path
_F_SMEM = ((r"  return __ldg\(lf \+ i\);\n", "  return lf[i];\n"),
           (r"  const double\* lf = a\.lf;\n",
            "  __shared__ double staged[6144];\n"
            "  for (int i = threadIdx.x; i < a.n_lf; i += kThreads)\n"
            "    staged[i] = a.lf[i];\n"
            "  __syncthreads();\n"
            "  const double* lf = staged;\n"))
# one launch: every block sums n_pass itself (right up to 1,024 tiles) in
# place of the one-block ends_kernel launch before it
_F_FOLD = ((r"ends_kernel<<<1, kEndsThreads, 0, s>>>\(.*?\);\n",
            "(void)0;\n"),
           (r"  const long long total = a\.ends\[a\.T\];\n",
            "  __shared__ long long s_ends[1025];\n"
            "  if (threadIdx.x == 0) {\n"
            "    long long c = 0;\n"
            "    for (int t = 0; t < a.T; ++t) s_ends[t] = c += a.n_pass[t];\n"
            "    s_ends[a.T] = c;\n"
            "  }\n"
            "  __syncthreads();\n"
            "  const long long total = s_ends[a.T];\n"),
           (r"a\.ends\[mid\]", "s_ends[mid]"),
           (r"a\.ends\[t\] >", "s_ends[t] >"))
#: variant -> edits of fisher_bracket.cu, as CUTS
FISHER_CUTS = {"whole": (), "no tail": (_F_TAIL,),
               "no search, no tail": (_F_SEARCH,)}
#: the same for the designs the kernel did not take, whose outputs are
#: right
FISHER_DESIGNS = {"table in shared memory": _F_SMEM, "one launch": _F_FOLD}
# epilogue.cu: the prefilter cut to a bit of the parts, so that the
# stores still depend on every load
_E_PREFILTER = (r"pair_pf<KIND, DP, P, C>\(a, sm, row, acj\[e\], "
                r"base \+ e, v, e\)",
                "[&] { int x = 0; for (int p = 0; p < P; ++p) x ^= v[p][e]; "
                "return (x & 1) != 0; }()")
_E_COLS = r"kCols = KIND == 0 \? 16 : KIND == 1 \? 8 : 4;"
#: variant -> edits of epilogue.cu, as CUTS: the prefilter cut, and copies
#: whose outputs stay right: both halves of the unphased prefilter a pair
#: (the branch-free statement), one count of pairs a lane for every
#: instance, other rows a block, other blocks an SM, 4 warps a block, the
#: next row's loads ahead of the prefilter in every instance or in none
EPILOGUE_CUTS = {
    "whole": (), "no prefilter": (_E_PREFILTER,),
    "both unphased halves": ((r"twk::unphased_prefilter_taken<DP>",
                              "twk::unphased_prefilter<DP>"),),
    "16 pairs a lane": ((_E_COLS, "kCols = 16;"),),
    "8 pairs a lane": ((_E_COLS, "kCols = 8;"),),
    "4 pairs a lane": ((_E_COLS, "kCols = 4;"),),
    "16 rows a block": ((r"kRows = 32;", "kRows = 16;"),),
    "64 rows a block": ((r"kRows = 32;", "kRows = 64;"),),
    "two blocks an SM": ((r"__launch_bounds__\(kThreads\) epilogue_kernel",
                          "__launch_bounds__(kThreads, 2) epilogue_kernel"),),
    "one block an SM": ((r"__launch_bounds__\(kThreads\) epilogue_kernel",
                         "__launch_bounds__(kThreads, 1) epilogue_kernel"),),
    "4 warps a block": ((r"kWarps = 8;", "kWarps = 4;"),),
    "a row ahead in every instance": ((r"kAhead = KIND < 2;",
                                       "kAhead = true;"),),
    "no row ahead": ((r"kAhead = KIND < 2;", "kAhead = false;"),)}
#: the parts_tile instances timed: (table, has_missing, cls)
PARTS_GROUPS = (("phased", True, "all"), ("unphased", False, "all"),
                ("unphased", True, "missing"))


def device_ms(fn, reps, probe_lib=None):
    """Mean device milliseconds per call of fn after one warm-up, the
    calls queued behind the MMA probe (~4 ms) of `probe_lib` (the kernel
    library by default)."""
    import torch
    from . import _build
    fn()
    sink = torch.zeros(528 * 256, dtype=torch.int32, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    stream = torch.cuda.current_stream().cuda_stream
    lib = probe_lib or _build.library()
    _build.check(lib.twk_mma_probe(0, 528, 20000, sink.data_ptr(), stream),
                 "mma_probe launch")
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _nvcc_shared(jobs):
    """Build each (source, library) of `jobs`, all at once; nvcc's output
    (ptxas's report) of each."""
    from . import _build
    return _build._run([[_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                         _build.CSRC, "-shared", "-o", so, src]
                        for src, so in jobs])


def _ptxas_lines(out, kernel):
    """'<instance>: <registers> registers, <bytes> bytes spilled' for each
    instance of `kernel` in ptxas's report `out`."""
    lines, name, spill = [], None, 0
    for line in out.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            inst = re.search(r"I(L.*?)EE", name)
            lines.append(f"{inst.group(1) if inst else name}: {m.group(1)} "
                         f"registers, {spill} bytes spilled")
    return lines


def _edited_builds(work, source_name, variants, tag, kernel=None):
    """Build one library per entry of `variants` (name -> edits, each a
    regular expression that must match once in the source and its
    replacement), all at once; their paths in order. With `kernel`, print
    ptxas's registers and spills of its instances in each."""
    from . import _build
    with open(os.path.join(_build.CSRC, source_name)) as fh:
        source = fh.read()
    jobs = []
    for n, edits in enumerate(variants.values()):
        text = source
        for pattern, repl in edits:
            text, hits = re.subn(pattern, repl, text, flags=re.S)
            if hits != 1:
                raise SystemExit(f"edit {pattern!r} matched {hits} times")
        jobs.append((os.path.join(work, f"{tag}{n}.cu"),
                     os.path.join(work, f"{tag}{n}.so")))
        with open(jobs[-1][0], "w") as fh:
            fh.write(text)
    outs = _nvcc_shared(jobs)
    if kernel:
        for name, out in zip(variants, outs):
            print(f"{kernel} {name}, ptxas: "
                  + "; ".join(_ptxas_lines(out, kernel)), flush=True)
    return [so for _, so in jobs]


def time_cuts(work):
    import torch
    from .. import workloads
    from ..compute import sweeps
    from . import _build, tiles
    from . import ld_kernels as K
    libs = _edited_builds(work, "phased_tile.cu", CUTS, "cut")
    cfg = sweeps.make_cfg("phased", False, "all", B, N_SAMPLES, 0, MIN_R2,
                          100.0)
    dev = sweeps.planes_to_device(workloads.build_planes(2, B, N_SAMPLES),
                                  "cuda", sweeps.dev_keys_for(cfg))
    mask, parts = tiles.tile_buffers(cfg, "cuda")
    counts = tiles.counts_buffer(cfg, "cuda")
    lo, hi, nonzero = K.prefilter_bounds(MIN_R2, 100.0)
    ptr = lambda k, s: dev[k][s].data_ptr()
    W = dev["alt_bits"].shape[-1]
    res = {}
    for name, so in zip(CUTS, libs):
        lib = ctypes.CDLL(so)
        lib.twk_phased_tile.argtypes = _build._SIGNATURES["twk_phased_tile"]

        def launch():
            rc = lib.twk_phased_tile(
                ptr("alt_bits", 0), ptr("alt_bits", 1), ptr("ac", 0),
                ptr("ac", 1), ptr("valid", 0), ptr("valid", 1), *[None] * 6,
                0, 0, B, W, 2 * N_SAMPLES, float(lo), float(hi),
                -float("inf"), float("inf"), int(nonzero), 0,
                mask.data_ptr(), parts.data_ptr(), counts.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"phased_tile ({name}): CUDA error {rc}")

        res[name] = device_ms(launch, 40)
        print(f"phased_tile, {name}: {res[name]:.4f} ms", flush=True)
    return res


def time_parts(work):
    """parts_tile.cu's cuts (PARTS_CUTS) in each of PARTS_GROUPS and its
    P = 9 variants (PARTS_SHAPES), each library swapped in for the
    kernel library around tiles.tile_prefilter with a counts buffer; and
    the same tile in two launches of the kernel library, local_parts over
    the whole row and tile_epilogue, whose one mask byte a thread runs the
    prefilter at full occupancy. Returns {group: {variant: ms}}."""
    from .. import workloads
    from ..compute import sweeps
    from . import _build, tiles
    main_lib = _build.library()
    variants = dict(PARTS_CUTS, **PARTS_SHAPES)
    libs = dict(zip(variants, _edited_builds(work, "parts_tile.cu",
                                             variants, "parts")))
    dev = sweeps.planes_to_device(
        workloads.genotype_planes(2, B, N_SAMPLES), "cuda")
    res = {}
    for group in PARTS_GROUPS:
        cfg = sweeps.make_cfg(*group, B, N_SAMPLES, 0, MIN_R2, 100.0)
        out = tiles.tile_buffers(cfg, "cuda")
        counts = tiles.counts_buffer(cfg, "cuda")
        tag = "/".join(map(str, group))
        res[tag] = {}
        for name, so in libs.items():
            if name in PARTS_SHAPES and group[:2] != ("unphased", True):
                continue
            lib = ctypes.CDLL(so)
            lib.twk_parts_tile.argtypes = _build._SIGNATURES["twk_parts_tile"]
            lib.twk_parts_tile.restype = ctypes.c_int
            _build._lib = lib
            try:
                ms = device_ms(lambda: tiles.tile_prefilter(
                    dev, 0, 1, False, cfg, out, counts), 20, main_lib)
            finally:
                _build._lib = main_lib
            res[tag][name] = ms
            print(f"parts_tile {tag}, {name}: {ms:.4f} ms", flush=True)
        name = "local_parts + tile_epilogue"
        res[tag][name] = device_ms(lambda: tiles.tile_epilogue(
            dev, 0, 1, False, cfg, (out[0], tiles.tile_local_parts(
                dev, 0, 1, cfg, out))), 20)
        print(f"parts_tile {tag}, {name}: {res[tag][name]:.4f} ms",
              flush=True)
    return res


def time_compact(work, old_source):
    import torch
    from .. import workloads
    from ..compute import sweeps
    from . import tiles
    so = os.path.join(work, "old_compact.so")
    _nvcc_shared([(old_source, so)])
    old = ctypes.CDLL(so)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    old.twk_compact.argtypes = [P_, P_, I_, I_, I_, P_, I_, I_, P_, P_, I_,
                                P_, P_, P_]
    cfg = sweeps.make_cfg("phased", False, "all", B, N_SAMPLES, 0, MIN_R2,
                          100.0)
    dev = sweeps.planes_to_device(
        workloads.build_planes_grouped(1, B, N_SAMPLES), "cuda",
        sweeps.dev_keys_for(cfg))
    counts = tiles.counts_buffer(cfg, "cuda")
    mask, parts = tiles.tile_prefilter(dev, 0, 0, True, cfg, counts=counts)
    cap, outcap = 32768, 1 << 18
    buf = torch.zeros((outcap, 2), dtype=torch.int32, device="cuda")
    n_pass, n_cand, off = (torch.zeros(1, dtype=torch.int32, device="cuda")
                           for _ in range(3))
    scratch = sweeps.compact_scratch(B, "cuda")

    def new(cnt):
        sweeps.compact_survivors(mask, parts, off, buf, n_pass, n_cand, 0,
                                 cap, cnt, scratch)

    def before():
        tmp = torch.empty(3 * B + 2, dtype=torch.int32, device="cuda")
        rc = old.twk_compact(
            mask.data_ptr(), parts.data_ptr(), 1, 2, B, off.data_ptr(), cap,
            outcap, n_pass.data_ptr(), n_cand.data_ptr(), 0, tmp.data_ptr(),
            buf.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"old compact: CUDA error {rc}")

    res = {"old": device_ms(before, 50),
           "counts given": device_ms(lambda: new(counts), 50),
           "no counts given": device_ms(lambda: new(None), 50)}
    print(f"compact, 1 part, {int((mask == 2).sum())} survivors: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in res.items()), flush=True)
    return res


class _OldTiles:
    """An earlier library's two tile launchers, handed the library's
    arguments, less the D' bounds where they predate them; anything else
    from the library."""

    def __init__(self, lib, main, dprime):
        self.lib, self.main, self.dprime = lib, main, dprime

    def twk_phased_tile(self, *a):
        if self.dprime:
            return self.lib.twk_phased_tile(*a)
        return self.lib.twk_phased_tile(*a[:19], *a[21:])

    def twk_parts_tile(self, *a):
        if self.dprime:
            return self.lib.twk_parts_tile(*a)
        return self.lib.twk_parts_tile(*a[:28], *a[30:])

    def __getattr__(self, name):
        return getattr(self.main, name)


def time_old_tiles(work, old_dir):
    """phased_tile and parts_tile of `old_dir` against the library's: ms a
    call, in turns, on the -p tile and on each of PARTS_GROUPS. Returns
    {group: {"old": [ms, ms], "new": [ms, ms]}}."""
    import torch
    from .. import workloads
    from ..compute import sweeps
    from . import _build, tiles
    so = os.path.join(work, "old_tiles.so")
    objs = [os.path.join(work, f"old_{s}.o") for s in ("phased", "parts")]
    _build._run([[_build._nvcc(), *_build.NVCC_FLAGS, "-c",
                  os.path.join(old_dir, f"{s}_tile.cu"), "-o", o]
                 for s, o in zip(("phased", "parts"), objs)])
    _build._run([[_build._nvcc(), *_build.LINK_FLAGS, "-o", so, *objs]])
    main = _build.library()
    lib = ctypes.CDLL(so)
    with open(os.path.join(old_dir, "phased_tile.cu")) as fh:
        dprime = "dp_lo" in fh.read()
    if dprime:
        for name in ("twk_phased_tile", "twk_parts_tile"):
            getattr(lib, name).argtypes = _build._SIGNATURES[name]
    else:
        P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.twk_phased_tile.argtypes = [P_] * 12 + [I_] * 5 + [F_] * 2 \
            + [I_] * 2 + [P_] * 4
        lib.twk_parts_tile.argtypes = [I_] + [P_] * 20 + [I_] * 5 \
            + [F_] * 2 + [I_] * 2 + [P_] * 4
    old = _OldTiles(lib, main, dprime)
    res = {}
    for group in (("phased", False, "all"),) + PARTS_GROUPS:
        planes = (workloads.build_planes(2, B, N_SAMPLES, seed=0)
                  if group[:2] == ("phased", False)
                  else workloads.genotype_planes(2, B, N_SAMPLES))
        dev = sweeps.planes_to_device(planes, "cuda")
        cfg = sweeps.make_cfg(*group, B, N_SAMPLES, 0, MIN_R2, 100.0)
        out = tiles.tile_buffers(cfg, "cuda")
        counts = tiles.counts_buffer(cfg, "cuda")
        tag = "/".join(map(str, group))
        res[tag] = {"old": [], "new": []}
        masks = []
        for side in ("old", "new", "new", "old"):
            _build._lib = old if side == "old" else main
            try:
                masks.append(tiles.tile_prefilter(dev, 0, 1, False, cfg, out,
                                                  counts)[0].clone())
                res[tag][side].append(device_ms(lambda: tiles.tile_prefilter(
                    dev, 0, 1, False, cfg, out, counts), 20, main))
            finally:
                _build._lib = main
        if any(not torch.equal(m, masks[0]) for m in masks):
            raise SystemExit(f"{tag}: the old and new masks differ")
        print(f"{tag}: old {res[tag]['old']}, new {res[tag]['new']} ms",
              flush=True)
    return res


class _OldEpilogue:
    """An earlier library's epilogue launcher, from before it wrote counts,
    handed the library's arguments less the counts; anything else from the
    library."""

    def __init__(self, lib, main):
        self.lib, self.main = lib, main

    def twk_tile_epilogue(self, *a):
        return self.lib.twk_tile_epilogue(*a[:-2], a[-1])

    def __getattr__(self, name):
        return getattr(self.main, name)


def time_epilogue(work, old_dir=None):
    """epilogue.cu's variants (EPILOGUE_CUTS) in each (table, has_missing)
    instance on the summed parts of the off-diagonal tile of genotype
    planes (cls "all", no window), each library swapped in for the kernel
    library around tiles.tile_epilogue with a counts buffer, the outputs of
    the right variants checked against the library's; the library's kernel
    without a counts buffer; with `old_dir`, that tree's epilogue.cu (the
    launcher without counts) against the library's in turns (old, new,
    new, old), masks checked equal. Returns {instance: {variant: ms}}."""
    import torch
    from .. import workloads
    from ..compute import sweeps
    from . import _build, tiles
    main_lib = _build.library()
    libs = dict(zip(EPILOGUE_CUTS, _edited_builds(
        work, "epilogue.cu", EPILOGUE_CUTS, "epi", "epilogue_kernel")))
    old = None
    if old_dir is not None:
        with open(os.path.join(old_dir, "epilogue.cu")) as fh:
            takes_counts = "void* mask, void* counts" in fh.read()
        so = os.path.join(work, "old_epilogue.so")
        _nvcc_shared([(os.path.join(old_dir, "epilogue.cu"), so)])
        lib = ctypes.CDLL(so)
        sig = _build._SIGNATURES["twk_tile_epilogue"]
        lib.twk_tile_epilogue.argtypes = sig if takes_counts \
            else sig[:-2] + sig[-1:]
        old = lib if takes_counts else _OldEpilogue(lib, main_lib)
    dev = sweeps.planes_to_device(
        workloads.genotype_planes(2, B, N_SAMPLES), "cuda")
    res = {}
    for table, miss in (("phased", False), ("phased", True),
                        ("unphased", False), ("unphased", True)):
        cfg = sweeps.make_cfg(table, miss, "all", B, N_SAMPLES, 0, MIN_R2,
                              100.0)
        out = tiles.tile_buffers(cfg, "cuda")
        counts = tiles.counts_buffer(cfg, "cuda")
        tiles.tile_local_parts(dev, 0, 1, cfg, out)
        call = lambda c=counts: tiles.tile_epilogue(dev, 0, 1, False, cfg,
                                                    out, c)
        want = call()[0].clone()
        want_c = counts.clone()
        tag = f"{table}/{miss}"
        res[tag] = {}
        for name, so in libs.items():
            lib = ctypes.CDLL(so)
            lib.twk_tile_epilogue.argtypes = \
                _build._SIGNATURES["twk_tile_epilogue"]
            lib.twk_tile_epilogue.restype = ctypes.c_int
            _build._lib = lib
            try:
                call()
                if name != "no prefilter" and not (
                        torch.equal(out[0], want)
                        and torch.equal(counts, want_c)):
                    raise SystemExit(f"tile_epilogue {tag}, {name}: the "
                                     f"mask or counts differ")
                res[tag][name] = device_ms(call, 20, main_lib)
            finally:
                _build._lib = main_lib
            print(f"tile_epilogue {tag}, {name}: {res[tag][name]:.4f} ms",
                  flush=True)
        res[tag]["whole, no counts"] = device_ms(lambda: call(None), 20)
        print(f"tile_epilogue {tag}, whole, no counts: "
              f"{res[tag]['whole, no counts']:.4f} ms", flush=True)
        if old is not None:
            turns = {"old": [], "new": []}
            for side in ("old", "new", "new", "old"):
                _build._lib = old if side == "old" else main_lib
                try:
                    out[0].fill_(7)
                    call()
                    if not torch.equal(out[0], want):
                        raise SystemExit(f"tile_epilogue {tag}: the old and "
                                         f"new masks differ")
                    turns[side].append(device_ms(call, 20, main_lib))
                finally:
                    _build._lib = main_lib
            res[tag].update(turns)
            print(f"tile_epilogue {tag}: old {turns['old']}, new "
                  f"{turns['new']} ms", flush=True)
    return res


def _fisher_rows():
    """(layout, dev, n_pass, buf with its bracket cleared, pi, pj, cfg,
    cap) of the dense workload's 10 tiles in both layouts, as
    chip_smoke.py compare_fisher sweeps them."""
    from .. import workloads
    from ..compute import sweeps
    nb = 4
    pairs = [(i, j) for i in range(nb) for j in range(i, nb)]
    pi = np.array([p[0] for p in pairs], np.int32)
    pj = np.array([p[1] for p in pairs], np.int32)
    dg = pi == pj
    for layout, planes, miss in (
            ("packed", workloads.build_planes_grouped(nb, B, N_SAMPLES),
             False),
            ("column", workloads.genotype_planes(nb, B, N_SAMPLES,
                                                 0.02, seed=13), True)):
        dev = sweeps.planes_to_device(planes, "cuda")
        cfg = sweeps.make_cfg("phased", miss, "all", B, N_SAMPLES, 0,
                              MIN_R2, 100.0, fisher=True)
        cap = 32768
        n_pass, _, buf = sweeps.fused_sweep(dev, pi, pj, dg,
                                            np.ones(len(pi), bool),
                                            cfg=cfg, cap=cap, outcap=1 << 20)
        if sweeps.fisher_packed(cfg):
            buf[:, 1] &= 0xFFFF
        else:
            buf[:, sweeps.buf_cols(cfg)] = 0
        yield layout, dev, n_pass, buf, pi, pj, cfg, cap


def _wide_rows():
    """The same for 2N = 32,768 haplotypes: workloads.fisher_tables as one
    tile of a phased sweep with missing data (chip_smoke.py
    compare_fisher_wide's rows)."""
    import torch
    from .. import workloads
    from ..compute import sweeps
    n_samples = 16384
    C = workloads.fisher_tables(2 * n_samples, sweeps.FISHER_MIN_ROWS, 17)
    cfg = sweeps.make_cfg("phased", True, "all", B, n_samples, 0, MIN_R2,
                          100.0, fisher=True)
    buf = torch.from_numpy(workloads.fisher_buffer(
        C, sweeps.out_cols(cfg))).cuda()
    dev = {"ac": torch.zeros((1, B), dtype=torch.int32, device="cuda")}
    n_pass = torch.tensor([len(C)], dtype=torch.int32, device="cuda")
    zero = np.zeros(1, np.int32)
    yield "2N = 32,768", dev, n_pass, buf, zero, zero, cfg, len(C)


def _brackets(buf, cfg):
    """(bracket f32, flagged) of every row of a buffer the Fisher kernel
    wrote (chip_smoke.py's _bracket_bits)."""
    import torch
    from ..compute import sweeps
    from . import fisher_dev as F
    if sweeps.fisher_packed(cfg):
        bits = (buf[:, 1] >> 16) & 0xFFFF
        return (bits << 16).view(torch.float32), bits == F.BF16_NAN
    br = buf[:, sweeps.buf_cols(cfg)].contiguous().view(torch.float32)
    return br, br < 0


def _old_fisher(so):
    """A launch of the walk's kernel of library `so` (the interface before
    the search: no table, one steps counter) with append_fisher_col's
    arguments."""
    import torch
    from ..compute import sweeps
    from . import _build
    from . import fisher_dev as F
    lib = ctypes.CDLL(so)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    lib.twk_fisher_bracket.argtypes = [P_] + [I_] * 9 + [P_, I_] + [P_] * 4 \
        + [ctypes.c_longlong, I_] + [P_] * 2

    def launch(dev, n_pass, buf, pi, pj, cfg, cap):
        miss = cfg["has_missing"]
        tl = torch.from_numpy(np.stack([pi, pj]).astype(np.int32)).cuda()
        ends = torch.empty(len(pi) + 1, dtype=torch.int64, device="cuda")
        rc = lib.twk_fisher_bracket(
            buf.data_ptr(), buf.shape[1], int(miss),
            int(sweeps.pack16_ok(cfg)), int(sweeps.fisher_packed(cfg)),
            sweeps.buf_cols(cfg), cfg["B"], 2 * cfg["n_samples"], cap,
            buf.shape[0], n_pass.data_ptr(), len(pi), ends.data_ptr(),
            None if miss else dev["ac"].data_ptr(),
            None if miss else tl[0].data_ptr(),
            None if miss else tl[1].data_ptr(), sweeps.FISHER_MIN_ROWS,
            F.MAX_STEPS, None, torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "old fisher_bracket launch")

    return launch


def time_fisher(work, old_dir=None, designs=False):
    """fisher_bracket.cu's cuts (FISHER_CUTS, with `designs` FISHER_DESIGNS
    too) and the whole kernel with the volume gate closed, on the survivor
    rows of `_fisher_rows` in each layout; with `old_dir`, that tree's walk
    kernel against the library's in turns. Returns {layout: {variant:
    ms}}."""
    from ..compute import sweeps
    from . import _build
    main_lib = _build.library()
    variants = dict(FISHER_CUTS, **(FISHER_DESIGNS if designs else {}))
    libs = dict(zip(variants, _edited_builds(
        work, "fisher_bracket.cu", variants, "fisher")))
    old = None
    if old_dir is not None:
        with open(os.path.join(old_dir, "fisher_bracket.cu")) as fh:
            walk_kernel = "search_table" not in fh.read()
        if walk_kernel:
            so = os.path.join(work, "old_fisher.so")
            _nvcc_shared([(os.path.join(old_dir, "fisher_bracket.cu"), so)])
            old = _old_fisher(so)
    res = {}
    for layout, dev, n_pass, buf, pi, pj, cfg, cap in itertools.chain(
            _fisher_rows(), _wide_rows()):
        res[layout] = {}
        ker = buf.clone()
        call = lambda: sweeps.append_fisher_col(dev, n_pass, ker, pi, pj,
                                                cfg, cap)
        for name, so in libs.items():
            if name == "table in shared memory" and cfg["n_samples"] > 3071:
                continue
            lib = ctypes.CDLL(so)
            lib.twk_fisher_bracket.argtypes = \
                _build._SIGNATURES["twk_fisher_bracket"]
            lib.twk_fisher_bracket.restype = ctypes.c_int
            _build._lib = lib
            try:
                res[layout][name] = device_ms(call, 20, main_lib)
            finally:
                _build._lib = main_lib
        gate = sweeps.FISHER_MIN_ROWS
        try:
            sweeps.FISHER_MIN_ROWS = 1 << 40
            res[layout]["gate closed"] = device_ms(call, 20)
        finally:
            sweeps.FISHER_MIN_ROWS = gate
        for name, ms in res[layout].items():
            print(f"fisher_bracket {layout}, {name}: {ms:.4f} ms",
                  flush=True)
        if old is None or layout not in ("packed", "column"):
            continue
        outs, turns = {}, {"old": [], "new": []}
        for side in ("old", "new", "new", "old"):
            out = buf.clone()
            fn = (lambda: old(dev, n_pass, out, pi, pj, cfg, cap)) \
                if side == "old" else (lambda: sweeps.append_fisher_col(
                    dev, n_pass, out, pi, pj, cfg, cap))
            turns[side].append(device_ms(fn, 20))
            outs[side] = _brackets(out, cfg)
        (ob, of), (nb_, nf) = outs["old"], outs["new"]
        both = ~of & ~nf
        rel = float(((nb_[both] - ob[both]).abs()
                     / ob[both].abs().clamp(min=1e-30)).max())
        if bool((nf & ~of).any()) or rel > 1e-6:
            raise SystemExit(f"fisher_bracket {layout}: the library flags "
                             f"{int((nf & ~of).sum())} lanes the old kernel "
                             f"does not, brackets {rel} apart")
        res[layout]["old"], res[layout]["new"] = turns["old"], turns["new"]
        print(f"fisher_bracket {layout}: old {turns['old']}, new "
              f"{turns['new']} ms", flush=True)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-compact", metavar="FILE")
    ap.add_argument("--old-tiles", metavar="DIR")
    ap.add_argument("--fisher-designs", action="store_true")
    args = ap.parse_args()
    from . import _build
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    work = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(work, exist_ok=True)
    try:
        out = {"phased_tile_cuts_ms": time_cuts(work),
               "parts_tile_cuts_ms": time_parts(work),
               "fisher_bracket_ms": time_fisher(work, args.old_tiles,
                                                 args.fisher_designs),
               "tile_epilogue_ms": time_epilogue(work, args.old_tiles)}
        if args.old_compact:
            out["compact_ms"] = time_compact(work, args.old_compact)
        if args.old_tiles:
            out["old_tiles_ms"] = time_old_tiles(work, args.old_tiles)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
