#!/usr/bin/env python3
"""Where the tile kernels' time goes.

    python3 time_variants.py

A measurement, not part of the library or of chip_smoke.py; needs an
NVIDIA GPU and nvcc, and runs from the root of a checkout. It builds
csrc/phased_tile.cu whole and once per entry of CUTS, each from a copy
with parts of the kernel edited out (the outputs of those builds are
wrong by design), and times each on the -p tile (B = 4096, 2,504
samples, W = 160 words, off-diagonal). The differences say what the
staging + MMA loop, the prefilter's arithmetic and the stores cost, and
how far they overlap. It does the same for
csrc/parts_tile.cu (PARTS_CUTS) in its three instances, on the
off-diagonal tile of genotype planes with ~1% of genotypes missing, and
times PARTS_SHAPES, copies with another block shape or register budget
whose outputs are right. PARTS_CUTS' "exact statement for every pair"
times the unphased prefilter without its division-free screen, and
`screen_share` prints the share of candidates the screen leaves to the
exact statement, on the unphased benchmark cell's planes too.

It builds csrc/fisher_bracket.cu whole and once per entry of
FISHER_CUTS and times each on the survivor rows of the dense workload's
10 tiles (4 LD-grouped super-blocks) in both layouts and on
chip_smoke.py's 16,988 tables at 2N = 32,768 (the 4-part layout), and
the whole kernel with the volume gate closed (the `ends` launch and an
empty second launch): where the Fisher search spends its time.

It builds csrc/epilogue.cu whole and once per entry of EPILOGUE_CUTS and
times each on the summed parts of the off-diagonal genotype tile in its
four (table, has_missing) instances, with a counts buffer, and the whole
kernel without one: what the prefilter, the one half of the unphased
prefilter a pair, the pairs a lane and the rows a block cost.

Every timed call is queued behind ~4 ms of other device work, so the host
stays ahead and the time is the device's, launch gaps included. Prints the
card's name and power limit, one line a variant, and one JSON object.
"""

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
_P_PREFILTER = (r"pair_mask<KIND, DP, COUNT>\(a, v, k, l0 \+ e, aci, vi\)",
                "(unsigned)(v[0] & 1) + (unsigned)(v[1] & 1)")
# the unphased prefilter's division-free screen cut: every candidate takes
# the exact f32 statement inline (the decision path before the screen)
_P_EXACT = (r"twk::unphased_screen<DP>\(T, a\.bnd, a\.scr\)",
            "(twk::unphased_prefilter<DP>(T, a.bnd) ? twk::kKeep "
            ": twk::kReject)")
_P_PARTS = (r"__stcs\(reinterpret_cast<int2\*>\(a\.parts.*?\)\);\n",
            "(void)0;\n")
#: variant -> edits of parts_tile.cu, as CUTS
PARTS_CUTS = {"whole": (), "no loop": (_P_LOOP,),
              "no prefilter": (_P_PREFILTER,),
              "exact statement for every pair": (_P_EXACT,),
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
#: variant -> edits of fisher_bracket.cu, as CUTS
FISHER_CUTS = {"whole": (), "no tail": (_F_TAIL,),
               "no search, no tail": (_F_SEARCH,)}
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
    from tomahawk_tpu_torch.ops import _build
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
    from tomahawk_tpu_torch.ops import _build
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
    from tomahawk_tpu_torch.ops import _build
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
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import _build, tiles
    from tomahawk_tpu_torch.ops import ld_kernels as K
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
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import _build, tiles
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


#: the unphased benchmark cell whose planes screen_share draws
SCREEN_CELL = "ldbench/cells/kg3_unphased.engine_far.json"


def screen_share():
    """The share of candidate pairs the unphased prefilter's screen leaves
    to the exact statement (parts_tile's screen counter), on the
    off-diagonal tiles among 4 super-blocks drawn as the unphased
    benchmark cell draws its planes (ldbench/traffic/genotype.py with the
    cell's traffic, 2 seeds) and on the tile of workloads.genotype_planes
    the cuts are timed on. Returns {planes: (screened, undecided)}."""
    import torch
    from ldbench.traffic import genotype
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import tiles
    with open(SCREEN_CELL) as fh:
        traffic = json.load(fh)["traffic"]
    cfg = sweeps.make_cfg("unphased", True, "all", B, N_SAMPLES, 0, MIN_R2,
                          100.0)
    out = tiles.tile_buffers(cfg, "cuda")
    sets = {f"cell seed {seed}": (sweeps.planes_to_device(genotype.draw(
        [B] * 4, B, N_SAMPLES, seed, "cuda", **traffic), "cuda"),
        [(0, 1), (0, 2), (1, 3), (2, 3)]) for seed in (2**31 + 7, 11)}
    sets["workloads.genotype_planes"] = (sweeps.planes_to_device(
        workloads.genotype_planes(2, B, N_SAMPLES), "cuda"), [(0, 1)])
    res = {}
    for name, (dev, pairs) in sets.items():
        screen = torch.zeros(2, dtype=torch.int64, device="cuda")
        for i, j in pairs:
            tiles.tile_prefilter(dev, i, j, False, cfg, out, screen=screen)
        scr, und = screen.tolist()
        res[name] = (scr, und)
        print(f"parts_tile screen on {name}: {und} of {scr} candidate "
              f"pairs undecided ({und / max(scr, 1):.3e})", flush=True)
    return res


def time_epilogue(work):
    """epilogue.cu's variants (EPILOGUE_CUTS) in each (table, has_missing)
    instance on the summed parts of the off-diagonal tile of genotype
    planes (cls "all", no window), each library swapped in for the kernel
    library around tiles.tile_epilogue with a counts buffer, the outputs of
    the right variants checked against the library's; and the library's
    kernel without a counts buffer. Returns {instance: {variant: ms}}."""
    import torch
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import _build, tiles
    main_lib = _build.library()
    libs = dict(zip(EPILOGUE_CUTS, _edited_builds(
        work, "epilogue.cu", EPILOGUE_CUTS, "epi", "epilogue_kernel")))
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
    return res


def _fisher_rows():
    """(layout, dev, n_pass, buf with its bracket cleared, pi, pj, cfg,
    cap) of the dense workload's 10 tiles in both layouts, as
    chip_smoke.py compare_fisher sweeps them."""
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute import sweeps
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
    from tomahawk_tpu_torch import workloads
    from tomahawk_tpu_torch.compute import sweeps
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


def time_fisher(work):
    """fisher_bracket.cu's cuts (FISHER_CUTS) and the whole kernel with
    the volume gate closed, on the survivor rows of `_fisher_rows` and
    `_wide_rows`. Returns {layout: {variant: ms}}."""
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import _build
    main_lib = _build.library()
    libs = dict(zip(FISHER_CUTS, _edited_builds(
        work, "fisher_bracket.cu", FISHER_CUTS, "fisher")))
    res = {}
    for layout, dev, n_pass, buf, pi, pj, cfg, cap in itertools.chain(
            _fisher_rows(), _wide_rows()):
        res[layout] = {}
        ker = buf.clone()
        call = lambda: sweeps.append_fisher_col(dev, n_pass, ker, pi, pj,
                                                cfg, cap)
        for name, so in libs.items():
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
    return res


def main():
    from tomahawk_tpu_torch.ops import _build
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    work = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(work, exist_ok=True)
    try:
        out = {"phased_tile_cuts_ms": time_cuts(work),
               "parts_tile_cuts_ms": time_parts(work),
               "parts_tile_screen": screen_share(),
               "fisher_bracket_ms": time_fisher(work),
               "tile_epilogue_ms": time_epilogue(work)}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
