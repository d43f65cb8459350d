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

With --old-tiles DIR it also builds phased_tile.cu and parts_tile.cu of
DIR, the csrc/ of an earlier tree whose launchers take no D' bounds (the
interface before the D' term), and times them against the library's on
the -p tile and the three parts_tile groups, in turns (old, new, new,
old), each after checking that both give the same mask.

Every timed call is queued behind ~4 ms of other device work, so the host
stays ahead and the time is the device's, launch gaps included. Prints the
card's name and power limit, one line a variant, and one JSON object.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

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
    """Build each (source, library) of `jobs`, all at once."""
    from . import _build
    _build._run([[_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                  "-shared", "-o", so, src] for src, so in jobs])


def _edited_builds(work, source_name, variants, tag):
    """Build one library per entry of `variants` (name -> edits, each a
    regular expression that must match once in the source and its
    replacement), all at once; their paths in order."""
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
    _nvcc_shared(jobs)
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
    arguments less the D' bounds; anything else from the library."""

    def __init__(self, lib, main):
        self.lib, self.main = lib, main

    def twk_phased_tile(self, *a):
        return self.lib.twk_phased_tile(*a[:19], *a[21:])

    def twk_parts_tile(self, *a):
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
    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.twk_phased_tile.argtypes = [P_] * 12 + [I_] * 5 + [F_] * 2 \
        + [I_] * 2 + [P_] * 4
    lib.twk_parts_tile.argtypes = [I_] + [P_] * 20 + [I_] * 5 + [F_] * 2 \
        + [I_] * 2 + [P_] * 4
    old = _OldTiles(lib, main)
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-compact", metavar="FILE")
    ap.add_argument("--old-tiles", metavar="DIR")
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
               "parts_tile_cuts_ms": time_parts(work)}
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
