#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (tomahawk_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. report the card (torch's name and nvidia-smi's name and power limit);
2. build the hand kernels from tomahawk_tpu_torch/csrc with nvcc (one
   process per source) and print ptxas's registers and spills for each
   kernel instance;
3. compare each kernel with its plain PyTorch version at the main
   paths' shapes (B = 4096 variants per tile, 2,504 samples):
   phased_tile (P = 1, W = 160 words) and compact as before; every
   parts_tile instance and phased_tile's clean class on planes with ~2%
   missing genotypes, packed as bitpack.block_to_planes packs them, on
   a diagonal and an off-diagonal tile; compact with 4- and 9-part
   payloads, pair-packed (2,504 samples) and one part per column
   (70,000 unphased samples); the time per call of each, and of the
   unphased P = 4 instance at tools/probe_pallas.py's shape (random
   het/hom words, W = 80). Outputs must be bit-identical;
4. run `calc` through the user's entry points (`python -m
   tomahawk_tpu_torch import`, then `python -m tomahawk_tpu_torch calc`
   in this process, so its kernel launch counts are visible), each path
   with the counts set to 0 just before it and read just after, and
   hold its .two record multiset against the native C++ CPU tile
   engine's on the same archive, field by field with P included:
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
5. time `LdEngine.run_phased_pairs` on bench.py's two workloads (64 x
   4096 random variants; 16 x 4096 LD-grouped variants), and
   `LdEngine.run_unphased_pairs` on 16 x 4096 random genotype variants
   without missing data (P = 4) and with 2% (P = 9);
6. check that each calc path launched each of its kernels, and never a
   plain version.

The last two lines are a JSON summary of the kernels and the device
line. Nothing here imports jax.
"""

import json
import os
import runpy
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_SAMPLES = 2504
B = 4096
MIN_R2 = 0.1


def _say(msg):
    print(msg, flush=True)


def _cuda_ms(fn, reps=10):
    """Mean device milliseconds per call of fn, after one warm-up."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def build_kernels():
    from tomahawk_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    _say(f"kernels built in {time.perf_counter() - t0:.1f}s "
         f"({_build._lib_path()})")
    for line in _build.build_log.splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            _say(f"  ptxas: {line.strip()}")


def compare_kernels():
    """phased_tile (P = 1, cls "all") and compact (one payload part)
    against their plain versions at the -p main path's shape. Returns
    {kernel: (max_abs_err, ms, plain_ms)}."""
    import torch
    import bench
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import tiles

    cfg = sweeps.make_cfg("phased", False, "all", B, N_SAMPLES, 0, MIN_R2,
                          100.0)
    planes = {"random": bench.build_planes(2, B, N_SAMPLES, seed=0),
              "grouped": bench.build_planes_grouped(1, B, N_SAMPLES)}
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
        mask, parts = tiles.tile_prefilter(dev, i, j, diag, cfg)
        want_m, want_p = tiles.tile_prefilter_plain(dev, i, j, diag, cfg)
        err = max(int((mask.int() - want_m.int()).abs().max()),
                  int((parts - want_p).abs().max()))
        _say(f"  phased_tile {name} ({i},{j}) diag={diag}: "
             f"{int((mask == 2).sum())} survivors, "
             f"{int((mask != 0).sum())} candidates, max |diff| {err}")
        if err:
            raise SystemExit("phased_tile disagrees with its plain version")
        tile_err = max(tile_err, err)
        masks.append((mask, parts))

    comp_err = 0
    for cap in (32768, 256):
        outs = []
        for fn in (sweeps.compact_survivors,
                   sweeps.compact_survivors_plain):
            buf = torch.zeros((1 << 18, 2), dtype=torch.int32, device="cuda")
            n_pass = torch.zeros(3, dtype=torch.int32, device="cuda")
            n_cand = torch.zeros(3, dtype=torch.int32, device="cuda")
            off = torch.zeros(1, dtype=torch.int32, device="cuda")
            for t, (mask, parts) in enumerate(masks):
                fn(mask, parts, off, buf, n_pass, n_cand, t, cap)
            outs.append([x.long() for x in (buf, n_pass, n_cand, off)])
        err = max(int((a - b).abs().max()) for a, b in zip(*outs))
        _say(f"  compact cap={cap}: n_pass {outs[0][1].tolist()}, "
             f"n_cand {outs[0][2].tolist()}, max |diff| {err}")
        if err:
            raise SystemExit("compact disagrees with its plain version")
        comp_err = max(comp_err, err)

    dev = devs["random"]
    out = tiles.tile_buffers(cfg, "cuda")
    tile_ms = _cuda_ms(lambda: tiles.tile_prefilter(dev, 0, 1, False, cfg,
                                                    out))
    tile_plain = _cuda_ms(
        lambda: tiles.tile_prefilter_plain(dev, 0, 1, False, cfg))
    mask, parts = masks[2]
    comp_ms, comp_plain = _time_compact(mask, parts, 2)
    _say(f"  ms per call: phased_tile {tile_ms:.4f} (plain "
         f"{tile_plain:.4f}); compact, 1 part {comp_ms:.4f} (plain "
         f"{comp_plain:.4f})")
    return {"phased_tile": (tile_err, tile_ms, tile_plain),
            "compact": (comp_err, comp_ms, comp_plain)}


def _time_compact(mask, parts, ncol):
    """(kernel ms, plain ms) per call of one tile's compaction at cap
    32768 into an [2**18, ncol] buffer."""
    import torch
    from tomahawk_tpu_torch.compute import sweeps
    bufs = [torch.zeros((1 << 18, ncol), dtype=torch.int32, device="cuda"),
            torch.zeros(1, dtype=torch.int32, device="cuda"),
            torch.zeros(1, dtype=torch.int32, device="cuda"),
            torch.zeros(1, dtype=torch.int32, device="cuda")]

    def compact(fn):
        bufs[3].zero_()
        fn(mask, parts, bufs[3], bufs[0], bufs[1], bufs[2], 0, 32768)

    return (_cuda_ms(lambda: compact(sweeps.compact_survivors)),
            _cuda_ms(lambda: compact(sweeps.compact_survivors_plain)))


def genotype_planes(n_blocks, miss_frac=0.02, seed=3, group=16, flip=0.02,
                    miss_rows=0.5):
    """bitpack.stack_planes output for n_blocks blocks of B variants at
    2,504 samples, packed as bitpack.block_to_planes packs them: every
    `group` consecutive variants are noisy copies of one haplotype
    template (group=1, flip=0: independent variants); a `miss_rows`
    share of the variants miss `miss_frac` of their genotypes (both
    alleles); the miss plane's padding bits are ones; ac and an count
    alt and missing alleles; n_het/n_hom are counted from the planes."""
    from tomahawk_tpu.ops.bitpack import (BlockPlanes, _pack_bits,
                                          _popcount_rows, stack_planes,
                                          words_for)
    rng = np.random.default_rng(seed)
    Wh, Ws = words_for(2 * N_SAMPLES), words_for(N_SAMPLES)
    planes = []
    for _ in range(n_blocks):
        n_grp = B // group
        maf = np.minimum(rng.beta(0.5, 2.0, size=n_grp) * 0.4 + 0.05, 0.5)
        base = rng.random((n_grp, 2 * N_SAMPLES), np.float32) < maf[:, None]
        alt = np.repeat(base, group, axis=0)
        if flip:
            alt ^= rng.random((B, 2 * N_SAMPLES), np.float32) < flip
        miss = rng.random((B, N_SAMPLES), np.float32) < miss_frac
        miss &= (rng.random(B) < miss_rows)[:, None]
        hap_miss = np.repeat(miss, 2, axis=1)
        alt &= ~hap_miss
        a, b = alt[:, 0::2], alt[:, 1::2]
        full = ~miss
        het_w = _pack_bits(full & (a ^ b), Ws)
        hom_w = _pack_bits(full & a & b, Ws)
        planes.append(BlockPlanes(
            n_rec=B, alt_bits=_pack_bits(alt, Wh),
            miss_bits=_pack_bits(hap_miss, Wh, pad_value=1),
            het_bits=het_w, hom_bits=hom_w,
            valid_bits=_pack_bits(full, Ws),
            pos=np.arange(B, dtype=np.int32), rid=np.zeros(B, np.int32),
            ac=alt.sum(axis=1).astype(np.int32),
            an=(2 * miss.sum(axis=1)).astype(np.int32),
            n_het=_popcount_rows(het_w), n_hom=_popcount_rows(hom_w),
            hwe=np.ones(B, np.float32), has_missing=miss.any(axis=1),
            valid=np.ones(B, bool)))
    return stack_planes(planes)


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
    off-diagonal and a diagonal tile; then the time per call of each.
    Returns {group: (max_abs_err, ms, plain_ms)}."""
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
        for i, j, diag in ((0, 1, False), (1, 1, True)):
            mask, parts = tiles.tile_prefilter(dev, i, j, diag, cfg)
            want_m, want_p = tiles.tile_prefilter_plain(dev, i, j, diag, cfg)
            err = max(int((mask.int() - want_m.int()).abs().max()),
                      int((parts - want_p).abs().max()))
            _say(f"  {name} {'/'.join(map(str, group))} ({i},{j}): P="
                 f"{parts.shape[0]}, {int((mask == 2).sum())} survivors, "
                 f"{int((mask != 0).sum())} candidates, max |diff| {err}")
            if err:
                raise SystemExit(f"{name} {group} disagrees with its plain "
                                 f"version")
            del want_m, want_p
        out = tiles.tile_buffers(cfg, "cuda")
        ms = _cuda_ms(lambda: tiles.tile_prefilter(dev, 0, 1, False, cfg,
                                                   out))
        plain = _cuda_ms(
            lambda: tiles.tile_prefilter_plain(dev, 0, 1, False, cfg), reps=3)
        _say(f"  ms per call: {name} {'/'.join(map(str, group))} {ms:.4f} "
             f"(plain {plain:.4f})")
        res[group] = (0, ms, plain)
    return res


def compare_payloads():
    """compact with 4- and 9-part payloads against its plain version:
    pair-packed at 2,504 samples (B = 4096), one part per column at
    70,000 unphased samples (a 512-row tile, where pack16_ok is false).
    Returns {P: (max_abs_err, ms, plain_ms)} at 2,504 samples."""
    import torch
    from tomahawk_tpu_torch.compute import sweeps
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
            err = 0
            for cap in (32768, 256):
                outs = []
                for fn in (sweeps.compact_survivors,
                           sweeps.compact_survivors_plain):
                    buf = torch.zeros((1 << 18, ncol), dtype=torch.int32,
                                      device="cuda")
                    cnt = [torch.zeros(2, dtype=torch.int32, device="cuda")
                           for _ in range(2)]
                    off = torch.zeros(1, dtype=torch.int32, device="cuda")
                    for t in range(2):
                        fn(mask, parts, off, buf, cnt[0], cnt[1], t, cap)
                    outs.append([x.long() for x in (buf, *cnt, off)])
                err = max([err] + [int((a - b).abs().max())
                                   for a, b in zip(*outs)])
            _say(f"  compact P={P}, {n_samples} samples, {ncol} columns, "
                 f"B={Bt}: {int(outs[0][1][0])} survivors, max |diff| "
                 f"{err}")
            if err:
                raise SystemExit("compact disagrees with its plain version")
            if n_samples == N_SAMPLES:
                ms, plain = _time_compact(mask, parts, ncol)
                _say(f"  ms per call: compact, {P} parts {ms:.4f} (plain "
                     f"{plain:.4f})")
                res[P] = (err, ms, plain)
    return res


def probe_shape():
    """The unphased P = 4 instance at tools/probe_pallas.py's shape:
    random het/hom words [4096, 80] on each side (the TPU probe's toy
    epilogue is replaced by the real prefilter). Returns (max_abs_err,
    ms, plain_ms)."""
    import torch
    from tomahawk_tpu.ops.bitpack import _popcount_rows
    from tomahawk_tpu_torch.compute import sweeps
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
    _say(f"K3 probe shape (B={B}, W={W}, random het/hom words): "
         f"parts_tile unphased P=4 {ms:.4f} ms (plain {plain:.4f}), "
         f"{int((mask == 2).sum())} survivors, max |diff| {err}")
    if err:
        raise SystemExit("parts_tile disagrees with its plain version at "
                         "the probe shape")
    return err, ms, plain


def write_vcf(path, n_sites, seed=7, group=16, flip=0.02, phased=True,
              miss_sites=0, miss_step=1, miss_frac=0.0):
    """VCF with LD: every `group` consecutive sites are noisy copies of
    one haplotype template (as bench.build_planes_grouped), genotypes
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


def native_reference(twk, mode):
    """The native C++ CPU tile engine's records for `calc -r 0.1` on the
    same archive under the JAX engine's dispatch for `mode` ("phased",
    "unphased" or "mixed"), with the port's super-block plan."""
    from tomahawk_tpu import native
    from tomahawk_tpu.compute.balancer import Balancer
    from tomahawk_tpu.compute.cpu_engine import run_native_cpu
    from tomahawk_tpu.compute.engine import (CalcSettings, _round_up,
                                             _super_ranges, group_tiles)
    from tomahawk_tpu.io.twk import TwkReader
    from tomahawk_tpu.ops.bitpack import block_to_planes, stack_planes
    from tomahawk_tpu.ops.ld_math import LdFilters
    if not native.available():
        raise SystemExit("the native CPU engine (g++ build of "
                         "tomahawk_tpu/native) is unavailable")
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
    tiles = Balancer.build(len(supers)).tile_pairs()
    groups = group_tiles(tiles, mode, stacked["has_missing"].any(axis=1))
    out = []
    run_native_cpu(stacked, groups, LdFilters(min_r2=MIN_R2),
                   lambda f, r: out.extend([f.copy(), r.copy()]), None,
                   N_SAMPLES, CalcSettings(min_r2=MIN_R2), {})
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


def run_calc(label, twk, two, flags, mode, need):
    """One calc path through the CLI entry point, in this process: the
    launch counts are set to 0 just before it and read just after; each
    kernel in `need` must have launched and no plain version run. The
    records must equal the native CPU engine's under `mode`. Returns the
    launch counts."""
    from tomahawk_tpu.io.two import TwoReader
    from tomahawk_tpu_torch.ops import _build
    argv = ["tomahawk_tpu_torch", "calc", "-i", twk, "-o", two,
            "-r", str(MIN_R2), *flags]
    _build.reset_counts()
    t0 = time.perf_counter()
    saved, sys.argv = sys.argv, argv
    try:
        runpy.run_module("tomahawk_tpu_torch", run_name="__main__")
    except SystemExit as e:
        if e.code not in (0, None):
            raise
    finally:
        sys.argv = saved
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    plain = dict(_build.PLAIN_CALLS)
    _say(f"main path {label}: `calc {' '.join(flags + ['-r', str(MIN_R2)])}`"
         f" {dt:.2f}s wall, launches {launches}, plain {plain}")
    idle = sorted(k for k in need if launches[k] == 0)
    if idle:
        raise SystemExit(f"calc {label} did not launch {idle}: {launches}")
    if any(plain.values()):
        raise SystemExit(f"calc {label} took a plain version on CUDA: "
                         f"{plain}")

    r = TwoReader(two)
    got = r.records()
    r.close()
    t0 = time.perf_counter()
    want, groups = native_reference(twk, mode)
    _say(f"  native CPU engine reference ({mode}: {groups}) in "
         f"{time.perf_counter() - t0:.1f}s")
    fields = list(got.dtype.names)
    got, want = np.sort(got, order=fields), np.sort(want, order=fields)
    if len(got) != len(want) or len(got) == 0:
        raise SystemExit(f"record count {len(got)} != reference "
                         f"{len(want)}")
    for f in fields:
        if not np.array_equal(got[f], want[f]):
            raise SystemExit(f".two field {f} differs from the native "
                             f"CPU engine")
    for f in ("D", "Dprime", "R", "R2", "P"):
        if not np.isfinite(got[f]).all():
            raise SystemExit(f"non-finite {f} in the output")
    _say(f"  {len(got)} records equal the native CPU engine's field by "
         f"field (P included); R2 in [{got['R2'].min():.3f}, "
         f"{got['R2'].max():.3f}]")
    return launches


def main_paths(work):
    """The four calc paths of phase 4. Returns the launch counts summed
    over them."""
    ld = make_archive(work, "ld", 16384)
    miss = make_archive(work, "miss", 16384, miss_sites=12288, miss_step=2,
                        miss_frac=0.025)
    unph = make_archive(work, "unph", 8192, seed=8, phased=False,
                        miss_sites=4096, miss_frac=0.02)
    two = os.path.join(work, "ld.two")
    paths = (
        ("a", ld, ["-p"], "phased", ("phased_tile", "compact")),
        ("b", miss, [], "mixed", ("phased_tile", "parts_tile", "compact")),
        ("c", unph, ["-u"], "unphased", ("parts_tile", "compact")),
        ("d", miss, ["-p"], "phased", ("phased_tile", "parts_tile",
                                       "compact")))
    total = {}
    for label, twk, flags, mode, need in paths:
        launches = run_calc(label, twk, two, flags, mode, need)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def _time_engine(work, tag, run, n_pairs, stat_key, engine):
    """Three reps (warm-up, rep0, rep1) of one engine workload into
    .two files; prints pairs/s per rep."""
    from tomahawk_tpu.compute.engine import _reverse_records
    from tomahawk_tpu.io.header import VcfContig, VcfHeader
    from tomahawk_tpu.io.two import TwoWriter
    hdr = VcfHeader(samples=[f"S{i}" for i in range(N_SAMPLES)],
                    contigs=[VcfContig(idx=0, name="bench")])
    for rep in ("warmup", "rep0", "rep1"):
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
        _say(f"  {rep}: {dt:.3f}s, {n_pairs / dt:.0f} pairs/s, "
             f"{n_rec[0]} records")
    st = engine.stats[stat_key]
    _say(f"  stats (all reps): count {st['count_s']:.2f}s, extract "
         f"{st['extract_s']:.2f}s, math {st['math_s']:.2f}s, repair "
         f"tiles {st['n_repair']}, fused cap {engine._fused_cap}")


def engine_rates(work):
    """bench.py's two workloads through LdEngine.run_phased_pairs, and
    random genotype variants through LdEngine.run_unphased_pairs with
    no missing data (P = 4) and 2% missing genotypes (P = 9)."""
    import bench
    from tomahawk_tpu.ops.ld_math import LdFilters
    from tomahawk_tpu_torch.compute.engine import CalcSettings, LdEngine

    filt = LdFilters(min_r2=MIN_R2)
    workloads = (
        ("sparse", lambda: bench.build_planes(64, B, N_SAMPLES), 64, "phased",
         False),
        ("dense", lambda: bench.build_planes_grouped(16, B, N_SAMPLES), 16,
         "phased", False),
        ("unphased P=4", lambda: genotype_planes(
            16, 0.0, seed=11, group=1, flip=0.0), 16, "unphased", False),
        ("unphased P=9", lambda: genotype_planes(
            16, 0.02, seed=12, group=1, flip=0.0, miss_rows=1.0), 16,
         "unphased", True))
    for tag, build, nb, table, miss in workloads:
        t0 = time.perf_counter()
        stacked = build()
        engine = LdEngine(stacked, N_SAMPLES, CalcSettings(min_r2=MIN_R2),
                          "cuda")
        pairs = [(i, j, i == j) for i in range(nb) for j in range(i, nb)]
        n_pairs = nb * B * (nb * B - 1) // 2
        _say(f"engine {tag}: {nb} x {B} variants built in "
             f"{time.perf_counter() - t0:.1f}s, {len(pairs)} tiles, "
             f"{n_pairs} pairs")
        run = (engine.run_phased_pairs if table == "phased"
               else engine.run_unphased_pairs)
        _time_engine(work, tag.replace(" ", "_").replace("=", ""),
                     lambda emit: run(pairs, miss, filt, emit), n_pairs,
                     f"{table}/{'miss' if miss else 'nomiss'}/all", engine)
        del engine, stacked


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "tomahawk_tpu_torch")):
        print("chip_smoke: run from the root of a checkout",
              file=sys.stderr)
        return 1
    sys.modules["jax"] = None           # nothing here may import jax
    sys.path.insert(0, ROOT)
    from tomahawk_tpu_torch.device import kernel_report

    report_card()
    build_kernels()
    checks = compare_kernels()
    groups = compare_groups()
    payloads = compare_payloads()
    probe = probe_shape()
    torch.cuda.empty_cache()
    # the kernels line: phased_tile at the -p path's shape; parts_tile
    # and compact at the default (mixed) dispatch's 9-part sweep
    checks["parts_tile"] = (max(max(v[0] for v in groups.values()),
                                probe[0]),) + groups[MAIN_GROUP][1:]
    checks["compact"] = (max(checks["compact"][0],
                             max(v[0] for v in payloads.values())),
                         ) + payloads[9][1:]
    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    try:
        launches = main_paths(work)
        engine_rates(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kernels = [dict(name=k["name"], route="cuda", source=k["source"],
                    replaces=k["replaces"], launches=launches[k["name"]],
                    max_abs_err=checks[k["name"]][0],
                    ms=checks[k["name"]][1], plain_ms=checks[k["name"]][2])
               for k in kernel_report()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
