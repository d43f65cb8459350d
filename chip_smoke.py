#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (tomahawk_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. report the card (torch's name and nvidia-smi's name and power limit);
2. build the hand kernels from tomahawk_tpu_torch/csrc with nvcc;
3. compare each kernel with its plain PyTorch version at the main
   path's shape (B = 4096 variants per tile, 2,504 samples, W = 160
   words): bit-identical outputs, and the time per call of each;
4. run `calc` all-vs-all phased through the user's entry points on a
   2,504-sample x 16,384-site phased VCF with LD structure and no
   missing genotypes: `python -m tomahawk_tpu_torch import`, then
   `python -m tomahawk_tpu_torch calc -p -r 0.1` (in this process, so
   its kernel launch counts are visible); the .two record multiset must
   equal the native C++ CPU tile engine's on the same archive, field by
   field;
5. time `LdEngine.run_phased_pairs` on bench.py's two workloads (64 x
   4096 random variants; 16 x 4096 LD-grouped variants);
6. check that the calc run launched both kernels and never their plain
   versions.

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
        if "Used" in line or "spill" in line:
            _say(f"  ptxas: {line.strip()}")


def compare_kernels():
    """Kernel vs plain version on the card at the main path's shape.
    Returns {kernel: (max_abs_err, ms, plain_ms)}."""
    import torch
    import bench
    from tomahawk_tpu_torch.compute import sweeps
    from tomahawk_tpu_torch.ops import tiles

    cfg = sweeps.make_cfg("phased", False, "all", B, N_SAMPLES, 0, MIN_R2,
                          100.0)
    planes = {"random": bench.build_planes(2, B, N_SAMPLES, seed=0),
              "grouped": bench.build_planes_grouped(1, B, N_SAMPLES)}
    devs = {k: sweeps.planes_to_device(v, "cuda") for k, v in planes.items()}
    W = devs["random"]["alt_bits"].shape[-1]
    _say(f"kernel check: B={B}, {N_SAMPLES} samples, W={W} words")
    tile_err = 0
    masks = []
    for name, i, j, diag in (("random", 0, 0, True), ("random", 0, 1, False),
                             ("grouped", 0, 0, True)):
        dev = devs[name]
        mask, altalt = tiles.tile_prefilter(dev, i, j, diag, cfg)
        want_m, want_a = tiles.tile_prefilter_plain(dev, i, j, diag, cfg)
        err = max(int((mask.int() - want_m.int()).abs().max()),
                  int((altalt - want_a).abs().max()))
        _say(f"  phased_tile {name} ({i},{j}) diag={diag}: "
             f"{int((mask == 2).sum())} survivors, "
             f"{int((mask != 0).sum())} candidates, max |diff| {err}")
        if err:
            raise SystemExit("phased_tile disagrees with its plain version")
        tile_err = max(tile_err, err)
        masks.append((mask, altalt))

    comp_err = 0
    for cap in (32768, 256):
        outs = []
        for fn in (sweeps.compact_survivors,
                   sweeps.compact_survivors_plain):
            buf = torch.zeros((1 << 18, 2), dtype=torch.int32, device="cuda")
            n_pass = torch.zeros(3, dtype=torch.int32, device="cuda")
            n_cand = torch.zeros(3, dtype=torch.int32, device="cuda")
            off = torch.zeros(1, dtype=torch.int32, device="cuda")
            for t, (mask, altalt) in enumerate(masks):
                fn(mask, altalt, off, buf, n_pass, n_cand, t, cap)
            outs.append([x.long() for x in (buf, n_pass, n_cand, off)])
        err = max(int((a - b).abs().max()) for a, b in zip(*outs))
        _say(f"  compact cap={cap}: n_pass {outs[0][1].tolist()}, "
             f"n_cand {outs[0][2].tolist()}, max |diff| {err}")
        if err:
            raise SystemExit("compact disagrees with its plain version")
        comp_err = max(comp_err, err)

    dev = devs["random"]
    tile_ms = _cuda_ms(lambda: tiles.tile_prefilter(dev, 0, 1, False, cfg))
    tile_plain = _cuda_ms(
        lambda: tiles.tile_prefilter_plain(dev, 0, 1, False, cfg))
    mask, altalt = masks[2]
    bufs = [torch.zeros((1 << 18, 2), dtype=torch.int32, device="cuda"),
            torch.zeros(1, dtype=torch.int32, device="cuda"),
            torch.zeros(1, dtype=torch.int32, device="cuda"),
            torch.zeros(1, dtype=torch.int32, device="cuda")]

    def compact(fn):
        bufs[3].zero_()
        fn(mask, altalt, bufs[3], bufs[0], bufs[1], bufs[2], 0, 32768)

    comp_ms = _cuda_ms(lambda: compact(sweeps.compact_survivors))
    comp_plain = _cuda_ms(lambda: compact(sweeps.compact_survivors_plain))
    _say(f"  ms per call: phased_tile {tile_ms:.4f} (plain "
         f"{tile_plain:.4f}); compact {comp_ms:.4f} (plain "
         f"{comp_plain:.4f})")
    return {"phased_tile": (tile_err, tile_ms, tile_plain),
            "compact": (comp_err, comp_ms, comp_plain)}


def write_vcf(path, n_sites, seed=7, group=16, flip=0.02):
    """Phased VCF, no missing genotypes: every `group` consecutive sites
    are noisy copies of one haplotype template (as
    bench.build_planes_grouped), so in-group pairs carry real LD."""
    rng = np.random.default_rng(seed)
    n_grp = n_sites // group
    maf = np.minimum(rng.beta(0.5, 2.0, size=n_grp) * 0.4 + 0.05, 0.5)
    base = rng.random((n_grp, 2 * N_SAMPLES)) < maf[:, None]
    alt = np.repeat(base, group, axis=0)
    alt ^= rng.random(alt.shape) < flip
    # "a|b\t" per sample, the last tab a newline
    cells = np.empty((n_sites, N_SAMPLES, 4), np.uint8)
    cells[:, :, 0] = ord("0") + alt[:, 0::2]
    cells[:, :, 1] = ord("|")
    cells[:, :, 2] = ord("0") + alt[:, 1::2]
    cells[:, :, 3] = ord("\t")
    cells[:, -1, 3] = ord("\n")
    pos = 1000 + np.cumsum(rng.integers(50, 500, n_sites))
    with open(path, "wb") as fh:
        fh.write(b"##fileformat=VCFv4.2\n##contig=<ID=20,length=63025520>\n"
                 b'##FORMAT=<ID=GT,Number=1,Type=String,Description="GT">\n'
                 b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(f"S{i}" for i in range(N_SAMPLES)).encode()
                 + b"\n")
        for s in range(n_sites):
            fh.write(f"20\t{pos[s]}\t.\tA\tC\t.\tPASS\t.\tGT\t".encode())
            fh.write(cells[s].tobytes())


def native_reference(twk):
    """The native C++ CPU tile engine's records for `calc -p -r 0.1` on
    the same archive, with the port's super-block plan."""
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
    groups = group_tiles(tiles, "phased",
                         stacked["has_missing"].any(axis=1))
    out = []
    run_native_cpu(stacked, groups, LdFilters(min_r2=MIN_R2),
                   lambda f, r: out.extend([f.copy(), r.copy()]), None,
                   N_SAMPLES, CalcSettings(min_r2=MIN_R2), {})
    return np.concatenate(out)


def main_path(work):
    """calc through the CLI entry points; returns the kernel launch
    counts of the calc run."""
    from tomahawk_tpu.io.two import TwoReader
    from tomahawk_tpu_torch.ops import _build
    n_sites = 16384
    vcf = os.path.join(work, "ld.vcf")
    twk = os.path.join(work, "ld.twk")
    two = os.path.join(work, "ld.two")
    t0 = time.perf_counter()
    write_vcf(vcf, n_sites)
    _say(f"main path: wrote {N_SAMPLES} x {n_sites} phased VCF in "
         f"{time.perf_counter() - t0:.1f}s")
    subprocess.run([sys.executable, "-m", "tomahawk_tpu_torch", "import",
                    "-i", vcf, "-o", twk], cwd=ROOT, check=True)

    argv = ["tomahawk_tpu_torch", "calc", "-i", twk, "-o", two, "-p",
            "-r", str(MIN_R2)]
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
    _say(f"  calc: {dt:.2f}s wall, launches {launches}, plain {plain}")

    r = TwoReader(two)
    got = r.records()
    r.close()
    t0 = time.perf_counter()
    want = native_reference(twk)
    _say(f"  native CPU engine reference in {time.perf_counter() - t0:.1f}s")
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
    return launches, plain


def engine_rates(work):
    """bench.py's two workloads through LdEngine.run_phased_pairs."""
    import bench
    from tomahawk_tpu.io.header import VcfContig, VcfHeader
    from tomahawk_tpu.io.two import TwoWriter
    from tomahawk_tpu.ops.ld_math import LdFilters
    from tomahawk_tpu.compute.engine import _reverse_records
    from tomahawk_tpu_torch.compute.engine import CalcSettings, LdEngine

    hdr = VcfHeader(samples=[f"S{i}" for i in range(N_SAMPLES)],
                    contigs=[VcfContig(idx=0, name="bench")])
    filt = LdFilters(min_r2=MIN_R2)
    for tag, build, nb in (("sparse", bench.build_planes, 64),
                           ("dense", bench.build_planes_grouped, 16)):
        t0 = time.perf_counter()
        stacked = build(nb, B, N_SAMPLES)
        engine = LdEngine(stacked, N_SAMPLES, CalcSettings(min_r2=MIN_R2),
                          "cuda")
        pairs = [(i, j, i == j) for i in range(nb) for j in range(i, nb)]
        n_pairs = nb * B * (nb * B - 1) // 2
        _say(f"engine {tag}: {nb} x {B} variants built in "
             f"{time.perf_counter() - t0:.1f}s, {len(pairs)} tiles, "
             f"{n_pairs} pairs")
        for rep in ("warmup", "rep0", "rep1"):
            writer = TwoWriter(os.path.join(work, f"{tag}_{rep}.two"), hdr)
            n_rec = [0]

            def emit(recs, rev=None):
                writer.add(recs)
                writer.add(rev if rev is not None
                           else _reverse_records(recs))
                n_rec[0] += 2 * len(recs)

            t0 = time.perf_counter()
            engine.run_phased_pairs(pairs, False, filt, emit)
            writer.close()
            dt = time.perf_counter() - t0
            _say(f"  {rep}: {dt:.3f}s, {n_pairs / dt:.0f} pairs/s, "
                 f"{n_rec[0]} records")
        st = engine.stats["phased/nomiss/all"]
        _say(f"  stats (all reps): count {st['count_s']:.2f}s, extract "
             f"{st['extract_s']:.2f}s, math {st['math_s']:.2f}s, repair "
             f"tiles {st['n_repair']}, fused cap {engine._fused_cap}")


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
    from tomahawk_tpu_torch.ops import _build

    report_card()
    build_kernels()
    checks = compare_kernels()
    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    try:
        launches, plain = main_path(work)
        engine_rates(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if not all(launches[k] > 0 for k in _build.KERNELS):
        raise SystemExit(f"calc did not launch every kernel: {launches}")
    if any(plain.values()):
        raise SystemExit(f"calc took a plain version on CUDA: {plain}")
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
