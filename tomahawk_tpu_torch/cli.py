"""Command line of the port: `python -m tomahawk_tpu_torch <subcommand>`.

`import` turns a VCF/BCF into a .twk archive on the host. `calc` and
`scalc` run on the port's GPU engine and take `--device` (default `cuda`,
which raises where torch sees no card); with `--distributed`, `calc` is
one process of a multi-process run (compute/engine.py). The
post-processing subcommands are not ported yet: they raise, naming the
ROADMAP.md item that brings each.
"""

import argparse
import sys

#: subcommands of the reference CLI this port does not own yet, with the
#: ROADMAP.md queue 1 item that ports each
UNPORTED = {
    name: "item 13b (post-processing subcommands: post/ copied, "
    "relationship's GEMM as X4)"
    for name in ("view", "sort", "concat", "aggregate", "stats", "decay",
                 "haplotype", "relationship")}

_DEVICE_HELP = ("torch device: 'cuda' (the default; raises without a card) "
                "or 'cpu' (the kernels' plain PyTorch versions)")


def _add_import(sub):
    p = sub.add_parser("import", help="import VCF into .twk")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    # reference letters (-n missingness, -r keep-univariate, -L level;
    # import.h:26-129) are accepted alongside the long spellings
    p.add_argument("-c", "-L", "--c-level", type=int, default=1)
    p.add_argument("-b", "--block-size", type=int, default=500)
    p.add_argument("-n", "-m", "--threshold-miss", type=float,
                   default=0.9,
                   help="minimum fraction of fully-called samples")
    p.add_argument("-H", "--hwe", type=float, default=0.0,
                   help="minimum HWE p-value")
    p.add_argument("-r", "--keep-univariate", action="store_true",
                   help="retain invariant sites")
    p.add_argument("-f", "--flip-major-minor", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="parse worker processes (0 = auto). Output is "
                   "byte-identical at any worker count")


def _cmd_import(args):
    from .io.importer import ImportSettings, import_vcf
    s = ImportSettings(input=args.input, output=args.output,
                       c_level=args.c_level, block_size=args.block_size,
                       threshold_miss=args.threshold_miss, hwe=args.hwe,
                       remove_univariate=not args.keep_univariate,
                       flip_major_minor=args.flip_major_minor,
                       workers=args.threads)
    import_vcf(s)
    return 0


def _add_calc(sub):
    """The reference CLI's `calc` options. Those that select what this
    port does not run yet parse and are then rejected by the engine,
    which names the ROADMAP.md item that adds each."""
    p = sub.add_parser("calc", help="compute pairwise LD -> .two")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", default="-")
    p.add_argument("-p", "--phased", action="store_true",
                   help="force phased math")
    p.add_argument("-u", "--unphased", action="store_true",
                   help="force unphased math")
    p.add_argument("-w", "--window", type=float, default=None,
                   help="window size in bp (enables window mode; "
                   "must be positive, like the reference calc.h:204)")
    p.add_argument("-P", "--min-p", type=float, default=1.0)
    p.add_argument("-r", "--min-r2", type=float, default=0.1)
    p.add_argument("-R", "--max-r2", type=float, default=100.0)
    p.add_argument("-d", "--min-dprime", type=float, default=0.0)
    p.add_argument("-D", "--max-dprime", type=float, default=100.0)
    p.add_argument("-c", "--n-chunks", type=int, default=1)
    p.add_argument("-C", "--c-chunk", type=int, default=0)
    p.add_argument("-I", "--interval", action="append", default=[])
    p.add_argument("-b", "--b-size", type=int, default=10000)
    p.add_argument("-l", "-k", "--c-level", type=int, default=1)
    p.add_argument("-m", "--low-memory", action="store_true",
                   help="accepted for reference compatibility; banded "
                   "streaming (the low-memory path) engages whenever the "
                   "planes exceed --memory-gb")
    p.add_argument("--performance", action="store_true",
                   help="print the per-sweep-group dispatch and timing "
                   "report (reference ComputePerformance analogue)")
    p.add_argument("--mesh", default="auto",
                   help="'auto' or 'off': one device per process; 'dcn' "
                   "(with --distributed): the packed-word axis spans the "
                   "processes, process 0 writes the one output; P x S "
                   "device meshes are not ported yet")
    p.add_argument("--tile-rows", type=int, default=0,
                   help="variants per super-block tile (0 = 4096)")
    p.add_argument("--tile-backend", default="auto",
                   choices=("auto", "pallas", "xla"),
                   help="only 'auto': the port has one tile path, its "
                   "CUDA kernels")
    p.add_argument("--backend", default="auto",
                   choices=("auto", "device", "cpu"),
                   help="'cpu' (the native CPU tile engine) is not "
                   "ported yet")
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="host threads for block unpacking (0 = all)")
    p.add_argument("-M", "--memory-gb", type=float, default=12.0,
                   help="device-memory budget for the genotype planes, GB "
                   "(the reference's calc -M); larger inputs stream in "
                   "band-pair loads, with the next band uploaded while "
                   "the current load computes. The budget is the user's, "
                   "not the card's size: on an 80 GB card a larger value "
                   "keeps more of an input resident")
    p.add_argument("--distributed", action="store_true",
                   help="run as one process of a torch.distributed group, "
                   "one device per process: the tile grid is partitioned "
                   "round-robin and each process writes out.pKofN.two "
                   "(with --mesh dcn the samples axis is sharded instead); "
                   "needs --coordinator, --num-processes, --process-id")
    p.add_argument("--sort-shards", action="store_true",
                   help="position-sort this process's output in place, so "
                   "merging the shards is a single merge pass")
    p.add_argument("--coordinator", default="",
                   help="host:port every process of the run can reach")
    p.add_argument("--num-processes", type=int, default=-1)
    p.add_argument("--process-id", type=int, default=-1)
    p.add_argument("--checkpoint", default="", help="not ported yet")
    p.add_argument("--checkpoint-interval", type=float, default=60.0)
    p.add_argument("--sweep-segment", type=int, default=4096,
                   help="upper limit of tiles per sweep segment")
    p.add_argument("--no-stage-prefetch", action="store_true",
                   help="banded runs: no staging worker; every band is "
                   "inflated and uploaded on demand")
    p.add_argument("--device", default="cuda", help=_DEVICE_HELP)


def _cmd_calc(args):
    from .compute.engine import CalcSettings, compute_ld
    if args.window is not None and int(args.window) <= 0:
        # the reference rejects this too (calc.h:204-208); l_window == 0
        # encodes "no window", so neither 0 nor a fractional bp value
        # that truncates to 0 may pass through
        raise SystemExit("ERROR: cannot have a non-positive window size")
    s = CalcSettings(
        input=args.input, output=args.output,
        force_phased=args.phased, forced_unphased=args.unphased,
        window=args.window is not None,
        l_window=int(args.window) if args.window is not None
        else 1_000_000,
        min_p=args.min_p, min_r2=args.min_r2, max_r2=args.max_r2,
        min_dprime=args.min_dprime, max_dprime=args.max_dprime,
        n_chunks=args.n_chunks, c_chunk=args.c_chunk,
        intervals=args.interval, b_size=args.b_size, c_level=args.c_level,
        performance=args.performance, mesh=args.mesh,
        tile_rows=args.tile_rows, tile_backend=args.tile_backend,
        backend=args.backend,
        memory_gb=args.memory_gb, threads=args.threads,
        distributed=args.distributed, coordinator=args.coordinator,
        num_processes=args.num_processes, process_id=args.process_id,
        checkpoint=args.checkpoint,
        checkpoint_interval=args.checkpoint_interval,
        sweep_segment=args.sweep_segment,
        sort_shards=args.sort_shards,
        stage_prefetch=not args.no_stage_prefetch)
    compute_ld(s, device=args.device)
    return 0


def _add_scalc(sub):
    """The JAX package's `scalc` options (its cli.py), and `--device`."""
    p = sub.add_parser("scalc", help="single-site LD against neighbours")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", default="-")
    p.add_argument("-I", "--interval", required=True,
                   help="target site, e.g. chr20:60000")
    p.add_argument("-w", "-l", "--l-surrounding", type=float,
                   default=500_000,
                   help="bases to include around the target site")
    p.add_argument("-P", "--min-p", type=float, default=1.0)
    p.add_argument("-r", "--min-r2", type=float, default=0.0,
                   help="min r2 (the reference scalc pins this to 0, "
                        "scalc.h:189; honored here if set)")
    p.add_argument("-R", "--max-r2", type=float, default=100.0)
    p.add_argument("-d", "--min-dprime", type=float, default=0.0)
    p.add_argument("-D", "--max-dprime", type=float, default=100.0)
    p.add_argument("-k", "--c-level", type=int, default=1)
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="accepted for reference compatibility")
    p.add_argument("--device", default="cuda", help=_DEVICE_HELP)


def _cmd_scalc(args):
    from .compute.scalc import ScalcSettings, compute_single
    s = ScalcSettings(input=args.input, output=args.output,
                      interval=args.interval,
                      l_surrounding=int(args.l_surrounding),
                      min_p=args.min_p, min_r2=args.min_r2,
                      max_r2=args.max_r2, min_dprime=args.min_dprime,
                      max_dprime=args.max_dprime, c_level=args.c_level)
    compute_single(s, device=args.device)
    return 0


COMMANDS = {"import": _cmd_import, "calc": _cmd_calc, "scalc": _cmd_scalc}


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m tomahawk_tpu_torch",
        description="tomahawk_tpu_torch: LD on an NVIDIA GPU",
        epilog="not ported yet: " + ", ".join(UNPORTED))
    sub = ap.add_subparsers(dest="command")
    _add_import(sub)
    _add_calc(sub)
    _add_scalc(sub)
    return ap


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in UNPORTED:
        raise NotImplementedError(
            f"`{argv[0]}` is not ported to tomahawk_tpu_torch yet "
            f"(ROADMAP.md queue 1, {UNPORTED[argv[0]]})")
    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.command:
        ap.print_help()
        return 1
    return COMMANDS[args.command](args)
