"""Command line of the port: `python -m tomahawk_tpu_torch <subcommand>`.

`import` turns a VCF/BCF into a .twk archive on the host. `calc` and
`scalc` run on the port's GPU engine and take `--device` (default `cuda`,
which raises where torch sees no card); with `--distributed`, `calc` is
one process of a multi-process run, and with `--checkpoint` it resumes
after a crash (compute/engine.py). The post-processing subcommands
`view`, `sort`, `concat`, `aggregate`, `stats`, `decay` and `haplotype`
run on the host with the JAX package's arguments; `relationship` runs
its kinship GEMM on `--device` (ops/kinship.py).
"""

import argparse
import sys

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
                   help="'auto': every visible card as the pairs axis when "
                   "there is more than one (one card a process under "
                   "--distributed); 'off': one device; 'PxS': the first "
                   "P*S cards as P pairs shards of S samples slices, a "
                   "'cuda:' or 'cpu:' prefix picking the platform (under "
                   "--distributed process k takes cards k*P*S up to "
                   "(k+1)*P*S, modulo the count); 'dcn' or 'dcn:P' (with "
                   "--distributed): the packed-word axis spans the "
                   "processes, P cards each, process 0 writes the one "
                   "output")
    p.add_argument("--tile-rows", type=int, default=0,
                   help="variants per super-block tile (0 = 4096)")
    p.add_argument("--tile-backend", default="auto",
                   choices=("auto", "pallas", "xla"),
                   help="only 'auto': the port has one tile path, its "
                   "CUDA kernels")
    p.add_argument("--backend", default="auto",
                   choices=("auto", "device", "cpu"),
                   help="'cpu': the native CPU tile engine, no card; "
                   "'device': the card; 'auto': the CPU below the card's "
                   "crossover of candidate pairs x haplotypes "
                   "(compute/engine.py CPU_ROUTE_WORK, measured on an "
                   "H100; TWK_CPU_ROUTE_WORK overrides it)")
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
                   "on its share of the cards: the tile grid is partitioned "
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
    p.add_argument("--checkpoint", default="",
                   help="sidecar file of an in-run checkpoint: written "
                   "after whole sweep segments, at most every "
                   "--checkpoint-interval seconds; a run that finds one "
                   "written with its own settings resumes after it "
                   "(truncating the output to the checkpointed offset); "
                   "removed when the run completes. Distributed "
                   "tile-partition runs keep one a process (PATH.pKofN)")
    p.add_argument("--checkpoint-interval", type=float, default=60.0,
                   help="seconds between checkpoint writes")
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


def _add_view(sub):
    p = sub.add_parser("view", help="convert/filter .two")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", default="-")
    p.add_argument("-H", "--no-header", action="store_true")
    p.add_argument("--header-only", action="store_true",
                   help="print only the stored literal header "
                        "(reference view -h)")
    p.add_argument("-J", "--json", action="store_true",
                   help="print records as JSON arrays (PrintLDJson)")
    p.add_argument("-O", "--output-mode", choices=["b", "u"],
                   default="u",
                   help="b: compressed TWO, u: text LD (reference -O)")
    p.add_argument("--binary", action="store_true",
                   help="write filtered binary .two (same as -O b)")
    p.add_argument("-I", "--interval", action="append", default=[])
    # filter letters follow the reference exactly (view.h:44-59):
    # -d/-D bound D, -b/-B bound D'
    p.add_argument("-r", "--min-r2", type=float, default=None)
    p.add_argument("-R", "--max-r2", type=float, default=None)
    p.add_argument("-p", "--min-p", type=float, default=None)
    p.add_argument("-P", "--max-p", type=float, default=None)
    p.add_argument("-d", "--min-d", type=float, default=None)
    p.add_argument("-D", "--max-d", type=float, default=None)
    p.add_argument("-b", "--min-dprime", type=float, default=None)
    p.add_argument("-B", "--max-dprime", type=float, default=None)
    p.add_argument("-z", "--min-r", type=float, default=None)
    p.add_argument("-Z", "--max-r", type=float, default=None)
    p.add_argument("-x", "--min-chi", type=float, default=None,
                   help="min ChiSqFisher (contingency chi-squared)")
    p.add_argument("-X", "--max-chi", type=float, default=None)
    p.add_argument("-m", "--min-mcv", type=float, default=None,
                   help="min ChiSqModel (unphased model chi-squared)")
    p.add_argument("-M", "--max-mcv", type=float, default=None)
    for cell, desc in (("p1", "REF_REF"), ("p2", "REF_ALT"),
                       ("q1", "ALT_REF"), ("q2", "ALT_ALT")):
        p.add_argument(f"--min-{cell}", type=float, default=None,
                       help=f"min {desc} haplotype count")
        p.add_argument(f"--max-{cell}", type=float, default=None)
    p.add_argument("--hap-min", type=float, default=0.0,
                   help="minimum count in any haplotype cell")
    p.add_argument("-a", "--min-mhc", type=float, default=None,
                   help="min non-major haplotype count (sum of all "
                        "cells except the largest)")
    p.add_argument("-A", "--max-mhc", type=float, default=None)
    p.add_argument("-f", "--flag-include", type=int, default=0)
    p.add_argument("-F", "--flag-exclude", type=int, default=0)
    p.add_argument("-u", "-U", "--upper-only", action="store_true")
    p.add_argument("-l", "-L", "--lower-only", action="store_true")


def _rng(lo, hi):
    return (lo, hi) if lo is not None or hi is not None else None


def _cmd_view(args):
    from .post.filters import TwoFilter
    from .post.view import view
    filt = TwoFilter(
        r2=_rng(args.min_r2, args.max_r2),
        r=_rng(args.min_r, args.max_r),
        p=_rng(args.min_p, args.max_p),
        d=_rng(args.min_d, args.max_d),
        dprime=_rng(args.min_dprime, args.max_dprime),
        chisq_fisher=_rng(args.min_chi, args.max_chi),
        chisq_model=_rng(args.min_mcv, args.max_mcv),
        refref=_rng(args.min_p1, args.max_p1),
        refalt=_rng(args.min_p2, args.max_p2),
        altref=_rng(args.min_q1, args.max_q1),
        altalt=_rng(args.min_q2, args.max_q2),
        hap_min=args.hap_min,
        mhc=_rng(args.min_mhc, args.max_mhc),
        flag_include=args.flag_include, flag_exclude=args.flag_exclude,
        upper_only=args.upper_only, lower_only=args.lower_only)
    out = None if args.output in ("-", "") else args.output
    if args.binary or args.output_mode == "b":
        view(args.input, output=out or "-", filt=filt,
             intervals=args.interval, binary=True)
    else:
        stream = open(out, "w") if out else sys.stdout
        view(args.input, filt=filt, intervals=args.interval,
             show_header=not args.no_header,
             header_only=args.header_only, json_out=args.json,
             out_stream=stream)
        if out:
            stream.close()
    return 0


def _add_sort(sub):
    p = sub.add_parser("sort", help="sort .two records")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-m", "--memory-limit", type=float, default=0.5,
                   help="GB per in-memory run")
    p.add_argument("-c", "--c-level", type=int, default=1)
    p.add_argument("-t", "--threads", type=int, default=0)


def _cmd_sort(args):
    from .post.sort import sort_two
    sort_two(args.input, args.output, memory_limit_gb=args.memory_limit,
             c_level=args.c_level, threads=args.threads)
    return 0


def _add_concat(sub):
    p = sub.add_parser("concat", help="concatenate .two files")
    p.add_argument("-i", "--input", action="append", default=[])
    p.add_argument("-I", "--input-list", default=None,
                   help="text file with one input path per line")
    p.add_argument("-o", "--output", required=True)


def _cmd_concat(args):
    from .post.concat import concat_two
    inputs = list(args.input)
    if args.input_list:
        with open(args.input_list) as fh:
            inputs += [ln.strip() for ln in fh if ln.strip()]
    if len(inputs) < 2:
        raise SystemExit("concat needs at least two input files")
    concat_two(inputs, args.output)
    return 0


def _add_aggregate(sub):
    p = sub.add_parser("aggregate", help="rasterize .two -> .twa matrix")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-f", "--aggregate-function", default="r2",
                   choices=["r", "r2", "d", "dprime", "dp", "p",
                            "hets", "alts", "het", "alt"])
    p.add_argument("-r", "--reduce-function", default="mean",
                   choices=["mean", "max", "min", "count", "n", "total",
                            "sd"])
    p.add_argument("-x", "--xbins", type=int, default=1000)
    p.add_argument("-y", "--ybins", type=int, default=1000)
    p.add_argument("-c", "--min-count", type=int, default=5)
    p.add_argument("-O", "--output-type", default="b", choices=["b", "u"],
                   help="b: binary .twa; u: uncompressed text matrix "
                        "(reference PrintMatrix)")
    p.add_argument("-I", "--interval", action="append", default=[])
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="threads for the two passes (0 = all cores)")


def _cmd_aggregate(args):
    from .post.aggregate import aggregate_two
    twa = aggregate_two(
        args.input,
        args.output if args.output_type == "b" else "-",
        agg=args.aggregate_function, reduce=args.reduce_function,
        xbins=args.xbins, ybins=args.ybins, min_count=args.min_count,
        intervals=args.interval, write=args.output_type == "b",
        threads=args.threads)
    if args.output_type == "u":
        # reference PrintMatrix: one tab-separated row per x bin
        stream = (sys.stdout if args.output in ("-", "")
                  else open(args.output, "w"))
        for i in range(twa.x):
            stream.write("\t".join(f"{v:.6g}" for v in twa.data[i])
                         + "\n")
        if stream is not sys.stdout:
            stream.close()
    return 0


def _add_stats(sub):
    p = sub.add_parser("stats", help="summary statistics of a .two file")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-b", "--bins", type=int, default=10)


def _cmd_stats(args):
    from .post.stats import stats_two
    stats_two(args.input, bins=args.bins)
    return 0


def _add_decay(sub):
    p = sub.add_parser("decay", help="LD decay as a function of distance")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-w", "-r", "--range", type=float, default=10_000_000,
                   help="maximum distance window in bp")
    p.add_argument("-b", "--bins", type=int, default=1000)
    p.add_argument("-I", "--interval", action="append", default=[])
    p.add_argument("--positional", action="store_true",
                   help="per-variant positional decay (the reference's "
                   "decay; default when -I is given)")
    p.add_argument("--binned", action="store_true",
                   help="binned mean-r2 vs distance (the reference's "
                   "commented-out Decay variant; default without -I)")


def _cmd_decay(args):
    from .post.decay import decay, positional_decay
    # the reference decay CLI runs PositionalDecay and requires an
    # interval (decay.h:95-108); mirror that dispatch when -I is given
    positional = args.positional or (args.interval and not args.binned)
    if positional:
        positional_decay(args.input, intervals=args.interval)
    else:
        decay(args.input, max_range=int(args.range), n_bins=args.bins,
              intervals=args.interval)
    return 0


def _add_haplotype(sub):
    p = sub.add_parser("haplotype", help="extract haplotype strings")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", default="-")
    p.add_argument("-I", "--interval", required=True)
    p.add_argument("--format", default="fasta", choices=["fasta", "tsv"])
    p.add_argument("-m", "--matrix", action="store_true",
                   help="tab-separated matrix output (same as --format tsv)")
    p.add_argument("-n", "--numeric", action="store_true",
                   help="emit 0/1/2 instead of ref/alt/N bases")


def _cmd_haplotype(args):
    from .post.haplotype import haplotype
    if args.matrix:
        args.format = "tsv"
    haplotype(args.input, args.output, args.interval, fmt=args.format,
              numeric=args.numeric)
    return 0


def _add_relationship(sub):
    p = sub.add_parser("relationship",
                       help="pairwise sample kinship/IBS matrix")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", default="-")
    p.add_argument("-I", "--interval", action="append", default=[])
    p.add_argument("--device", default="cuda",
                   help="torch device of the kinship GEMM: 'cuda' (the "
                   "default; torch._int_mm, raises without a card) or "
                   "'cpu' (its plain version)")


def _cmd_relationship(args):
    from .post.relationship import relationship
    relationship(args.input, args.output, intervals=args.interval,
                 device=args.device)
    return 0


COMMANDS = {
    "import": _cmd_import,
    "calc": _cmd_calc,
    "scalc": _cmd_scalc,
    "view": _cmd_view,
    "sort": _cmd_sort,
    "concat": _cmd_concat,
    "aggregate": _cmd_aggregate,
    "stats": _cmd_stats,
    "decay": _cmd_decay,
    "haplotype": _cmd_haplotype,
    "relationship": _cmd_relationship,
}


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m tomahawk_tpu_torch",
        description="tomahawk_tpu_torch: LD on an NVIDIA GPU")
    sub = ap.add_subparsers(dest="command")
    for adder in (_add_import, _add_calc, _add_scalc, _add_view, _add_sort,
                  _add_concat, _add_aggregate, _add_stats, _add_decay,
                  _add_haplotype, _add_relationship):
        adder(sub)
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.command:
        ap.print_help()
        return 1
    return COMMANDS[args.command](args)
