"""Command line of the port: `python -m tomahawk_tpu_torch <subcommand>`.

`calc` runs on the port's GPU engine and takes `--device` (default
`cuda`, which raises where torch sees no card). Every other subcommand
is host code and goes to the JAX package's jax-free CLI unchanged.
"""

import argparse
import sys

from tomahawk_tpu import cli as ref_cli


def _cmd_calc(args):
    from .compute.engine import CalcSettings, compute_ld
    if args.window is not None and int(args.window) <= 0:
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


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] != "calc":
        return ref_cli.main(argv)
    ap = argparse.ArgumentParser(
        prog="python -m tomahawk_tpu_torch",
        description="tomahawk_tpu_torch: LD on an NVIDIA GPU")
    sub = ap.add_subparsers(dest="command")
    ref_cli._add_calc(sub)
    sub.choices["calc"].add_argument(
        "--device", default="cuda",
        help="torch device: 'cuda' (the default; raises without a card) "
        "or 'cpu' (the kernels' plain PyTorch versions)")
    return _cmd_calc(ap.parse_args(argv))
