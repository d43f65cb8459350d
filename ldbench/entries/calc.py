"""Entry `calc`: whole `calc` jobs, archive in, .two out.

Set-up draws the cell's planes on the card from the seed, writes them as
VCF text into the run's directory and imports that with the port's
importer (`import_vcf`, 512-variant blocks, so the port regroups them
into super-blocks of 4,096 as the benchmark drew them): the archive is
made anew in every run. A unit of work is one job, `compute_ld(
CalcSettings(input=<archive>, output=<dir>/job.two, ...))`, as `calc`
runs it: its own reader, inflation, engine, sweep, host math and writer,
with `backend` left to the port's choice; each job's output replaces the
last one's. A job that launched no kernel (the port's CPU route) counts
in `host_route_jobs`.
"""

import os
import time

from ldbench.entries import engine as eng
from ldbench.run import load_module, say


def _launches(run) -> int:
    from tomahawk_tpu_torch.ops import _build
    counts = _build.PLAIN_CALLS if run.device == "cpu" else _build.LAUNCHES
    return sum(counts.values())


def setup(run):
    from tomahawk_tpu_torch.compute.engine import CalcSettings
    from tomahawk_tpu_torch.io.importer import ImportSettings, import_vcf
    cell, cfg = run.cell, run.config
    stacked, ids = eng.draw_planes(run)
    tiles = eng.tile_list(cell["layout"], ids)
    t0 = time.perf_counter()
    vcf = os.path.join(run.tmp, "chunk.vcf")
    twk = os.path.join(run.tmp, "chunk.twk")
    n_vcf = load_module("traffic", "vcf").write(vcf, stacked,
                                               cfg["n_samples"],
                                               run.cards[0])
    t1 = time.perf_counter()
    stats = import_vcf(ImportSettings(input=vcf, output=twk,
                                      block_size=cell["import_block"],
                                      c_level=cfg["c_level"]))
    t2 = time.perf_counter()
    n_var = int(stacked["n_rec"].sum())
    if stats.n_kept != n_var:
        raise RuntimeError(f"the importer kept {stats.n_kept} of {n_var} "
                           f"variants")
    run.bytes_written += n_vcf + os.path.getsize(twk)
    os.remove(vcf)
    say(f"archive: VCF text {n_vcf} bytes in {t1 - t0:.3f} s, imported "
        f"({os.path.getsize(twk)} bytes) in {t2 - t1:.3f} s")
    settings = CalcSettings(
        input=twk, output=os.path.join(run.tmp, "job.two"),
        force_phased=cell["mode"] == "phased",
        forced_unphased=cell["mode"] == "unphased",
        min_r2=cfg["min_r2"], c_level=cfg["c_level"],
        tile_rows=cell["tile_rows"], threads=cell.get("threads", 0))
    run.shapes = dict(B=cell["tile_rows"],
                      Wh=stacked["alt_bits"].shape[-1],
                      Ws=stacked["het_bits"].shape[-1])
    return dict(stacked=stacked, tiles=tiles, settings=settings,
                pairs=eng.pair_count(tiles, stacked["n_rec"]),
                candidates=eng.candidate_count(tiles, stacked))


def unit(run, state):
    from tomahawk_tpu_torch.compute.engine import compute_ld
    before = _launches(run)
    t0 = time.perf_counter()
    res = compute_ld(state["settings"], device=run.cards[0].split(":")[0])
    run.sync()
    run.bytes_written += os.path.getsize(state["settings"].output)
    return dict(pairs=state["pairs"], program_pairs=int(res.n_pairs),
                records=int(res.n_records),
                launches=_launches(run) - before,
                wall=time.perf_counter() - t0)


def trace_spans(run, state, spans):
    """Spans around reading and inflating the archive, and around the
    writer on every thread; the engines that `compute_ld` builds are
    kept, for their host-math counters."""
    from tomahawk_tpu_torch.compute import engine as mod
    from tomahawk_tpu_torch.io.twk import TwkReader
    from tomahawk_tpu_torch.io.two import TwoWriter
    spans.wrap(TwkReader, "read_block", "calc.read")
    spans.wrap(mod, "block_to_planes", "calc.inflate")
    spans.wrap(mod, "ld_records", "calc.math")
    for attr in ("add", "write_block", "_emit_block", "close"):
        spans.wrap(TwoWriter, attr, "calc.write")
    engines = run.counters.setdefault("engines", [])
    real = mod.LdEngine

    class Kept(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            engines.append(self)
    spans.replace(mod, "LdEngine", Kept)


memory_peak = eng.memory_peak


def release(run, state):
    """compute_ld frees its engine at the end of each job."""


def check(run, state, units) -> dict:
    from ldbench.tworead import read_records
    recs = read_records(state["settings"].output)
    numbers = eng.common_numbers(run, units, recs, state["stacked"],
                                 state["tiles"], state["candidates"])
    numbers["units_differ"] += int(len(recs) != units[-1]["records"])
    numbers["host_route_jobs"] = sum(u["launches"] == 0 for u in units)
    return numbers
