"""Single-site LD: one target variant against its neighbourhood.

Mirrors the reference scalc pipeline (reference: lib/scalc.h,
lib/ld/ld.cpp:123-255 LoadTargetSingle, :673-876 ComputeSingle,
ld_engine.cpp:2226-2332 CalculateSingle): the target variant is placed
in block 0, all variants within +-l_surrounding bp go into fixed-size
neighbour blocks, and (target x neighbour-block) tiles run through the
same kernels with per-pair phased/unphased dispatch on missingness.
"""

import datetime
from dataclasses import dataclass

import numpy as np

from .. import __version__
from ..io.twk import Twk1Block, TwkReader
from ..io.two import TwoWriter
from ..ops.bitpack import block_to_planes, stack_planes
from ..ops.ld_math import LdFilters
from ..post.intervals import parse_intervals
from ..utils import Timer, log, pretty_int
from .engine import (CalcResult, CalcSettings, LdEngine, _reverse_records,
                     dispatch_pairs)


@dataclass
class ScalcSettings:
    input: str = ""
    output: str = "-"
    interval: str = ""
    l_surrounding: int = 500_000
    min_p: float = 1.0
    # the reference scalc force-sets minR2 = 0 after flag parsing
    # (reference: lib/scalc.h:189 — its -r flag is effectively ignored);
    # we default to 0 for drop-in behavior but still honor -r if given
    min_r2: float = 0.0
    max_r2: float = 100.0
    min_dprime: float = 0.0
    max_dprime: float = 100.0
    c_level: int = 1
    neighbour_block: int = 100   # reference uses 100-record blocks


def compute_single(settings: ScalcSettings, device="cuda") -> CalcResult:
    timer = Timer()
    reader = TwkReader(settings.input)
    ivals = parse_intervals([settings.interval], reader.header)
    iv = ivals[0]

    # Ranged targets (reference LoadTargetSingle, ld.cpp:123-255):
    # every variant inside [start, end] is a target and goes into
    # block 0; the flanks [start - l, start) and (end, end + l] are the
    # neighbourhood. A point interval is the start == end special case.
    lo = max(iv.start - settings.l_surrounding, 0)
    hi = iv.end + settings.l_surrounding

    targets = []
    neighbours = []
    for i, ent in enumerate(reader.index.ent):
        if ent.rid != iv.rid or ent.minpos - 1 > hi or ent.maxpos - 1 < lo:
            continue
        blk = reader.read_block(i)
        for rec in blk.rcds:
            if rec.rid != iv.rid:
                continue
            if iv.start <= rec.pos <= iv.end:
                targets.append(rec)
            elif lo <= rec.pos <= hi:
                neighbours.append(rec)
    if not targets:
        raise ValueError(
            f"no target variant found in {settings.interval}")
    log("LOG", f"Target {settings.interval}: "
        f"{pretty_int(len(targets))} target variant(s), "
        f"{pretty_int(len(neighbours))} neighbours within "
        f"{pretty_int(settings.l_surrounding)} bp", sub="SCALC")

    rid = targets[0].rid
    nb = settings.neighbour_block
    B = max(nb, 1)
    # targets split into nb-sized blocks too (a single huge target
    # block would pad every neighbour block up to its row count)
    blocks = []
    for s in range(0, len(targets), nb):
        b = Twk1Block(rid=rid)
        for rec in targets[s:s + nb]:
            b.add(rec)
        blocks.append(b)
    n_target_blocks = len(blocks)
    for s in range(0, len(neighbours), nb):
        b = Twk1Block(rid=rid)
        for rec in neighbours[s:s + nb]:
            b.add(rec)
        blocks.append(b)

    n_samples = reader.header.n_samples
    planes = [block_to_planes(b, n_samples, pad_to=B) for b in blocks]
    stacked = stack_planes(planes)

    calc = CalcSettings(min_p=settings.min_p, min_r2=settings.min_r2,
                        max_r2=settings.max_r2,
                        min_dprime=settings.min_dprime,
                        max_dprime=settings.max_dprime)
    engine = LdEngine(stacked, n_samples, calc, device)
    filt = LdFilters(min_p=settings.min_p, min_r2=settings.min_r2,
                     max_r2=settings.max_r2,
                     min_dprime=settings.min_dprime,
                     max_dprime=settings.max_dprime)

    out = settings.output
    if out not in ("-",) and not out.endswith(".two"):
        out += ".two"
    hdr = reader.header
    hdr.literals += (f"\n##tomahawk_tpu_torch_scalcVersion={__version__}\n"
                     f"##tomahawk_tpu_torch_scalcCommand=scalc "
                     f"{settings.interval}; "
                     f"Date={datetime.datetime.now().isoformat()}\n")
    writer = TwoWriter(out, hdr, c_level=settings.c_level)
    result = CalcResult()

    target_pos = np.array(sorted(r.pos for r in targets), np.int64)

    def emit(recs: np.ndarray, rev: np.ndarray = None):
        if len(recs) == 0:
            return
        # keep only rows where the A side is a target variant
        m = ((recs["ridA"] == rid) &
             np.isin((recs["packA"] >> 2).astype(np.int64), target_pos))
        fwd = recs[m]
        writer.add(fwd)
        writer.add(rev[m] if rev is not None else _reverse_records(fwd))
        result.n_records += 2 * len(fwd)

    # target x target (upper triangle over target blocks) plus
    # target x each neighbour block (reference BuildSingleSite covers
    # (0, 0..n), ld_balancing.h:91-101)
    pairs = [(i, j, i == j)
             for i in range(n_target_blocks)
             for j in range(i, len(blocks))]
    try:
        result.n_pairs = dispatch_pairs(engine, pairs, "mixed", filt, emit,
                                        stacked)
    finally:
        engine.stage_close()
    writer.close()
    reader.close()
    result.elapsed = timer.elapsed()
    log("LOG", f"Computed {pretty_int(result.n_pairs)} pairs -> "
        f"{pretty_int(result.n_records)} records in "
        f"{timer.elapsed_string()}", sub="SCALC")
    return result
