"""Entry `engine`: the port's library API over resident planes.

Set-up draws the cell's planes on the card from the seed, builds one
`LdEngine` over them (on one card, or on the cell's in-process mesh of
cards), and lists the cell's tiles. A unit of work is one pass over the
tile list: `dispatch_pairs(engine, tiles, mode, LdFilters(min_r2), emit,
stacked)`, whose `emit` hands the records to the port's `TwoWriter` as
`compute_ld`'s does, into a file that each pass writes anew; the pass
ends when the writer is closed and every card is synchronised.

Layouts of the tile list: `far` pairs every super-block of the first
region with every one of the second (no diagonal tile); `all` takes
every pair of super-blocks of the one region, diagonal tiles included.
"""

import json
import os
import time

import numpy as np

from ldbench import check as chk
from ldbench.reference import ld as ref_ld
from ldbench.run import load_module, say


def block_sizes(regions, B):
    """Super-block sizes of each region (full blocks, then the rest) and
    the block ids of each region."""
    sizes, ids = [], []
    for n in regions:
        blocks = [B] * (n // B) + ([n % B] if n % B else [])
        ids.append(list(range(len(sizes), len(sizes) + len(blocks))))
        sizes += blocks
    return sizes, ids


def tile_list(layout: str, ids):
    if layout == "far":
        return [(i, j, False) for i in ids[0] for j in ids[1]]
    if layout == "all":
        return [(i, j, i == j) for k, i in enumerate(ids[0])
                for j in ids[0][k:]]
    raise ValueError(f"unknown layout {layout}")


def pair_count(tiles, n_rec) -> int:
    """Variant pairs of a tile list: n_i x n_j off the diagonal, n (n - 1)
    / 2 on it."""
    n = n_rec.astype(np.int64)
    return int(sum(n[i] * (n[i] - 1) // 2 if d else n[i] * n[j]
                   for i, j, d in tiles))


def candidate_count(tiles, stacked) -> int:
    """The pairs the port's sweep must evaluate: those of the tile list
    but the pairs whose alt alleles number 2 or fewer together (the
    reference tool's skip rule, ld_engine.cpp:1910-1912), counted from
    the benchmark's own allele counts."""
    low = np.zeros((len(stacked["n_rec"]), 3), np.int64)
    for x in range(3):
        low[:, x] = ((stacked["ac"] == x) & stacked["valid"]).sum(1)
    total = 0
    for i, j, d in tiles:
        a, b = low[i], low[j]
        if d:
            skip = a[0] * (a[0] - 1) // 2 + a[0] * (a[1] + a[2]) \
                + a[1] * (a[1] - 1) // 2
        else:
            skip = a[0] * (b[0] + b[1] + b[2]) + a[1] * (b[0] + b[1]) \
                + a[2] * b[0]
        total += pair_count([(i, j, d)], stacked["n_rec"]) - int(skip)
    return total


def draw_planes(run):
    cell, cfg = run.cell, run.config
    sizes, ids = block_sizes(cell["regions"], cell["tile_rows"])
    gen = load_module("traffic", cell["generator"])
    stacked = gen.draw(sizes, cell["tile_rows"], cfg["n_samples"], run.seed,
                       run.cards[0], **cell.get("traffic", {}))
    return stacked, ids


def setup(run):
    import torch
    from tomahawk_tpu_torch.compute.engine import CalcSettings, LdEngine
    from tomahawk_tpu_torch.io.header import VcfContig, VcfHeader
    from tomahawk_tpu_torch.parallel.mesh import make_mesh
    cell, cfg = run.cell, run.config
    t0 = time.perf_counter()
    stacked, ids = draw_planes(run)
    t1 = time.perf_counter()
    tiles = tile_list(cell["layout"], ids)
    P, S = cell.get("mesh", [1, 1])
    settings = CalcSettings(min_r2=cfg["min_r2"], c_level=cfg["c_level"])
    if P * S > 1:
        engine = LdEngine(stacked, cfg["n_samples"], settings,
                          mesh=make_mesh(P, S, run.cards[:P * S]))
    else:
        engine = LdEngine(stacked, cfg["n_samples"], settings,
                          device=torch.device(run.cards[0]))
    hdr = VcfHeader(samples=[f"S{i}" for i in range(cfg["n_samples"])],
                    contigs=[VcfContig(idx=0, name="6")])
    Wh = stacked["alt_bits"].shape[-1]
    Ws = stacked["het_bits"].shape[-1]
    run.shapes = dict(B=cell["tile_rows"], Wh=Wh, Ws=Ws)
    say(f"planes drawn in {t1 - t0:.3f} s, engine built in "
        f"{time.perf_counter() - t1:.3f} s")
    say(f"{len(tiles)} tiles over {len(stacked['n_rec'])} super-blocks, "
        f"{pair_count(tiles, stacked['n_rec'])} pairs a pass; planes "
        f"{sum(v.nbytes for v in stacked.values())} bytes on the host")
    return dict(stacked=stacked, tiles=tiles, engine=engine, hdr=hdr,
                pairs=pair_count(tiles, stacked["n_rec"]),
                candidates=candidate_count(tiles, stacked),
                out=os.path.join(run.tmp, "pass.two"))


def unit(run, state):
    from tomahawk_tpu_torch.compute.engine import (_reverse_records,
                                                   dispatch_pairs)
    from tomahawk_tpu_torch.io.two import TwoWriter
    from tomahawk_tpu_torch.ops.ld_math import LdFilters
    t0 = time.perf_counter()
    writer = TwoWriter(state["out"], state["hdr"],
                       c_level=run.config["c_level"], async_blocks=True)
    n_rec = [0]

    def emit(recs, rev=None):
        if len(recs) == 0:
            return
        writer.add(recs)
        writer.add(rev if rev is not None else _reverse_records(recs))
        n_rec[0] += 2 * len(recs)
    try:
        n = dispatch_pairs(state["engine"], state["tiles"],
                           run.cell["mode"],
                           LdFilters(min_r2=run.config["min_r2"]), emit,
                           state["stacked"])
    finally:
        writer.close()
    run.sync()
    run.bytes_written += os.path.getsize(state["out"])
    return dict(pairs=state["pairs"], program_pairs=int(n),
                records=n_rec[0], wall=time.perf_counter() - t0)


def trace_spans(run, state, spans):
    """Spans that name the card's idle gaps: the main thread's dispatch
    of a segment's sweep, and the consumer's work on a segment (its
    read-back, repairs, host math and emit)."""
    from tomahawk_tpu_torch.compute.engine import LdEngine
    spans.wrap(LdEngine, "_submit_segment", "engine.dispatch")
    spans.wrap(LdEngine, "_run_segment", "engine.consume")


def memory_peak(run) -> int:
    import torch
    if run.device == "cpu":
        return 0
    return max(torch.cuda.max_memory_allocated(c) for c in run.cards)


def release(run, state):
    import torch
    state["engine"].stage_close()
    state["engine"] = None
    if run.device != "cpu":
        torch.cuda.empty_cache()


def reference_tiles(run, stacked, tiles, dtype):
    """The plain reference of each of `tiles` on the run's first card,
    as numpy arrays."""
    import torch
    dev = run.cards[0]
    table = "phased" if run.config["phased"] else "unphased"
    out = {}
    for bi, bj, diag in tiles:
        planes = []
        for b in (bi, bj):
            n = int(stacked["n_rec"][b])
            planes.append({k: torch.from_numpy(
                stacked[k][b][:n].view(np.int32)).to(dev)
                for k in ("alt_bits", "valid_bits")})
        res = ref_ld.tile(planes[0], planes[1], diag, table,
                          run.config["n_samples"], run.config["min_r2"],
                          dtype=dtype)
        out[(bi, bj, diag)] = {k: v.cpu().numpy() for k, v in res.items()}
    return out


def pair_table(run, stacked, bi, bj, idx):
    """One pair's contingency table from the benchmark's planes: 2x2
    haplotype counts (phased) or 3x3 genotype counts (unphased)."""
    import torch
    n_hap = 2 * run.config["n_samples"]
    rows = []
    for b, r in ((bi, idx // stacked["n_rec"][bj]),
                 (bj, idx % stacked["n_rec"][bj])):
        alt = ref_ld.unpack(torch.from_numpy(
            stacked["alt_bits"][b][r:r + 1].view(np.int32)), n_hap)[0]
        called = ref_ld.unpack(torch.from_numpy(
            stacked["valid_bits"][b][r:r + 1].view(np.int32)),
            n_hap // 2)[0]
        rows.append((alt.numpy().astype(int), called.numpy().astype(bool)))
    (a, ca), (b, cb) = rows
    if run.config["phased"]:
        return np.array([[np.sum((1 - a) * (1 - b)), np.sum((1 - a) * b)],
                         [np.sum(a * (1 - b)), np.sum(a * b)]])
    ga, gb = a[0::2] + a[1::2], b[0::2] + b[1::2]
    both = ca & cb
    T = np.zeros((3, 3), int)
    np.add.at(T, (ga[both], gb[both]), 1)
    return T


def common_numbers(run, units, recs, stacked, tiles, candidates) -> dict:
    """The numbers of every entry: the pairs of each unit as the program
    counted them against the benchmark's count of candidate pairs
    (`candidate_count`), units whose record count
    differs from the last's, and the comparison of `recs` with the
    reference on the tiles drawn from the seed."""
    import torch
    numbers = dict(
        pairs_gap=sum(abs(u["program_pairs"] - candidates) for u in units),
        units_differ=sum(u["records"] != units[-1]["records"]
                         for u in units))
    chk_cfg = run.cell["check"]
    pick = chk.sample_tiles(tiles, run.seed, chk_cfg["off_diagonal"],
                            chk_cfg.get("diagonal", 0))
    refs = reference_tiles(run, stacked, pick, torch.float64)
    numbers.update(chk.compare(recs, stacked, refs))
    for (bi, bj), idx, side in numbers.pop("diffs"):
        n_j = stacked["n_rec"][bj]
        say(f"pair {side}: tile ({bi}, {bj}), rows {idx // n_j}, "
            f"{idx % n_j}; table "
            f"{pair_table(run, stacked, bi, bj, idx).tolist()}")
    say(f"checked tiles {pick}: {json.dumps(numbers)}")
    for k in ("stat_gap", "p_gap"):
        # no pair kept on both sides: pairs_differ holds what differs
        numbers[k] = numbers[k] or 0.0
    return numbers


def check(run, state, units) -> dict:
    from ldbench.tworead import read_records
    recs = read_records(state["out"])
    numbers = common_numbers(run, units, recs, state["stacked"],
                             state["tiles"], state["candidates"])
    # the file holds what was emitted
    numbers["units_differ"] += int(len(recs) != units[-1]["records"])
    return numbers
