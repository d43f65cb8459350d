"""Datashader-style rasterization of .two records into an x-by-y matrix
of summary statistics, written as a .twa archive.

Mirrors the reference two-pass design (reference: lib/aggregate.h,
lib/aggregation.h, lib/two_reader.cpp:544-850): pass 1 finds the used
coordinate ranges per contig; the genome is flattened with per-contig
cumulative offsets (tight range for a single contig, whole contigs
otherwise); pass 2 scatter-adds records into bins of running statistics
(count, total, total^2, min, max) fully vectorized, after which the
chosen reduction (mean/max/min/count/total/sd) with a minimum-count
cutoff produces the output matrix. Output format is byte-compatible
with the reference .twa (reference: lib/core.cpp:646-785).
"""

import struct
from dataclasses import dataclass, field
from typing import List

import numpy as np
import zstandard

from ..io.buffer import BufferWriter, BufferReader
from ..io.constants import TWOAGG_MAGIC, TWOAGG_EOF
from ..io.two import TwoReader
from ..utils import log, pretty_int

AGG_FIELDS = {
    "r": lambda recs: recs["R"],
    "r2": lambda recs: recs["R2"],
    "d": lambda recs: recs["D"],
    "dprime": lambda recs: recs["Dprime"],
    "dp": lambda recs: recs["Dprime"],
    "p": lambda recs: recs["P"],
    "hets": lambda recs: (recs["cnt"][:, 1] + recs["cnt"][:, 2])
    / np.maximum(recs["cnt"].sum(axis=1), 1e-300),
    "het": lambda recs: (recs["cnt"][:, 1] + recs["cnt"][:, 2])
    / np.maximum(recs["cnt"].sum(axis=1), 1e-300),
    "alts": lambda recs: recs["cnt"][:, 3]
    / np.maximum(recs["cnt"].sum(axis=1), 1e-300),
    "alt": lambda recs: recs["cnt"][:, 3]
    / np.maximum(recs["cnt"].sum(axis=1), 1e-300),
}

REDUCERS = ("mean", "max", "min", "count", "n", "total", "sd")


@dataclass
class Twa:
    """In-memory .twa aggregate matrix."""
    x: int
    y: int
    bpx: int = 0
    bpy: int = 0
    n_original: int = 0
    range: int = 0
    filename: str = ""
    rid_offsets: List[tuple] = field(default_factory=list)  # (min,max,range)
    data: np.ndarray = None   # [x, y] float64

    @property
    def n(self) -> int:
        return self.x * self.y

    def write(self, path: str):
        with open(path, "wb") as fh:
            fh.write(TWOAGG_MAGIC)
            w = BufferWriter()
            w.u32(self.n).u32(self.x).u32(self.y)
            w.u32(self.bpx).u32(self.bpy).u32(self.n_original)
            w.u64(self.range)
            # the reference .twa writer uses the OSTREAM SerializeString
            # (length is size_t = u64, utility.cpp:210-214), unlike the
            # u32-length buffer variant used inside archives
            fb = self.filename.encode()
            w.u64(len(fb))
            w.raw(fb)
            w.u32(len(self.rid_offsets))
            for mn, mx, rng in self.rid_offsets:
                w.u32(mn).u32(mx).u64(rng)
            fh.write(w.getvalue())
            comp = zstandard.ZstdCompressor(level=6).compress(
                np.ascontiguousarray(self.data, np.float64).tobytes())
            fh.write(struct.pack("<I", len(comp)))
            fh.write(comp)
            fh.write(TWOAGG_EOF)

    @classmethod
    def open(cls, path: str) -> "Twa":
        from ..io.errors import CorruptFileError
        raw = open(path, "rb").read()
        if not raw.startswith(TWOAGG_MAGIC):
            raise CorruptFileError(path, "not a .twa file (bad magic)", 0)
        if not raw.endswith(TWOAGG_EOF):
            raise CorruptFileError(path, "truncated .twa (bad EOF)",
                                   len(raw))
        try:
            r = BufferReader(raw, len(TWOAGG_MAGIC))
            n = r.u32()
            obj = cls(x=r.u32(), y=r.u32(), bpx=r.u32(), bpy=r.u32(),
                      n_original=r.u32(), range=r.u64(),
                      filename=r.raw(r.u64()).decode())
            n_rid = r.u32()
            obj.rid_offsets = [(r.u32(), r.u32(), r.u64())
                               for _ in range(n_rid)]
            nc = r.u32()
            data = zstandard.ZstdDecompressor().decompress(
                r.raw(nc), max_output_size=max(n * 8, 1))
            obj.data = np.frombuffer(data, np.float64).reshape(obj.x, obj.y)
        except (EOFError, zstandard.ZstdError, ValueError,
                MemoryError) as e:
            raise CorruptFileError(path, f"corrupt .twa: {e}") from None
        if obj.n != n:
            raise CorruptFileError(
                path, f"corrupt .twa: raster is {obj.x}x{obj.y} but "
                f"header declares {n} cells")
        return obj


def aggregate_two(input_path: str, output_path: str, agg: str = "r2",
                  reduce: str = "mean", xbins: int = 1000,
                  ybins: int = 1000, min_count: int = 5,
                  intervals=None, write: bool = True,
                  threads: int = 0) -> Twa:
    if agg not in AGG_FIELDS:
        raise ValueError(f"unknown aggregation function: {agg}")
    if reduce not in REDUCERS:
        raise ValueError(f"unknown reduction function: {reduce}")
    value_of = AGG_FIELDS[agg]

    reader = TwoReader(input_path)
    n_contigs = max(reader.header.n_contigs, 1)
    ivals = None
    if intervals:
        from .intervals import parse_intervals, interval_mask
        ivals = parse_intervals(intervals, reader.header)

    def _filtered(recs):
        if ivals is None:
            return recs
        from .intervals import interval_mask
        return recs[interval_mask(recs, ivals)]

    # ---- pass 1: used ranges per contig (threaded over block ranges,
    # the reference's FindRangesUnsorted slaves, aggregation.h:127-154) --
    import os as _os
    from concurrent.futures import ThreadPoolExecutor
    n_workers = threads if threads > 0 else min(8, _os.cpu_count() or 1)
    from .intervals import interval_block_ids
    blk_ids = list(interval_block_ids(reader, ivals))
    n_blocks = len(blk_ids)

    def _pass1(lo, hi):
        mn = np.full(n_contigs, np.iinfo(np.uint32).max, np.int64)
        mx = np.zeros(n_contigs, np.int64)
        seen = np.zeros(n_contigs, bool)
        rd = TwoReader(input_path)
        for i in blk_ids[lo:hi]:
            recs = _filtered(rd.read_block(i))
            if not len(recs):
                continue
            for rid_f, pos_f in (("ridA", "packA"), ("ridB", "packB")):
                rid = recs[rid_f].astype(np.int64)
                pos = (recs[pos_f] >> 2).astype(np.int64)
                # few distinct contigs per block: masked min/max beats
                # np.minimum.at by ~50x
                for c in np.unique(rid):
                    sel = pos[rid == c]
                    mn[c] = min(mn[c], int(sel.min()))
                    mx[c] = max(mx[c], int(sel.max()))
                    seen[c] = True
        rd.close()
        return mn, mx, seen

    bounds = np.linspace(0, n_blocks, n_workers + 1).astype(int)
    spans = [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])
             if b > a]
    if n_workers > 1 and len(spans) > 1:
        with ThreadPoolExecutor(len(spans)) as pool:
            parts = list(pool.map(lambda s: _pass1(*s), spans))
    else:
        parts = [_pass1(0, n_blocks)]
    mn = np.min([p[0] for p in parts], axis=0)
    mx = np.max([p[1] for p in parts], axis=0)
    # the reference stamps the TOTAL index record count (aggregate.h
    # n_recs), not the filtered count
    n_original = sum(e.n for e in reader.index.ent)
    used = np.any([p[2] for p in parts], axis=0)

    # ---- flattened genome coordinates ---------------------------------
    # Replicates the reference CLI exactly (aggregate.h:296-370 — note
    # the CLI carries its own copy of this logic; the library method
    # two_reader.cpp:725 double-counts contig 0 and is unused): one
    # used contig -> tight [min, max] landscape; several -> whole
    # contigs at their declared header lengths. flat coordinates then
    # follow BuildMatrix (aggregation.h:168):
    # cum_range - (max - min) + (pos - min).
    contig_len = np.zeros(n_contigs, np.int64)
    for c in reader.header.contigs:
        if 0 <= c.idx < n_contigs:
            contig_len[c.idx] = c.n_bases
    n_chrom_set = int(used.sum())
    mnr = np.zeros(n_contigs, np.int64)
    mxr = np.zeros(n_contigs, np.int64)
    cum = np.zeros(n_contigs, np.int64)
    total_range = 0
    acc = 0
    for c in range(n_contigs):
        if n_chrom_set == 1:
            span = int(mx[c] - mn[c] + 1) if used[c] else 0
            mnr[c] = int(mn[c]) if used[c] else np.iinfo(np.uint32).max
            mxr[c] = int(mx[c]) if used[c] else 0
        else:
            span = int(contig_len[c]) if used[c] else 0
            mnr[c] = 0
            mxr[c] = int(contig_len[c])
        acc += span
        total_range += span
        cum[c] = acc
    if total_range == 0:
        raise ValueError("no records to aggregate")

    rid_offsets = []
    for c in range(n_contigs):
        # writer-side clamping mirrors core.cpp:663-665
        w_min = 0 if mnr[c] == np.iinfo(np.uint32).max else int(mnr[c])
        w_max = 0 if mxr[c] < w_min else int(mxr[c])
        rid_offsets.append((w_min, w_max, int(cum[c])))

    # bp-per-bin, float32 ceil exactly as the reference
    # (two_reader.cpp:801-802)
    xrange = int(np.ceil(np.float32(total_range) / np.float32(xbins)))
    yrange = int(np.ceil(np.float32(total_range) / np.float32(ybins)))

    # ---- pass 2: scatter-add into bins (threaded BuildMatrix slaves
    # with per-thread partial matrices + reduce, the reference's
    # aggregation.h:156-187 design) --------------------------------------
    # np.bincount on a flattened bin index is ~100x np.ufunc.at; the
    # bin-index streams batch across blocks so the XY-sized bincount
    # runs once per ~2M records, not once per block
    XY = xbins * ybins
    need_minmax = reduce in ("min", "max")
    BATCH = 1 << 21

    def _pass2(lo, hi):
        cnt = np.zeros(XY)
        tot = np.zeros(XY)
        tot2 = np.zeros(XY)
        vmin = np.full((xbins, ybins), np.inf)
        vmax = np.full((xbins, ybins), -np.inf)
        flats, vals, pend = [], [], 0

        def drain():
            nonlocal flats, vals, pend
            if not pend:
                return
            flat = np.concatenate(flats)
            v = np.concatenate(vals)
            cnt[:] += np.bincount(flat, minlength=XY)
            tot[:] += np.bincount(flat, weights=v, minlength=XY)
            tot2[:] += np.bincount(flat, weights=v * v, minlength=XY)
            flats, vals, pend = [], [], 0

        rd = TwoReader(input_path)
        for i in blk_ids[lo:hi]:
            recs = _filtered(rd.read_block(i))
            if not len(recs):
                continue
            rid_a = recs["ridA"].astype(np.int64)
            rid_b = recs["ridB"].astype(np.int64)
            pos_a = (recs["packA"] >> 2).astype(np.int64)
            pos_b = (recs["packB"] >> 2).astype(np.int64)
            fa = cum[rid_a] - (mxr[rid_a] - mnr[rid_a]) \
                + (pos_a - mnr[rid_a])
            fb = cum[rid_b] - (mxr[rid_b] - mnr[rid_b]) \
                + (pos_b - mnr[rid_b])
            xb = np.clip(fa // xrange, 0, xbins - 1)
            yb = np.clip(fb // yrange, 0, ybins - 1)
            v = value_of(recs).astype(np.float64)
            flats.append(xb * ybins + yb)
            vals.append(v)
            pend += len(v)
            if pend >= BATCH:
                drain()
            if need_minmax:
                np.minimum.at(vmin, (xb, yb), v)
                np.maximum.at(vmax, (xb, yb), v)
        drain()
        rd.close()
        return cnt, tot, tot2, vmin, vmax

    if n_workers > 1 and len(spans) > 1:
        with ThreadPoolExecutor(len(spans)) as pool:
            parts = list(pool.map(lambda s: _pass2(*s), spans))
    else:
        parts = [_pass2(0, n_blocks)]
    cnt = np.sum([p[0] for p in parts], axis=0)
    tot = np.sum([p[1] for p in parts], axis=0)
    tot2 = np.sum([p[2] for p in parts], axis=0)
    vmin = np.min([p[3] for p in parts], axis=0)
    vmax = np.max([p[4] for p in parts], axis=0)
    cnt = cnt.reshape(xbins, ybins)
    tot = tot.reshape(xbins, ybins)
    tot2 = tot2.reshape(xbins, ybins)

    # reducer semantics mirror the reference's twk_sstats exactly
    # (reference: include/core.h:929-976, cutoff applied by Overload,
    # aggregation.h:204-212), quirks included:
    #   - GetMean returns 0 when the cutoff itself is 0;
    #   - GetMin/GetMax IGNORE the cutoff, and min/max accumulators
    #     start at 0, so the min is never positive and the max never
    #     negative;
    #   - GetTotal compares the SUM (not the count) against the
    #     cutoff, zeroing cells whose total falls below it (negative
    #     D totals always zero under any positive cutoff);
    #   - GetStandardDeviation zeroes below-cutoff cells (we also
    #     return 0 for empty cells where the reference would divide
    #     0/0).
    ok = cnt >= min_count
    safe_cnt = np.where(cnt > 0, cnt, 1.0)
    if reduce == "mean":
        data = np.where(ok if min_count > 0 else False,
                        tot / safe_cnt, 0.0)
    elif reduce == "max":
        data = np.where(cnt > 0,
                        np.maximum(np.where(np.isfinite(vmax), vmax,
                                            0.0), 0.0), 0.0)
    elif reduce == "min":
        data = np.where(cnt > 0,
                        np.minimum(np.where(np.isfinite(vmin), vmin,
                                            0.0), 0.0), 0.0)
    elif reduce in ("count", "n"):
        data = np.where(ok, cnt, 0.0)
    elif reduce == "total":
        data = np.where(tot < min_count, 0.0, tot)
    else:  # sd
        mean = tot / safe_cnt
        var = np.maximum(tot2 / safe_cnt - mean * mean, 0.0)
        data = np.where(ok & (cnt >= 1), np.sqrt(var), 0.0)

    twa = Twa(x=xbins, y=ybins,
              bpx=xrange, bpy=yrange,
              n_original=n_original, range=total_range,
              filename=input_path, rid_offsets=rid_offsets, data=data)
    if output_path and write:
        if not output_path.endswith(".twa"):
            output_path += ".twa"
        twa.write(output_path)
        log("LOG", f"Aggregated {pretty_int(n_original)} records into "
            f"{xbins}x{ybins} bins -> {output_path}", sub="AGGREGATE")
    reader.close()
    return twa
