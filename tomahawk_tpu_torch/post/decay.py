"""LD decay statistics (reference: lib/two_reader.cpp:424-541).

decay: binned mean r2 as a function of pairwise distance (same contig,
upper triangle only). positional_decay: per left-variant summary of its
partner positions (count and mean partner offset)."""

import sys

import numpy as np

from ..io.two import TwoReader


def _interval_plan(reader, intervals, threads):
    """(block stream, record filter) for an interval query: parse the
    strings ONCE, stream only index-overlapping blocks on sorted
    files, and filter records within them."""
    if not intervals:
        return reader.blocks(threads=threads), lambda recs: recs
    from .intervals import (interval_block_ids, interval_mask,
                            parse_intervals)
    ivals = parse_intervals(intervals, reader.header)
    stream = reader.stream_blocks(interval_block_ids(reader, ivals),
                                  threads=threads)
    return stream, lambda recs: recs[interval_mask(recs, ivals)]


def decay(path: str, max_range: int = 10_000_000, n_bins: int = 1000,
          out=None, intervals=None):
    out = out or sys.stdout
    bin_w = max(max_range // n_bins, 1)
    sums = np.zeros(n_bins)
    cnts = np.zeros(n_bins, np.int64)
    r = TwoReader(path)
    import os as _os
    stream, filt = _interval_plan(r, intervals,
                                  min(4, _os.cpu_count() or 1))
    for recs in stream:
        recs = filt(recs)
        pos_a = (recs["packA"] >> 2).astype(np.int64)
        pos_b = (recs["packB"] >> 2).astype(np.int64)
        m = (recs["ridA"] == recs["ridB"]) & (pos_a < pos_b)
        d = pos_b[m] - pos_a[m]
        b = np.minimum(d // bin_w, n_bins - 1)
        sums += np.bincount(b, weights=recs["R2"][m], minlength=n_bins)
        cnts += np.bincount(b, minlength=n_bins)
    r.close()
    out.write("From\tTo\tMean\tFrequency\n")
    for i in range(n_bins):
        mean = sums[i] / max(cnts[i], 1)
        out.write(f"{i * bin_w}\t{(i + 1) * bin_w}\t{mean:.6g}\t"
                  f"{cnts[i]}\n")
    return sums, cnts


def positional_decay(path: str, out=None, intervals=None):
    """Per left-variant mean partner offset; emitted in file order
    grouped by consecutive (ridA, Apos) runs, like the reference.
    Vectorized: per-block run-boundary detection + bincount reduction,
    with the run that straddles a block boundary carried over."""
    out = out or sys.stdout
    r = TwoReader(path)
    groups = []   # [rid, pos, n, sum_bpos]
    carry = None  # open run at the block boundary
    import os as _os
    stream, filt = _interval_plan(r, intervals,
                                  min(4, _os.cpu_count() or 1))
    for recs in stream:
        recs = filt(recs)
        if len(recs) == 0:
            continue
        rid = recs["ridA"].astype(np.int64)
        pos_a = (recs["packA"] >> 2).astype(np.int64)
        pos_b = (recs["packB"] >> 2).astype(np.int64)
        use = (recs["ridA"] == recs["ridB"]) & (pos_a < pos_b)

        change = np.empty(len(recs), bool)
        change[0] = True
        change[1:] = (rid[1:] != rid[:-1]) | (pos_a[1:] != pos_a[:-1])
        run_id = np.cumsum(change) - 1
        starts = np.flatnonzero(change)
        n_runs = len(starts)
        cnt = np.bincount(run_id[use], minlength=n_runs)
        tot = np.bincount(run_id[use], weights=pos_b[use],
                          minlength=n_runs)

        g_rid = rid[starts]
        g_pos = pos_a[starts]
        first = 0
        if carry is not None:
            if (carry[0], carry[1]) == (int(g_rid[0]), int(g_pos[0])):
                # block starts inside the carried run: fold run 0 in
                carry[2] += int(cnt[0])
                carry[3] += float(tot[0])
                first = 1
                if n_runs == 1:
                    continue   # whole block is one run; keep carrying
            groups.append(np.array([[carry[0], carry[1], carry[2],
                                     carry[3]]], np.float64))
            carry = None
        # all complete runs of this block as one [K, 4] chunk; the last
        # run stays open in `carry` (it may continue into the next block)
        k = n_runs - 1
        carry = [int(g_rid[k]), int(g_pos[k]), int(cnt[k]),
                 float(tot[k])]
        if k > first:
            groups.append(np.stack(
                [g_rid[first:k], g_pos[first:k], cnt[first:k],
                 tot[first:k]], axis=1).astype(np.float64))
    if carry is not None:
        groups.append(np.array([[carry[0], carry[1], carry[2],
                                 carry[3]]], np.float64))
    r.close()
    g = (np.concatenate(groups) if groups
         else np.zeros((0, 4), np.float64))
    rid_c, pos_c, n_c, tot_c = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
    mean_off = np.where(n_c > 0, tot_c / np.maximum(n_c, 1) - pos_c,
                        -pos_c)
    from ..native import format_decay_rows
    txt = format_decay_rows(rid_c.astype(np.int64),
                            pos_c.astype(np.int64),
                            n_c.astype(np.int64), mean_off)
    if txt is not None:
        out.write(txt)
    else:
        lines = []
        for i in range(len(g)):
            lines.append(f"{int(rid_c[i])}\t{int(pos_c[i])}\t"
                         f"{int(n_c[i])}\t{mean_off[i]:.6f}\n")
            if len(lines) >= 65536:
                out.write("".join(lines))
                lines = []
        out.write("".join(lines))
    return g          # [K, 4] float64: rid, pos, n, sum_bpos per group
