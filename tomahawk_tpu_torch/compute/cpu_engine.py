"""Native CPU LD engine for small workloads.

The MXU tile design (compute/sweeps.py) is wrong-shaped for tiny
inputs: XLA:CPU pays compile time, [B, B] mask materialization, and
repair-pass churn for work the reference's per-pair SSE kernels finish
in seconds (reference: lib/ld/ld_engine.cpp:84-1160). When `calc`
routes a run to the CPU backend (engine._route_backend), this module
executes the SAME dispatch plan (engine.group_tiles order, row-major
pair order per tile, identical candidate rules to sweeps.tile_mask)
through one native call per tile row-chunk: uint64 AND+popcount
contingency counts feeding the exact filter-ladder record assembly of
twk_ld_records (native/twk_native.cpp twk_ld_tile). Output .two files
are byte-identical to the device engine's by construction.
"""

import time

import numpy as np

from ..io.two import TWO_DTYPE
from ..ops.ld_math import native_params
from ..utils import log


def _tile_meta(stacked, s) -> dict:
    """Per-super-block metadata views in the dtypes twk_ld_tile reads
    (int64 / float64 / uint8); converted once per block, not per pair."""
    return dict(
        pos=np.ascontiguousarray(stacked["pos"][s], np.int64),
        rid=np.ascontiguousarray(stacked["rid"][s], np.int64),
        ac=np.ascontiguousarray(stacked["ac"][s], np.int64),
        an=np.ascontiguousarray(stacked["an"][s], np.int64),
        n_het=np.ascontiguousarray(stacked["n_het"][s], np.int64),
        n_hom=np.ascontiguousarray(stacked["n_hom"][s], np.int64),
        hwe=np.ascontiguousarray(stacked["hwe"][s], np.float64),
        valid=np.ascontiguousarray(stacked["valid"][s], np.uint8),
    )


_CLS = {"all": 0, "clean": 1}

# record-buffer budget (records per chunk); tiles taller than
# _ROWS_BUDGET // B rows process in row chunks against the same buffer
_ROWS_BUDGET = 1 << 20


def run_native_cpu(stacked, tiles_by_group, filt, emit, ticker,
                   n_samples, settings, stats) -> int:
    """Run the grouped tile lists through the native tile engine.
    `stacked` holds host planes/metadata for every super-block the
    tiles reference (slot coordinates); `tiles_by_group` is the
    engine.group_tiles output. Returns candidate-pair total, or None
    when the native library is unavailable (caller falls back to the
    XLA engine)."""
    from .. import native
    if not native.available():
        return None
    params = native_params(filt)
    window = settings.l_window if settings.window else 0
    B = stacked["alt_bits"].shape[1]
    meta = {}
    # reusable record buffers: one record per candidate pair of a chunk
    rows_per = max(1, _ROWS_BUDGET // B)
    cap = rows_per * B
    fwd = np.empty(cap, TWO_DTYPE)
    rev = np.empty(cap, TWO_DTYPE)
    n_pairs = 0
    for table, has_missing, cls, tiles in tiles_by_group:
        if not tiles:
            continue
        if table == "phased":
            keys, W = ("alt_bits", "miss_bits", None), \
                stacked["alt_bits"].shape[2]
        else:
            keys, W = ("het_bits", "hom_bits", "valid_bits"), \
                stacked["het_bits"].shape[2]
        key = f"{table}/{'miss' if has_missing else 'nomiss'}/{cls}"
        stat = stats.setdefault(key, dict(
            n_tiles=0, n_cand=0, n_pass=0, n_records=0,
            count_s=0.0, extract_s=0.0, math_s=0.0))
        stat["n_tiles"] += len(tiles)
        t_i = int(table == "unphased")
        cls_i = _CLS.get(cls, 2)
        for (bi, bj, diag) in tiles:
            if bi not in meta:
                meta[bi] = _tile_meta(stacked, bi)
            if bj not in meta:
                meta[bj] = _tile_meta(stacked, bj)
            planes_i = tuple(stacked[k][bi] if k else None for k in keys)
            planes_j = tuple(stacked[k][bj] if k else None for k in keys)
            for r0 in range(0, B, rows_per):
                r1 = min(r0 + rows_per, B)
                t0 = time.perf_counter()
                out = native.ld_tile(
                    t_i, has_missing, cls_i, diag, window, n_samples,
                    B, W, r0, r1, planes_i, planes_j,
                    meta[bi], meta[bj], params, fwd, rev)
                if out is None:
                    return None
                n, ncand = out
                stat["math_s"] += time.perf_counter() - t0
                stat["n_cand"] += ncand
                stat["n_pass"] += n
                stat["n_records"] += n
                n_pairs += ncand
                if n:
                    # emit views; the writer copies before returning
                    emit(fwd[:n], rev[:n])
                if ticker:
                    ticker.add(pairs=ncand, records=n)
    log("LOG", f"Native CPU tile engine: {n_pairs:,} candidate pairs",
        sub="ENGINE")
    return n_pairs
