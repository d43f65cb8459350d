"""The unphased parts tile kernel's (P = 9) share of its roofline with
the contraction counted: the least time its calls in the traced window
could take, the larger of their bytes over the HBM's published bandwidth
(ldbench/roofline/parts_tile.py) and their 1-bit AND + POPC operations,
counted from the kernel's loop (ldbench/roofline/parts_tile_loop.py),
over the MMA's measured rate (mma_b1.py), over their device time. At
biobank width (15,264 words a sample plane) the operations bound the
kernel; at 80 words its bytes do, as parts_tile.roofline_pct counts
them."""

from ldbench.roofline import mma_b1, parts_tile, parts_tile_loop, peaks
from ldbench.run import say


def read(run, res):
    dt = run.device_trace
    calls, secs = dt.kernel("parts_tile_kernel<2>") if dt else (0, 0.0)
    if not calls or secs <= 0:
        return None
    B, Ws = run.shapes["B"], run.shapes["Ws"]
    by_bytes = parts_tile.bytes_per_call(B, Ws) / peaks.HBM_BYTES_PER_S
    by_ops = parts_tile_loop.ops_per_call(B, Ws) / mma_b1.B1_OPS_PER_S
    say(f"parts_tile<2>: {calls} calls, {1e3 * secs / calls:.4f} ms a call; "
        f"least {1e3 * by_bytes:.4f} ms by bytes, {1e3 * by_ops:.4f} ms by "
        f"operations")
    return 100.0 * calls * max(by_bytes, by_ops) / secs
