"""The phased tile kernel's share of its roofline with the contraction
counted: the least time its calls in the traced window could take, the
larger of their bytes over the HBM's published bandwidth and their
1-bit AND + POPC operations over the MMA's measured rate
(ldbench/roofline/phased_tile.py, mma_b1.py), over their device time.
At a wide panel's rows the operations bound the kernel; at 160 words a
row its bytes do, as phased_tile.roofline_pct counts them."""

from ldbench.roofline import mma_b1, peaks
from ldbench.roofline import phased_tile as rf
from ldbench.run import say


def read(run, res):
    dt = run.device_trace
    calls, secs = dt.kernel("phased_tile_kernel") if dt else (0, 0.0)
    if not calls or secs <= 0:
        return None
    B, Wh = run.shapes["B"], run.shapes["Wh"]
    by_bytes = rf.bytes_per_call(B, Wh) / peaks.HBM_BYTES_PER_S
    by_ops = rf.ops_per_call(B, Wh) / mma_b1.B1_OPS_PER_S
    say(f"phased_tile: {calls} calls, {1e3 * secs / calls:.4f} ms a call; "
        f"least {1e3 * by_bytes:.4f} ms by bytes, {1e3 * by_ops:.4f} ms by "
        f"operations")
    return 100.0 * calls * max(by_bytes, by_ops) / secs
