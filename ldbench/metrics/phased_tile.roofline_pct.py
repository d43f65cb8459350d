"""The phased tile kernel's share of its roofline: the least time its
calls in the traced window could take at the HBM's published bandwidth
(ldbench/roofline/phased_tile.py), over their device time. The
operations per byte go to the log: the 1-bit MMA has no published peak,
so the operations' bound is left out."""

from ldbench.roofline import peaks
from ldbench.roofline import phased_tile as rf
from ldbench.run import say


def read(run, res):
    dt = run.device_trace
    calls, secs = dt.kernel("phased_tile_kernel") if dt else (0, 0.0)
    if not calls or secs <= 0:
        return None
    B, Wh = run.shapes["B"], run.shapes["Wh"]
    least = calls * rf.bytes_per_call(B, Wh) / peaks.HBM_BYTES_PER_S
    say(f"phased_tile: {calls} calls, {secs:.6f} s, "
        f"{rf.ops_per_call(B, Wh) / rf.bytes_per_call(B, Wh):.1f} "
        f"operations a byte")
    return 100.0 * least / secs
