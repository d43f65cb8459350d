"""The unphased parts tile kernel's (P = 9) share of its roofline: the
least time its calls in the traced window could take at the HBM's
published bandwidth (ldbench/roofline/parts_tile.py), over their device
time; operations per byte to the log (no published peak for the 1-bit
MMA)."""

from ldbench.roofline import parts_tile as rf
from ldbench.roofline import peaks
from ldbench.run import say


def read(run, res):
    dt = run.device_trace
    calls, secs = dt.kernel("parts_tile_kernel<2>") if dt else (0, 0.0)
    if not calls or secs <= 0:
        return None
    B, Ws = run.shapes["B"], run.shapes["Ws"]
    least = calls * rf.bytes_per_call(B, Ws) / peaks.HBM_BYTES_PER_S
    say(f"parts_tile<2>: {calls} calls, {secs:.6f} s, "
        f"{rf.ops_per_call(B, Ws) / rf.bytes_per_call(B, Ws):.1f} "
        f"operations a byte")
    return 100.0 * least / secs
