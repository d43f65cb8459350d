"""The share of the traced window in which the card was idle (the
complement of the device trace's busy intervals, averaged over the
cell's cards) while the main thread was in the program's span
`engine.dispatch`: a segment's tile arrays, its fused sweep's launch and
its read-back copies queued (ldbench/program_spans.py)."""

from ldbench import program_spans


def read(run, res):
    return program_spans.idle_share(run, ("engine.dispatch",))
