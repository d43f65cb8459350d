"""The share of the traced window in which the card was idle (averaged
over the cell's cards) while the main thread was in the program's span
`engine.wait`: blocked on the segment consumer, with the next segment
not yet dispatched (ldbench/program_spans.py)."""

from ldbench import program_spans


def read(run, res):
    return program_spans.idle_share(run, ("engine.wait",))
