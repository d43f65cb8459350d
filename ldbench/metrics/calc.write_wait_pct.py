"""The share of the traced window's `calc` jobs in which a thread of the
job waited on the .two writer: the union of the program's spans
`write.add` (a block's snapshot and its place on the writer's queue) and
`write.close` (the final drain) over the jobs' walls; the writer's own
compression beside them is not counted (ldbench/program_spans.py)."""

from ldbench import program_spans


def read(run, res):
    return program_spans.share(run, ("write.add", "write.close"))
