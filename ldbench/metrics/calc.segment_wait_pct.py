"""The share of the traced window's `calc` jobs in which the job's
thread waited on the segment consumer (its read-back, host math and
emit): the union of the program's spans `engine.wait` over the jobs'
walls (ldbench/program_spans.py)."""

from ldbench import program_spans


def read(run, res):
    return program_spans.share(run, ("engine.wait",))
