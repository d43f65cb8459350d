"""The share of the traced window's `calc` jobs in which the job's
thread waited on its inflation pool and stacked the planes: the union of
the program's spans `calc.inflate_wait` over the jobs' walls
(ldbench/program_spans.py)."""

from ldbench import program_spans


def read(run, res):
    return program_spans.share(run, ("calc.inflate_wait",))
