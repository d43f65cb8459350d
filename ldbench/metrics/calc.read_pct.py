"""The share of the traced window's `calc` jobs in which the archive's
blocks were read and merged into super-blocks: the union of the
program's spans `calc.read` over the jobs' walls
(ldbench/program_spans.py)."""

from ldbench import program_spans


def read(run, res):
    return program_spans.share(run, ("calc.read",))
