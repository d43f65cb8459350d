"""The share of the traced window's `calc` jobs in which the archive was
read or inflated: the union, over every thread, of the benchmark's spans
around `TwkReader.read_block` and the engine's `block_to_planes`, over
the jobs' walls."""


def read(run, res):
    if run.spans is None:
        return None
    return run.spans.share(("calc.read", "calc.inflate"), run.walls)
