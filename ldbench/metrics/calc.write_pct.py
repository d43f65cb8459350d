"""The share of the traced window's `calc` jobs in which the .two writer
worked: the union, over every thread, of the benchmark's spans around
`TwoWriter.add`, `write_block`, `_emit_block` (its compression and
write, on its own thread) and `close`, over the jobs' walls."""


def read(run, res):
    if run.spans is None:
        return None
    return run.spans.share(("calc.write",), run.walls)
