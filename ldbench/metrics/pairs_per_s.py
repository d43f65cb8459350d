"""Variant pairs of the window's completed units (the benchmark's own
count, from the tile shapes) over the time from the window's start to
the last unit's end."""


def read(run, res):
    return res["pairs_per_s"]
