"""The share of a `calc` cell's traced window in which no kernel, copy or
memset ran on the card (torch.profiler's device activity): how far the
host's reading, inflation, math and writing keep the card waiting."""

from ldbench.run import load_module


def read(run, res):
    return load_module("metrics", "device_idle_pct").read(run, res)
