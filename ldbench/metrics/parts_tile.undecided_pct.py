"""The share of the candidate pairs that the unphased prefilter's
division-free screen (csrc/prefilter.cuh `unphased_screen`) left to the
exact f32 statement, in the port's `parts_tile` on the engine's path:
the program's own counter, read back with each segment's counts and
summed over the process (tomahawk_tpu_torch/compute/engine.py
`SCREEN_TOTALS`; each `engine.group` span carries its group's as
`screened` and `undecided`). The process's passes are the warm unit's
and the window's, each the same tile list over the same planes, so the
share is the window's. Read in a traced run; a port without the counter
gives None."""


def read(run, res):
    if run.device_trace is None:
        return None
    try:
        from tomahawk_tpu_torch.compute import engine
    except ImportError:
        return None
    totals = getattr(engine, "SCREEN_TOTALS", None)
    if not totals or not totals["screened"]:
        return None
    return 100.0 * totals["undecided"] / totals["screened"]
