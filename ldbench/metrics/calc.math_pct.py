"""The host math's share of the traced window's `calc` jobs: the engine's
own counter `stats[*]["math_s"]` (the native record pipeline's time on
the segment consumer), summed over every engine `compute_ld` built in
the window, over the jobs' walls."""


def read(run, res):
    engines = run.counters.get("engines")
    total = sum(b - a for a, b in run.walls)
    if not engines or total <= 0:
        return None
    math_s = sum(s["math_s"] for e in engines for s in e.stats.values())
    return 100.0 * math_s / total
