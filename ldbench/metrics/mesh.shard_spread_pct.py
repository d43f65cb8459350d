"""How unevenly a mesh's pairs shards end: in each unit of the traced
window, the device busy time of the slowest card less the fastest's,
over the slowest's; the mean over the units."""


def read(run, res):
    dt = run.device_trace
    n = run.cell["chips"]
    if dt is None or n < 2 or not dt.units:
        return None
    spreads = []
    for lo, hi in dt.units:
        busy = [dt.busy_s(c, lo, hi) for c in range(n)]
        if max(busy) > 0:
            spreads.append((max(busy) - min(busy)) / max(busy))
    if not spreads:
        return None
    return 100.0 * sum(spreads) / len(spreads)
