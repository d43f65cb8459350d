"""The share of the traced window in which no kernel, copy or memset ran
on a card, from torch.profiler's device activity, averaged over the
cell's cards."""


def read(run, res):
    dt = run.device_trace
    if dt is None or not dt.busy:
        return None
    n = run.cell["chips"]
    busy = sum(dt.busy_s(c) for c in dt.busy) / n
    return 100.0 * (1.0 - busy / dt.window_s())
