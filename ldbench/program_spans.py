"""The program's own spans of a traced window, for the readers of
ldbench/metrics that use them.

The port records spans (`tomahawk_tpu_torch.spans`) while a torch
profiler records, so a `--trace 1` run's spans are those of its window:
not the warm unit's, not the check's. `spans(run)` collects them once a
run and keeps them in `run.counters`, with their times in seconds on the
host clock (`time.perf_counter`, the clock of `run.walls`: the program
stamps them with `perf_counter_ns`). A checkout whose program records no
spans gives None, and so does every reader of them.

Two views:
- `share(run, names)`: the union of spans `names` over the units' walls,
  as `trace.Spans.share` takes the benchmark's own spans (host clock).
- `idle_share(run, names)`: the time in the window during which a card
  was idle (the complement of the device trace's busy intervals) and a
  span `names` was open, averaged over the cell's cards, over the
  window. Spans move onto the trace's clock by the median offset between
  the start of each unit's `ldbench.unit` annotation and of its wall;
  the spread of the offsets goes to the log.

At first collection the log also gets the spans by name, any the
program dropped, the job thread's coverage of each `calc.job`, and in
the engine cells the card's idle split: in `engine.dispatch`, in
`engine.wait`, elsewhere in `engine.group`, outside any `engine.group`.
"""

import statistics
from collections import Counter

from ldbench.run import say
from ldbench.trace import Spans, union

KEY = "program_spans"


def spans(run):
    """The window's program spans as (name, start s, end s, thread, id,
    parent, job), host clock; None where the program has none."""
    if KEY in run.counters:
        return run.counters[KEY]
    got = None
    try:
        from tomahawk_tpu_torch import spans as recorder
    except ImportError:
        recorder = None
    if recorder is not None and run.device_trace is not None:
        got = [(s.name, s.start * 1e-9, s.end * 1e-9, s.thread, s.id,
                s.parent, s.job) for s in recorder.collect()]
        say(f"program spans: {dict(Counter(s[0] for s in got))}; dropped "
            f"{recorder.dropped()}")
        got = got or None
    run.counters[KEY] = got
    if got:
        _log_coverage(run, got)
    return got


def share(run, names):
    """The union of the program's spans `names` over the units' walls,
    in percent (`trace.Spans.share`)."""
    got = spans(run)
    if got is None:
        return None
    held = Spans()
    for s in got:
        if s[0] in names:
            held.by_name[s[0]].append((s[1], s[2]))
    return held.share(names, run.walls) or 0.0


def trace_offset(run):
    """Seconds to add to a host-clock time to place it on the trace's
    clock: the median over units of the offset between the start of the
    unit's `ldbench.unit` annotation and the start of its wall (taken
    right after the annotation opens; the ends lie further apart, by the
    annotation's varying cost of closing), and the offsets' spread
    (largest less least)."""
    dt = run.device_trace
    n = min(len(dt.units), len(run.walls))
    if n == 0:
        return None
    offs = [s - a for (s, _), (a, _) in zip(dt.units[:n], run.walls[:n])]
    return statistics.median(offs), max(offs) - min(offs)


def _intervals(got, names, off=0.0):
    return [(s[1] + off, s[2] + off) for s in got if s[0] in names]


def _gaps(busy, lo, hi):
    """The complement of `busy` intervals in [lo, hi]."""
    out, at = [], lo
    for a, b in sorted(busy):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        elif b > a:
            out.append((a, b))
    return out


def _overlap(xs, ys) -> float:
    """Length of the intersection of two interval sets."""
    xs, ys = _merged(xs), _merged(ys)
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _idle_in(run, intervals) -> float:
    """Idle seconds of the cell's cards inside `intervals` (trace
    clock), averaged over the cards."""
    dt = run.device_trace
    lo, hi = dt.window
    n = run.cell["chips"]
    return sum(_overlap(_gaps(dt.busy.get(c, ()), lo, hi), intervals)
               for c in range(n)) / n


def idle_share(run, names):
    """The cards' idle time while a program span `names` was open, over
    the window, in percent."""
    got = spans(run)
    off = trace_offset(run) if got is not None else None
    if off is None:
        return None
    return 100.0 * _idle_in(run, _intervals(got, names, off[0])) \
        / run.device_trace.window_s()


def _log_coverage(run, got):
    """What the metrics leave out, to the log: the clock offsets' spread,
    the job thread's coverage of each `calc.job`, the idle split of the
    engine cells."""
    off = trace_offset(run)
    if off is not None:
        say(f"program clock -> trace clock: offset {off[0]:.6f} s, spread "
            f"over {len(run.walls)} units {off[1] * 1e6:.1f} us")
    jobs = [s for s in got if s[0] == "calc.job"]
    cover = []
    for j in jobs:
        kids = [(s[1], s[2]) for s in got if s[5] == j[4] and s[3] == j[3]]
        cover.append(union(kids, j[1], j[2]) / (j[2] - j[1]))
    if cover:
        say(f"calc.job covered by its thread's child spans: "
            f"{', '.join(f'{100 * c:.2f}%' for c in cover)}")
    if off is not None and any(s[0] == "engine.group" for s in got):
        win = run.device_trace.window_s()
        idle = _idle_in(run, [run.device_trace.window])
        parts = {n: _idle_in(run, _intervals(got, (n,), off[0]))
                 for n in ("engine.group", "engine.dispatch", "engine.wait")}
        rest = parts["engine.group"] - parts["engine.dispatch"] \
            - parts["engine.wait"]
        say(f"card idle {100 * idle / win:.3f}% of the window: in "
            f"engine.dispatch {100 * parts['engine.dispatch'] / win:.3f}, "
            f"engine.wait {100 * parts['engine.wait'] / win:.3f}, elsewhere "
            f"in engine.group {100 * rest / win:.3f}, outside engine.group "
            f"{100 * (idle - parts['engine.group']) / win:.3f}")
