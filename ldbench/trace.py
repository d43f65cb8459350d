"""What a `--trace 1` run records: the benchmark's spans around calls
into the program, and the device's activity from torch.profiler.

Spans are taken from the benchmark's side only: a method of the program
is wrapped for the length of the traced window (`Spans.wrap`), its calls
timed on the host's clock on whichever thread makes them. The profiler
records annotations of the main thread only, so the spans are moved onto
the trace's clock by the window's start on both (`DeviceTrace.
add_spans`), and the device's idle gaps are named by what the host was
doing on any thread.
"""

import contextlib
import threading
import time
from collections import defaultdict

#: device activities that count as busy (not the user annotations that
#: the profiler mirrors onto the device)
BUSY = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals, lo=None, hi=None) -> float:
    """Length of the union of (start, end) intervals, clipped to [lo, hi]."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        if b <= a:
            continue
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Spans:
    """Host-clock spans of wrapped program calls, by name."""

    def __init__(self):
        self.by_name = defaultdict(list)
        self._lock = threading.Lock()
        self._undo = []

    def wrap(self, owner, attr: str, name: str):
        """Time every call of `owner.attr` (a class or module attribute)
        as span `name` until `restore`."""
        real = getattr(owner, attr)
        spans = self

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                with spans._lock:
                    spans.by_name[name].append((t0, t1))
        self.replace(owner, attr, timed)

    def replace(self, owner, attr: str, new):
        """`owner.attr` is `new` until `restore`."""
        self._undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def restore(self):
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)
        self._undo = []

    def share(self, names, walls) -> float:
        """The union of spans `names`, clipped to each (start, end) of
        `walls`, over the walls' summed length, in percent."""
        spans = [s for n in names for s in self.by_name.get(n, ())]
        total = sum(b - a for a, b in walls)
        if not spans or total <= 0:
            return None
        return 100.0 * sum(union(spans, a, b) for a, b in walls) / total


def _ns(e, which):
    """An event's start or end in ns, across profiler versions."""
    fn = getattr(e, f"{which}_ns", None)
    if fn is not None:
        return fn()
    if which == "start":
        return e.start_us() * 1000
    return (e.start_us() + e.duration_us()) * 1000


class DeviceTrace:
    """The device's activity in a profiler's trace: busy intervals by
    card, time by kernel, and the benchmark's host annotations."""

    def __init__(self, prof):
        from torch.autograd import DeviceType
        self.busy = defaultdict(list)        # card -> [(s, e)] seconds
        self.kernels = defaultdict(lambda: [0, 0.0])   # name -> [calls, s]
        self.notes = []                      # (name, s, e) host annotations
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                kind = e.activity_type() if hasattr(e, "activity_type") \
                    else "kernel"
                if kind not in BUSY or name.startswith("ldbench."):
                    continue
                s, t = _ns(e, "start") * 1e-9, _ns(e, "end") * 1e-9
                self.busy[e.device_index()].append((s, t))
                k = self.kernels[kernel_name(name)]
                k[0] += 1
                k[1] += t - s
            elif name.startswith("ldbench."):
                self.notes.append((name[8:], _ns(e, "start") * 1e-9,
                                   _ns(e, "end") * 1e-9))
        self.note_counts = defaultdict(int)
        for n, _, _ in self.notes:
            self.note_counts[n] += 1
        wins = [(s, t) for n, s, t in self.notes if n == "window"]
        self.window = wins[0] if wins else None
        self.units = sorted((s, t) for n, s, t in self.notes if n == "unit")

    def add_spans(self, spans: "Spans", window_start: float):
        """The host-clock spans as annotations, on the trace's clock:
        `window_start` is the window's start on the host clock."""
        off = self.window[0] - window_start
        for name, iv in spans.by_name.items():
            self.notes += [(name, a + off, b + off) for a, b in iv]

    def busy_s(self, card, lo=None, hi=None) -> float:
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        return union(self.busy.get(card, ()), lo, hi)

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernel(self, pattern: str):
        """(calls, seconds) of the kernels whose name holds `pattern`."""
        calls, secs = 0, 0.0
        for name, (n, s) in self.kernels.items():
            if pattern in name:
                calls += n
                secs += s
        return calls, secs

    def idle_gaps(self, card, top=10):
        """Idle time of `card` in the window by what the host was doing:
        [[what, seconds]] (`idle_by_host`)."""
        return idle_by_host(self.busy.get(card, ()), self.notes,
                            self.window, top)

    def top_ops(self, top=10):
        return [[k, v[1]] for k, v in sorted(self.kernels.items(),
                                             key=lambda kv: -kv[1][1])][:top]


def idle_by_host(busy, notes, window, top=10):
    """The idle time of one card in `window` (the complement of its busy
    intervals), each instant of it given to the host annotation open then
    that started last (a unit's own annotation only where no other is
    open; "outside" where none is): [[f"host: {name}", seconds]], the
    `top` largest. `notes` are (name, start, end)."""
    lo, hi = window
    gaps, at = [], lo
    for a, b in sorted(busy):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    marks = sorted({t for _, s, e in notes for t in (s, e)
                    if lo < t < hi} | {t for g in gaps for t in g})
    open_ = sorted((s, e, n) for n, s, e in notes if n != "window")
    by = defaultdict(float)
    g, k, active = 0, 0, []
    for t0, t1 in zip(marks, marks[1:]):
        while g < len(gaps) and gaps[g][1] <= t0:
            g += 1
        if g == len(gaps):
            break
        if not (gaps[g][0] <= t0 and t1 <= gaps[g][1]):
            continue
        while k < len(open_) and open_[k][0] <= t0:
            active.append(open_[k])
            k += 1
        active = [x for x in active if x[1] > t0]
        inner = [x for x in active if x[2] != "unit"] or active
        what = max(inner)[2] if inner else "outside"
        by[f"host: {what}"] += t1 - t0
    return [[w, v] for w, v in sorted(by.items(), key=lambda kv: -kv[1])
            ][:top]


def kernel_name(name: str) -> str:
    """A kernel's name without its argument list and `void`."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            return name[:i]
    return name


@contextlib.contextmanager
def profiled(on: bool):
    """torch.profiler over the block (CPU and CUDA activity) when `on`;
    yields the profiler or None."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
