"""Spans of the port's own work: what each thread did, when, and inside
what.

A span is a named interval of one thread on `time.perf_counter_ns()`'s
clock with its own id, its parent's id, the id of the job it belongs to
and integer attributes: counts (records, tiles, bytes), which `table`
sums. The parent is the span open on the same thread;
work handed to another thread names its parent explicitly (`span(...,
parent=ctx)`), with `ctx` a span's `ctx` or `current()` taken on the
handing thread. A job is one `compute_ld` call (its `calc.job`), or in
library use one `LdEngine.run_group` call (its `engine.group`): a span
opened with `job=True` starts a job where its thread has none open.

Spans are recorded only while a torch profiler records
(`torch.autograd.profiler._is_profiler_enabled`) or inside a
`recording()` block. Otherwise `span` costs one check and returns a
shared null context. `timed` always measures, since the engine's
always-on totals (`LdEngine.stats`, `stage_stats`, `gather_s`) read its
`seconds`, and records only when recording is on. Recorded spans stay in
memory, at most `LIMIT`, counting what they drop (`dropped`);
`collect()` hands them over and clears them. The profiler sees none of
them: its annotations are the main thread's alone, so readers move these
onto its clock themselves.

`table` sums spans by name and thread (count, total and self seconds:
a span less what its children on its thread cover, and each attribute);
`log_table` prints it (`calc --performance`).
"""

import contextlib
import itertools
import re
import threading
import time
from collections import defaultdict, namedtuple

import torch.autograd.profiler as _profiler

from .utils import log

__all__ = ["LIMIT", "NULL", "Span", "collect", "current", "dropped",
           "log_table", "on", "recording", "span", "table", "timed"]

#: a recorded span: times in perf_counter_ns, `attrs` a dict of ints
Span = namedtuple("Span", "name start end thread id parent job attrs")

#: the most spans held between two `collect` calls (~20 MB; a traced
#: benchmark run records ~2,000, a calc job ~350 plus ~4 a written block)
LIMIT = 1 << 16

_local = threading.local()
_lock = threading.Lock()
_ids = itertools.count(1)
_jobs = itertools.count(1)
_buf = []
_state = dict(recording=0, dropped=0)


def on() -> bool:
    """Whether spans are recorded now."""
    return _state["recording"] > 0 or _profiler._is_profiler_enabled


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def current():
    """(span id, job id) of the innermost span open on this thread, or
    None: the `ctx` to hand to work on another thread."""
    st = getattr(_local, "stack", None)
    return st[-1] if st else None


class _Null:
    """What a span site gets while nothing is recorded."""
    __slots__ = ()
    ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass

    def start(self):
        return self

    def stop(self):
        pass


NULL = _Null()


class _Span:
    __slots__ = ("name", "attrs", "rec", "new_job", "parent", "id", "job",
                 "t0", "t1", "_depth")

    def __init__(self, name, attrs, rec, new_job=False, parent=None):
        self.name, self.attrs, self.rec = name, attrs, rec
        self.new_job, self.parent = new_job, parent
        self.id = self.job = None
        self.t0 = self.t1 = 0

    def __enter__(self):
        if self.rec:
            st = _stack()
            top = self.parent or (st[-1] if st else (None, None))
            self.parent, self.job = top
            if self.new_job and self.job is None:
                self.job = next(_jobs)
            self.id = next(_ids)
            self._depth = len(st)
            st.append((self.id, self.job))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.rec:
            # also closes what an exception left open above this span
            del _stack()[self._depth:]
            _add(Span(self.name, self.t0, self.t1,
                      threading.current_thread().name, self.id,
                      self.parent, self.job, self.attrs))
        return False

    def start(self):
        """Open the span without a `with` block (`stop` closes it)."""
        return self.__enter__()

    def stop(self):
        self.__exit__(None, None, None)

    def set(self, **attrs):
        """Integer attributes of the span."""
        self.attrs.update(attrs)

    @property
    def ctx(self):
        """(id, job) for spans of this one's children on other threads;
        None when it is not recorded."""
        return (self.id, self.job) if self.rec else None

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


def span(name: str, job: bool = False, parent=None, **attrs):
    """A span `name` around a `with` block, recorded when `on()`; the
    shared null context otherwise. `job`: start a job where this thread
    has none open. `parent`: a `ctx` from another thread."""
    if not on():
        return NULL
    return _Span(name, attrs, True, job, parent)


def timed(name: str, **attrs) -> _Span:
    """A span that measures always (its `seconds` after the block) and
    is recorded when `on()`."""
    return _Span(name, attrs, on())


def _add(rec: Span):
    with _lock:
        if len(_buf) < LIMIT:
            _buf.append(rec)
        else:
            _state["dropped"] += 1


@contextlib.contextmanager
def recording():
    """Record spans inside the block, on every thread, profiler or not."""
    with _lock:
        _state["recording"] += 1
    try:
        yield
    finally:
        with _lock:
            _state["recording"] -= 1


def collect(job=None) -> list:
    """The recorded spans, in the order they ended, taken out of the
    buffer: all of them, or those of job `job`."""
    global _buf
    with _lock:
        if job is None:
            out, _buf = _buf, []
        else:
            out = [s for s in _buf if s.job == job]
            _buf = [s for s in _buf if s.job != job]
    return out


def dropped() -> int:
    """Spans not kept since the process started: the buffer was full."""
    return _state["dropped"]


def _thread_kind(name: str) -> str:
    """A thread's name without its pool index (`twk-inflate_3` ->
    `twk-inflate`)."""
    return re.sub(r"_\d+$", "", name)


def _covered(intervals, lo, hi) -> int:
    """Length of the union of `intervals` clipped to [lo, hi]."""
    total, end = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def table(spans) -> list:
    """[(name, thread, count, total s, self s, {attribute: sum})] of
    `spans` by name and thread kind, largest total first. Self time is a
    span's duration less the union of its children's on the same
    thread."""
    kids = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            kids[(s.parent, s.thread)].append((s.start, s.end))
    rows = defaultdict(lambda: [0, 0, 0, defaultdict(int)])
    for s in spans:
        r = rows[(s.name, _thread_kind(s.thread))]
        r[0] += 1
        r[1] += s.end - s.start
        r[2] += s.end - s.start - _covered(kids.get((s.id, s.thread), ()),
                                           s.start, s.end)
        for k, v in s.attrs.items():
            r[3][k] += v
    return sorted(((n, t, c, tot * 1e-9, own * 1e-9, dict(sorted(at.items())))
                   for (n, t), (c, tot, own, at) in rows.items()),
                  key=lambda r: -r[3])


def log_table(spans, dropped: int = 0):
    """The span table under the PERF log tag; `dropped`: spans of the
    job the full buffer did not keep."""
    log("LOG", f"{'span':<26}{'thread':<14}{'count':>7}{'total s':>10}"
        f"{'self s':>10}  attributes (sums)", sub="PERF")
    for name, thread, n, tot, own, attrs in table(spans):
        sums = " ".join(f"{k}={v}" for k, v in attrs.items())
        log("LOG", f"{name:<26}{thread:<14}{n:>7}{tot:>10.3f}{own:>10.3f}"
            f"  {sums}".rstrip(), sub="PERF")
    if dropped:
        log("WARNING", f"{dropped} spans not recorded: the buffer holds "
            f"{LIMIT}", sub="PERF")
