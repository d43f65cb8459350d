"""Detached progress ticker.

TPU-native analogue of the reference's progress threads
(reference: lib/ld/ld_progress.h:42-96, lib/sort_progress.h): a daemon
thread wakes on a fixed cadence (30 s by default, like the reference),
prints processed-pair / output-record counts plus an ETA derived from
the current rate, and on finalize prints the end-of-run throughput
summary (pairs/s and genotypes/s = pairs/s x samples, mirroring
docs/tutorial.md:185-191)."""

import threading
import time

from .logging import log, pretty_int


class ProgressTicker:
    def __init__(self, total_pairs: int = 0, n_samples: int = 0,
                 interval: float = 30.0, sub: str = "PROGRESS",
                 enabled: bool = True):
        self.total_pairs = int(total_pairs)
        self.n_samples = int(n_samples)
        self.interval = interval
        self.sub = sub
        self.enabled = enabled
        # ints mutated under the GIL; single-writer accuracy is enough
        self.n_pairs = 0
        self.n_records = 0
        self.b_out = 0
        self._t0 = time.monotonic()
        self._stop = threading.Event()
        self._thread = None

    # -- counters ----------------------------------------------------
    def add(self, pairs: int = 0, records: int = 0, bytes_out: int = 0):
        self.n_pairs += int(pairs)
        self.n_records += int(records)
        self.b_out += int(bytes_out)

    # -- lifecycle ----------------------------------------------------
    def start(self):
        if not self.enabled or self._thread is not None:
            return self
        self._t0 = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval):
            self._tick()

    def _tick(self):
        el = max(time.monotonic() - self._t0, 1e-9)
        rate = self.n_pairs / el
        msg = (f"{pretty_int(self.n_pairs)} pairs, "
               f"{pretty_int(self.n_records)} records "
               f"({pretty_int(int(rate))} pairs/s)")
        if self.total_pairs and rate > 0:
            left = max(self.total_pairs - self.n_pairs, 0) / rate
            msg += f"; ETA {self._fmt(left)}"
        log("PROGRESS", msg, sub=self.sub)

    def finalize(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None
        el = max(time.monotonic() - self._t0, 1e-9)
        rate = self.n_pairs / el
        msg = (f"Finished: {pretty_int(self.n_pairs)} pairs -> "
               f"{pretty_int(self.n_records)} records in "
               f"{self._fmt(el)} ({pretty_int(int(rate))} pairs/s")
        if self.n_samples:
            msg += f", {pretty_int(int(rate * self.n_samples))} genotypes/s"
        if self.enabled:
            log("PROGRESS", msg + ")", sub=self.sub)
        return rate

    @staticmethod
    def _fmt(seconds: float) -> str:
        s = int(seconds)
        h, s = divmod(s, 3600)
        m, s = divmod(s, 60)
        if h:
            return f"{h:02d}h{m:02d}m{s:02d}s"
        if m:
            return f"{m:02d}m{s:02d}s"
        return f"{seconds:.3f}s"
