import time


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def start(self):
        self.t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def elapsed_string(self) -> str:
        # round to milliseconds FIRST so the carry propagates (else
        # 119.9996s renders as "01m60.000s" instead of "02m00.000s")
        ms = round(self.elapsed() * 1000)
        h, rem = divmod(ms, 3_600_000)
        m, rem = divmod(rem, 60_000)
        sec = rem / 1000.0
        if h >= 1:
            return f"{h:02d}h{m:02d}m{sec:06.3f}s"
        if m >= 1:
            return f"{m:02d}m{sec:06.3f}s"
        return f"{sec:.3f}s"
