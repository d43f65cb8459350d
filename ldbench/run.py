"""One run of one cell of the port's benchmark.

    python3 -m ldbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port (tomahawk_tpu_torch).
The run finds the cell's file (`ldbench/cells/<cell>.json`), its
configuration (`ldbench/configs/<config>.json`) and its entry
(`ldbench/entries/<entry>.py`) by name; it fails where the cell's cards
are not there (it never falls back to the CPU), sets up and warms up
(one whole unit of work at the cell's own shapes), runs whole units for
at least `--seconds`, checks what the window produced against the plain
reference, and prints one JSON line last on standard output:
`correct`, `attempted` (units in the window), `failed` (units whose
record count differs from the last one's), `metrics` (with `--trace 0`
the cell's end-to-end metrics, with `--trace 1` its per-layer ones, each
read by `ldbench/metrics/<metric>.py`), `device`, with `--trace 1`
`breakdown`, and last `checks`: each number compared with its limit.
Everything else goes to standard error.

Builds and caches stay in the checkout: the port's kernels and native
library in `build/tomahawk_tpu_torch/` (the port's own fixed place), and
Triton's and torch's extension caches in `build/ldbench/`. Outputs go to
a directory made under TMPDIR and removed at the end.
"""

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "ldbench")
#: top-level modules that may not be loaded by the end of a run: JAX and
#: the JAX package the port was made from (whole names: the port's own
#: name begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "tomahawk_tpu")


def say(msg: str):
    print(f"[ldbench] {msg}", file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, root: str = ROOT):
    """(cell, configuration) of cell `name`, from their files."""
    cell = load_json(os.path.join(root, "ldbench", "cells", f"{name}.json"))
    config = load_json(os.path.join(root, "ldbench", "configs",
                                    f"{cell['config']}.json"))
    return cell, config


def load_module(kind: str, name: str, root: str = ROOT):
    """ldbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(root, "ldbench", kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"ldbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, group: str) -> list:
    """The metrics of BENCHMARK.json's `group` that cell `cell` reports:
    those that list it, or that list no cells (a per-layer metric
    without a list: every cell that reports the metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if group == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs(root: str = ROOT):
    """Triton's and torch's build caches at fixed places in the checkout
    (the port builds its own kernels in build/tomahawk_tpu_torch/)."""
    base = os.path.join(root, "build", "ldbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")


class Run:
    """What a run knows: its cell, configuration, seed, window, device,
    output directory, the spans and counters of its traced window."""

    def __init__(self, name, cell, config, seed, seconds, trace, device,
                 tmp):
        self.name, self.cell, self.config = name, cell, config
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.tmp = device, tmp
        self.spans = None        # trace.Spans of the traced window
        self.device_trace = None  # trace.DeviceTrace of it
        self.counters = {}
        self.walls = []          # (start, end) of each unit in the window
        self.shapes = {}
        self.bytes_written = 0

    @property
    def cards(self) -> list:
        n = self.cell["chips"]
        if self.device == "cpu":
            return ["cpu"] * n
        return [f"cuda:{i}" for i in range(n)]

    def sync(self):
        import torch
        if self.device != "cpu":
            for c in self.cards:
                torch.cuda.synchronize(c)


def measure(run: Run, entry) -> dict:
    """Set up, warm up, run the window, check; the numbers of the run."""
    from . import trace as tr
    say(f"imports done at {time.perf_counter() - T_START:.3f} s")
    state = entry.setup(run)
    t_warm = time.perf_counter()
    warm = entry.unit(run, state)
    run.sync()
    setup_s = time.perf_counter() - T_START
    say(f"set-up {setup_s:.3f} s, of it the warm unit "
        f"{setup_s - (t_warm - T_START):.3f} s: {json.dumps(warm)}")
    if run.device != "cpu":
        import torch
        for c in run.cards:
            torch.cuda.reset_peak_memory_stats(c)
    units = []
    if run.trace:
        run.spans = tr.Spans()
        entry.trace_spans(run, state, run.spans)
    from torch.profiler import record_function
    with tr.profiled(run.trace) as prof:
        with record_function("ldbench.window"):
            t0 = time.perf_counter()
            while True:
                with record_function("ldbench.unit"):
                    a = time.perf_counter()
                    u = entry.unit(run, state)
                    b = time.perf_counter()
                run.walls.append((a, b))
                units.append(u)
                if b - t0 >= run.seconds:
                    break
            window_s = time.perf_counter() - t0
    if run.spans is not None:
        run.spans.restore()
    peak = entry.memory_peak(run)
    if prof is not None:
        run.device_trace = tr.DeviceTrace(prof)
        if run.spans is not None:
            run.device_trace.add_spans(run.spans, t0)
        spans = run.spans.by_name if run.spans is not None else {}
        say(f"host annotations in the trace: "
            f"{dict(run.device_trace.note_counts)}; spans: "
            f"{ {k: len(v) for k, v in spans.items()} }")
    pairs = sum(u["pairs"] for u in units)
    say(f"window {window_s:.3f} s, {len(units)} units, {pairs} pairs; "
        f"units: {json.dumps(units)}")
    entry.release(run, state)
    t0 = time.perf_counter()
    numbers = entry.check(run, state, units)
    say(f"check {time.perf_counter() - t0:.3f} s")
    return dict(setup_s=setup_s, window_s=window_s, units=units, pairs=pairs,
                pairs_per_s=pairs / window_s, memory_peak=peak,
                numbers=numbers)


def result_line(run: Run, bench: dict, res: dict) -> dict:
    """The JSON object a run prints last."""
    import torch
    limits = run.cell["limits"]
    checks = {k: dict(value=res["numbers"][k], limit=limits[k])
              for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    group = "per_layer" if run.trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, run.name, group):
        value = load_module("metrics", m["name"]).read(run, res)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    count = run.cell["chips"]
    device = dict(platform="gpu" if run.device != "cpu" else "cpu",
                  kind=(torch.cuda.get_device_name(0) if run.device != "cpu"
                        else "cpu"),
                  count=count, memory_peak_bytes=res["memory_peak"])
    out = dict(correct=correct, attempted=len(res["units"]),
               failed=int(res["numbers"].get("units_differ", 0)),
               metrics=metrics, device=device)
    dt = run.device_trace
    if dt is not None:
        cards = sorted(dt.busy) or [0]
        device["busy_s"] = sum(dt.busy_s(c) for c in cards) / count
        device["window_s"] = dt.window_s()
        out["breakdown"] = dict(device_ops=dt.top_ops(),
                                idle_gaps=dt.idle_gaps(cards[0]))
    out["checks"] = checks
    return out


def card_report() -> str:
    """The card's name, power limit and clocks (nvidia-smi), for the log."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run_cell(name: str, seed: int, seconds: float, trace: int,
             device: str = "cuda", cell=None, config=None, bench=None):
    """One run; returns (result line, run). `cell`, `config` and `bench`
    given: a cell that has no file (the tests' small cells)."""
    if cell is None:
        cell, config = load_cell(name)
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = load_module("entries", cell["entry"])
    tmp = tempfile.mkdtemp(prefix="ldbench-", dir=tempfile.gettempdir())
    try:
        run = Run(name, cell, config, seed, seconds, trace, device, tmp)
        res = measure(run, entry)
        say(f"bytes written: {run.bytes_written}")
        return result_line(run, bench, res), run
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ldbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    cell, config = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        say(f"cell {args.workload} needs {cell['chips']} CUDA card(s); "
            f"torch sees {torch.cuda.device_count()}")
        return 3
    if importlib.util.find_spec("tomahawk_tpu_torch") is None or not \
            os.path.abspath(importlib.util.find_spec(
                "tomahawk_tpu_torch").origin).startswith(ROOT + os.sep):
        say("the port (tomahawk_tpu_torch) is not in this checkout")
        return 4
    say(f"card: {card_report()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    line, _ = run_cell(args.workload, args.seed, args.seconds, args.trace)
    bad = forbidden_modules()
    if bad:
        say(f"modules that may not be loaded are loaded: {bad}")
        return 5
    for name, c in line["checks"].items():
        say(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
