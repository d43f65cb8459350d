"""parts_tile's wide instance (csrc/cluster_stage.cuh: clusters of 4 x 2
blocks that share TMA-multicast operand stages) as the CPU sees it. The
kernel runs only on the card: chip_smoke.py's `compare_wide` holds it to
today's instance and the plain version there, and so does the card test
of tests/test_torch_biobank_width.py at 15,264 words.

- Every kernel of csrc/parts_tile.cu, named as torch.profiler names it,
  is counted by the benchmark's `DeviceTrace.kernel("parts_tile_kernel<2>")`
  (ldbench's parts_tile rooflines find their kernel by that substring).
- `_build.WIDE_LAUNCHES` starts at 0 and stays 0 on the CPU's plain path,
  where each `engine.group` span carries `wide` = 0.
- The wrappers count what the C side reports: `tiles._launch` asks
  `twk_parts_tile_wide` with the arguments it launched with, and
  `sweeps._launch_sweep` takes the C loop's third count (a stand-in
  library).
"""

import ctypes
import os
import re
import types
from collections import defaultdict

import numpy as np
import pytest
import torch

from ldbench.trace import DeviceTrace, kernel_name
from tomahawk_tpu_torch import spans, workloads
from tomahawk_tpu_torch.compute import sweeps
from tomahawk_tpu_torch.compute.engine import (CalcSettings, LdEngine,
                                               dispatch_pairs)
from tomahawk_tpu_torch.ops import _build, tiles
from tomahawk_tpu_torch.ops.ld_math import LdFilters

SOURCE = os.path.join(_build.CSRC, "parts_tile.cu")
B, MIN_R2 = 64, 0.1


def _source():
    with open(SOURCE) as fh:
        return fh.read()


def _kernels():
    """The names of the __global__ functions of parts_tile.cu."""
    return re.findall(r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s*)*"
                      r"(\w+)\s*\(", _source())


def _wide_words():
    return int(re.search(r"constexpr int kWideWords = (\d+);",
                         _source()).group(1))


def test_parts_tile_has_a_wide_kernel():
    names = _kernels()
    assert "parts_tile_kernel" in names
    assert any(n != "parts_tile_kernel" for n in names)


@pytest.mark.parametrize("args", ["(anonymous namespace)::Args",
                                  "(anonymous namespace)::Args, "
                                  "(anonymous namespace)::Maps"])
@pytest.mark.parametrize("name", _kernels())
def test_trace_counts_every_kind2_kernel_as_parts_tile(name, args):
    """Kind 2 of every kernel, as the profiler names it, lands under
    `parts_tile_kernel<2>` in a device trace, and kind 1 does not."""
    dt = DeviceTrace.__new__(DeviceTrace)
    dt.kernels = defaultdict(lambda: [0, 0.0])
    for kind, secs in ((2, 0.25), (1, 0.5)):
        k = dt.kernels[kernel_name(
            f"void (anonymous namespace)::{name}<{kind}>({args})")]
        k[0] += 1
        k[1] += secs
    assert dt.kernel("parts_tile_kernel<2>") == (1, 0.25)


@pytest.fixture(scope="module")
def wide_planes():
    """Two super-blocks of B genotype variants with missing calls, as
    wide as the wide instance's least W."""
    n_samples = 32 * _wide_words() - 7
    return workloads.genotype_planes(2, B, n_samples, seed=5), n_samples


def test_wide_counter_stays_zero_on_the_cpu(wide_planes):
    stacked, n_samples = wide_planes
    _build.reset_counts()
    assert _build.WIDE_LAUNCHES == {"parts_tile": 0}
    engine = LdEngine(stacked, n_samples, CalcSettings(min_r2=MIN_R2),
                      device="cpu")
    pairs = [(0, 1, False), (1, 1, True)]
    try:
        with spans.recording():
            dispatch_pairs(engine, pairs, "unphased",
                           LdFilters(min_r2=MIN_R2), lambda r, rev=None: 0,
                           stacked)
    finally:
        if hasattr(engine, "stage_close"):
            engine.stage_close()
    groups = [s for s in spans.collect() if s.name == "engine.group"
              and s.attrs["tiles"]]
    assert groups and all(g.attrs["wide"] == 0 for g in groups)
    assert _build.PLAIN_CALLS["parts_tile"] > 0
    assert _build.WIDE_LAUNCHES == {"parts_tile": 0}


class _Library:
    """A stand-in kernel library whose parts_tile takes the wide instance
    for every launch; records the query's arguments."""

    def __init__(self):
        self.launched, self.asked = [], []

    def twk_parts_tile(self, *args):
        self.launched.append(args)
        return 0

    def twk_parts_tile_wide(self, *args):
        self.asked.append(args)
        return 1

    def twk_compact(self, *args):
        return 0

    def twk_sweep(self, *args):
        done = args[-1]
        T, live = args[21], args[25]
        n = T if live is None else sum(
            (ctypes.c_uint8 * T).from_address(live))
        done[0] = done[1] = done[2] = n
        return 0


@pytest.fixture
def stand_in(monkeypatch, wide_planes):
    stacked, n_samples = wide_planes
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=7777))
    monkeypatch.setattr(sweeps, "_TICKETS", {})
    cfg = sweeps.make_cfg("unphased", True, "all", B, n_samples, 0, MIN_R2,
                          100.0)
    dev = sweeps.planes_to_device(stacked, "cpu", sweeps.dev_keys_for(cfg))
    _build.reset_counts()
    return lib, cfg, dev


def test_tile_launch_counts_what_the_c_side_reports(stand_in):
    lib, cfg, dev = stand_in
    out = tiles.tile_buffers(cfg, "cpu")
    tiles._launch(dev, 0, 1, False, cfg, out)
    assert _build.LAUNCHES["parts_tile"] == 1
    assert _build.WIDE_LAUNCHES == {"parts_tile": 1}
    (launch,), (asked,) = lib.launched, lib.asked
    kind, window, W = launch[0], launch[21], launch[24]
    assert asked == (kind, window, W) + launch[1:7]
    assert (kind, window, W) == (2, 0, _wide_words())


def test_sweep_counts_the_c_loops_wide_launches(stand_in):
    lib, cfg, dev = stand_in
    out, cnt, scratch = sweeps._sweep_buffers(cfg, "cpu")
    buf = torch.zeros((1 << 10, sweeps.buf_cols(cfg)), dtype=torch.int32)
    T = 3
    n_pass = torch.zeros(T, dtype=torch.int32)
    live = np.array([1, 0, 1], bool)
    sweeps._launch_sweep(dev, np.array([0, 0, 1]), np.array([0, 1, 1]),
                         np.array([True, False, True]), live, cfg, 256, out,
                         cnt, scratch, torch.zeros(1, dtype=torch.int32),
                         buf, n_pass, n_pass.clone())
    assert _build.LAUNCHES["parts_tile"] == _build.LAUNCHES["compact"] == 2
    assert _build.WIDE_LAUNCHES == {"parts_tile": 2}
