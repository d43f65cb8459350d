"""Build and bind the hand-written CUDA kernels.

`csrc/*.cu` compile with nvcc for Hopper (`sm_90a`), one nvcc process
per source, all started together, and link into one shared library
with a plain C interface, loaded with ctypes. The library lands
in `build/tomahawk_tpu_torch/` beside the package, named by a hash of
the sources and flags, so an edited source rebuilds on first use and an
unchanged one loads at once. Nothing is built when the module is
imported: `library()` builds on the first kernel launch.

Each C entry point launches on the stream it is given, allocates
nothing, and returns `cudaGetLastError()`; `check` turns a non-zero
code into an exception. The files are built with `-fmad=false` so the
f32 prefilter rounds each product and difference on its own, exactly as
the plain PyTorch version does.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "tomahawk_tpu_torch")
SOURCES = ("phased_tile.cu", "parts_tile.cu", "compact.cu", "local_parts.cu",
           "epilogue.cu", "mma_probe.cu", "sweep.cu", "fisher_bracket.cu")
#: headers the sources include (part of the build hash)
HEADERS = ("prefilter.cuh", "mma_tile.cuh", "cluster_stage.cuh")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*_ARCH, "-shared")

#: the hand kernels: CUDA source and the TPU code each replaces
KERNELS = {
    "phased_tile": dict(
        source="tomahawk_tpu_torch/csrc/phased_tile.cu",
        replaces="tomahawk_tpu/ops/pallas_tiles.py:297"),
    "parts_tile": dict(
        source="tomahawk_tpu_torch/csrc/parts_tile.cu",
        replaces="tomahawk_tpu/ops/pallas_tiles.py:297"),
    "compact": dict(
        source="tomahawk_tpu_torch/csrc/compact.cu",
        replaces="tomahawk_tpu/ops/ld_kernels.py:364"),
    "local_parts": dict(
        source="tomahawk_tpu_torch/csrc/local_parts.cu",
        replaces="tomahawk_tpu/ops/pallas_tiles.py:221"),
    "tile_epilogue": dict(
        source="tomahawk_tpu_torch/csrc/epilogue.cu",
        replaces="tomahawk_tpu/compute/sweeps.py:279"),
    "fisher_bracket": dict(
        source="tomahawk_tpu_torch/csrc/fisher_bracket.cu",
        replaces="tomahawk_tpu/ops/fisher_dev.py:110"),
}

#: relationship's kinship GEMM (X4): a library call, torch._int_mm, not
#: a hand kernel; counted like one by its wrapper (ops/kinship.py)
KINSHIP = "kinship_int_mm"
#: launches of each kernel, counted by its wrapper where it launches
LAUNCHES = {name: 0 for name in (*KERNELS, KINSHIP)}
#: wrapper calls that took the plain PyTorch version (CPU tensors)
PLAIN_CALLS = {name: 0 for name in (*KERNELS, KINSHIP)}
#: the launches of LAUNCHES again by card: str(device) -> {name: count},
#: for the launches whose wrapper names the card it launched on
LAUNCHES_BY_CARD = {}
#: the launches of LAUNCHES that took a kernel's wide instance, as the C
#: side reports them (parts_tile: `twk_parts_tile_wide`, clusters sharing
#: operand stages)
WIDE_LAUNCHES = {"parts_tile": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L, _D = ctypes.c_longlong, ctypes.c_double
_SIGNATURES = {
    # alt_i, alt_j, ac_i, ac_j, valid_i, valid_j, an_i, an_j, pos_i, pos_j,
    # rid_i, rid_j, window, cls, B, W, n_hap, lo, hi, dp_lo, dp_hi,
    # need_nonzero, diag, mask, altalt, counts, stream
    "twk_phased_tile": [_P] * 12 + [_I] * 5 + [_F] * 4 + [_I] * 2
    + [_P] * 4,
    # kind, x_i, y_i, z_i, x_j, y_j, z_j, ac_i, ac_j, valid_i, valid_j,
    # an_i, an_j, n_het_i, n_hom_i, n_het_j, n_hom_j, pos_i, pos_j, rid_i,
    # rid_j, window, cls, B, W, n_samples, lo, hi, dp_lo, dp_hi,
    # need_nonzero, diag, mask, parts, counts, screen, stream
    "twk_parts_tile": [_I] + [_P] * 20 + [_I] * 5 + [_F] * 4 + [_I] * 2
    + [_P] * 5,
    # kind, window, W, x_i, y_i, z_i, x_j, y_j, z_j: 1 where twk_parts_tile
    # takes its wide instance
    "twk_parts_tile_wide": [_I] * 3 + [_P] * 6,
    # mask, parts, counts, P, ncol, ld, B, off, cap, outcap, n_pass, n_cand,
    # t, scratch, ticket, buf, stream
    "twk_compact": [_P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P, _P, _I, _P,
                    _P, _P, _P],
    # kind, x_i, y_i, z_i, x_j, y_j, z_j, B, W, parts, stream
    "twk_local_parts": [_I] + [_P] * 6 + [_I] * 2 + [_P] * 2,
    # kind, parts, ac_i, ac_j, valid_i, valid_j, an_i, an_j, n_het_i,
    # n_hom_i, n_het_j, n_hom_j, pos_i, pos_j, rid_i, rid_j, window, cls, B,
    # n_samples, lo, hi, dp_lo, dp_hi, need_nonzero, diag, mask, counts,
    # stream
    "twk_tile_epilogue": [_I] + [_P] * 15 + [_I] * 4 + [_F] * 4 + [_I] * 2
    + [_P] * 3,
    # kind, blocks, iters, out, stream
    "twk_mma_probe": [_I] * 3 + [_P] * 2,
    # buf, ld, has_missing, pack16, packed, fcol, B, n_hap, cap, outcap,
    # n_pass, T, ends, ac, pi, pj, min_rows, max_steps, lf, n_lf, cut_lo,
    # cut_hi, g, steps, stream
    "twk_fisher_bracket": [_P] + [_I] * 9 + [_P, _I] + [_P] * 4
    + [_L, _I, _P, _I] + [_D] * 3 + [_P] * 2,
    # kind, x, y, z, W, ac, valid, an, n_het, n_hom, pos, rid, window, cls,
    # B, n_samples, lo, hi, dp_lo, dp_hi, need_nonzero, T, pi, pj, dg, live,
    # mask, parts, counts, screen, P, ncol, ld, off, per_tile_off, cap,
    # outcap, n_pass, n_cand, scratch, ticket, buf, stream, done (csrc/
    # sweep.cu: the tile loop)
    "twk_sweep": [_I] + [_P] * 3 + [_I] + [_P] * 7 + [_I] * 4 + [_F] * 4
    + [_I] * 2 + [_P] * 8 + [_I] * 3 + [_P] + [_I] * 3 + [_P] * 7,
}

#: entry points called with the GIL held (ctypes.PyDLL): short calls the
#: main thread makes between a segment's sweep and its prefix copy. Each
#: call that releases the GIL lets the consumer thread take it, and the
#: main thread may then wait out the interpreter's switch interval (5 ms)
#: to get it back, a segment at a time (the windowed rows of chip_smoke.py
#: phase 5 show it)
HOLD_GIL = ("twk_fisher_bracket",)

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None
#: nvcc's report (registers, shared memory, spills) of the loaded
#: library's build, kept beside it (`_log_path`)
build_log = ""


def reset_counts():
    with _count_lock:
        for d in (LAUNCHES, PLAIN_CALLS, WIDE_LAUNCHES):
            for k in d:
                d[k] = 0
        LAUNCHES_BY_CARD.clear()


def count(counts: dict, name: str, n: int = 1, device=None):
    """Add n to counts[name] (LAUNCHES, PLAIN_CALLS or WIDE_LAUNCHES),
    and a launch on
    `device` to LAUNCHES_BY_CARD too. A segment's consumer thread
    launches repair sweeps while the main thread enqueues the next
    segment, so the read-modify-write holds a lock."""
    with _count_lock:
        counts[name] += n
        if device is not None and counts is LAUNCHES:
            card = LAUNCHES_BY_CARD.setdefault(str(device), {})
            card[name] = card.get(name, 0) + n


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA "
                           "kernels cannot be built")
    return found


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libtwk_torch-{h.hexdigest()[:16]}.so")


def _log_path(lib_path: str) -> str:
    return lib_path + ".ptxas.txt"


def _run(cmds):
    """Run the commands at once; (stdout + stderr) of each, raising if
    any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(c)}\n{out}")
    return outs


def _compile(path: str):
    global build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [f"{tmp}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
    try:
        outs = _run([[nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, s),
                      "-o", o] for s, o in zip(SOURCES, objs)])
        _run([[nvcc, *LINK_FLAGS, "-o", tmp, *objs]])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    build_log = "".join(outs)
    with open(f"{tmp}.log", "w") as fh:
        fh.write(build_log)
    os.replace(f"{tmp}.log", _log_path(path))
    os.replace(tmp, path)


def library():
    """The loaded kernel library, built first if needed."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            path = _lib_path()
            if not os.path.exists(path):
                _compile(path)
            elif os.path.exists(_log_path(path)):
                with open(_log_path(path)) as fh:
                    build_log = fh.read()
            lib = ctypes.CDLL(path)
            held = ctypes.PyDLL(path)
            for name, argtypes in _SIGNATURES.items():
                if name in HOLD_GIL:
                    setattr(lib, name, getattr(held, name))
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.twk_error_string.argtypes = [ctypes.c_int]
            lib.twk_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def loaded() -> bool:
    return _lib is not None


def check(code: int, what: str):
    if code != 0:
        msg = _lib.twk_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
