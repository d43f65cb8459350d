"""ctypes loader for the native C++ runtime kernels.

Builds libtwk_native_torch.so on first use (g++ -O3) into
build/tomahawk_tpu_torch/ beside the package. A build that fails raises;
the pure-numpy fallbacks of the consumers serve only hosts without g++.
"""

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "twk_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                          "tomahawk_tpu_torch")
_SO = os.path.join(_BUILD_DIR, "libtwk_native_torch.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    if shutil.which("g++") is None:
        return False
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
           "-o", tmp, _SRC, "-lz"]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"building {_SO} failed ({r.returncode}): "
                           f"{' '.join(cmd)}\n{r.stderr}")
    os.replace(tmp, _SO)
    return True


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or \
                os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.twk_parse_gt_line.restype = ctypes.c_int64
        lib.twk_parse_gt_line.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
        lib.twk_rle_decode.restype = ctypes.c_int64
        lib.twk_rle_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64]
        lib.twk_rle_encode.restype = ctypes.c_int64
        lib.twk_rle_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64]
        lib.twk_codes_to_planes.restype = None
        lib.twk_codes_to_planes.argtypes = [ctypes.c_void_p,
                                            ctypes.c_int64] + \
            [ctypes.c_void_p] * 5
        lib.twk_code_stats.restype = None
        lib.twk_code_stats.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_void_p]
        lib.twk_hwe_exact.restype = None
        lib.twk_hwe_exact.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_void_p]
        lib.twk_rle_assess.restype = ctypes.c_int32
        lib.twk_rle_assess.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int32]
        lib.twk_fisher_exact.restype = None
        lib.twk_fisher_exact.argtypes = [ctypes.c_void_p] * 4 + \
            [ctypes.c_int64, ctypes.c_void_p]
        lib.twk_encode_site.restype = ctypes.c_int64
        lib.twk_encode_site.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.twk_encode_codes.restype = ctypes.c_int64
        lib.twk_encode_codes.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64]
        lib.twk_bcf_gt.restype = ctypes.c_int32
        lib.twk_bcf_gt.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.twk_bcf_scan.restype = ctypes.c_int32
        lib.twk_bcf_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.twk_runs_to_planes.restype = ctypes.c_int64
        lib.twk_runs_to_planes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32] + [ctypes.c_void_p] * 5 + [ctypes.c_int64]
        lib.twk_import_chunk.restype = ctypes.c_int64
        lib.twk_import_chunk.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.twk_bcf_import_chunk.restype = ctypes.c_int64
        lib.twk_bcf_import_chunk.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.twk_radix_sort_idx.restype = ctypes.c_int64
        lib.twk_radix_sort_idx.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.twk_format_ld.restype = ctypes.c_int64
        lib.twk_format_ld.argtypes = (
            [ctypes.c_int64] + [ctypes.c_void_p] * 13 +
            [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p])
        lib.twk_pack_records.restype = ctypes.c_int64
        lib.twk_pack_records.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64]
        lib.twk_format_g6_matrix.restype = ctypes.c_int64
        lib.twk_format_g6_matrix.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64]
        lib.twk_format_decay.restype = ctypes.c_int64
        lib.twk_format_decay.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64]
        lib.twk_gather_rows.restype = ctypes.c_int64
        lib.twk_gather_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p]
        lib.twk_unphased_em.restype = ctypes.c_int64
        lib.twk_unphased_em.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.twk_ld_records.restype = ctypes.c_int64
        lib.twk_ld_records.argtypes = (
            [ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64] +
            [ctypes.c_void_p] * 15 + [ctypes.c_int32])
        lib.twk_ld_tile.restype = ctypes.c_int64
        lib.twk_ld_tile.argtypes = (
            [ctypes.c_int32] * 4 + [ctypes.c_int64] * 6 +
            [ctypes.c_void_p] * 26)
        lib.twk_inflate_new.restype = ctypes.c_void_p
        lib.twk_inflate_new.argtypes = []
        lib.twk_inflate_free.restype = None
        lib.twk_inflate_free.argtypes = [ctypes.c_void_p]
        lib.twk_inflate_feed.restype = ctypes.c_int32
        lib.twk_inflate_feed.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


class NativeGzipFile:
    """Read-only file object over a gzip/BGZF stream, inflated by the
    native streaming inflater (twk_inflate_feed). BGZF files are
    thousands of <=64 KB gzip members; CPython's gzip module re-frames
    each member in Python, which dominates BCF import at population
    scale -- here member hopping stays in C. Use `native_gzip_open`,
    which returns None when the native library is unavailable."""

    _IN_CHUNK = 1 << 20
    _OUT_CHUNK = 1 << 22

    def __init__(self, path: str):
        self._lib = get_lib()
        self._h = self._lib.twk_inflate_new()
        if not self._h:
            raise MemoryError("inflateInit failed")
        self._fh = open(path, "rb")
        self._in_buf = b""
        self._in_off = 0
        self._out = np.empty(self._OUT_CHUNK, np.uint8)
        self._chunk = b""
        self._coff = 0
        self._eof = False
        self._path = path

    def _refill(self):
        """Inflate the next decompressed chunk into self._view."""
        lib = self._lib
        produced_total = 0
        out = self._out
        while produced_total == 0:
            if self._in_off >= len(self._in_buf):
                data = self._fh.read(self._IN_CHUNK)
                if not data:
                    self._eof = True
                    return
                self._in_buf = data
                self._in_off = 0
            consumed = ctypes.c_int64(0)
            produced = ctypes.c_int64(0)
            src = np.frombuffer(self._in_buf, np.uint8)
            r = lib.twk_inflate_feed(
                self._h,
                ctypes.c_void_p(src.ctypes.data + self._in_off),
                len(self._in_buf) - self._in_off,
                out.ctypes.data_as(ctypes.c_void_p), len(out),
                ctypes.byref(consumed), ctypes.byref(produced))
            if r != 0:
                raise ValueError(f"{self._path}: corrupt gzip stream "
                                 f"(code {r})")
            self._in_off += consumed.value
            produced_total = produced.value
            if produced_total == 0 and consumed.value == 0:
                # no progress possible with a full input buffer means
                # a truncated/corrupt trailing member
                if self._in_off < len(self._in_buf):
                    raise ValueError(
                        f"{self._path}: corrupt gzip stream")
        self._chunk = out[:produced_total].tobytes()
        self._coff = 0

    def read(self, n: int = -1) -> bytes:
        parts = []
        want = n if n >= 0 else (1 << 62)
        while want > 0:
            avail = len(self._chunk) - self._coff
            if avail == 0:
                if self._eof:
                    break
                self._refill()
                continue
            take = min(want, avail)
            parts.append(self._chunk[self._coff:self._coff + take])
            self._coff += take
            want -= take
        if len(parts) == 1:
            return parts[0]
        return b"".join(parts)

    def readline(self) -> bytes:
        parts = []
        while True:
            nl = self._chunk.find(b"\n", self._coff)
            if nl >= 0:
                parts.append(self._chunk[self._coff:nl + 1])
                self._coff = nl + 1
                break
            if self._coff < len(self._chunk):
                parts.append(self._chunk[self._coff:])
                self._coff = len(self._chunk)
            if self._eof:
                break
            self._refill()
        if len(parts) == 1:
            return parts[0]
        return b"".join(parts)

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        line = self.readline()
        if not line:
            raise StopIteration
        return line

    def close(self):
        if self._h:
            self._lib.twk_inflate_free(self._h)
            self._h = None
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def native_gzip_open(path: str):
    """NativeGzipFile for `path`, or None when the native library is
    unavailable (callers fall back to gzip.open)."""
    if get_lib() is None:
        return None
    return NativeGzipFile(path)


def parse_gt_line(line: bytes, n_samples: int, gt_col: int = 9):
    """Returns (codes, phase) or None on parse failure."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.empty(n_samples, np.uint8)
    phase = np.empty(n_samples, np.uint8)
    r = lib.twk_parse_gt_line(
        line, len(line), gt_col, n_samples,
        codes.ctypes.data_as(ctypes.c_void_p),
        phase.ctypes.data_as(ctypes.c_void_p))
    if r != n_samples:
        return None
    return codes, phase


def rle_decode(words: np.ndarray, miss: bool, n_samples: int):
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(n_samples, np.uint8)
    w = np.ascontiguousarray(words)
    n = lib.twk_rle_decode(
        w.ctypes.data_as(ctypes.c_void_p), len(w), w.dtype.itemsize,
        int(miss), out.ctypes.data_as(ctypes.c_void_p), n_samples)
    if n != n_samples:
        return None
    return out


def rle_encode(codes: np.ndarray, width: int, miss: bool):
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    cap = 2 * len(codes) + 16
    dt = {1: np.uint8, 2: np.uint16, 4: np.uint32}[width]
    out = np.empty(cap, dt)
    n = lib.twk_rle_encode(
        codes.ctypes.data_as(ctypes.c_void_p), len(codes), width,
        int(miss), out.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        return None
    return out[:n].copy()


def runs_to_planes(runs: np.ndarray, miss: bool,
                   alt, mis, het, hom, val, n_samples: int):
    """Decode RLE runs straight into caller-provided plane rows (alt and
    mis zeroed except mis padding ones). Returns samples decoded, -1
    when a (corrupt) run overflows n_samples -- the write stops BEFORE
    touching memory past the plane rows -- or None if the lib is
    missing."""
    lib = get_lib()
    if lib is None:
        return None
    w = np.ascontiguousarray(runs)
    return lib.twk_runs_to_planes(
        w.ctypes.data_as(ctypes.c_void_p), len(w), w.dtype.itemsize,
        int(miss),
        alt.ctypes.data_as(ctypes.c_void_p),
        mis.ctypes.data_as(ctypes.c_void_p),
        het.ctypes.data_as(ctypes.c_void_p),
        hom.ctypes.data_as(ctypes.c_void_p),
        val.ctypes.data_as(ctypes.c_void_p), int(n_samples))


def codes_to_planes(codes: np.ndarray, alt, mis, het, hom, val):
    """Pack codes into caller-provided zeroed uint32 plane rows."""
    lib = get_lib()
    if lib is None:
        return False
    codes = np.ascontiguousarray(codes, np.uint8)
    lib.twk_codes_to_planes(
        codes.ctypes.data_as(ctypes.c_void_p), len(codes),
        alt.ctypes.data_as(ctypes.c_void_p),
        mis.ctypes.data_as(ctypes.c_void_p),
        het.ctypes.data_as(ctypes.c_void_p),
        hom.ctypes.data_as(ctypes.c_void_p),
        val.ctypes.data_as(ctypes.c_void_p))
    return True


class BcfScanner:
    """Reusable scratch around twk_bcf_scan (the BCF shared/indiv block
    walk). scan() returns the 8-int64 result array or None on fallback
    (unsupported layout or missing lib)."""

    def __init__(self, gt_key: int):
        self._lib = get_lib()
        self._gt_key = gt_key
        self.out = np.zeros(8, np.int64)
        self._optr = self.out.ctypes.data_as(ctypes.c_void_p)

    def scan(self, shared: bytes, indiv: bytes):
        if self._lib is None:
            return None
        r = self._lib.twk_bcf_scan(shared, len(shared), indiv,
                                   len(indiv), self._gt_key, self._optr)
        if r != 0:
            return None
        return self.out


def unphased_em(T: np.ndarray):
    """Batched unphased cubic-EM root solve on [K, 3, 3] int64 tables.
    Returns (f11, p, q, n, valid, multiple, chi_model) or None if the
    native lib is unavailable (ops/ld_math has the numpy fallback)."""
    lib = get_lib()
    if lib is None:
        return None
    T = np.ascontiguousarray(T, np.int64)
    K = len(T)
    f11 = np.empty(K, np.float64)
    p = np.empty(K, np.float64)
    q = np.empty(K, np.float64)
    n = np.empty(K, np.float64)
    valid = np.empty(K, np.uint8)
    multiple = np.empty(K, np.uint8)
    chi = np.empty(K, np.float64)
    lib.twk_unphased_em(
        T.ctypes.data_as(ctypes.c_void_p), K,
        f11.ctypes.data_as(ctypes.c_void_p),
        p.ctypes.data_as(ctypes.c_void_p),
        q.ctypes.data_as(ctypes.c_void_p),
        n.ctypes.data_as(ctypes.c_void_p),
        valid.ctypes.data_as(ctypes.c_void_p),
        multiple.ctypes.data_as(ctypes.c_void_p),
        chi.ctypes.data_as(ctypes.c_void_p))
    return f11, p, q, n, valid.astype(bool), multiple.astype(bool), chi


def ld_records(table: int, data: np.ndarray, meta, params: np.ndarray,
               out_fwd: np.ndarray, out_rev: np.ndarray,
               out_idx: np.ndarray, n_threads: int = 1, p_pre=None):
    """Fused survivor -> TWO-record batch (twk_ld_records): filter
    ladder + Fisher + flags + fwd/rev record assembly in one native
    call. `table` 0 = phased counts [K, 4], 1 = unphased tables
    [K, 9]; `meta` is a PairMeta-like object with 10 length-K arrays;
    `out_fwd`/`out_rev` are TWO_DTYPE arrays and `out_idx` int64, all
    length >= K. `p_pre` (f64 [K], optional): precomputed Fisher P per
    row (device bracket path); NaN rows fall back to the exact scan.
    Returns the kept-record count, or None if the native library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if len(data) == 0:
        return 0
    data = np.ascontiguousarray(data.reshape(len(data), -1), np.int64)
    ints = [np.ascontiguousarray(a, np.int64) for a in
            (meta.pos_a, meta.pos_b, meta.rid_a, meta.rid_b,
             meta.ac_a, meta.ac_b, meta.an_a, meta.an_b)]
    f64s = [np.ascontiguousarray(a, np.float64)
            for a in (meta.hwe_a, meta.hwe_b)]
    params = np.ascontiguousarray(params, np.float64)
    if p_pre is not None:
        p_pre = np.ascontiguousarray(p_pre, np.float64)
    vp = ctypes.c_void_p
    return lib.twk_ld_records(
        table, vp(data.ctypes.data), len(data),
        *(vp(a.ctypes.data) for a in ints),
        *(vp(a.ctypes.data) for a in f64s),
        vp(params.ctypes.data),
        vp(p_pre.ctypes.data) if p_pre is not None else vp(None),
        vp(out_fwd.ctypes.data),
        vp(out_rev.ctypes.data), vp(out_idx.ctypes.data),
        int(n_threads))


_TILE_META = ("pos", "rid", "ac", "an", "n_het", "n_hom", "hwe", "valid")


def ld_tile(table: int, has_missing: bool, cls: int, diag: bool,
            window: int, n_samples: int, B: int, W: int,
            r0: int, r1: int, planes_i, planes_j, meta_i, meta_j,
            params: np.ndarray, out_fwd: np.ndarray,
            out_rev: np.ndarray):
    """One [r0, r1) row chunk of a native CPU block-pair LD tile
    (twk_ld_tile): candidate gating, popcount contingency counts, and
    the full filter-ladder record assembly in one call. planes_* are
    tuples of up to 3 contiguous uint32 [B, W] arrays (None for unused
    slots: phased = (alt, miss), unphased = (het, hom, valid));
    meta_* are dicts with pos/rid/ac/an/n_het/n_hom as int64 [B], hwe
    float64 [B], valid uint8 [B]. out_fwd/out_rev must hold one
    TWO_DTYPE record per candidate pair of the chunk. Returns
    (n_records, n_candidates) or None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    vp = ctypes.c_void_p

    def pp(a):
        return vp(0) if a is None else vp(a.ctypes.data)

    ncand = np.zeros(1, np.int64)
    args = ([int(table), int(has_missing), int(cls), int(diag),
             int(window), int(n_samples), int(B), int(W),
             int(r0), int(r1)]
            + [pp(a) for a in planes_i] + [pp(a) for a in planes_j]
            + [vp(meta_i[k].ctypes.data) for k in _TILE_META]
            + [vp(meta_j[k].ctypes.data) for k in _TILE_META]
            + [vp(params.ctypes.data), vp(out_fwd.ctypes.data),
               vp(out_rev.ctypes.data), vp(ncand.ctypes.data)])
    n = lib.twk_ld_tile(*args)
    return int(n), int(ncand[0])


def hwe_exact(n_het: np.ndarray, n_hom1: np.ndarray, n_hom2: np.ndarray):
    """Exact HWE p-values, or None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n_het = np.ascontiguousarray(n_het, np.int64)
    n_hom1 = np.ascontiguousarray(n_hom1, np.int64)
    n_hom2 = np.ascontiguousarray(n_hom2, np.int64)
    out = np.empty(len(n_het), np.float64)
    lib.twk_hwe_exact(n_het.ctypes.data_as(ctypes.c_void_p),
                      n_hom1.ctypes.data_as(ctypes.c_void_p),
                      n_hom2.ctypes.data_as(ctypes.c_void_p),
                      len(n_het), out.ctypes.data_as(ctypes.c_void_p))
    return out


_RLE_DT = {1: np.uint8, 2: np.uint16, 4: np.uint32}


class SiteEncoder:
    """Reusable scratch buffers around twk_encode_site (the fused
    parse + stats + RLE step). encode() returns
    (codes, stats[8], width, phase_state, miss, runs) or an int error
    (-1 bad count, -2 non-diploid), or None if the lib is missing."""

    def __init__(self, n_samples: int):
        self.n = n_samples
        self.codes = np.empty(n_samples, np.uint8)
        self.phase = np.empty(n_samples, np.uint8)
        self.stats = np.zeros(8, np.int64)
        self.meta = np.zeros(3, np.int32)
        self.cap = 2 * n_samples + 16
        self.runs = np.empty(self.cap, np.uint32)
        self._lib = get_lib()
        self._ptrs = tuple(a.ctypes.data_as(ctypes.c_void_p) for a in
                           (self.codes, self.phase, self.stats,
                            self.meta, self.runs))

    def encode(self, blob: bytes):
        if self._lib is None:
            return None
        n = self._lib.twk_encode_site(blob, len(blob), self.n,
                                      *self._ptrs, self.cap)
        if n < 0:
            return int(n)
        width = int(self.meta[0])
        runs = self.runs.view(_RLE_DT[width])[:n].copy()
        return (self.codes, self.stats, width, int(self.meta[1]),
                bool(self.meta[2]), runs)

    def encode_codes(self, codes: np.ndarray = None,
                     phase: np.ndarray = None):
        """Fused stats + RLE for pre-parsed codes (BCF path). With no
        arguments, encodes the scratch buffers in place (as filled by
        bcf_gt)."""
        if self._lib is None:
            return None
        if codes is None:
            cptr, pptr = self._ptrs[0], self._ptrs[1]
            codes = self.codes
        else:
            codes = np.ascontiguousarray(codes, np.uint8)
            phase = np.ascontiguousarray(phase, np.uint8)
            cptr = codes.ctypes.data_as(ctypes.c_void_p)
            pptr = phase.ctypes.data_as(ctypes.c_void_p)
        n = self._lib.twk_encode_codes(cptr, pptr, self.n,
                                       *self._ptrs[2:], self.cap)
        if n < 0:
            return int(n)
        width = int(self.meta[0])
        runs = self.runs.view(_RLE_DT[width])[:n].copy()
        return (codes, self.stats, width, int(self.meta[1]),
                bool(self.meta[2]), runs)

    def bcf_gt(self, vals: np.ndarray, width: int) -> bool:
        """Convert BCF GT int pairs [n_samples, 2] straight into the
        scratch codes/phase buffers. False on non-diploid rows or when
        the lib is missing."""
        if self._lib is None:
            return False
        vals = np.ascontiguousarray(vals)
        r = self._lib.twk_bcf_gt(vals.ctypes.data_as(ctypes.c_void_p),
                                 width, self.n, self._ptrs[0],
                                 self._ptrs[1])
        return r == 0


def fisher_exact(n11, n12, n21, n22):
    """Two-sided Fisher exact p-values, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arrs = [np.ascontiguousarray(x, np.int64) for x in (n11, n12, n21, n22)]
    out = np.empty(len(arrs[0]), np.float64)
    lib.twk_fisher_exact(*(a.ctypes.data_as(ctypes.c_void_p) for a in arrs),
                         len(arrs[0]), out.ctypes.data_as(ctypes.c_void_p))
    return out


def rle_assess(codes: np.ndarray, miss: bool):
    """Cheapest RLE word width (1/2/4), or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    return int(lib.twk_rle_assess(
        codes.ctypes.data_as(ctypes.c_void_p), len(codes), int(miss)))


def code_stats(codes: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    out = np.zeros(8, np.int64)
    lib.twk_code_stats(codes.ctypes.data_as(ctypes.c_void_p),
                       len(codes), out.ctypes.data_as(ctypes.c_void_p))
    return out


def format_ld(recs: np.ndarray, contig_names, json: bool = False):
    """Format a block of .two records as LD text (or JSON arrays), one
    row per record, matching the reference's PrintLD/PrintLDJson
    columns (reference: lib/core.cpp:520-532). `contig_names` is a
    sequence indexed by rid. Returns bytes, or None if the native
    library is unavailable (callers fall back to Python formatting)."""
    lib = get_lib()
    if lib is None or len(recs) == 0:
        return b"" if len(recs) == 0 and lib is not None else None
    n = len(recs)
    controller = np.ascontiguousarray(recs["controller"], np.uint16)
    ridA = np.ascontiguousarray(recs["ridA"], np.uint32)
    ridB = np.ascontiguousarray(recs["ridB"], np.uint32)
    posA = np.ascontiguousarray((recs["packA"] >> 2) + 1, np.uint32)
    posB = np.ascontiguousarray((recs["packB"] >> 2) + 1, np.uint32)
    cnt = np.ascontiguousarray(recs["cnt"], np.float64)
    cols = [np.ascontiguousarray(recs[f], np.float64)
            for f in ("D", "Dprime", "R", "R2", "P", "ChiSqFisher",
                      "ChiSqModel")]
    blobs = [str(c).encode() for c in contig_names]
    names = b"".join(blobs)
    name_off = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=name_off[1:])
    rows_done = ctypes.c_int64(0)
    max_name = max((len(b) for b in blobs), default=0)
    parts = []
    start = 0
    per_row = 440 + 2 * max_name
    vp = ctypes.c_void_p
    while start < n:
        chunk = min(n - start, 65536)
        cap = chunk * per_row
        # np.empty, not create_string_buffer: the latter zero-fills
        # ~4 MB per block, which showed up as 25% of view wall time
        buf = np.empty(cap, np.uint8)
        sl = slice(start, start + chunk)
        nb = lib.twk_format_ld(
            chunk, vp(controller[sl].ctypes.data),
            vp(ridA[sl].ctypes.data), vp(ridB[sl].ctypes.data),
            vp(posA[sl].ctypes.data), vp(posB[sl].ctypes.data),
            vp(cnt[sl].ctypes.data),
            *(vp(c[sl].ctypes.data) for c in cols),
            names, vp(name_off.ctypes.data), len(blobs),
            int(json), vp(buf.ctypes.data), cap,
            vp(ctypes.addressof(rows_done)))
        done = rows_done.value
        if done <= 0:
            # a pathological row (e.g. out-of-range rid rendered as an
            # integer) outgrew the estimate: widen and retry rather
            # than dropping output
            per_row *= 2
            continue
        parts.append(buf[:nb].tobytes())
        start += done
    return b"".join(parts)


def radix_sort_idx(k1: np.ndarray, k2: np.ndarray):
    """Permutation that sorts by (k1, k2) ascending — adaptive LSD radix
    (constant byte planes skipped). Returns None if the native library
    is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(k1)
    k1 = np.ascontiguousarray(k1, np.uint64)
    k2 = np.ascontiguousarray(k2, np.uint32)
    idx = np.empty(n, np.int64)
    tmp = np.empty(n, np.int64)
    lib.twk_radix_sort_idx(
        k1.ctypes.data_as(ctypes.c_void_p),
        k2.ctypes.data_as(ctypes.c_void_p), n,
        idx.ctypes.data_as(ctypes.c_void_p),
        tmp.ctypes.data_as(ctypes.c_void_p))
    return idx


def pack_records(meta: np.ndarray, rows: np.ndarray, rids: np.ndarray,
                 hwe: np.ndarray, runs_buf: np.ndarray) -> bytes:
    """Serialize kept import sites (meta rows selected by `rows`, with
    per-row rid and HWE p-value) into .twk record bytes in one native
    call (twk_pack_records). Returns None if the native library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    rids = np.ascontiguousarray(rids, np.int64)
    hwe = np.ascontiguousarray(hwe, np.float64)
    cap = int(38 * len(rows)
              + (meta[rows, 9] * meta[rows, 6]).sum())
    out = np.empty(max(cap, 1), np.uint8)
    n = lib.twk_pack_records(
        meta.ctypes.data_as(ctypes.c_void_p),
        rows.ctypes.data_as(ctypes.c_void_p), len(rows),
        rids.ctypes.data_as(ctypes.c_void_p),
        hwe.ctypes.data_as(ctypes.c_void_p),
        runs_buf.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p), cap)
    if n != cap:
        raise RuntimeError(f"pack_records size mismatch: {n} != {cap}")
    return out[:cap].tobytes()


def format_g6_matrix(mat: np.ndarray) -> str:
    """%.6g tab-separated text of a 2-D f64 matrix, one line per row
    (twk_format_g6_matrix). Returns None if the native library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    mat = np.ascontiguousarray(mat, np.float64)
    R, C = mat.shape
    cap = R * C * 16 + R + 64
    while True:
        out = np.empty(cap, np.uint8)
        nb = lib.twk_format_g6_matrix(
            mat.ctypes.data_as(ctypes.c_void_p), R, C,
            out.ctypes.data_as(ctypes.c_void_p), cap)
        if nb >= 0:
            return out[:nb].tobytes().decode()
        cap *= 2


def format_decay_rows(rid: np.ndarray, pos: np.ndarray, n: np.ndarray,
                      mean: np.ndarray) -> str:
    """positional-decay text rows "rid\tpos\tn\tmean" with %.6f means
    (twk_format_decay). Returns None if the native library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    rid = np.ascontiguousarray(rid, np.int64)
    pos = np.ascontiguousarray(pos, np.int64)
    n = np.ascontiguousarray(n, np.int64)
    mean = np.ascontiguousarray(mean, np.float64)
    cap = len(rid) * 96 + 64
    out = np.empty(cap, np.uint8)
    nb = lib.twk_format_decay(
        rid.ctypes.data_as(ctypes.c_void_p),
        pos.ctypes.data_as(ctypes.c_void_p),
        n.ctypes.data_as(ctypes.c_void_p),
        mean.ctypes.data_as(ctypes.c_void_p), len(rid),
        out.ctypes.data_as(ctypes.c_void_p), cap)
    if nb < 0:
        return None
    return out[:nb].tobytes().decode()


def gather_rows(arr: np.ndarray, idx: np.ndarray, out=None):
    """out[k] = arr[idx[k]] for a contiguous 1-D (possibly structured)
    array — one memcpy per row instead of numpy's per-field walk.
    Pass a reusable `out` (same dtype, len >= len(idx)) to avoid fresh
    page-faulting allocations on hot paths; the filled prefix view is
    returned. Returns None if the native library is unavailable."""
    lib = get_lib()
    if lib is None or not arr.flags.c_contiguous:
        return None
    idx = np.ascontiguousarray(idx, np.int64)
    if out is None:
        out = np.empty(len(idx), arr.dtype)
    else:
        assert out.dtype == arr.dtype and len(out) >= len(idx) \
            and out.flags.c_contiguous
        out = out[:len(idx)]
    lib.twk_gather_rows(
        arr.ctypes.data_as(ctypes.c_void_p), arr.dtype.itemsize,
        idx.ctypes.data_as(ctypes.c_void_p), len(idx),
        out.ctypes.data_as(ctypes.c_void_p))
    return out


META_N = 19   # int64 fields per site in twk_import_chunk's meta table


class ChunkImporter:
    """Reusable buffers around twk_import_chunk (bulk VCF-body parse +
    stats + RLE for every complete line of a chunk in ONE native
    call)."""

    def __init__(self, n_samples: int, max_sites: int = 4096):
        self.n = n_samples
        self.max_sites = max_sites
        self.meta = np.zeros((max_sites, META_N), np.int64)
        # worst case per site is (2N+16)*4 bytes of runs; size for the
        # TYPICAL case (~N bytes) and let the native side stop early
        # when a pathological chunk would overflow
        self.runs = np.zeros(
            min(max(max_sites * max(2 * n_samples, 1024),
                    (2 * n_samples + 16) * 4 * 8), 1 << 27), np.uint8)
        self.codes = np.empty(n_samples, np.uint8)
        self.phase = np.empty(n_samples, np.uint8)
        self._consumed = ctypes.c_int64(0)
        self._lib = get_lib()

    def parse(self, chunk: bytes):
        """Returns (n_sites, meta_view, runs_buffer, consumed_bytes),
        or None when the native library is unavailable."""
        if self._lib is None:
            return None
        vp = ctypes.c_void_p
        n = self._lib.twk_import_chunk(
            chunk, len(chunk), self.n, self.max_sites,
            vp(self.meta.ctypes.data), vp(self.runs.ctypes.data),
            len(self.runs), vp(self.codes.ctypes.data),
            vp(self.phase.ctypes.data),
            vp(ctypes.addressof(self._consumed)))
        return n, self.meta, self.runs, self._consumed.value

    def parse_bcf(self, chunk: bytes, gt_key: int):
        """BCF-record twin of parse() (twk_bcf_import_chunk)."""
        if self._lib is None:
            return None
        vp = ctypes.c_void_p
        n = self._lib.twk_bcf_import_chunk(
            chunk, len(chunk), self.n, gt_key, self.max_sites,
            vp(self.meta.ctypes.data), vp(self.runs.ctypes.data),
            len(self.runs), vp(self.codes.ctypes.data),
            vp(self.phase.ctypes.data),
            vp(ctypes.addressof(self._consumed)))
        return n, self.meta, self.runs, self._consumed.value
