"""The benchmark's own reader of .two record files.

A .two file is "TWO\\x01" | u64 b_unc | u64 b_cmp | zstd(header), then
blocks of u8 marker=1 | u32 b_unc | u32 b_cmp | zstd(u32 n | u32 m | n
records of 106 bytes), and a footer that starts with u8 marker=0. The
record layout is the reference tool's (tomahawk lib/core.cpp:470-518).
Blocks are decompressed with the system libzstd through ctypes (a frozen
copy of the port's stand-in for the `zstandard` package, which the
card's host lacks), so nothing of the program reads its own output.
"""

import ctypes
import ctypes.util
import struct

import numpy as np

MAGIC = b"TWO\x01"
RECORD = np.dtype([
    ("controller", "<u2"),
    ("ridA", "<u4"), ("ridB", "<u4"),
    ("packA", "<u4"), ("packB", "<u4"),
    ("cnt", "<f8", (4,)),           # REFREF, ALTREF, REFALT, ALTALT
    ("D", "<f8"), ("Dprime", "<f8"), ("R", "<f8"), ("R2", "<f8"),
    ("P", "<f8"), ("ChiSqFisher", "<f8"), ("ChiSqModel", "<f8"),
])
assert RECORD.itemsize == 106

_lib = None


def _libzstd():
    global _lib
    if _lib is None:
        try:
            lib = ctypes.CDLL("libzstd.so.1")
        except OSError:
            name = ctypes.util.find_library("zstd")
            if name is None:
                raise OSError("no libzstd shared library") from None
            lib = ctypes.CDLL(name)
        sz, vp = ctypes.c_size_t, ctypes.c_void_p
        lib.ZSTD_decompress.restype = sz
        lib.ZSTD_decompress.argtypes = [vp, sz, vp, sz]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [sz]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getErrorName.argtypes = [sz]
        _lib = lib
    return _lib


def decompress(comp: bytes, size: int) -> np.ndarray:
    """One zstd frame of `size` bytes uncompressed, as uint8."""
    lib = _libzstd()
    src = np.frombuffer(comp, np.uint8)
    out = np.empty(max(size, 1), np.uint8)
    n = lib.ZSTD_decompress(out.ctypes.data, size, src.ctypes.data,
                            src.nbytes)
    if lib.ZSTD_isError(n) or n != size:
        msg = lib.ZSTD_getErrorName(n).decode() if lib.ZSTD_isError(n) \
            else f"{n} of {size} bytes"
        raise ValueError(f"bad zstd frame: {msg}")
    return out[:size]


def read_records(path: str) -> np.ndarray:
    """Every record of a .two file, in file order."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != MAGIC:
        raise ValueError(f"{path}: not a .two file")
    _, h_cmp = struct.unpack_from("<QQ", data, 4)
    off = 20 + h_cmp
    parts = []
    while True:
        marker = data[off]
        if marker == 0:
            break
        if marker != 1:
            raise ValueError(f"{path}: bad block marker at {off}")
        b_unc, b_cmp = struct.unpack_from("<II", data, off + 1)
        off += 9
        payload = decompress(data[off:off + b_cmp], b_unc)
        off += b_cmp
        n = int(payload[:4].view("<u4")[0])
        parts.append(payload[8:8 + n * RECORD.itemsize].view(RECORD))
    if not parts:
        return np.zeros(0, RECORD)
    return np.concatenate(parts)
