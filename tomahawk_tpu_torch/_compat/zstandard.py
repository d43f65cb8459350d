"""Stand-in for the `zstandard` package: the subset of its API that the
shared host code uses (`ZstdCompressor(level).compress`,
`ZstdDecompressor().decompress`, `ZstdError`), bound with ctypes to the
system libzstd.

tomahawk_tpu_torch puts this directory at the END of sys.path only
where the real package is missing, so the real one always wins.
Frames are standard zstd frames with the content size recorded,
readable by either implementation. ctypes releases the interpreter
lock around each call, so the thread pools in io/two.py still decode in
parallel."""

import ctypes
import ctypes.util

import numpy as np


class ZstdError(Exception):
    pass


_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2
_lib = None


def _libzstd():
    global _lib
    if _lib is None:
        try:
            lib = ctypes.CDLL("libzstd.so.1")
        except OSError:
            name = ctypes.util.find_library("zstd")
            if name is None:
                raise ZstdError("neither the zstandard package nor the "
                                "libzstd shared library is available")
            lib = ctypes.CDLL(name)
        sz, vp = ctypes.c_size_t, ctypes.c_void_p
        lib.ZSTD_compressBound.restype = sz
        lib.ZSTD_compressBound.argtypes = [sz]
        lib.ZSTD_compress.restype = sz
        lib.ZSTD_compress.argtypes = [vp, sz, vp, sz, ctypes.c_int]
        lib.ZSTD_decompress.restype = sz
        lib.ZSTD_decompress.argtypes = [vp, sz, vp, sz]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [vp, sz]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [sz]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getErrorName.argtypes = [sz]
        _lib = lib
    return _lib


def _check(lib, code: int) -> int:
    if lib.ZSTD_isError(code):
        raise ZstdError(lib.ZSTD_getErrorName(code).decode())
    return code


def _bytes_view(data) -> np.ndarray:
    """Any contiguous bytes-like object as a uint8 array (the pointer
    source; the caller keeps it alive across the native call)."""
    return np.frombuffer(data, np.uint8)


class ZstdCompressor:
    def __init__(self, level: int = 3):
        self.level = int(level)

    def compress(self, data) -> bytes:
        lib = _libzstd()
        src = _bytes_view(data)
        out = np.empty(lib.ZSTD_compressBound(src.nbytes), np.uint8)
        n = _check(lib, lib.ZSTD_compress(out.ctypes.data, out.nbytes,
                                          src.ctypes.data, src.nbytes,
                                          self.level))
        return out[:n].tobytes()


class ZstdDecompressor:
    def decompress(self, data, max_output_size: int = 0) -> bytes:
        lib = _libzstd()
        src = _bytes_view(data)
        size = lib.ZSTD_getFrameContentSize(src.ctypes.data, src.nbytes)
        if size == _CONTENTSIZE_ERROR:
            raise ZstdError("not a zstd frame")
        if size == _CONTENTSIZE_UNKNOWN:
            if max_output_size <= 0:
                raise ZstdError("frame does not record its content size "
                                "and no max_output_size was given")
            size = max_output_size
        out = np.empty(max(size, 1), np.uint8)
        n = _check(lib, lib.ZSTD_decompress(out.ctypes.data, size,
                                            src.ctypes.data, src.nbytes))
        return out[:n].tobytes()
