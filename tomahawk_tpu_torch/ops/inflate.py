"""Calc's archive inflation: each super-block's .twk blocks read as
compressed frames, then decompressed and decoded in one native call
straight into the load's stacked planes.

`read_super` reads a super-block's blocks (frame header checked, bytes
read) on the caller's thread; `new_planes` allocates a load's arrays,
the `[NB, B, W]` / `[NB, B]` arrays that `bitpack.stack_planes` gives;
`decode_super` decompresses a super-block's payloads and fills its slot
of them through `twk_inflate_super` (inflate.cpp). zstd and ctypes both
release the interpreter lock, so a pool of threads inflates super-blocks
in parallel. The result is bit for bit `stack_planes([block_to_planes(
merged block, n_samples, pad_to=B), ...])`.

The library builds on first use (g++ -O3 -march=native) into
build/tomahawk_tpu_torch/ beside the package; a build that fails raises.
On a host without g++ `decode_super` takes the per-record path
(`Twk1Block.deserialize`, `bitpack.block_to_planes`) and counts its
records as `fallback`.
"""

import ctypes
import os
import shutil
import struct
import subprocess
import threading
from collections import namedtuple

import numpy as np
import zstandard

from ..io.errors import CorruptFileError, decompress_checked, read_exact
from ..io.twk import Twk1Block
from . import bitpack

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "inflate.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                          "tomahawk_tpu_torch")
_SO = os.path.join(_BUILD_DIR, "libtwk_inflate.so")
_lock = threading.Lock()
_lib = None
_tried = False

#: the planes and rows of a load, in the order inflate.cpp takes them
PLANES = ("alt_bits", "miss_bits", "het_bits", "hom_bits", "valid_bits")
ROWS = ("pos", "rid", "ac", "an", "n_het", "n_hom", "hwe", "has_missing",
        "valid")
_DTYPES = {**dict.fromkeys(PLANES, np.uint32),
           **dict.fromkeys(ROWS, np.int32), "hwe": np.float32,
           "has_missing": np.bool_, "valid": np.bool_}

#: a super-block's blocks: the archive's path, each block's zstd frame,
#: its payload's size and the frame's byte offset in the archive
Frames = namedtuple("Frames", "path frames sizes offsets")


def _build() -> bool:
    if shutil.which("g++") is None:
        return False
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp,
           _SRC]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"building {_SO} failed ({r.returncode}): "
                           f"{' '.join(cmd)}\n{r.stderr}")
    os.replace(tmp, _SO)
    return True


def get_lib():
    """The loaded decoder library, or None on a host without g++."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        if not os.path.exists(_SO) or \
                os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _build():
                _tried = True
                return None
        lib = ctypes.CDLL(_SO)
        lib.twk_inflate_super.restype = ctypes.c_int64
        lib.twk_inflate_super.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        _lib, _tried = lib, True
        return _lib


def read_super(reader, ids) -> Frames:
    """The compressed blocks `ids` of a `TwkReader`: each block's 9-byte
    header checked and its frame read, as `TwkReader.read_block` does
    before it decompresses."""
    frames, sizes, offsets = [], [], []
    fh, path = reader._fh, reader.path
    for i in ids:
        ent = reader.index.ent[i]
        fh.seek(ent.foff)
        marker, b_unc, b_cmp = struct.unpack(
            "<BII", read_exact(fh, 9, path, "block header"))
        if marker != 1:
            raise CorruptFileError(path, "corrupt block marker", ent.foff)
        frames.append(read_exact(fh, b_cmp, path, "block"))
        sizes.append(b_unc)
        offsets.append(ent.foff + 9)
    return Frames(path, frames, sizes, offsets)


def _slot_shapes(B: int, n_samples: int) -> dict:
    """The shape of one super-block's slot of each array."""
    Wh, Ws = bitpack.words_for(2 * n_samples), bitpack.words_for(n_samples)
    return dict({k: (B, Ws) for k in PLANES}, alt_bits=(B, Wh),
                miss_bits=(B, Wh), **{k: (B,) for k in ROWS})


def new_planes(n_supers: int, B: int, n_samples: int) -> dict:
    """Uninitialised arrays for `n_supers` super-blocks of B rows, under
    `stack_planes`' keys and dtypes; `decode_super` writes all of a
    slot."""
    out = {k: np.empty((n_supers,) + shape, _DTYPES[k])
           for k, shape in _slot_shapes(B, n_samples).items()}
    out["n_rec"] = np.empty(n_supers, np.int32)
    return out


def decode_super(sup: Frames, n_samples: int, out: dict, k: int) -> dict:
    """Slot `k` of `out` (`new_planes`) from super-block `sup`: its
    records in block order, then padding rows. Returns the counts
    {records, runs, fallback}: `fallback` the records decoded by the
    per-record path (no library)."""
    B = out["valid"].shape[1]
    dctx = zstandard.ZstdDecompressor()   # one a call: not thread-safe
    blobs = [decompress_checked(dctx, f, size, sup.path, "block", at)
             for f, size, at in zip(sup.frames, sup.sizes, sup.offsets)]
    lib = get_lib()
    if lib is None:
        return _decode_per_record(blobs, sup, n_samples, out, k, B)
    shapes = _slot_shapes(B, n_samples)
    rows = [out[key][k] for key in PLANES + ROWS]
    for key, r in zip(PLANES + ROWS, rows):
        if r.dtype != _DTYPES[key] or r.shape != shapes[key] or \
                not r.flags.c_contiguous:
            raise ValueError(f"{key}: a slot of {r.shape} {r.dtype}, not "
                             f"C-contiguous {shapes[key]} {_DTYPES[key]}")
    Wh, Ws = shapes["alt_bits"][1], shapes["het_bits"][1]
    n = len(blobs)
    ptrs = (ctypes.c_void_p * len(rows))(*(r.ctypes.data for r in rows))
    info = (ctypes.c_int64 * 7)()
    got = lib.twk_inflate_super((ctypes.c_char_p * n)(*blobs),
                                (ctypes.c_int64 * n)(*map(len, blobs)), n,
                                n_samples, B, Wh, Ws, ptrs, info)
    if got < 0:
        _raise(got, info, sup, n_samples, B)
    out["n_rec"][k] = got
    return dict(records=got, runs=info[1], fallback=0)


def _raise(code, info, sup, n_samples, B):
    """A CorruptFileError for inflate.cpp's error codes."""
    _, _, p, rec, detail, rid, pos = info
    at = sup.offsets[p]
    if code == -1:
        raise CorruptFileError(sup.path, f"corrupt block payload: record "
                               f"{rec} truncated", at)
    if code == -2:
        raise CorruptFileError(sup.path, f"corrupt block payload: RLE word "
                               f"width {detail} at record {rec}", at)
    if code in (-3, -4):
        raise CorruptFileError(
            sup.path, f"corrupt RLE genotypes at rid {rid} pos {pos}: runs "
            f"decode to {detail} of {n_samples} samples", at)
    if code == -5:
        raise CorruptFileError(sup.path, f"corrupt block payload: the "
                               f"super-block holds more than {B} records",
                               at)
    raise ValueError(f"twk_inflate_super refused the planes' shapes "
                     f"({code})")


def _decode_per_record(blobs, sup, n_samples, out, k, B):
    """The per-record path: records parsed in Python, planes by
    `bitpack.block_to_planes`."""
    blk = None
    for blob, at in zip(blobs, sup.offsets):
        try:
            part = Twk1Block.deserialize(blob)
        except (EOFError, struct.error, KeyError) as e:
            raise CorruptFileError(sup.path, f"corrupt block payload: {e}",
                                   at) from None
        if blk is None:
            blk = part
        else:
            for rec in part.rcds:
                blk.add(rec)
    blk = blk or Twk1Block()
    if blk.n > B:
        raise CorruptFileError(sup.path, f"corrupt block payload: the "
                               f"super-block holds more than {B} records",
                               sup.offsets[0])
    planes = bitpack.block_to_planes(blk, n_samples, pad_to=B)
    for key in PLANES + ROWS:
        out[key][k] = getattr(planes, key)
    out["n_rec"][k] = blk.n
    return dict(records=blk.n, runs=sum(r.n_runs for r in blk.rcds),
                fallback=blk.n)
