"""tomahawk_tpu_torch: the PyTorch + CUDA port of tomahawk_tpu.

This package runs `calc` all-vs-all -- phased (`-p`), unphased (`-u`)
and the default mixed dispatch, with or without missing genotypes -- on
one NVIDIA H100, through three hand-written CUDA kernels
(`csrc/phased_tile.cu`, `csrc/parts_tile.cu`, `csrc/compact.cu`). The JAX package
`tomahawk_tpu` stays the reference; its host code (file formats,
balancer, exact f64 statistics, native record assembly) is shared by
import and never touches jax. This package imports torch and never
jax.

The shared host code compresses `.twk`/`.two` sections through the
`zstandard` module. Where that package is not installed, a ctypes
binding of the system libzstd (`_compat/zstandard.py`) stands in for
it, so the port reads and writes the same files either way. Its
directory goes on sys.path rather than into sys.modules because the
importer's worker processes are spawned: they inherit sys.path, not
modules.
"""

import os
import sys

try:
    import zstandard  # noqa: F401
except ImportError:
    sys.path.append(os.path.join(os.path.dirname(__file__), "_compat"))

__version__ = "0.1.0"

PROGRAM_NAME = "tomahawk_tpu_torch"
