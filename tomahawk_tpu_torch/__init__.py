"""tomahawk_tpu_torch: the PyTorch + CUDA port of tomahawk_tpu.

This package runs `import` on the host; `calc` -- all-vs-all or
windowed (`-w`); phased (`-p`), unphased (`-u`) and the default mixed
dispatch, with or without missing genotypes; banded above `-M`;
checkpointed (`--checkpoint`); in several processes (`--distributed`,
with or without `--mesh dcn`) -- and `scalc` on NVIDIA H100s, through
the hand-written CUDA kernels under `csrc/` (`ops/_build.KERNELS`); and
the post-processing subcommands `view`, `sort`, `concat`, `aggregate`,
`stats`, `decay`, `haplotype` on the host and `relationship`, whose
kinship GEMM is `torch._int_mm` on a card (`ops/kinship.py`). The JAX
package `tomahawk_tpu` is the reference the port is held against and is
never imported here: the host layer (`utils/`, `io/`, `native/`,
`ops/bitpack|fisher|hwe|ld_math`, `compute/balancer|cpu_engine|scalc`,
`post/`) is this package's own copy, under the same module names. This
package imports torch and never jax.

The host code compresses `.twk`/`.two` sections through the
`zstandard` module. Where that package is not installed, a ctypes
binding of the system libzstd (`_compat/zstandard.py`) stands in for
it, so the port reads and writes the same files either way. Its
directory goes on sys.path rather than into sys.modules because the
importer's worker processes are spawned: they inherit sys.path, not
modules, and unpickle their tasks by module name, so they import this
package's modules again and with them this stand-in.
"""

import os
import sys

try:
    import zstandard  # noqa: F401
except ImportError:
    sys.path.append(os.path.join(os.path.dirname(__file__), "_compat"))

__version__ = "0.1.0"

PROGRAM_NAME = "tomahawk_tpu_torch"
