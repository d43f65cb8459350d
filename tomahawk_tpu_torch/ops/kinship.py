"""The kinship GEMM of `relationship` (X4): kin += gᵀ g over blocks of
variants.

The JAX package hands this to XLA (tomahawk_tpu/post/relationship.py:54-58,
a `dot_general` of an int8 [V, N] block in {-1, 0, +1} with itself over
the variant axis into an int32 [N, N] accumulator). It is a plain int8
GEMM outside any Pallas kernel, so on a card it is `torch._int_mm`
(cuBLAS's int8 tensor-core GEMM); on the CPU its plain version, the same
product of the same blocks, exact in f64 (a block's entries sum to at
most its row count) and added in int32. Both routes give the same
integers.

`torch._int_mm` takes a first operand of more than 16 rows and its other
dimensions in multiples of 8, and runs with the first operand row-major
and the second the transpose of a row-major matrix (the layout
chip_smoke.py's library yardstick uses): here gᵀ made contiguous, and
its transpose view. The samples axis is padded with zeros to
`padded_samples(N)` and a block's rows to a multiple of 8; the padding
adds nothing, and `to_host` slices it off.
"""

import numpy as np
import torch

from . import _build


def _round_up(n: int, q: int) -> int:
    return -(-n // q) * q


def padded_samples(n_samples: int) -> int:
    """The accumulator's side: N in a multiple of 8, above 16."""
    return max(24, _round_up(n_samples, 8))


def new_accumulator(n_samples: int, device) -> torch.Tensor:
    """A zero int32 [N', N'] kinship accumulator on `device`."""
    n = padded_samples(n_samples)
    return torch.zeros((n, n), dtype=torch.int32, device=device)


def block_to_device(block: np.ndarray, device) -> torch.Tensor:
    """An int8 [R, N] host block as an int8 [R', N'] tensor on `device`,
    zero-padded to `_int_mm`'s multiples."""
    rows, n = block.shape
    out = torch.zeros((_round_up(rows, 8), padded_samples(n)),
                      dtype=torch.int8)
    out[:rows, :n] = torch.from_numpy(block)
    return out.to(device)


def gram_accumulate(kin: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """kin += gᵀ g, in place, for an int8 block g [R', N'] and its int32
    accumulator kin [N', N'] on the same device: `torch._int_mm` on a
    card, the plain version on the CPU. Returns kin."""
    if g.is_cuda:
        gt = g.t().contiguous()
        _build.count(_build.LAUNCHES, _build.KINSHIP, device=g.device)
        kin += torch._int_mm(gt, gt.t())
        return kin
    if g.device.type != "cpu":
        raise ValueError(f"no kinship GEMM for device {g.device}")
    _build.count(_build.PLAIN_CALLS, _build.KINSHIP)
    return gram_plain(kin, g)


def gram_plain(kin: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain version of `gram_accumulate` (any device): the block's
    product in f64, exact, added to kin in int32."""
    gf = g.to(torch.float64)
    kin += (gf.t() @ gf).to(torch.int32)
    return kin


def to_host(kin: torch.Tensor, n_samples: int) -> np.ndarray:
    """The [N, N] int32 kinship counts on the host, padding dropped."""
    return kin[:n_samples, :n_samples].cpu().numpy()
