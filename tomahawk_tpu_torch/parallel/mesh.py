"""Device meshes of one process: the tile grid over ('pairs', 'samples').

Counterpart of tomahawk_tpu/parallel/mesh.py. The JAX package shards a
sweep over a jax Mesh with `shard_map`; here a `Mesh` is a plain [P, S]
array of torch devices, and the engine (compute/engine.py) drives its
shards itself:

- axis "pairs": a segment's tile list, padded to a multiple of 16 * P,
  splits into P contiguous slices; each pairs shard sweeps its slice on
  the devices of its row, into its own survivor buffer at its own
  running offset, and the host reads the shards' survivors in shard
  order, so the record stream is the one a single device gives;
- axis "samples": the packed-word axis of every plane splits into S
  slices, one a device of the row (`planes_to_device(...,
  word_slice=(s, S))`); per tile each device computes the local parts of
  its slice (`tile_local_parts`, K2) on its own card, `SamplesGroup`
  copies them to the row's first device and sums them there (the JAX
  sweep's `psum` over 'samples'), and the epilogue (X5) and the
  compaction (X1) run there.

A device may appear more than once: the tests build meshes of several
`cpu` entries, and a mesh over one card repeated runs the same code on
the card. A mesh whose 'samples' axis spans processes (`--mesh dcn`,
parallel/distributed.py `make_dcn_mesh`) carries the process group in
`group`; this process then holds one samples column of it.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import on_device


@dataclass
class Mesh:
    """A ('pairs', 'samples') grid of devices: `devices[p, s]` holds
    samples slice s of pairs shard p. `group` (a
    distributed.ProcessGroup) is set where the samples axis spans the
    processes of a run: column s then holds the devices of process s."""
    devices: np.ndarray
    group: Optional[object] = None

    @property
    def shape(self) -> dict:
        P, S = self.devices.shape
        return {"pairs": P, "samples": S}


def make_mesh(n_pairs: int = None, n_samples_shards: int = 1,
              devices=None) -> Mesh:
    """A ('pairs', 'samples') mesh over `devices` (a list of torch
    devices or device strings, repeats allowed; default every visible
    card), row-major: shard p's samples slices are devices[p * S:(p + 1)
    * S]. Raises ValueError when P x S is not the number of devices."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n_dev = len(devices)
    if n_pairs is None:
        n_pairs = n_dev // n_samples_shards
    if n_pairs < 1 or n_samples_shards < 1 \
            or n_pairs * n_samples_shards != n_dev:
        raise ValueError(f"{n_pairs} x {n_samples_shards} != {n_dev} "
                         f"devices")
    grid = np.empty((n_pairs, n_samples_shards), dtype=object)
    for k, d in enumerate(devices):
        grid[k // n_samples_shards, k % n_samples_shards] = d
    return Mesh(grid)


class SamplesGroup:
    """The samples axis of one pairs shard of a local mesh, as the sweeps
    see a process group (compute/sweeps.py `_tile`): the row's first
    device is this group's own rank, and `peers` holds every other
    slice's (device tensors, tile buffers). `all_reduce_parts` sums the
    peers' local parts onto the first device's, the JAX psum's place.

    A peer on another card is first copied into a staging tensor of its
    own on the first card, all the peers' copies in flight together, then
    the adds run on the first card. PyTorch's copy between cards runs on
    the peer card's current stream once the first card's stream has
    reached it, and the first card's stream waits for the copy: so the
    peer's next `local_parts`, queued behind the copy on the same stream,
    cannot overwrite the tile buffer the copy still reads, and the copy
    cannot overwrite a staging tensor an earlier add still reads. ATen
    enables peer access at a pair of cards' first copy where
    `torch.cuda.can_device_access_peer` allows it (the copy then goes
    over NVLink); a copy without it goes through the host.

    `timing`, a list (None by default, for every group of the process):
    each reduction on a card then appends three CUDA events recorded on
    the first card's stream: before the copies, after them (the peers'
    parts there), and after the adds."""

    timing = None

    def __init__(self, peers):
        self.peers = list(peers)
        self._staging = {}

    def all_reduce_parts(self, parts: torch.Tensor):
        marks = None
        if SamplesGroup.timing is not None and parts.is_cuda:
            stream = torch.cuda.current_stream(parts.device)
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            marks[0].record(stream)
        summands = []
        for k, (_, (_, peer)) in enumerate(self.peers):
            if peer.device != parts.device:
                stage = self._staging.get(k)
                if stage is None:
                    stage = self._staging[k] = torch.empty_like(parts)
                with on_device(parts.device):
                    stage.copy_(peer, non_blocking=True)
                peer = stage
            summands.append(peer)
        if marks:
            marks[1].record(stream)
        for peer in summands:
            parts.add_(peer)
        if marks:
            marks[2].record(stream)
            SamplesGroup.timing.append(marks)
