"""Multi-process orchestration for distributed `calc` runs.

Counterpart of tomahawk_tpu/parallel/distributed.py over
`torch.distributed`. The JAX package drives several devices from one
process (`shard_map` over a ('pairs', 'samples') mesh); here the unit is
one process with one explicit device, and the processes of a run form
one `torch.distributed` group:

    JAX run mode                       this package
    --distributed, mesh auto/off       the same: rank k of N takes
      (tile partition)                 pairs[k::N] (`partition_tiles`),
                                       loads only the super-blocks it
                                       touches, writes out.pKofN.two,
                                       joins the barrier (`sync_shards`);
                                       `merge_shards` folds the shards
    --distributed --mesh dcn           the samples group is all N ranks:
      (the packed-word axis spans      rank s uploads words [s*W/N,
      the processes)                   (s+1)*W/N) of every word plane;
                                       per tile: local parts, then
                                       `all_reduce_parts` (SUM), then the
                                       epilogue and the compaction on
                                       global counts; rank 0 alone writes
    --checkpoint                       the same: a tile-partition rank
                                       keeps PATH.pKofN; in a dcn run
                                       rank 0's sidecar is broadcast
                                       (`broadcast_resume`: a fixed head,
                                       then the load boundaries), and
                                       every rank passes
                                       `resume_barrier` once its sidecar
                                       is checked
    --mesh PxS or dcn:P, and           not ported: the engine raises
      P x S rank grids                 NotImplementedError

Device of a rank (`rank_device`): `cuda` means `cuda:{rank %
torch.cuda.device_count()}`, `cpu` the CPU. The backends are decided
once, at the rendezvous, from that layout and never by catching a
failure: when every rank sits on a CUDA device of its own, device
tensors reduce over NCCL and host barriers go through gloo; when ranks
share a device, or run on the CPU, gloo serves both, and a CUDA tensor
is then reduced through one pinned host buffer (gloo's own CUDA path
stages through the host as well, and not every build has it). A
collective that fails raises in every rank; there is no fallback.

Entry: `python -m tomahawk_tpu_torch calc --distributed --coordinator
host:port --num-processes N --process-id K [--mesh dcn]`.
"""

import datetime
import glob
import socket
from dataclasses import dataclass
from typing import Optional

import torch

from ..utils.logging import log

#: seconds a rank waits in the rendezvous or in a collective before it
#: raises (a rank that died leaves the others waiting)
TIMEOUT_S = 600


@dataclass
class ProcessGroup:
    """The process group of one run. `device_group` carries the device
    tensors' collectives (NCCL, or gloo where ranks share a device or
    run on the CPU), `host_group` the barriers (always gloo)."""
    rank: int
    size: int
    device: torch.device
    device_backend: str            # "nccl" or "gloo"
    device_group: object
    host_group: object
    # gloo with CUDA tensors: the pinned host buffer all_reduce_parts
    # stages through, allocated at the first reduction and grown on demand
    _staging: Optional[torch.Tensor] = None


_group: Optional[ProcessGroup] = None


def rank_device(device, rank: int) -> torch.device:
    """The device of one rank: an explicit index stands; plain `cuda`
    spreads the ranks over the visible cards, rank % count."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("device 'cuda' requested but torch sees no "
                               "CUDA device")
        dev = torch.device("cuda", rank % n)
    return dev


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device) -> tuple:
    """Rendezvous at tcp://`coordinator`; returns (process_id,
    n_processes). `device` is this rank's resolved device
    (`rank_device`). The group is kept for `group()` until
    `shutdown()`."""
    global _group
    import torch.distributed as dist
    if _group is not None:
        raise RuntimeError("the process group is already initialised")
    if not coordinator or num_processes < 1 \
            or not 0 <= process_id < num_processes:
        raise ValueError(
            "--distributed needs --coordinator host:port, --num-processes N "
            f"and --process-id K in [0, N): got {coordinator!r}, "
            f"{num_processes}, {process_id}")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    host_group = dist.group.WORLD
    # the layout: which (host, device) every rank sits on
    mine = (socket.gethostname(), str(device))
    layout = [None] * num_processes
    dist.all_gather_object(layout, mine, group=host_group)
    own_card = (all(d.startswith("cuda") for _, d in layout)
                and len(set(layout)) == num_processes)
    if own_card and num_processes > 1:
        backend = "nccl"
        device_group = dist.new_group(
            backend="nccl", timeout=datetime.timedelta(seconds=TIMEOUT_S))
    else:
        backend = "gloo"
        device_group = host_group
    _group = ProcessGroup(process_id, num_processes, device, backend,
                          device_group, host_group)
    shared = "" if own_card or device.type == "cpu" else \
        "; ranks share a card, CUDA tensors reduce through pinned host memory"
    log("LOG", f"Distributed: process {process_id}/{num_processes} on "
        f"{device}; device collectives over {backend}, host barriers over "
        f"gloo{shared}", sub="DIST")
    return process_id, num_processes


def group() -> ProcessGroup:
    """The group `init_distributed` made."""
    if _group is None:
        raise RuntimeError("no process group: call init_distributed first")
    return _group


def shutdown():
    """Destroy the process group (every rank calls it, after the last
    collective)."""
    global _group
    import torch.distributed as dist
    if _group is not None:
        _group = None
        dist.destroy_process_group()


def all_reduce_parts(parts: torch.Tensor, grp: ProcessGroup):
    """Sum `parts` (the i32 [P, B, B] local contractions of one tile)
    over the ranks of `grp`, in place: the counterpart of the JAX
    sweep's `psum` over the 'samples' axis. Every rank must call it for
    the same tiles in the same order."""
    import torch.distributed as dist
    if parts.device != grp.device:
        raise ValueError(f"parts on {parts.device}, the group's rank on "
                         f"{grp.device}")
    if parts.is_cuda and grp.device_backend == "gloo":
        # ranks share the card: through one pinned host buffer
        n = parts.numel()
        if grp._staging is None or grp._staging.numel() < n:
            grp._staging = torch.empty(n, dtype=parts.dtype, pin_memory=True)
        host = grp._staging[:n].view(parts.shape)
        host.copy_(parts, non_blocking=True)
        torch.cuda.current_stream(parts.device).synchronize()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=grp.device_group)
        parts.copy_(host, non_blocking=True)
        return
    dist.all_reduce(parts, op=dist.ReduceOp.SUM, group=grp.device_group)


def resume_barrier(error: Optional[BaseException] = None):
    """The resume barrier of a checkpointed run: every rank calls it
    once it has read and validated its sidecar, passing the exception of
    that check if it failed. No rank proceeds until all have checked, and
    if any failed, every rank raises here -- the failed one its own
    error -- so no rank is left waiting in a later collective."""
    import torch.distributed as dist
    grp = group()
    failed = torch.zeros(grp.size, dtype=torch.int64)
    failed[grp.rank] = error is not None
    dist.all_reduce(failed, group=grp.host_group)
    if error is not None:
        raise error
    bad = failed.nonzero().flatten().tolist()
    if bad:
        raise RuntimeError(f"rank(s) {bad} failed the checkpoint check; "
                           f"see their output")


#: the fixed head of the resume state a dcn run broadcasts
RESUME_HEAD = ("has", "units", "n_pairs", "n_records", "fused_cap",
               "outcap", "n_loads")


def broadcast_resume(ck: Optional[dict]) -> Optional[dict]:
    """Rank 0's resume state (`ck`, its sidecar read, or None) on every
    rank of a dcn run: the fixed head RESUME_HEAD, then `n_loads` values
    of `load_cum`, each an int64 broadcast over the host group. Rank 0
    gets its own dict back; the others a dict of the same keys with no
    writer state (they own no output)."""
    import torch.distributed as dist
    grp = group()
    head = torch.zeros(len(RESUME_HEAD), dtype=torch.int64)
    if grp.rank == 0 and ck is not None:
        caps = ck.get("caps") or {}
        head[:] = torch.tensor([1, ck["units"], ck["n_pairs"],
                                ck["n_records"], caps.get("fused_cap", 0),
                                caps.get("outcap", 0), len(ck["load_cum"])])
    dist.broadcast(head, src=0, group=grp.host_group)
    st = dict(zip(RESUME_HEAD, head.tolist()))
    if not st["has"]:
        return None
    cum = torch.zeros(st["n_loads"], dtype=torch.int64)
    if grp.rank == 0:
        cum[:] = torch.tensor(ck["load_cum"], dtype=torch.int64)
    if st["n_loads"]:
        dist.broadcast(cum, src=0, group=grp.host_group)
    if grp.rank == 0:
        return ck
    return dict(units=st["units"], n_pairs=st["n_pairs"],
                n_records=st["n_records"], load_cum=cum.tolist(),
                caps=dict(fused_cap=st["fused_cap"], outcap=st["outcap"]),
                writer=None)


def partition_tiles(pairs, proc_id: int, n_procs: int):
    """Round-robin slice of the (i, j, diag) tile list for one process,
    plus the set of super-block ids that slice touches (only those need
    loading on this host)."""
    mine = pairs[proc_id::n_procs]
    touched = {i for i, j, _ in mine} | {j for _, j, _ in mine}
    return mine, touched


def shard_output_path(output: str, proc_id: int, n_procs: int) -> str:
    """Per-process shard name: out.two -> out.pKofN.two. Raises on
    stdout output -- shards must land on disk to be mergeable."""
    if output == "-":
        raise ValueError("distributed calc needs a file output")
    base = output[:-4] if output.endswith(".two") else output
    return f"{base}.p{proc_id}of{n_procs}.two"


def shard_paths(output: str, n_procs: int):
    """The shard names a `n_procs`-process run of `output` produces."""
    return [shard_output_path(output, p, n_procs) for p in range(n_procs)]


def sync_shards():
    """Barrier: every process's shard is closed and on disk before any
    process returns (so a driving script can merge right after rank 0
    exits)."""
    import torch.distributed as dist
    dist.barrier(group=group().host_group)


def merge_shards(shards, output: str, memory_gb: float = 1.0,
                 threads: int = 0) -> int:
    """Fold per-process (or per-chunk) .two shards into ONE
    position-sorted .two: the shard list streams straight into the
    external sorter's run phase (sort_two accepts multiple inputs), so
    the merge never writes or re-reads a concatenated intermediate.
    `shards` is a list of paths or a glob pattern. Returns the merged
    record count."""
    from ..post.sort import sort_two
    if isinstance(shards, str):
        shards = sorted(glob.glob(shards))
    if not shards:
        raise ValueError("no shards to merge")
    return sort_two(shards, output, memory_limit_gb=memory_gb,
                    threads=threads)
