"""Multi-process orchestration for distributed `calc` runs, and the
device meshes of one process.

Counterpart of tomahawk_tpu/parallel/distributed.py over
`torch.distributed`. The JAX package drives the devices of a process
through a jax Mesh and `shard_map`; here a mesh is parallel/mesh.py's
[P, S] grid of torch devices, which the engine drives itself, and the
processes of a run form one `torch.distributed` group:

    JAX run mode                       this package
    --mesh auto (one process)          the same: a P x 1 mesh over every
                                       visible card when there is more
                                       than one (`resolve_mesh`)
    --mesh PxS, cpu:PxS                the same: the first P*S cards, or
                                       P*S entries of `cpu` (how the
                                       tests mesh the CPU); the pairs
                                       shards' survivors are read in
                                       shard order, and a samples row sums
                                       its local parts on its first device
    --distributed, mesh auto/off       the same: rank k of N takes
      (tile partition)                 pairs[k::N] (`partition_tiles`),
                                       loads only the super-blocks it
                                       touches, writes out.pKofN.two,
                                       joins the barrier (`sync_shards`);
                                       `merge_shards` folds the shards
    --distributed --mesh PxS           each process meshes its own cards:
                                       process k takes cards k*P*S up to
                                       (k+1)*P*S, modulo the card count
                                       (`process_devices`)
    --distributed --mesh dcn[:P]       the samples group is all N ranks:
      (the packed-word axis spans      rank s uploads words [s*W/N,
      the processes)                   (s+1)*W/N) of every word plane on
                                       each of its P cards (`make_dcn_mesh`;
                                       cards s*P up to (s+1)*P, modulo the
                                       count); per tile: local parts, then
                                       `all_reduce_parts` (SUM) over the
                                       row's device group, then the
                                       epilogue and the compaction on
                                       global counts; each rank runs the
                                       host math of its slice of the
                                       survivors and the records are
                                       gathered over gloo; rank 0 writes
    --checkpoint                       the same: a tile-partition rank
                                       keeps PATH.pKofN; in a dcn run
                                       rank 0's sidecar is broadcast
                                       (`broadcast_resume`: a fixed head,
                                       then the load boundaries), and
                                       every rank passes
                                       `resume_barrier` once its sidecar
                                       is checked

Placement is the one place where this package differs from the JAX one:
torch shows every card of the host to every process, with no set of
local devices a process owns, so a process's cards follow from its rank
and the mesh spec, by one rule (`process_devices`): `cuda` under
`--distributed` means card `rank % count`, `--mesh auto` stays one card
a process, and the first of a process's cards is the one its group is
bound to. The backends are decided once, at the rendezvous, from the
layout and never by catching a failure (`device_backend`): each rank
tells its host and the identity (UUID) of the card of each row, so
ranks started with `CUDA_VISIBLE_DEVICES=k` each, which all call their
card `cuda:0`, are told apart. Where every row card of every rank is a
card of its own, device tensors reduce over NCCL and host barriers go
through gloo; where two ranks share a card, or run on the CPU, gloo
serves both, and a CUDA tensor is then reduced through one pinned host
buffer (gloo's own CUDA path stages through the host as well, and not
every build has it), one buffer a card, so reductions on two cards
never share one. A dcn:P mesh has P rows, row p joining card p of every
rank (the JAX package's `mesh[p, s]` = process s's device p); each row
has a device group of its own, made by every rank in row order in
every layout, and a tile of pairs shard p reduces over row p's group.
A collective that fails raises in every rank; there is no fallback.

Entry: `python -m tomahawk_tpu_torch calc --distributed --coordinator
host:port --num-processes N --process-id K [--mesh dcn]`.
"""

import datetime
import glob
import socket
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..utils.logging import log
from .mesh import Mesh, SamplesGroup, make_mesh

#: seconds a rank waits in the rendezvous or in a collective before it
#: raises (a rank that died leaves the others waiting)
TIMEOUT_S = 600


@dataclass
class ProcessGroup:
    """The process group of one run (`host_group`: the barriers, always
    gloo), or one row of it. The run's group holds a row for each row of
    a dcn mesh in `rows`, in row order, and no device group of its own:
    row p's `device` is this rank's card p and its `device_group`, which
    carries the device tensors' collectives (NCCL, or gloo where ranks
    share a device or run on the CPU), joins card p of every rank. A row
    has no rows of its own."""
    rank: int
    size: int
    device: torch.device
    device_backend: str            # "nccl" or "gloo"
    device_group: object
    host_group: object
    rows: list = field(default_factory=list)
    # gloo with CUDA tensors: the pinned host buffers all_reduce_parts
    # stages through, one a card (a card's reductions are ordered by its
    # stream, two cards' are not), allocated at the card's first
    # reduction and grown on demand
    _staging: dict = field(default_factory=dict)
    # the samples slices this process holds beside its own, whose local
    # parts the sweep computes before the reduction (a SamplesGroup's;
    # one slice a process here)
    peers = ()


_group: Optional[ProcessGroup] = None


def _mesh_shape(spec: str) -> tuple:
    """(P, S) of a 'PxS' spec ('P' alone: S = 1)."""
    p, _, s = spec.partition("x")
    try:
        shape = int(p), int(s) if s else 1
    except ValueError:
        shape = (0, 0)
    if min(shape) < 1:
        raise ValueError(f"mesh {spec!r}: expected 'auto', 'off', 'PxS', "
                         f"'cpu:PxS', 'cuda:PxS' or 'dcn[:P]'")
    return shape


def _split_platform(spec: str, device) -> tuple:
    """(platform, shape part) of a mesh spec: its 'cuda:' or 'cpu:'
    prefix, else `device`'s type."""
    platform = torch.device(device).type
    if ":" in spec:
        platform, _, spec = spec.partition(":")
    if platform not in ("cuda", "cpu"):
        raise ValueError(f"mesh platform {platform!r}: use 'cuda' or 'cpu'")
    return platform, spec


def process_devices(device, rank: int = 0, spec: str = None) -> list:
    """The devices of the process of rank `rank` under the mesh spec
    `spec`: the one placement rule of this package. The process takes n
    cards, P*S under 'PxS', P under 'dcn:P', else one; rank k's are the
    cards k*n up to (k+1)*n, modulo the count (`cuda`), or n entries of
    the CPU (`cpu`, or a 'cpu:' spec). An explicit card index stands
    where the process takes one card. The first device is the rank's
    own, the one its process group is bound to."""
    spec = spec or "off"
    if spec == "dcn" or spec.startswith("dcn:"):
        platform, (_, _, p) = torch.device(device).type, spec.partition(":")
        n = _mesh_shape(p)[0] if p else 1
    else:
        platform, shape = _split_platform(spec, device)
        n = 1 if shape in ("auto", "off") else \
            int(np.prod(_mesh_shape(shape)))
    dev = torch.device(device)
    if platform != "cuda":
        return [torch.device(platform)] * n
    if dev.type == "cuda" and dev.index is not None and n == 1:
        return [dev]
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("device 'cuda' requested but torch sees no "
                           "CUDA device")
    return [torch.device("cuda", (rank * n + i) % count) for i in range(n)]


def resolve_mesh(spec: str, local_only: bool = False, device="cuda",
                 rank: int = 0):
    """Mesh spec -> parallel.mesh.Mesh or None (one device), as the JAX
    package's resolve_mesh: 'off' and '' give None; 'auto' a P x 1 mesh
    over every visible card when there is more than one; 'PxS' the first
    P*S cards (ValueError when there are fewer); a 'cuda:' or 'cpu:'
    prefix picks the platform, which is otherwise `device`'s ('cpu:PxS':
    P*S entries of the CPU). `local_only` (a distributed run): the
    process of rank `rank` meshes its own cards (`process_devices`), and
    'auto' is one card a process. 'dcn' and 'dcn:P' give
    `make_dcn_mesh`'s."""
    if spec in ("off", "", None):
        return None
    if spec == "dcn" or spec.startswith("dcn:"):
        return make_dcn_mesh(spec, device)
    platform, shape = _split_platform(spec, device)
    count = torch.cuda.device_count() if platform == "cuda" else 1
    if shape == "auto":
        if local_only or count < 2:
            return None
        return make_mesh(count, 1)
    P, S = _mesh_shape(shape)
    if platform == "cuda" and P * S > count:
        raise ValueError(f"mesh {P}x{S} needs {P * S} cards; torch sees "
                         f"{count}")
    return make_mesh(P, S, process_devices(device, rank if local_only else 0,
                                           spec))


def make_dcn_mesh(spec: str = "dcn", device="cuda") -> Mesh:
    """The mesh of a samples-sharded run (`--mesh dcn`): its 'samples'
    axis spans the processes of the group, one column a process, and
    'dcn:P' gives each process P cards of its own (cards s*P up to
    (s+1)*P of process s, modulo the count; 'dcn' is 'dcn:1'), each
    holding the process's word slice of the planes for a pairs shard.
    The mesh carries the group, whose row p (`ProcessGroup.rows`) joins
    card p of every process: this process's column must be the cards of
    the rows the group was made with."""
    grp = group() if _group is not None else None
    if grp is None or grp.size < 2:
        raise ValueError("mesh 'dcn' needs a multi-process run "
                         "(use --distributed)")
    cols = [process_devices(device, s, spec) for s in range(grp.size)]
    n_p = len(cols[0])
    if cols[0][0].type == "cuda" and n_p > torch.cuda.device_count():
        raise ValueError(f"dcn:{n_p} exceeds the {torch.cuda.device_count()} "
                         f"cards")
    grid = np.empty((n_p, grp.size), dtype=object)
    for s, col in enumerate(cols):
        grid[:, s] = col
    if grp.rows and [r.device for r in grp.rows] != cols[grp.rank]:
        raise ValueError(f"mesh {spec!r} puts this rank on "
                         f"{[str(d) for d in cols[grp.rank]]}, its row "
                         f"groups on {[str(r.device) for r in grp.rows]}: "
                         f"give init_distributed the rows of the same spec")
    return Mesh(grid, group=grp)


def mesh_is_multiprocess(mesh) -> bool:
    """True when the mesh's samples axis spans processes (a dcn mesh)."""
    return mesh is not None and mesh.group is not None


def card_id(device) -> str:
    """The identity of a device for the layout: 'cpu', or the card's
    UUID, which stays the card's own whatever index the process's
    CUDA_VISIBLE_DEVICES gives it."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return str(torch.cuda.get_device_properties(device).uuid)


def device_backend(layout) -> str:
    """The device collectives' backend of a run from its layout: one
    (host, [(device name, card_id), ...]) a rank, its card of each row.
    'nccl' where there are two ranks or more and every row card of every
    rank is a CUDA card that no other rank or row holds (by host and
    UUID, not by index); 'gloo' where any is shared or on the CPU."""
    cards = [(host, ident) for host, row in layout for _, ident in row]
    if len(layout) > 1 and all(ident != "cpu" for _, ident in cards) \
            and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device, rows=None) -> tuple:
    """Rendezvous at tcp://`coordinator`; returns (process_id,
    n_processes). `device` is this rank's resolved device
    (`process_devices`' first); `rows` this rank's card of each row of a
    dcn mesh (`process_devices` under 'dcn:P'; default `[device]`, one
    row). Every rank makes a device group for each row, in row order.
    The group is kept for `group()` until `shutdown()`."""
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
    rows = [torch.device(d) for d in (rows or [device])]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    host_group = dist.group.WORLD
    # the layout: the host and the card of each row of every rank
    mine = (socket.gethostname(), [(str(d), card_id(d)) for d in rows])
    layout = [None] * num_processes
    dist.all_gather_object(layout, mine, group=host_group)
    if len({len(row) for _, row in layout}) != 1:
        raise ValueError(f"the ranks hold different numbers of rows: "
                         f"{[len(row) for _, row in layout]}")
    backend = device_backend(layout)
    row_groups = []
    for d in rows:
        g = dist.new_group(backend=backend,
                           timeout=datetime.timedelta(seconds=TIMEOUT_S))
        row_groups.append(ProcessGroup(process_id, num_processes, d, backend,
                                       g, host_group))
    _group = ProcessGroup(process_id, num_processes, device, backend,
                          None, host_group, row_groups)
    shared = "" if backend == "nccl" or device.type == "cpu" else \
        "; ranks share a card, CUDA tensors reduce through pinned host memory"
    cards = ", ".join(f"{name} ({ident})" for name, ident in mine[1])
    log("LOG", f"Distributed: process {process_id}/{num_processes} on "
        f"{cards}; device collectives over {backend} in {len(rows)} row "
        f"group(s) (row p: card p of every rank), host barriers over "
        f"gloo{shared}", sub="DIST")
    return process_id, num_processes


def group() -> ProcessGroup:
    """The group `init_distributed` made."""
    if _group is None:
        raise RuntimeError("no process group: call init_distributed first")
    return _group


def shutdown():
    """Destroy the process group (every rank calls it, after the last
    collective, or after `init_distributed` raised past the
    rendezvous)."""
    global _group
    import torch.distributed as dist
    _group = None
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def all_reduce_parts(parts: torch.Tensor, grp):
    """Sum `parts` (the i32 [P, B, B] local contractions of one tile)
    over the ranks of `grp`, in place: the counterpart of the JAX
    sweep's `psum` over the 'samples' axis. `grp` is a row of the run's
    ProcessGroup (`rows[p]`, whose ranks must all call it for the same
    tiles in the same order) or the SamplesGroup of a local mesh's row
    (the peers' parts copied to its first card and added there)."""
    import torch.distributed as dist
    if isinstance(grp, SamplesGroup):
        return grp.all_reduce_parts(parts)
    if grp.rows:
        raise ValueError("all_reduce_parts reduces over a row of the "
                         "process group (`rows[p]`), not the group itself")
    if grp.device_backend == "nccl" and parts.device != grp.device:
        raise ValueError(f"parts on {parts.device}, the row's card "
                         f"{grp.device}: NCCL reduces each row on its card")
    if parts.is_cuda and grp.device_backend == "gloo":
        # ranks share the card: through the card's pinned host buffer,
        # which the copy back from its last reduction may still read
        # (queued on this card's stream, ahead of the copy below)
        n = parts.numel()
        buf = grp._staging.get(parts.device)
        if buf is None or buf.numel() < n:
            buf = grp._staging[parts.device] = torch.empty(
                n, dtype=parts.dtype, pin_memory=True)
        host = buf[:n].view(parts.shape)
        host.copy_(parts, non_blocking=True)
        torch.cuda.current_stream(parts.device).synchronize()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=grp.device_group)
        parts.copy_(host, non_blocking=True)
        return
    dist.all_reduce(parts, op=dist.ReduceOp.SUM, group=grp.device_group)


def allgather_records(arrays, grp: ProcessGroup) -> list:
    """Each of `arrays` (this rank's chunk of one record stream, numpy
    structured arrays) concatenated over the ranks of `grp` in rank
    order, on every rank: the chunk lengths first, then the chunks'
    bytes padded to the longest, over the host group (gloo), as the JAX
    engine's process_allgather of records. Every rank calls it, with an
    empty chunk too."""
    import torch.distributed as dist
    n = torch.tensor([len(arrays[0])], dtype=torch.int64)
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(grp.size)]
    dist.all_gather(lens, n, group=grp.host_group)
    lens = [int(x) for x in lens]
    mx = max(lens)
    if mx == 0:
        return [a[:0] for a in arrays]
    out = []
    for a in arrays:
        size = a.dtype.itemsize
        buf = torch.zeros(mx * size, dtype=torch.uint8)
        buf.numpy()[:len(a) * size] = np.ascontiguousarray(a).view(np.uint8)
        got = [torch.empty_like(buf) for _ in range(grp.size)]
        dist.all_gather(got, buf, group=grp.host_group)
        out.append(np.concatenate([g.numpy()[:k * size].view(a.dtype)
                                   for g, k in zip(got, lens)]))
    return out


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
