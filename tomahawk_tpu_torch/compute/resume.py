"""Checkpoint and resume of a `calc` run (`--checkpoint PATH`).

The resume unit is a segment (`LdEngine.run_group`), cut and dispatched
in an order that follows from the settings alone. After a segment's
records are emitted, at most every `checkpoint_interval` seconds, the
consumer writes a sidecar (`_ckpt_write`: segments done, totals, the
segments done after each completed load, the engine's caps and the
writer's durable state). A run that finds a sidecar with its own
settings (`_ckpt_config_key`) truncates the output to its offset, skips
the loads and then the segments done before it without dispatching them
and restores the caps, so it cuts and extracts the same segments as an
uninterrupted run. `_ckpt_config_key`, `_ckpt_read` and `_ckpt_write`
are the JAX package's (tomahawk_tpu/compute/engine.py).
"""

from __future__ import annotations

import os
import time
from typing import TYPE_CHECKING

from ..parallel import distributed as dist
from ..utils import log, pretty_int

if TYPE_CHECKING:
    from .engine import CalcSettings

__all__ = ["Checkpoint"]


def _ckpt_config_key(settings: CalcSettings, seg_effective: int,
                     proc_id: int = 0, n_procs: int = 1) -> str:
    """Fingerprint of everything that determines the dispatch plan and
    the output stream; a resume under a different key would silently
    mix incompatible runs, so it is rejected. `seg_effective` is the
    resolved segment size (it depends on the visible device count, not
    just the settings: resuming on a different machine shape would
    misalign segment counting)."""
    import hashlib
    import json as _json
    import os as _os
    st = _os.stat(settings.input)
    fields = dict(
        # bump when the segment-size derivation changes (run_group
        # splits groups into ~PIPELINE_SEGMENTS pieces since round 4):
        # resumed runs must count segments identically
        plan=2,
        proc=f"{proc_id}/{n_procs}",
        input=_os.path.abspath(settings.input), size=st.st_size,
        mtime=st.st_mtime,
        output=_os.path.abspath(settings.output),
        seg_effective=seg_effective,
        force_phased=settings.force_phased,
        forced_unphased=settings.forced_unphased, window=settings.window,
        l_window=settings.l_window, min_p=settings.min_p,
        min_r2=settings.min_r2, max_r2=settings.max_r2,
        min_dprime=settings.min_dprime, max_dprime=settings.max_dprime,
        n_chunks=settings.n_chunks, c_chunk=settings.c_chunk,
        intervals=list(settings.intervals), b_size=settings.b_size,
        c_level=settings.c_level, sweep_segment=settings.sweep_segment,
        tile_rows=settings.tile_rows, mesh=settings.mesh,
        memory_gb=settings.memory_gb,
        # the load plan's band size depends on it, and segment counting
        # follows the plan
        stage_prefetch=settings.stage_prefetch,
        engine="tomahawk_tpu_torch")
    blob = _json.dumps(fields, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def _ckpt_read(path: str, config_key: str):
    import base64
    import json as _json
    with open(path) as fh:
        ck = _json.load(fh)
    if ck.get("version") != 1:
        raise ValueError(f"unsupported checkpoint version in {path}")
    if ck["config"] != config_key:
        raise ValueError(
            f"checkpoint {path} was written by a run with different "
            "settings or input; delete it to start over")
    ck["writer"]["index"] = base64.b64decode(ck["writer"]["index"])
    return ck


def _ckpt_write(path: str, config_key: str, units: int, n_pairs: int,
                n_records: int, load_cum, writer_state: dict,
                caps: dict = None):
    """Atomic sidecar write (tmp + fsync + rename): the checkpoint is
    only ever observed complete, and the writer state it carries was
    fsync'd by checkpoint_state() before this is called. `caps`
    carries the engine's adaptive buffer state (fused cap, outcap) so
    a resumed run replays the SAME fused-vs-repair extraction paths --
    with the in-sweep Fisher bracket, path choice decides which f32
    program computes P, and resuming with reset caps would leave
    f32-noise differences vs the uninterrupted run."""
    import base64
    import json as _json
    import os as _os
    state = dict(version=1, config=config_key, units=units,
                 n_pairs=n_pairs, n_records=n_records,
                 load_cum=list(load_cum),
                 caps=caps or {},
                 writer=dict(offset=writer_state["offset"],
                             n_records=writer_state["n_records"],
                             index=base64.b64encode(
                                 writer_state["index"]).decode()))
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        _json.dump(state, fh)
        fh.flush()
        _os.fsync(fh.fileno())
    _os.replace(tmp, path)


def _resume_state(settings, proc_id, n_procs, dcn, n_pair_shards=1):
    """(sidecar path, config key, the state to resume from or None). A
    tile-partition rank keeps a sidecar of its own (`PATH.pKofN`); in a
    dcn run rank 0 owns the one output and the one sidecar, and every
    rank takes its state (`parallel.broadcast_resume`), so all skip the
    same segments and the collectives stay aligned. Every rank of a
    multi-process run passes the resume barrier once each has read and
    validated its sidecar: a rank whose check failed fails every rank
    there, before any writes. The key holds the segment size's quantum,
    16 a pairs shard of the mesh (`LdEngine._segment_size`)."""
    path = settings.checkpoint
    if n_procs > 1 and not dcn:
        path = f"{path}.p{proc_id}of{n_procs}"
    key = _ckpt_config_key(settings,
                           max(settings.sweep_segment, 16 * n_pair_shards),
                           0 if dcn else proc_id, n_procs)

    def read():
        if (proc_id == 0 or not dcn) and os.path.exists(path):
            return _ckpt_read(path, key)
        return None
    if n_procs == 1:
        ck = read()
    else:
        ck, err = None, None
        try:
            ck = read()
        except Exception as e:   # noqa: BLE001 - raised at the barrier
            err = e
        dist.resume_barrier(err)
        if dcn:
            ck = dist.broadcast_resume(ck)
    if ck is not None:
        log("LOG", f"Resuming from {settings.checkpoint if dcn else path}"
            f": {ck['units']} segments, {pretty_int(ck['n_records'])} "
            f"records already on disk", sub="CKPT")
    return path, key, ck


class Checkpoint:
    """The sidecar of one checkpointed run: its path and key, the state
    it resumes from (`state`, None for a fresh run) and `load_cum`, the
    engine's segments done after each completed load, which every
    sidecar carries."""

    def __init__(self, settings, proc_id, n_procs, dcn, n_pair_shards=1):
        self.path, self.key, self.state = _resume_state(
            settings, proc_id, n_procs, dcn, n_pair_shards)
        self.units = self.state["units"] if self.state else 0
        self.load_cum = list(self.state["load_cum"]) if self.state else []
        self.interval = settings.checkpoint_interval
        self._last = time.monotonic()

    def restore(self, result, engine=None):
        """Start `result` and the engine, where there is one, at the
        sidecar's totals, segment count and caps."""
        ck = self.state
        if ck is None:
            return
        result.n_pairs, result.n_records = ck["n_pairs"], ck["n_records"]
        if engine is not None:
            engine.ckpt_skip = ck["units"]
            engine.cand_total = ck["n_pairs"]
            engine.caps.update({k: int(v) for k, v in
                                (ck.get("caps") or {}).items() if v})

    def load_done(self, li: int) -> bool:
        """Whether load `li` was complete when the sidecar was written: a
        resumed run skips it whole, neither inflating nor staging its
        bands."""
        return li < len(self.load_cum) and self.load_cum[li] <= self.units

    def write_due(self, engine, result, writer):
        """After a segment's records, on the thread that emitted them (a
        sidecar always describes a whole-segment boundary): the sidecar,
        where `checkpoint_interval` has passed since the last."""
        now = time.monotonic()
        if now - self._last < self.interval:
            return
        self._last = now
        _ckpt_write(self.path, self.key, engine.units_done,
                    engine.cand_total, result.n_records, self.load_cum,
                    writer.checkpoint_state(), caps=dict(engine.caps))

    def remove(self):
        """The output is complete: the sidecar is obsolete."""
        if os.path.exists(self.path):
            os.remove(self.path)
