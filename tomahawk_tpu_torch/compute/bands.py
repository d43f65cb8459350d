"""Band residency and staging of the segment engine's device planes
(`Bands`). Every upload is accounted in `_upload`, in the span
`engine.upload`; the staging worker's job is `engine.stage`, the main
thread's wait for it `engine.stage_wait`.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import spans
from ..device import on_device
from ..utils import log
from . import sweeps

__all__ = ["Bands", "META_KEYS"]

#: per-variant host arrays of a band, concatenated per load for the host
#: math
META_KEYS = ("pos", "rid", "ac", "an", "n_het", "n_hom", "hwe",
             "has_missing", "valid", "n_rec")


class Bands:
    """The bands of one engine: the host planes of the resident bands,
    their device planes on every position of the mesh (uploaded on first
    use, then kept while the band stays resident), the current load's
    per-variant host arrays and device concatenation, made once a load,
    and a staging worker that inflates and uploads the next load's band
    while the current load computes. `grid`: the (device, word slice) of
    every position by pairs shard (`LdEngine._grid`); `n_slices`: the
    samples shards the word planes are padded for; `B`: the tile rows,
    or None to take them from the first band."""

    def __init__(self, grid, n_slices: int, B: int = None):
        self._positions = [pos for row in grid for pos in row]
        #: the distinct devices of the mesh, in position order
        self.cards = list(dict.fromkeys(d for d, _ in self._positions))
        self._P, self._S = len(grid), len(grid[0])
        self._n_slices = n_slices
        self.device = grid[0][0][0]
        self.B = B
        self.limit = 2
        self._lock = threading.Lock()
        # host planes and per-variant arrays by band, device planes by
        # (key, band)
        self._host = {}
        self._meta = {}
        self._dev = {}
        # the current load's bands and their device concatenation by key
        self._load = []
        self._load_dev = {}
        self.n_uploads = 0
        # `exposed_s`: main-thread time blocked on uploads; `wait_s`:
        # main-thread time blocked on an unfinished prefetch; `hidden_s`:
        # the worker's upload time
        self.stats = dict(hidden_s=0.0, exposed_s=0.0, wait_s=0.0, bytes=0,
                          n_prefetched=0, n_blocking=0)
        # the staging worker, its stream on each card, its queued jobs
        # and the device plane keys the sweeps have used
        self._pool = None
        self._streams = {}
        self._futures = []
        self._seen = set()

    def resident(self) -> list:
        """The resident bands, oldest first."""
        return list(self._host)

    def set_load(self, bands, limit: int = 2) -> dict:
        """Make `bands` (a list of (band_id, stacked-or-None)) the current
        load, in order, and return its per-variant host arrays. A band
        passed with stacked=None must still be resident from an earlier
        load. At most `limit` bands stay resident, the load's among them,
        and the staging worker keeps to it."""
        for band_id, stacked in bands:
            if stacked is None:
                if band_id not in self._meta:
                    raise ValueError(f"band {band_id} not resident")
                continue
            self._register(band_id, stacked)
        self._load = [b for b, _ in bands]
        self._load_dev = {}
        self.limit = limit
        self._evict(keep=self._load)
        return {k: np.concatenate([self._meta[b][k] for b in self._load])
                for k in META_KEYS}

    def _register(self, band_id, stacked):
        host = {k: stacked[k] for k in sweeps.DEV_KEYS}
        if self._n_slices > 1:
            # padded to a multiple of the samples shards, as the JAX
            # engine pads them for a 'samples' axis (the miss plane with
            # ones: padding is "missing"), so every slice has the same
            # words
            host = {k: sweeps.pad_words(v, k, self._n_slices)
                    for k, v in host.items()}
        if self.B is None:
            self.B = stacked["alt_bits"].shape[1]
        elif stacked["alt_bits"].shape[1] != self.B:
            raise ValueError("band tile_rows mismatch")
        with self._lock:
            self._host[band_id] = host
            self._meta[band_id] = {k: stacked[k] for k in META_KEYS}

    def _evict(self, keep):
        """Drop the oldest bands outside `keep` until at most `limit` stay
        resident. A device plane the staging worker uploaded was marked
        for the compute stream, so its memory is not reused before the
        kernels queued there are done with it."""
        with self._lock:
            others = [b for b in self._host if b not in keep]
            for b in others[:max(0, len(self._host) - self.limit)]:
                del self._host[b], self._meta[b]
                for key in [k for k in self._dev if k[1] == b]:
                    del self._dev[key]

    def _mesh_upload(self, k, host, put=None):
        """Plane `k` of a band on every position of the mesh, a list in
        position order: a word plane cut to the position's slice of the
        samples axis, metadata copied whole to each card. Positions that
        share a device and a slice share one tensor. `put(device, array)`
        makes a device tensor of the host array (`host_plane` of the
        position's slice); by default an upload from the calling thread
        on the device's current stream."""
        out, made = [], {}
        for dev, ws in self._positions:
            key = (dev, ws if k in sweeps.WORD_KEYS else None)
            if key not in made:
                arr = sweeps.host_plane(host, k, ws)
                with on_device(dev):
                    made[key] = (put(dev, arr) if put is not None
                                 else torch.from_numpy(arr).to(dev))
            out.append(made[key])
        return out

    def _upload(self, k, band_id, put=None, staged=False):
        """Plane `k` of band `band_id` on every position, uploaded through
        `_mesh_upload(k, ..., put)` unless it is there already, and
        accounted: one upload, its bytes and its seconds, hidden behind
        the sweeps where the staging worker made it (`staged`), exposed
        on the main thread otherwise."""
        key = (k, band_id)
        with self._lock:
            arr = self._dev.get(key)
            if arr is not None:
                return arr
            host = self._host[band_id][k]
        with spans.timed("engine.upload") as up:
            arr = self._mesh_upload(k, host, put)
            up.set(bytes=sum(t.numel() * t.element_size()
                             for t in {id(t): t for t in arr}.values()))
        with self._lock:
            self._dev[key] = arr
            self.n_uploads += 1
            self.stats["bytes"] += up.attrs["bytes"]
            if staged:
                self.stats["hidden_s"] += up.seconds
            else:
                self.stats["exposed_s"] += up.seconds
                self.stats["n_blocking"] += 1
        return arr

    def dev_for(self, cfg) -> list:
        """The current load's device tensors for one sweep config, a dict
        for each position of the mesh: [pairs shard][samples slice]. Each
        band's plane uploads on first use (a phased run never pays for
        the het/hom/valid planes), then the bands of the load are
        concatenated on each device, once a load."""
        keys = sweeps.dev_keys_for(cfg)
        for k in keys:
            if k not in self._load_dev:
                self._seen.add(k)
                parts = [self._upload(k, b) for b in self._load]
                made = {}
                for q in range(len(self._positions)):
                    src = [p[q] for p in parts]
                    key = tuple(map(id, src))
                    if key not in made:
                        made[key] = src[0] if len(src) == 1 else torch.cat(src)
                    self._load_dev.setdefault(k, []).append(made[key])
        S = self._S
        return [[{k: self._load_dev[k][p * S + s] for k in keys}
                 for s in range(S)] for p in range(self._P)]

    # -- staging (upload / compute overlap) ------------------------------
    def _stage(self, band_id, stacked, compute_streams):
        """Register `stacked` as band `band_id`, evict what the limit
        allows no room for, and push its device planes ahead of use, so
        the following `set_load` finds the band resident with its
        transfers done. Runs on the staging worker. On a card each plane
        is uploaded from pinned host memory on the worker's stream, so
        that the copy overlaps the sweeps, and is complete when `put`
        returns; it is marked as used on its card's stream in
        `compute_streams`, where the sweeps read it, so that once evicted
        its memory goes back to the staging stream's pool only after the
        kernels queued there."""
        if band_id in self._meta:
            return
        self._register(band_id, stacked)
        self._evict(keep=self._load + [band_id])

        def put(dev, arr):
            stream = self._streams[dev]
            with torch.cuda.stream(stream):
                out = torch.from_numpy(arr).pin_memory().to(
                    dev, non_blocking=True)
            stream.synchronize()
            out.record_stream(compute_streams[dev])
            return out
        # stage the planes the run has used (a phased sweep never pays
        # for het/hom/valid planes); before any sweep ran, the alt plane
        # is the one certainty
        keys = (self._seen & set(sweeps.DEV_KEYS)) or {"alt_bits"}
        for k in sorted(keys):
            self._upload(k, band_id, put if compute_streams else None,
                         staged=True)
        self.stats["n_prefetched"] += 1

    def stage_async(self, band_id, provider):
        """Queue background staging of one band: `provider()` builds its
        stacked host planes (the archive's blocks inflated) and `_stage`
        uploads them, both overlapping the current load's sweeps. The
        single worker thread is also the backpressure: at most one band
        stages at a time."""
        if band_id in self._meta:
            return
        compute_streams = None
        if self._pool is None:
            self._pool = ThreadPoolExecutor(1, thread_name_prefix="twk-stage")
        if self.device.type == "cuda":
            compute_streams = {d: torch.cuda.current_stream(d)
                               for d in self.cards}
            for d in self.cards:
                if d not in self._streams:
                    self._streams[d] = torch.cuda.Stream(d)
        ctx = spans.current()

        def work():
            with on_device(self.device), \
                    spans.span("engine.stage", parent=ctx):
                if band_id not in self._meta:
                    self._stage(band_id, provider(), compute_streams)
        self._futures.append((band_id, self._pool.submit(work)))

    def stage_wait(self):
        """Drain outstanding staging work before the next `set_load`
        touches the residency maps. A failed staging job is reported and
        its band loads on demand at the next `set_load`: the same kernels
        on the same card, where a device fault raises at that upload."""
        with spans.timed("engine.stage_wait") as wait:
            for band_id, fut in self._futures:
                try:
                    fut.result()
                except Exception as e:   # noqa: BLE001 - loads on demand
                    log("WARNING", f"staging band {band_id} failed "
                        f"({type(e).__name__}: {str(e)[:120]}); loading it "
                        f"on demand", sub="MEMORY")
        if self._futures:
            self.stats["wait_s"] += wait.seconds
        self._futures = []

    def close(self):
        """Drain and join the staging worker."""
        self.stage_wait()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
