"""calc's .two writer: each block compressed on a pool of workers, the
file written in block order on one thread.

`TwoWriter` (io/two.py, a held copy of the JAX package's) compresses and
writes every block on its one `twk-two-write` thread. `PooledTwoWriter`
hands each block's payload, once `write_block` has copied it, at once to
a pool of `threads` compressors (`twk-two-zstd_<i>`), each thread with a
zstd compressor of its own: the zstandard package's may not be used by
two threads at once. `twk-two-write` takes the frames in the order the
blocks were queued and writes each, with its index entry, as `TwoWriter`
does. A frame depends only on its payload and the level, so the file is
`TwoWriter`'s byte for byte at every pool size. The reference tool
compresses on its `-t` worker threads the same way (reference:
ld_engine.cpp:1742-1764).

`add` blocks once the queue holds a block for each compressor and
`QUEUE_BYTES` of payload buffers beyond them (at least 8 blocks). Every
payload buffer is a full block's, and at least the 1 MiB that
`TwoWriter._payload_buf` allocates, so any free buffer takes any block:
a buffer is made only when all are in flight, so the writer holds at
most the queue's count of buffers and two more (the one the writer
thread writes, the one `add` fills): `QUEUE_BYTES` and `threads + 2`
blocks, or `threads + 10` blocks where 8 pass `QUEUE_BYTES`. A
worker's error is raised by the next `add` (or `write_block`),
`checkpoint_state` or `close`, which drain every compression and write.

Spans: `write.compress` a block on the pool (attribute `inflight`: the
blocks compressing when it started, itself included) and `write.block`
its ordered write (`records`, `bytes_in`, `bytes_out`); both are
children of the span that queued the block (`write.add` or
`write.close`), handed on with the block.

What the pool takes of `TwoWriter`, whose own code is left as it is: it
starts `_wq` and `_wthread` itself before `write_block` would, and
`write_block` puts `(payload, ent)` on `_wq`; it replaces
`_write_worker` and `_emit_block(payload, ent)` (the ordered write,
which reads the frame the writer thread took with the block), and sizes
`_payload_buf`; it shares `_werr`, `_free_bufs` and `_fh`, and
`close` and `_drain_async` as they are. A wrap of `TwoWriter.
_emit_block` on the class does not see the override.
"""

import queue
import struct
import threading
from concurrent.futures import ThreadPoolExecutor, wait

import zstandard

from .. import spans
from ..io.constants import TWK_IDX_UNSORTED
from ..io.two import TWO_DTYPE, TwoWriter

#: payload bytes queued beyond a block a compressor: a segment's records
#: (~100 blocks of 10,000 in a dense 1000 Genomes job) go on the queue at
#: once, and compress while the consumer reads and computes the next
#: segment; a shallower queue leaves the compressors idle then
QUEUE_BYTES = 128 << 20


def _block_bytes(block_limit: int) -> int:
    """The payload buffer of one block: a full block's, and at least the
    1 MiB that `TwoWriter._payload_buf` allocates."""
    return max(8 + block_limit * TWO_DTYPE.itemsize, 1 << 20)


class _Blocks(queue.Queue):
    """The writer's queue: a block `(payload, ent)` put on it goes to the
    compressors at once, and the writer thread gets `(payload, ent,
    (frame future, parent ctx))`."""

    def __init__(self, writer):
        super().__init__(maxsize=writer.threads + max(
            8, QUEUE_BYTES // _block_bytes(writer.block_limit)))
        self._writer = writer

    def put(self, item, block=True, timeout=None):
        if item is not None:
            payload, ent = item
            ctx = spans.current()
            item = (payload, ent, (self._writer._pool.submit(
                self._writer._compress, payload, ctx), ctx))
        super().put(item, block, timeout)


class PooledTwoWriter(TwoWriter):
    """A `TwoWriter` that always writes asynchronously, its blocks
    compressed on `threads` workers (module docstring)."""

    def __init__(self, path, header, threads: int, c_level: int = 1,
                 block_limit: int = 10000, state: int = TWK_IDX_UNSORTED):
        super().__init__(path, header, c_level=c_level,
                         block_limit=block_limit, state=state,
                         async_blocks=True)
        self._init_pool(threads)

    @classmethod
    def resume(cls, path, header, state, threads: int, c_level: int = 1,
               block_limit: int = 10000):
        w = super().resume(path, header, state, c_level=c_level,
                           block_limit=block_limit, async_blocks=True)
        w._init_pool(threads)
        return w

    def _init_pool(self, threads: int):
        self.threads = threads
        self._pool = None
        self._local = threading.local()
        self._lock = threading.Lock()
        self._compressing = 0
        self._frame = None      # the block's (future, ctx), writer thread

    def write_block(self, recs, ent=None):
        if self._wq is None and len(recs):
            # started here, before TwoWriter.write_block would start its
            # own single worker
            self._pool = ThreadPoolExecutor(
                self.threads, thread_name_prefix="twk-two-zstd")
            self._wq = _Blocks(self)
            self._wthread = threading.Thread(
                target=self._write_worker, name="twk-two-write", daemon=True)
            self._wthread.start()
        super().write_block(recs, ent)

    def _payload_buf(self, size: int) -> bytearray:
        return super()._payload_buf(
            max(size, _block_bytes(self.block_limit)))

    def _compress(self, payload, ctx) -> bytes:
        """One block's frame, on a pool thread, with its own compressor."""
        with self._lock:
            self._compressing += 1
            inflight = self._compressing
        try:
            with spans.span("write.compress", parent=ctx, inflight=inflight):
                cctx = getattr(self._local, "cctx", None)
                if cctx is None:
                    cctx = self._local.cctx = zstandard.ZstdCompressor(
                        level=self.c_level)
                return cctx.compress(payload)
        finally:
            with self._lock:
                self._compressing -= 1

    def _write_worker(self):
        while True:
            item = self._wq.get()
            if item is None:
                self._wq.task_done()
                return
            payload, ent, self._frame = item
            try:
                if self._werr is None:
                    self._emit_block(payload, ent)
            except Exception as e:  # noqa: BLE001 - reraised on add/close
                self._werr = e
            finally:
                # waited for even after an error: the payload's buffer is
                # recycled only once no compressor reads it
                wait([self._frame[0]])
                self._frame = None
                # kept, as many as can be in flight: none is dropped
                # to be made anew
                if len(self._free_bufs) < self._wq.maxsize + 2:
                    self._free_bufs.append(payload.obj)
                self._wq.task_done()

    def _emit_block(self, payload, ent):
        """The ordered write of one block, on the writer thread: the
        frame its compressor made, then as `TwoWriter._emit_block`."""
        frame, ctx = self._frame
        comp = frame.result()
        with spans.span("write.block", parent=ctx, records=ent.n,
                        bytes_in=len(payload), bytes_out=len(comp)):
            ent.b_cmp = len(comp)
            ent.foff = self._fh.tell()
            self._fh.write(struct.pack("<BII", 1, len(payload), len(comp)))
            self._fh.write(comp)
            ent.fend = self._fh.tell()
            self.index.add(ent)
            if self.index.state == 2 and ent.rid >= 0:
                self.index.add_meta(ent)

    def close(self):
        try:
            super().close()
        finally:
            if self._wq is not None:
                # TwoWriter.close raised before it stopped the writer
                # thread, which drains the queue whatever has failed
                self._wq.put(None)
                self._wthread.join()
                self._wq = self._wthread = None
            if self._pool is not None:
                self._pool.shutdown()
                self._pool = None
