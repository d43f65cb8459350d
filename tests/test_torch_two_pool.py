"""calc's pooled .two writer (tomahawk_tpu_torch/compute/two_pool.py) on the
CPU, with the real zstandard package, each pool thread with a compressor
of its own.

- The same `add` calls give the file `TwoWriter(async_blocks=False)`
  writes, byte for byte: pools of 1, 2, 3 and 8, block limits that leave
  a tail, unsorted and sorted (blocks cut at ridA changes), and a
  `checkpoint_state` mid-stream, then `resume` and more adds.
- The `-` sink: the bytes on stdout are the file's, and its index points
  at every block.
- `add` blocks while the queue is full (a block a compressor and
  `QUEUE_BYTES` beyond them, at least 8), and goes on when the
  compressors do. Every payload buffer holds a full block and at least
  1 MiB, the queue's count of them stays within `QUEUE_BYTES` and a
  block a compressor at every block limit, and the writer makes no more
  buffers than the queue's count and two.
- A compressor that raises in one worker is raised on the next `add` or
  on `close`, and the writer's threads end.
- Spans: one `write.compress` a block on a `twk-two-zstd` thread with
  `inflight` between 1 and the pool's size, one `write.block` a block
  on `twk-two-write`.
- `compute_ld` with `threads` 1, 2 and 4 writes one file, byte for byte
  (the header's Date frozen), which is what the single compressor of
  `TwoWriter(async_blocks=True)` writes.
"""

import datetime
import io
import sys
import threading
import time
import types

import numpy as np
import pytest
import zstandard

import tomahawk_tpu_torch  # noqa: F401  (binds libzstd where needed)

from tomahawk_tpu_torch import spans
from tomahawk_tpu_torch.compute import engine as E
from tomahawk_tpu_torch.compute.engine import CalcSettings, compute_ld
from tomahawk_tpu_torch.compute import two_pool
from tomahawk_tpu_torch.io.constants import TWK_IDX_SORTED, TWK_IDX_UNSORTED
from tomahawk_tpu_torch.io.header import VcfContig, VcfHeader
from tomahawk_tpu_torch.io.importer import ImportSettings, import_vcf
from tomahawk_tpu_torch.io.two import TWO_DTYPE, TwoReader, TwoWriter
from tomahawk_tpu_torch.compute.two_pool import PooledTwoWriter

from test_importer import make_vcf

HDR = VcfHeader(samples=["s0", "s1"],
                contigs=[VcfContig(idx=i, name=f"c{i}") for i in range(3)])
N = 1000
STATES = {"unsorted": TWK_IDX_UNSORTED, "sorted": TWK_IDX_SORTED}


class _Owned:
    """A real compressor that records the threads that use it."""

    def __init__(self, made, level):
        self._c = zstandard.ZstdCompressor(level=level)
        self.threads = set()
        made.append(self)

    def compress(self, data):
        self.threads.add(threading.current_thread().name)
        return self._c.compress(data)


@pytest.fixture
def made(monkeypatch):
    """The compressors the pool makes, each recording its threads; the
    thread switch interval shortened so the workers interleave."""
    assert "_compat" not in zstandard.__file__, "the real package"
    out = []
    monkeypatch.setattr(two_pool, "zstandard", types.SimpleNamespace(
        ZstdCompressor=lambda level: _Owned(out, level)))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    spans.collect()
    try:
        yield out
    finally:
        sys.setswitchinterval(interval)
        spans.collect()


def _records(n, seed):
    """n records sorted by (ridA, posA), three contigs."""
    rng = np.random.default_rng(seed)
    recs = np.zeros(n, TWO_DTYPE)
    rid = rng.integers(0, 3, n)
    pos = rng.integers(1, 1 << 20, n)
    order = np.lexsort((pos, rid))
    recs["ridA"], recs["ridB"] = rid[order], rng.integers(0, 3, n)
    recs["packA"] = pos[order].astype(np.uint32) << 2 | 2
    recs["packB"] = rng.integers(1, 1 << 20, n).astype(np.uint32) << 2
    recs["cnt"] = rng.random((n, 4)) * 100
    for f in ("D", "Dprime", "R", "R2", "P", "ChiSqFisher", "ChiSqModel"):
        recs[f] = rng.random(n)
    return recs


def _chunks(recs, seed):
    """`recs` cut at 12 random points, empty pieces included."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(0, len(recs), 12))
    return np.split(recs, cuts)


def _write(w, parts):
    for p in parts:
        w.add(p)


def _check_spans(threads, n_blocks):
    got = spans.collect()
    comp = [s for s in got if s.name == "write.compress"]
    blocks = [s for s in got if s.name == "write.block"]
    assert len(comp) == len(blocks) == n_blocks
    assert all(s.thread.startswith("twk-two-zstd") for s in comp)
    assert all(1 <= s.attrs["inflight"] <= threads for s in comp)
    assert {s.thread for s in blocks} == {"twk-two-write"}


@pytest.mark.parametrize("state", sorted(STATES))
@pytest.mark.parametrize("block_limit", [7, 64])
@pytest.mark.parametrize("threads", [1, 2, 3, 8])
def test_pool_writes_the_sync_file(tmp_path, made, threads, block_limit,
                                   state):
    parts = _chunks(_records(N, threads), block_limit)
    want, got = str(tmp_path / "sync.two"), str(tmp_path / "pool.two")
    w = TwoWriter(want, HDR, block_limit=block_limit, state=STATES[state])
    _write(w, parts)
    w.close()
    with spans.recording():
        w = PooledTwoWriter(got, HDR, threads, block_limit=block_limit,
                            state=STATES[state])
        _write(w, parts)
        w.close()
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()
    with TwoReader(got) as r:
        n_blocks = r.index.n
        sizes = [e.n for e in r.index.ent]
        assert max(sizes) == block_limit > min(sizes)
        if state == "unsorted":
            assert sizes[-1] == N % block_limit
        np.testing.assert_array_equal(r.records(), np.concatenate(parts))
    _check_spans(threads, n_blocks)
    assert 1 <= len(made) <= threads
    assert all(len(c.threads) == 1 and next(iter(c.threads))
               .startswith("twk-two-zstd") for c in made)


@pytest.mark.parametrize("threads", [1, 2, 3, 8])
def test_pool_checkpoint_and_resume(tmp_path, made, threads):
    """Checkpoint mid-stream (a short block), adds the checkpoint does
    not hold, then a resume and the rest: the sync writer's file."""
    recs = _records(N, 7)
    head, lost, tail = recs[:433], recs[433:600], recs[433:]
    files = {}
    for kind in ("sync", "pool"):
        path = files[kind] = str(tmp_path / f"{kind}.two")
        if kind == "sync":
            w = TwoWriter(path, HDR, block_limit=50)
        else:
            w = PooledTwoWriter(path, HDR, threads, block_limit=50)
        _write(w, _chunks(head, 1))
        state = w.checkpoint_state()
        assert state["n_records"] == len(head)
        w.add(lost)
        w.close()
        if kind == "sync":
            w = TwoWriter.resume(path, HDR, state, block_limit=50)
        else:
            w = PooledTwoWriter.resume(path, HDR, state, threads,
                                       block_limit=50)
            assert w._pool is None
        _write(w, _chunks(tail, 2))
        w.close()
    with open(files["sync"], "rb") as a, open(files["pool"], "rb") as b:
        assert a.read() == b.read()
    with TwoReader(files["pool"]) as r:
        np.testing.assert_array_equal(r.records(), recs)
        assert [e.n for e in r.index.ent][8:10] == [33, 50]


def test_pool_stdout_sink(tmp_path, monkeypatch, made):
    """`-` writes to stdout with offsets counted: the bytes are the
    file's, and each index entry points at its block."""
    parts = _chunks(_records(N, 5), 3)
    want = str(tmp_path / "sync.two")
    w = TwoWriter(want, HDR, block_limit=64)
    _write(w, parts)
    w.close()
    out = types.SimpleNamespace(buffer=io.BytesIO())
    monkeypatch.setattr(sys, "stdout", out)
    w = PooledTwoWriter("-", HDR, 3, block_limit=64)
    _write(w, parts)
    w.close()
    data = out.buffer.getvalue()
    with open(want, "rb") as fh:
        assert data == fh.read()
    got = tmp_path / "stdout.two"
    got.write_bytes(data)
    with TwoReader(str(got)) as r:
        for i, ent in enumerate(r.index.ent):
            assert data[ent.foff] == 1 and ent.fend - ent.foff == 9 + ent.b_cmp
            assert len(r.read_block(i)) == ent.n
        np.testing.assert_array_equal(r.records(), np.concatenate(parts))


class _Held(_Owned):
    """Compresses once `go` is set."""
    go = None

    def compress(self, data):
        assert self.go.wait(timeout=60)
        return super().compress(data)


@pytest.mark.parametrize("block_limit", [10, 100, 1000, 9900, 10000,
                                         200000])
def test_pool_queue_holds_queue_bytes(tmp_path, block_limit):
    """At the default `QUEUE_BYTES`, whatever `-b`: the payload buffers
    are a full block's and at least the 1 MiB `TwoWriter` allocates, and
    the queue's count of them stays within `QUEUE_BYTES` and a block a
    compressor (8 blocks where fewer would pass it)."""
    threads = 2
    w = PooledTwoWriter(str(tmp_path / "o.two"), HDR, threads,
                        block_limit=block_limit)
    w.write_block(_records(3, 0))
    maxsize = w._wq.maxsize
    w.close()
    block = max(8 + block_limit * TWO_DTYPE.itemsize, 1 << 20)
    assert [len(b) for b in w._free_bufs] == [block]
    assert maxsize >= threads + 8
    assert maxsize * block <= max(two_pool.QUEUE_BYTES, 8 * block) \
        + threads * block
    if block_limit == 10:
        assert maxsize * (1 << 20) <= two_pool.QUEUE_BYTES \
            + threads * (1 << 20)


def test_pool_add_blocks_on_a_full_queue(tmp_path, monkeypatch):
    """Held compressors: the adding thread stops with the queue full
    (2 compressors + 8 blocks) and finishes once they go on; the writer
    made no more payload buffers than the queue's count and two, each of
    1 MiB; the file is the sync writer's."""
    w = PooledTwoWriter(str(tmp_path / "unused.two"), HDR, 2)
    w.write_block(_records(3, 0))
    assert w._wq.maxsize == 2 + two_pool.QUEUE_BYTES // (8 + 10000 * 106)
    w.close()
    made, bufs = [], []
    real = TwoWriter._payload_buf

    def counted(self, size):
        buf = real(self, size)
        if all(b is not buf for b in bufs):
            bufs.append(buf)
        return buf
    monkeypatch.setattr(TwoWriter, "_payload_buf", counted)
    monkeypatch.setattr(two_pool, "QUEUE_BYTES", 0)
    monkeypatch.setattr(_Held, "go", threading.Event())
    monkeypatch.setattr(two_pool, "zstandard", types.SimpleNamespace(
        ZstdCompressor=lambda level: _Held(made, level)))
    recs = _records(300, 4)
    w = PooledTwoWriter(str(tmp_path / "pool.two"), HDR, 2, block_limit=10)
    adder = threading.Thread(target=_write, args=(w, np.split(recs, 30)))
    adder.start()
    deadline = time.monotonic() + 30
    while w._wq is None or w._wq.qsize() < 10 or len(bufs) < 12:
        assert time.monotonic() < deadline
        time.sleep(1e-3)
    time.sleep(0.2)
    assert adder.is_alive() and w._wq.qsize() == w._wq.maxsize == 10
    assert len(bufs) == 12
    _Held.go.set()
    adder.join(timeout=60)
    assert not adder.is_alive()
    w.close()
    assert len(w._free_bufs) == 12
    assert len(bufs) == 12 and {len(b) for b in bufs} == {1 << 20}
    want = str(tmp_path / "sync.two")
    s = TwoWriter(want, HDR, block_limit=10)
    _write(s, np.split(recs, 30))
    s.close()
    with open(want, "rb") as a, open(tmp_path / "pool.two", "rb") as b:
        assert a.read() == b.read()


class _Failing(_Owned):
    """Raises on the block of `fail_n` records."""
    fail_n = None

    def compress(self, data):
        if (len(data) - 8) // TWO_DTYPE.itemsize == self.fail_n:
            raise zstandard.ZstdError("planted")
        return super().compress(data)


@pytest.mark.parametrize("where", ["add", "close"])
def test_pool_worker_error_is_raised(tmp_path, monkeypatch, where):
    """A block that fails to compress in one worker is raised by a later
    `add` (a full block fails) or by `close` (the tail fails), and the
    writer thread and the pool end."""
    made = []
    monkeypatch.setattr(_Failing, "fail_n", 10 if where == "add" else 5)
    monkeypatch.setattr(two_pool, "zstandard", types.SimpleNamespace(
        ZstdCompressor=lambda level: _Failing(made, level)))
    recs = _records(N, 9)
    w = PooledTwoWriter(str(tmp_path / "o.two"), HDR, 3, block_limit=10)
    if where == "add":
        deadline = time.monotonic() + 60
        with pytest.raises(RuntimeError, match="async .two writer failed"):
            while time.monotonic() < deadline:
                w.add(recs[:10])
                time.sleep(1e-3)
    else:
        w.add(recs[:995])
    thread, pool = w._wthread, w._pool
    with pytest.raises(RuntimeError, match="async .two writer failed") as e:
        w.close()
    assert isinstance(e.value.__cause__, zstandard.ZstdError)
    thread.join(timeout=10)
    assert not thread.is_alive()
    for t in list(pool._threads):
        t.join(timeout=10)
        assert not t.is_alive()


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_two_pool")
    vcf = str(d / "in.vcf")
    make_vcf(vcf, n_samples=40, n_sites=300, seed=11, miss_frac=0.0,
             contigs=("20",))
    twk = str(d / "in.twk")
    import_vcf(ImportSettings(input=vcf, output=twk, block_size=16))
    return twk


class _Single(TwoWriter):
    """Today's calc writer: one compressor on `twk-two-write`."""

    def __init__(self, path, header, threads, **kw):
        super().__init__(path, header, async_blocks=True, **kw)


def test_calc_file_is_the_same_at_every_pool_size(archive, tmp_path,
                                                  monkeypatch):
    """The whole file of a calc job, its Date frozen, at `threads` 1, 2
    and 4, and with the single-compressor writer."""
    now = datetime.datetime(2026, 1, 2, 3, 4, 5, 678901)
    monkeypatch.setattr(E, "datetime", types.SimpleNamespace(
        datetime=types.SimpleNamespace(now=lambda: now)))
    files = {}

    def job(name, threads):
        out = files[name] = str(tmp_path / f"{name}.two")
        return compute_ld(CalcSettings(
            input=archive, output=out, force_phased=True, min_r2=0.0,
            tile_rows=32, sweep_segment=16, b_size=997, threads=threads),
            device="cpu")
    results = {t: job(f"pool{t}", t) for t in (1, 2, 4)}
    with monkeypatch.context() as m:
        m.setattr(E, "PooledTwoWriter", _Single)
        single = job("single", 2)
    data = {k: open(p, "rb").read() for k, p in files.items()}
    assert data["pool1"] == data["pool2"] == data["pool4"] == data["single"]
    assert {r.n_records for r in results.values()} == {single.n_records}
    with TwoReader(files["pool4"]) as r:
        assert r.index.n > 40 and r.n_records == single.n_records
