"""Self-indexing archive indices.

Byte-compatible with the reference's Index / IndexOutput wire formats
(reference: include/index.h, lib/index.cpp:8-268):

- IndexEntry        {i32 rid, u32 n, u32 minpos, u32 maxpos, u32 b_unc,
                     u32 b_cmp, u64 foff, u64 fend}
- IndexEntryOutput  IndexEntry + {i32 ridB}
- IndexEntryEntry   per-contig meta: {i32 rid, u32 n, u32 minpos, u32 maxpos,
                     u64 foff, u64 fend, u64 nn}  (no b_unc/b_cmp)
- Index             u64 marker | u64 n | u64 m | u64 m_ent | entries | metas
- IndexOutput       u64 marker | u8 state | u64 n | u64 m | u64 m_ent | ...
"""

from dataclasses import dataclass
from typing import List

from .buffer import BufferReader, BufferWriter
from .constants import INDEX_START_MARKER, TWK_IDX_UNSORTED
from .errors import CorruptFileError


@dataclass
class IndexEntry:
    rid: int = 0
    n: int = 0
    minpos: int = 0
    maxpos: int = 0
    b_unc: int = 0
    b_cmp: int = 0
    foff: int = 0
    fend: int = 0
    ridB: int = -1  # only serialized for .two output entries

    def write(self, w: BufferWriter, output: bool = False):
        w.i32(self.rid)
        w.u32(self.n)
        w.u32(self.minpos)
        w.u32(self.maxpos)
        w.u32(self.b_unc)
        w.u32(self.b_cmp)
        w.u64(self.foff)
        w.u64(self.fend)
        if output:
            w.i32(self.ridB)

    @classmethod
    def read(cls, r: BufferReader, output: bool = False) -> "IndexEntry":
        e = cls()
        e.rid = r.i32()
        e.n = r.u32()
        e.minpos = r.u32()
        e.maxpos = r.u32()
        e.b_unc = r.u32()
        e.b_cmp = r.u32()
        e.foff = r.u64()
        e.fend = r.u64()
        if output:
            e.ridB = r.i32()
        return e


@dataclass
class IndexEntryMeta:
    """Per-contig rollup entry (reference IndexEntryEntry)."""
    rid: int = 0
    n: int = 0
    minpos: int = 0
    maxpos: int = 0
    foff: int = 0
    fend: int = 0
    nn: int = 0

    def add(self, ent: IndexEntry):
        if self.n == 0:
            self.minpos = ent.minpos
            self.foff = ent.foff
            self.rid = ent.rid
        self.n += ent.n
        self.maxpos = ent.maxpos
        self.fend = ent.fend
        self.nn += 1

    def write(self, w: BufferWriter):
        w.i32(self.rid)
        w.u32(self.n)
        w.u32(self.minpos)
        w.u32(self.maxpos)
        w.u64(self.foff)
        w.u64(self.fend)
        w.u64(self.nn)

    @classmethod
    def read(cls, r: BufferReader) -> "IndexEntryMeta":
        e = cls()
        e.rid = r.i32()
        e.n = r.u32()
        e.minpos = r.u32()
        e.maxpos = r.u32()
        e.foff = r.u64()
        e.fend = r.u64()
        e.nn = r.u64()
        return e


class Index:
    """Index over .twk variant blocks."""

    output = False

    def __init__(self, n_contigs: int = 0):
        self.ent: List[IndexEntry] = []
        self.ent_meta: List[IndexEntryMeta] = [
            IndexEntryMeta() for _ in range(n_contigs)]

    def add(self, e: IndexEntry):
        self.ent.append(e)
        if 0 <= e.rid < len(self.ent_meta):
            self.ent_meta[e.rid].add(e)

    @property
    def n(self) -> int:
        return len(self.ent)

    def total_variants(self) -> int:
        return sum(e.n for e in self.ent)

    def find_overlap(self, rid: int, pos_a: int, pos_b: int) -> List[int]:
        """Block indices whose [minpos, maxpos] overlaps [pos_a, pos_b]."""
        return [i for i, e in enumerate(self.ent)
                if e.rid == rid and e.minpos <= pos_b and e.maxpos >= pos_a]

    def write(self, w: BufferWriter):
        w.u64(INDEX_START_MARKER)
        if self.output:
            w.u8(self.state)
        w.u64(len(self.ent))
        w.u64(max(len(self.ent), 1))   # capacity m (>= n); readers allocate m
        w.u64(len(self.ent_meta))
        for e in self.ent:
            e.write(w, output=self.output)
        for m in self.ent_meta:
            m.write(w)

    def serialize(self) -> bytes:
        w = BufferWriter()
        self.write(w)
        return w.getvalue()

    @classmethod
    def read(cls, r: BufferReader, path: str = "<index>") -> "Index":
        marker = r.u64()
        if marker != INDEX_START_MARKER:
            raise CorruptFileError(path, "corrupt index (bad start marker)")
        idx = cls()
        if cls.output:
            idx.state = r.u8()
        n = r.u64()
        _m = r.u64()
        m_ent = r.u64()
        try:
            idx.ent = [IndexEntry.read(r, output=cls.output)
                       for _ in range(n)]
            idx.ent_meta = [IndexEntryMeta.read(r) for _ in range(m_ent)]
        except EOFError as e:
            raise CorruptFileError(path, f"corrupt index: {e}") from None
        return idx

    @classmethod
    def deserialize(cls, buf: bytes, path: str = "<index>") -> "Index":
        return cls.read(BufferReader(buf), path=path)


class IndexOutput(Index):
    """Index over .two record blocks; entries carry ridB and the index
    carries a sorted-state byte."""

    output = True

    def __init__(self, n_contigs: int = 0):
        super().__init__(n_contigs)
        self.state = TWK_IDX_UNSORTED

    def add(self, e: IndexEntry):
        # .two index entries are not rolled into per-contig meta at build
        # time (reference: lib/index.cpp IndexOutput::Add) unless sorted.
        self.ent.append(e)

    def add_meta(self, e: IndexEntry):
        if 0 <= e.rid < len(self.ent_meta):
            self.ent_meta[e.rid].add(e)
