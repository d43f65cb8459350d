"""VCF header container with buffer serialization.

Byte-compatible with the reference's VcfHeader / VcfContig wire format
(reference: include/header.h:114-144 contig serialization,
lib/header.cpp:330-368 header serialization). Only the fields that are
serialized are retained: fileformat string, raw header literals, sample
names, and contigs.
"""

import struct
from dataclasses import dataclass, field
from typing import List, Tuple

from .buffer import BufferReader, BufferWriter


@dataclass
class VcfContig:
    idx: int = 0
    name: str = ""
    description: str = ""
    n_bases: int = 0
    extra: List[Tuple[str, str]] = field(default_factory=list)

    def write(self, w: BufferWriter):
        w.u32(self.idx)
        w.string(self.name)
        w.string(self.description)
        w.i64(self.n_bases)
        w.u32(len(self.extra))
        for k, v in self.extra:
            w.string(k)
            w.string(v)

    @classmethod
    def read(cls, r: BufferReader) -> "VcfContig":
        c = cls()
        c.idx = r.u32()
        c.name = r.string()
        c.description = r.string()
        c.n_bases = r.i64()
        n_extra = r.u32()
        c.extra = [(r.string(), r.string()) for _ in range(n_extra)]
        return c


@dataclass
class VcfHeader:
    fileformat: str = "VCFv4.1"
    literals: str = ""
    samples: List[str] = field(default_factory=list)
    contigs: List[VcfContig] = field(default_factory=list)

    @property
    def n_samples(self) -> int:
        return len(self.samples)

    @property
    def n_contigs(self) -> int:
        return len(self.contigs)

    def contig_name(self, rid: int) -> str:
        if 0 <= rid < len(self.contigs):
            return self.contigs[rid].name
        return str(rid)

    def contig_rid(self, name: str) -> int:
        for c in self.contigs:
            if c.name == name:
                return c.idx
        return -1

    def write(self, w: BufferWriter):
        w.string(self.fileformat)
        w.string(self.literals)
        w.u32(len(self.samples))
        # the names as w.string writes each, in one part: a call a name
        # took 0.6 s of every file's header at 488,377 samples
        pack = struct.Struct("<I").pack
        w.raw(b"".join([pack(len(b)) + b
                        for b in map(str.encode, self.samples)]))
        w.u32(len(self.contigs))
        for c in self.contigs:
            c.write(w)

    def serialize(self) -> bytes:
        w = BufferWriter()
        self.write(w)
        return w.getvalue()

    @classmethod
    def read(cls, r: BufferReader) -> "VcfHeader":
        h = cls()
        h.fileformat = r.string()
        h.literals = r.string()
        n_samples = r.u32()
        h.samples = [r.string() for _ in range(n_samples)]
        n_contigs = r.u32()
        h.contigs = [VcfContig.read(r) for _ in range(n_contigs)]
        return h

    @classmethod
    def deserialize(cls, buf: bytes) -> "VcfHeader":
        return cls.read(BufferReader(buf))
