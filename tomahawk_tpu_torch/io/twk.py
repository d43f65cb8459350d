""".twk genotype archive: RLE-packed variant records in zstd blocks.

Byte-compatible with the reference container (reference:
lib/core.cpp:60-96 record serialization, :245-262 block serialization,
:265-293 oblock framing; lib/importer.cpp:83-98 header, :311-326 footer).

Layout:
  "TOMAHAWK\\x01" | u64 b_unc | u64 b_cmp | zstd(VcfHeader)
  { u8 marker=1 | u32 b_unc | u32 b_cmp | zstd(block payload) }*
  u8 marker=0 | u64 b_unc | u64 b_cmp | zstd(Index) | u64 index_offset
  | 32-byte EOF sentinel

Block payload: u32 n | u32 m | u32 rid | n records.
Record: u8 pack(ptype<<3|flipped<<2|phase<<1|missing) | u8 alleles |
        u32 pos | u32 ac | u32 an | u32 rid | u32 n_het | u32 n_hom |
        f64 hwe | u32 (n_runs<<1|miss) | n_runs x uint{8,16,32} RLE words.

RLE word: run_length << (2 + 2*miss) | packed genotype symbol. Symbol
without missing is 2 bits (alleleA<<1 | alleleB); with missing it is
4 bits (codeA<<2 | codeB) with code 0=ref, 1=alt, 2=missing.
"""

import struct
from dataclasses import dataclass, field
from typing import Iterator, List

import numpy as np
import zstandard

from .buffer import BufferReader, BufferWriter
from .constants import TWK_MAGIC, FILE_EOF
from .errors import (CorruptFileError, decompress_checked, parse_checked,
                     read_exact)
from .header import VcfHeader
from .index import Index, IndexEntry

_PTYPE_DTYPE = {1: np.uint8, 2: np.uint16, 4: np.uint32}


@dataclass
class Twk1Record:
    """One variant site: metadata + RLE genotype runs."""
    pos: int = 0
    rid: int = 0
    ac: int = 0           # alternate-allele count
    an: int = 0           # number of MISSING alleles (reference semantics)
    n_het: int = 0
    n_hom: int = 0
    hwe: float = 0.0
    alleles: int = 0      # packed single-base ref/alt (BASE_MAP codes)
    gt_ptype: int = 1     # RLE word width in bytes: 1, 2 or 4
    gt_flipped: bool = False
    gt_phase: bool = False
    gt_missing: bool = False
    gt_runs: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))

    @property
    def n_runs(self) -> int:
        return len(self.gt_runs)

    def decode_codes(self) -> np.ndarray:
        """Expand RLE runs to one uint8 code per sample in the 4-bit
        space: (codeA << 2) | codeB with code 0=ref, 1=alt, 2=missing."""
        shift = 2 + 2 * int(self.gt_missing)
        runs = self.gt_runs.astype(np.uint32)
        lens = runs >> shift
        syms = (runs & ((1 << shift) - 1)).astype(np.uint8)
        if not self.gt_missing:
            # widen 2-bit symbols (a<<1|b) to 4-bit (a<<2|b)
            syms = ((syms & 0b10) << 1) | (syms & 0b01)
        return np.repeat(syms, lens)

    _HDR = struct.Struct("<BBIIIIIIdI")

    def write(self, w: BufferWriter):
        pack = (self.gt_ptype << 3) | (int(self.gt_flipped) << 2) | \
               (int(self.gt_phase) << 1) | int(self.gt_missing)
        w.raw(self._HDR.pack(
            pack, self.alleles, self.pos, self.ac, self.an, self.rid,
            self.n_het, self.n_hom, self.hwe,
            (len(self.gt_runs) << 1) | int(self.gt_missing)))
        arr = np.ascontiguousarray(
            self.gt_runs, dtype=_PTYPE_DTYPE[self.gt_ptype])
        if arr.dtype.byteorder == ">":  # pragma: no cover - LE platforms
            arr = arr.byteswap()
        w.raw(arr.tobytes())

    @classmethod
    def read(cls, r: BufferReader) -> "Twk1Record":
        rec = cls()
        pack = r.u8()
        rec.gt_ptype = pack >> 3
        rec.gt_flipped = bool((pack >> 2) & 1)
        rec.gt_phase = bool((pack >> 1) & 1)
        rec.gt_missing = bool(pack & 1)
        rec.alleles = r.u8()
        rec.pos = r.u32()
        rec.ac = r.u32()
        rec.an = r.u32()
        rec.rid = r.u32()
        rec.n_het = r.u32()
        rec.n_hom = r.u32()
        rec.hwe = r.f64()
        nw = r.u32()
        n_runs = nw >> 1
        # gt container's own miss bit mirrors the record's gt_missing flag
        dt = _PTYPE_DTYPE[rec.gt_ptype]
        raw = r.raw(n_runs * rec.gt_ptype)
        rec.gt_runs = np.frombuffer(raw, dtype=np.dtype(dt).newbyteorder("<"))
        return rec


@dataclass
class Twk1Block:
    rid: int = 0
    minpos: int = 0
    maxpos: int = 0
    rcds: List[Twk1Record] = field(default_factory=list)

    @property
    def n(self) -> int:
        return len(self.rcds)

    def add(self, rec: Twk1Record):
        if not self.rcds:
            self.minpos = rec.pos + 1
        self.maxpos = rec.pos + 1  # right non-inclusive
        self.rcds.append(rec)

    def serialize(self) -> bytes:
        w = BufferWriter()
        w.u32(len(self.rcds))
        w.u32(max(len(self.rcds), 1))
        w.u32(self.rid)
        for rec in self.rcds:
            rec.write(w)
        return w.getvalue()

    @classmethod
    def deserialize(cls, buf: bytes) -> "Twk1Block":
        r = BufferReader(buf)
        n = r.u32()
        _m = r.u32()
        blk = cls(rid=r.u32())
        blk.rcds = [Twk1Record.read(r) for _ in range(n)]
        if blk.rcds:
            blk.minpos = blk.rcds[0].pos + 1
            blk.maxpos = blk.rcds[-1].pos + 1
        return blk


class TwkWriter:
    """Streaming writer for .twk archives."""

    def __init__(self, path: str, header: VcfHeader, c_level: int = 1):
        self.path = path
        self.header = header
        self.c_level = c_level
        self.index = Index(header.n_contigs)
        self._fh = open(path, "wb")
        self._cctx = zstandard.ZstdCompressor(level=c_level)
        self._fh.write(TWK_MAGIC)
        self._hdr_unc = header.serialize()
        comp = self._cctx.compress(self._hdr_unc)
        self._fh.write(struct.pack("<QQ", len(self._hdr_unc), len(comp)))
        self._fh.write(comp)
        self._data_start = self._fh.tell()

    def write_block(self, blk: Twk1Block):
        if blk.n == 0:
            return
        self.write_payload(blk.rid, blk.n, blk.minpos, blk.maxpos,
                           blk.serialize())

    def write_payload(self, rid: int, n: int, minpos: int, maxpos: int,
                      payload: bytes):
        """Write one block whose record bytes are already serialized
        (the bulk importer packs records natively; see
        native.pack_records)."""
        comp = self._cctx.compress(payload)
        ent = IndexEntry(rid=rid, n=n, minpos=minpos,
                         maxpos=maxpos, b_unc=len(payload),
                         b_cmp=len(comp), foff=self._fh.tell())
        self._fh.write(struct.pack("<BII", 1, len(payload), len(comp)))
        self._fh.write(comp)
        ent.fend = self._fh.tell()
        self.index.add(ent)

    def close(self):
        # The header was serialized at open (the reference's layout puts
        # it before the blocks, importer.cpp:83-98); if the import
        # appended implicit contigs since (body lines on contigs the VCF
        # header never declared), the stored header could not resolve
        # the records' rids -- rewrite the file around the grown header.
        if self.header.serialize() != self._hdr_unc:
            self._rewrite_header()
        idx_buf = self.index.serialize()
        comp = self._cctx.compress(idx_buf)
        index_offset = self._fh.tell()
        self._fh.write(struct.pack("<B", 0))
        self._fh.write(struct.pack("<QQ", len(idx_buf), len(comp)))
        self._fh.write(comp)
        self._fh.write(struct.pack("<Q", index_offset))
        self._fh.write(FILE_EOF)
        self._fh.close()

    def _rewrite_header(self):
        import os
        tmp = self.path + ".hdrfix"
        self._fh.flush()
        with open(self.path, "rb") as src, open(tmp, "wb") as dst:
            dst.write(TWK_MAGIC)
            hdr_buf = self.header.serialize()
            comp = zstandard.ZstdCompressor(
                level=self.c_level).compress(hdr_buf)
            dst.write(struct.pack("<QQ", len(hdr_buf), len(comp)))
            dst.write(comp)
            new_start = dst.tell()
            src.seek(self._data_start)
            while True:
                chunk = src.read(1 << 22)
                if not chunk:
                    break
                dst.write(chunk)
        delta = new_start - self._data_start
        for ent in self.index.ent:
            ent.foff += delta
            ent.fend += delta
        # rebuild the per-contig rollups: they were sized for the
        # original contig count, so implicit-contig blocks were skipped
        from .index import IndexEntryMeta
        self.index.ent_meta = [IndexEntryMeta()
                               for _ in range(self.header.n_contigs)]
        for ent in self.index.ent:
            if 0 <= ent.rid < len(self.index.ent_meta):
                self.index.ent_meta[ent.rid].add(ent)
        self._fh.close()
        os.replace(tmp, self.path)
        self._fh = open(self.path, "ab")
        self._hdr_unc = self.header.serialize()
        self._data_start = new_start

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TwkReader:
    """Random-access + streaming reader for .twk archives."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        self._dctx = zstandard.ZstdDecompressor()
        magic = self._fh.read(len(TWK_MAGIC))
        if magic != TWK_MAGIC:
            raise CorruptFileError(path, "not a .twk archive (bad magic)", 0)
        b_unc, b_cmp = struct.unpack(
            "<QQ", read_exact(self._fh, 16, path, "header sizes"))
        hoff = self._fh.tell()
        self.header = parse_checked(
            VcfHeader.deserialize,
            decompress_checked(
                self._dctx, read_exact(self._fh, b_cmp, path, "header"),
                b_unc, path, "header", hoff),
            path, "header", hoff)
        self._data_start = self._fh.tell()

        # Footer: EOF sentinel then index offset just before it.
        end = self._fh.seek(0, 2)
        if end < self._data_start + len(FILE_EOF) + 8:
            raise CorruptFileError(path, "truncated archive (no footer)",
                                   end)
        self._fh.seek(-(len(FILE_EOF) + 8), 2)
        index_offset, = struct.unpack("<Q", self._fh.read(8))
        eof = self._fh.read(len(FILE_EOF))
        if eof != FILE_EOF:
            raise CorruptFileError(
                path, "truncated archive (bad EOF sentinel)",
                end - len(FILE_EOF))
        if not self._data_start <= index_offset < end:
            raise CorruptFileError(
                path, f"corrupt footer: index offset {index_offset} "
                "out of range", end - len(FILE_EOF) - 8)
        self._fh.seek(index_offset)
        marker, ib_unc, ib_cmp = struct.unpack(
            "<BQQ", read_exact(self._fh, 17, path, "index header"))
        if marker != 0:
            raise CorruptFileError(path, "corrupt footer marker",
                                   index_offset)
        self.index = Index.deserialize(
            decompress_checked(
                self._dctx, read_exact(self._fh, ib_cmp, path, "index"),
                ib_unc, path, "index", index_offset + 17),
            path=path)
        self._fh.seek(self._data_start)

    @property
    def n_samples(self) -> int:
        return self.header.n_samples

    def read_block(self, i: int) -> Twk1Block:
        ent = self.index.ent[i]
        self._fh.seek(ent.foff)
        marker, b_unc, b_cmp = struct.unpack(
            "<BII", read_exact(self._fh, 9, self.path, "block header"))
        if marker != 1:
            raise CorruptFileError(self.path, "corrupt block marker",
                                   ent.foff)
        payload = decompress_checked(
            self._dctx, read_exact(self._fh, b_cmp, self.path, "block"),
            b_unc, self.path, "block", ent.foff + 9)
        try:
            return Twk1Block.deserialize(payload)
        except (EOFError, struct.error, KeyError) as e:
            raise CorruptFileError(self.path, f"corrupt block payload: {e}",
                                   ent.foff + 9) from None

    def blocks(self) -> Iterator[Twk1Block]:
        for i in range(self.index.n):
            yield self.read_block(i)

    def records(self) -> Iterator[Twk1Record]:
        for blk in self.blocks():
            yield from blk.rcds

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
