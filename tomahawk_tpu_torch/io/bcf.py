"""Self-contained BCF2.2 reader (and a minimal writer for tests).

The reference imports BCF through htslib (reference: lib/vcf_reader.h
hts_open/bcf_read); this is the native equivalent without the htslib
dependency: BGZF is a sequence of gzip members (zlib handles them), the
header block is ordinary ##-VCF text, and each record is a pair of
binary blocks (shared site fields + per-sample FORMAT fields) using the
BCF typed-value encoding.

Only the fields the importer needs are decoded: CHROM, POS, REF/ALT
alleles, and the GT FORMAT vector (vectorized with numpy across
samples). Everything else is skipped structurally.

Spec: samtools/hts-specs VCFv4.x "BCF2" section.
"""

import gzip
import struct
from typing import Iterator, Optional

import numpy as np

from .vcf import VcfSite, VcfReader


def is_bcf(path: str) -> bool:
    """True if the file is (possibly BGZF-compressed) binary BCF."""
    try:
        with open(path, "rb") as fh:
            raw = fh.read(4)
        if raw.startswith(b"BCF"):
            return True
        if raw[:2] != b"\x1f\x8b":
            return False
        with gzip.open(path, "rb") as fh:
            return fh.read(3) == b"BCF"
    except OSError:
        return False


class _Stream:
    """Buffered reader over a (possibly multi-member gzip) byte stream."""

    def __init__(self, fh):
        self._fh = fh

    def read(self, n: int) -> bytes:
        out = self._fh.read(n)
        if len(out) != n:
            raise ValueError("truncated BCF stream")
        return out

    def maybe_read(self, n: int) -> bytes:
        return self._fh.read(n)


# typed-value atom sizes by type code
_TYPE_SIZE = {0: 0, 1: 1, 2: 2, 3: 4, 5: 4, 7: 1}
_TYPE_DTYPE = {1: np.int8, 2: np.int16, 3: np.int32, 5: np.float32,
               7: np.uint8}
# missing / end-of-vector sentinels keyed by int byte width
_MISSING = {1: -128, 2: -32768, 4: -2147483648}
_EOV = {1: -127, 2: -32767, 4: -2147483647}


def _type_size(t: int) -> int:
    size = _TYPE_SIZE.get(t)
    if size is None:
        raise ValueError(f"invalid BCF typed-value code {t}")
    return size


def _read_typed_desc(buf: memoryview, off: int, _nested=False):
    """Decode one type descriptor. Returns (type, n_elems, new_off)."""
    if off >= len(buf):
        raise ValueError("truncated BCF typed value")
    b = buf[off]
    off += 1
    t = b & 0x0F
    n = b >> 4
    if n == 15:
        if _nested:
            raise ValueError("malformed BCF typed-value count")
        t2, n2, off = _read_typed_desc(buf, off, _nested=True)
        if t2 not in (1, 2, 3) or n2 < 1:
            raise ValueError("malformed BCF typed-value count")
        size = _type_size(t2)
        raw = bytes(buf[off:off + size * n2])
        if len(raw) != size * n2:
            raise ValueError("truncated BCF typed value")
        off += size * n2
        n = int(np.frombuffer(raw, _TYPE_DTYPE[t2])[0])
        if n < 0:
            raise ValueError("malformed BCF typed-value count")
    return t, n, off


def _skip_typed(buf: memoryview, off: int) -> int:
    t, n, off = _read_typed_desc(buf, off)
    return off + _type_size(t) * n


def _read_typed_int(buf: memoryview, off: int):
    t, n, off = _read_typed_desc(buf, off)
    if t not in (1, 2, 3):
        raise ValueError(f"expected BCF int vector, got type {t}")
    size = _type_size(t)
    raw = bytes(buf[off:off + size * n])
    if len(raw) != size * n:
        raise ValueError("truncated BCF typed value")
    vals = np.frombuffer(raw, _TYPE_DTYPE[t])
    return int(vals[0]) if n else 0, off + size * n


def _read_typed_string(buf: memoryview, off: int):
    t, n, off = _read_typed_desc(buf, off)
    if t != 7:
        raise ValueError(f"expected BCF char vector, got type {t}")
    s = bytes(buf[off:off + n]).decode("latin-1")
    return s, off + n


class BcfReader:
    """Iterates VcfSite records from a BCF file, presenting the same
    surface as VcfReader (header + sites())."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as probe:
            magic = probe.read(2)
        if magic == b"\x1f\x8b":
            # BGZF: prefer the native streaming inflater (C member
            # hopping; CPython gzip re-frames each <=64 KB member in
            # Python, which dominates at population scale)
            from ..native import native_gzip_open
            fh = native_gzip_open(path) or gzip.open(path, "rb")
        else:
            fh = open(path, "rb")
        self._s = _Stream(fh)
        raw_magic = self._s.read(5)
        if raw_magic[:3] != b"BCF":
            raise ValueError(f"{path}: not a BCF file (bad magic)")
        if raw_magic[3] != 2:
            raise ValueError(
                f"{path}: unsupported BCF major version {raw_magic[3]}")
        (l_text,) = struct.unpack("<I", self._s.read(4))
        text = self._s.read(l_text).rstrip(b"\x00").decode("utf-8")
        self._parse_header(text)

    def _parse_header(self, text: str):
        """Reuse the VCF text-header parser, then build the BCF string
        dictionary (FILTER/INFO/FORMAT ids in order of appearance, PASS
        implicitly first) honoring explicit IDX= overrides."""
        import io as _io
        from .header import VcfHeader
        vr = VcfReader.__new__(VcfReader)
        vr.path = self.path
        vr._fh = _io.StringIO(text)
        vr.header = VcfHeader()
        vr._contig_map = {}
        vr._parse_header()
        self.header = vr.header
        self._contig_map = vr._contig_map

        def _split_kv(body):
            """Split a ##LINE=<...> body on commas OUTSIDE quotes: a
            Description="a,IDX=7" must not fabricate dictionary keys.
            Backslash-escaped characters inside quotes (VCF 4.x allows
            \\" and \\\\ in Description strings) never toggle the quote
            state or split."""
            parts, cur, q, esc = [], [], False, False
            for ch in body:
                if esc:
                    cur.append(ch)
                    esc = False
                    continue
                if q and ch == "\\":
                    cur.append(ch)
                    esc = True
                    continue
                if ch == '"':
                    q = not q
                if ch == "," and not q:
                    parts.append("".join(cur))
                    cur = []
                else:
                    cur.append(ch)
            parts.append("".join(cur))
            return parts

        self._dict = {}            # idx -> id string
        nxt = 0
        if "PASS" not in self._dict.values():
            self._dict[0] = "PASS"
            nxt = 1
        for line in text.splitlines():
            for kind in ("##FILTER=<", "##INFO=<", "##FORMAT=<"):
                if line.startswith(kind):
                    body = line[len(kind):].rstrip(">")
                    fields = {}
                    for kv in _split_kv(body):
                        if "=" in kv:
                            k, v = kv.split("=", 1)
                            fields[k] = v.strip('"')
                    name = fields.get("ID")
                    if name is None or name in self._dict.values():
                        continue
                    idx = int(fields["IDX"]) if "IDX" in fields else nxt
                    self._dict[idx] = name
                    nxt = max(nxt, idx + 1)
        self._gt_key = None
        for idx, name in self._dict.items():
            if name == "GT":
                self._gt_key = idx
        # contigs with explicit IDX= refer to the IDX dictionary, not
        # appearance order (BCF2 spec 6.2.1; htslib assigns bcf_hdr
        # contig ids from IDX when present): build bcf_rid -> our
        # appearance-order rid
        self._rid_map = None
        idx_of = {}
        appearance = 0
        for line in text.splitlines():
            if not line.startswith("##contig=<"):
                continue
            body = line[len("##contig=<"):].rstrip(">")
            fields = {}
            for kv in _split_kv(body):
                if "=" in kv:
                    k, v = kv.split("=", 1)
                    fields[k] = v.strip('"')
            name = fields.get("ID")
            if name is None:
                continue
            if "IDX" in fields:
                idx_of[int(fields["IDX"])] = appearance
            appearance += 1
        # the spec requires IDX= on all contig lines or none; a partial
        # map would fail at record time with an opaque rid error, so
        # reject it here with the file position of the header
        if idx_of and len(idx_of) != appearance:
            from .errors import CorruptFileError
            raise CorruptFileError(
                self.path, f"header has IDX= on {len(idx_of)} of "
                f"{appearance} ##contig lines (must be all or none)", 0)
        if idx_of and any(k != v for k, v in idx_of.items()):
            self._rid_map = idx_of
        self._n_samples = len(self.header.samples)

    def _map_rid(self, rid: int) -> int:
        if self._rid_map is None:
            return rid
        try:
            return self._rid_map[rid]
        except KeyError:
            raise ValueError(
                f"{self.path}: BCF record rid {rid} has no matching "
                f"##contig IDX= entry") from None

    def sites(self, raw: bool = False) -> Iterator[VcfSite]:
        """raw=True defers simple diploid GT decoding to the fused
        native import step: such sites carry raw_gt = (gt_bytes,
        int_width) and codes=None."""
        scanner = None
        if raw and self._gt_key is not None:
            from ..native import BcfScanner, available
            if available():
                scanner = BcfScanner(self._gt_key)
        while True:
            head = self._s.maybe_read(8)
            if len(head) == 0:
                return
            if len(head) != 8:
                raise ValueError(f"{self.path}: truncated BCF record")
            l_shared, l_indiv = struct.unpack("<II", head)
            shared_b = self._s.read(l_shared)
            indiv_b = self._s.read(l_indiv)
            yield self.parse_record(shared_b, indiv_b, scanner=scanner)

    _BASE_OF = {65: "A", 67: "C", 71: "G", 84: "T"}

    def parse_record(self, shared_b: bytes, indiv_b: bytes,
                     scanner=None) -> VcfSite:
        """One framed BCF record (shared + indiv blocks) -> VcfSite."""
        n_samples = self._n_samples
        if scanner is not None:
            res = scanner.scan(shared_b, indiv_b)
            if res is not None and res[7] == n_samples \
                    and res[5] >= 0:
                rid, pos, n_allele = int(res[0]), int(res[1]), \
                    int(res[2])
                ref = self._BASE_OF.get(int(res[3]))
                alt = self._BASE_OF.get(int(res[4]))
                is_snp = ref is not None and alt is not None
                go, gw = int(res[5]), int(res[6])
                gt = indiv_b[go:go + gw * 2 * n_samples]
                return VcfSite(self._map_rid(rid), pos, ref or "N",
                               alt or ".", None, None, n_allele,
                               is_snp, True, raw_gt=(gt, gw))
        shared = memoryview(shared_b)
        indiv = memoryview(indiv_b)

        (rid, pos, _rlen) = struct.unpack("<iii", shared[:12])
        if pos < 0 or rid < 0:
            raise ValueError(
                f"{self.path}: malformed BCF record (rid={rid}, "
                f"pos={pos})")
        # qual f32 at 12:16
        n_info = struct.unpack("<H", shared[16:18])[0]
        n_allele = struct.unpack("<H", shared[18:20])[0]
        n_sample = struct.unpack("<I", shared[20:24])[0] & 0xFFFFFF
        n_fmt = shared[23]
        off = 24
        off = _skip_typed(shared, off)   # ID string (unused)
        alleles = []
        for _ in range(n_allele):
            a, off = _read_typed_string(shared, off)
            alleles.append(a)
        ref = alleles[0] if alleles else "N"
        alts = alleles[1:] if len(alleles) > 1 else ["."]

        is_snp = len(ref) == 1 and len(alts[0]) == 1 and \
            ref in "ACGT" and alts[0] in "ACGT"
        codes, phase, ploidy_ok = self._parse_gt(
            indiv, n_fmt, n_sample)
        if n_sample != n_samples:
            codes = np.zeros(0, np.uint8)
            phase = np.zeros(0, np.uint8)
            ploidy_ok = False
        return VcfSite(self._map_rid(rid), pos, ref, alts[0], codes,
                       phase, n_allele, is_snp, ploidy_ok)

    def _find_gt(self, indiv: memoryview, n_fmt: int, n_sample: int):
        """Locate a plain diploid int-typed GT vector; returns
        (type, bytes view) or None (caller falls back to full
        decoding)."""
        off = 0
        for _ in range(n_fmt):
            key, off = _read_typed_int(indiv, off)
            t, per_sample, off = _read_typed_desc(indiv, off)
            size = _type_size(t) * per_sample * n_sample
            if key != self._gt_key:
                off += size
                continue
            if t in (1, 2, 3) and per_sample == 2:
                return t, indiv[off:off + size]
            return None
        return None

    def _parse_gt(self, indiv: memoryview, n_fmt: int, n_sample: int):
        empty = (np.zeros(0, np.uint8), np.zeros(0, np.uint8), False)
        off = 0
        for _ in range(n_fmt):
            key, off = _read_typed_int(indiv, off)
            t, per_sample, off = _read_typed_desc(indiv, off)
            size = _type_size(t) * per_sample * n_sample
            if key != self._gt_key:
                off += size
                continue
            if t not in (1, 2, 3):
                return empty
            vals = np.frombuffer(bytes(indiv[off:off + size]),
                                 _TYPE_DTYPE[t]).reshape(n_sample,
                                                         per_sample)
            if per_sample != 2:
                if per_sample == 1:
                    return empty   # haploid: reference drops these sites
                # >2: diploid samples padded with END_OF_VECTOR
                eov = _EOV[_TYPE_SIZE[t]]
                if not np.all(vals[:, 2:] == eov):
                    return empty
                vals = vals[:, :2]
            a, b = vals[:, 0].astype(np.int32), vals[:, 1].astype(np.int32)
            eov = _EOV[_TYPE_SIZE[t]]
            # haploid-in-diploid rows (b == EOV) are non-diploid
            if np.any(b == eov):
                return empty
            # value = (allele + 1) << 1 | phased; allele < 0 => missing
            aa = (a >> 1) - 1
            ab = (b >> 1) - 1
            ca = np.where(aa < 0, 2, np.minimum(aa, 1))
            cb = np.where(ab < 0, 2, np.minimum(ab, 1))
            codes = ((ca << 2) | cb).astype(np.uint8)
            phase = (b & 1).astype(np.uint8)
            return codes, phase, True
        return empty

    def close(self):
        self._s._fh.close()


# ---------------------------------------------------------------------------
# minimal writer (test/tooling support): GT-only BCF2.2, gzip-compressed
# ---------------------------------------------------------------------------

def _typed_string(s: str) -> bytes:
    b = s.encode()
    if len(b) < 15:
        return bytes([(len(b) << 4) | 7]) + b
    return bytes([0xF7]) + _typed_ints([len(b)]) + b


def _typed_ints(vals, force_width: Optional[int] = None) -> bytes:
    vals = list(vals)
    w = force_width
    if w is None:
        lo = min(vals) if vals else 0
        hi = max(vals) if vals else 0
        if -120 <= lo and hi <= 127:
            w = 1
        elif -32000 <= lo and hi <= 32767:
            w = 2
        else:
            w = 4
    t = {1: 1, 2: 2, 4: 3}[w]
    n = len(vals)
    if n < 15:
        head = bytes([(n << 4) | t])
    else:
        head = bytes([0xF0 | t]) + _typed_ints([n])
    dt = {1: np.int8, 2: np.int16, 4: np.int32}[w]
    return head + np.asarray(vals, dt).tobytes()


def write_bcf(path: str, header_text: str, sites, n_samples: int,
              gt_key: int):
    """Write a GT-only BCF2.2 (gzip-compressed). sites yields
    (rid, pos, ref, alt, gt_pairs[n_samples, 2] encoded BCF ints)."""
    out = bytearray()
    text = header_text.encode() + b"\x00"
    out += b"BCF\x02\x02" + struct.pack("<I", len(text)) + text
    for rid, pos, ref, alt, gt in sites:
        shared = bytearray()
        shared += struct.pack("<iii", rid, pos, 1)
        shared += struct.pack("<f", 0.0)
        n_allele = 2 if alt not in (".", "") else 1
        shared += struct.pack("<HH", 0, n_allele)
        shared += struct.pack("<I", n_samples)[:3] + bytes([1])  # n_fmt=1
        shared += _typed_string(".")          # ID
        shared += _typed_string(ref)
        if n_allele > 1:
            shared += _typed_string(alt)
        shared += _typed_ints([])             # FILTER: empty vector
        indiv = bytearray()
        indiv += _typed_ints([gt_key])
        flat = np.asarray(gt, np.int32).reshape(n_samples, 2)
        w = 1 if flat.max(initial=0) <= 127 else 2
        t = {1: 1, 2: 2}[w]
        indiv += bytes([(2 << 4) | t])
        dt = {1: np.int8, 2: np.int16}[w]
        indiv += flat.astype(dt).tobytes()
        out += struct.pack("<II", len(shared), len(indiv))
        out += bytes(shared) + bytes(indiv)
    with gzip.open(path, "wb") as fh:
        fh.write(bytes(out))
