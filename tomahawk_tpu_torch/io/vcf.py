"""Minimal self-contained VCF parser (text / gzip).

Native equivalent of the reference's htslib VcfReader boundary
(reference: lib/vcf_reader.h). Only what the importer needs is parsed:
header metadata (contigs, samples, raw literals) and per-site
CHROM/POS/REF/ALT + diploid GT matrices.

Genotype codes follow the reference convention
(reference: lib/genotype_encoder.h:11-14 TWK_GT_MAP): 0 = ref, 1 = alt,
2 = missing. A site's per-sample symbol is (codeA << 2) | codeB.
"""

import gzip
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .header import VcfContig, VcfHeader


def _open_text(path: str):
    if path == "-":    # stdin, like htslib's hts_open("-")
        import sys
        return sys.stdin
    if path.endswith(".gz") or path.endswith(".bgz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


@dataclass
class VcfSite:
    rid: int
    pos: int            # 0-based
    ref: str
    alt: str
    codes: np.ndarray   # uint8 per sample: (codeA<<2)|codeB, code 2=missing
    phase: np.ndarray   # uint8 per sample: 1 = '|' separator
    n_alleles: int
    is_snp: bool
    ploidy_ok: bool
    # raw GT column blob when parsing is deferred to the fused native
    # import step (sites(raw=True)); codes is None in that case
    raw_gt: str = None
    # filter attribution when the line carries no genotypes
    # (reference: importer.cpp:273-280): 0 = GT present,
    # 1 = FORMAT without leading GT ("No genotypes"),
    # 2 = no FORMAT column at all ("No FORMAT")
    fmt_state: int = 0


class VcfReader:
    def __init__(self, path: str):
        self.path = path
        self._fh = _open_text(path)
        self.header = VcfHeader()
        self._contig_map = {}
        self._parse_header()

    def _parse_header(self):
        literals = []
        contig_idx = 0
        for line in self._fh:
            line = line.rstrip("\n")
            if line.startswith("##"):
                literals.append(line)
                if line.startswith("##fileformat="):
                    self.header.fileformat = line.split("=", 1)[1]
                elif line.startswith("##contig=<"):
                    body = line[len("##contig=<"):].rstrip(">")
                    fields = {}
                    for kv in _split_header_fields(body):
                        if "=" in kv:
                            k, v = kv.split("=", 1)
                            fields[k] = v.strip('"')
                    c = VcfContig(idx=contig_idx,
                                  name=fields.get("ID", str(contig_idx)),
                                  n_bases=int(fields.get("length", 0)))
                    c.extra = [(k, v) for k, v in fields.items()
                               if k not in ("ID", "length")]
                    self.header.contigs.append(c)
                    self._contig_map[c.name] = contig_idx
                    contig_idx += 1
            elif line.startswith("#CHROM"):
                cols = line.split("\t")
                self.header.samples = cols[9:]
                break
            else:
                raise ValueError(f"malformed VCF header line: {line[:80]}")
        self.header.literals = "\n".join(literals) + ("\n" if literals else "")

    def _rid_for(self, chrom: str) -> int:
        rid = self._contig_map.get(chrom)
        if rid is None:
            # contig not declared in header: append implicitly
            rid = len(self.header.contigs)
            self.header.contigs.append(VcfContig(idx=rid, name=chrom))
            self._contig_map[chrom] = rid
        return rid

    def parse_line(self, line: str, lineno: int = 0,
                   raw: bool = False) -> Optional[VcfSite]:
        """One VCF body line -> VcfSite (None for blank lines)."""
        from ..native import parse_gt_line as native_gt
        from ..native import available as native_ok
        if not line or line == "\n":
            return None
        n_samples = self.header.n_samples
        # limited split: the sample columns stay one blob for the
        # native parser (twk_native.cpp twk_parse_gt_line)
        fields = line.rstrip("\n").split("\t", 9)
        if len(fields) < 8:
            raise ValueError(
                f"{self.path}: malformed VCF body line {lineno}: "
                f"expected >=8 tab-separated fields, got {len(fields)}")
        chrom, pos, _id, ref, alt = fields[0], fields[1], fields[2], \
            fields[3], fields[4]
        alts = alt.split(",")
        n_alleles = 1 + len(alts)
        fmt = fields[8] if len(fields) > 8 else ""
        if not (fmt == "GT" or fmt.startswith("GT:")):
            return VcfSite(self._rid_for(chrom), int(pos) - 1, ref,
                           alts[0], np.zeros(0, np.uint8),
                           np.zeros(0, np.uint8), n_alleles, False, False,
                           fmt_state=2 if fmt == "" else 1)
        is_snp = len(ref) == 1 and len(alts[0]) == 1 and \
            ref in "ACGT" and alts[0] in "ACGT"
        if raw and len(fields) > 9:
            # defer GT parsing to the fused native import step
            return VcfSite(self._rid_for(chrom), int(pos) - 1, ref,
                           alts[0], None, None, n_alleles, is_snp,
                           True, raw_gt=fields[9])
        parsed = None
        if native_ok() and len(fields) > 9:
            parsed = native_gt(fields[9].encode(), n_samples, gt_col=0)
        if parsed is not None:
            codes, phase, ploidy_ok = parsed[0], parsed[1], True
        else:
            codes, phase, ploidy_ok = _parse_gt_fields(
                fields[9].split("\t") if len(fields) > 9 else [],
                n_samples)
        return VcfSite(self._rid_for(chrom), int(pos) - 1, ref, alts[0],
                       codes, phase, n_alleles, is_snp, ploidy_ok)

    def sites(self, raw: bool = False) -> Iterator[VcfSite]:
        for lineno, line in enumerate(self._fh, 1):
            site = self.parse_line(line, lineno, raw=raw)
            if site is not None:
                yield site

    def close(self):
        import sys
        if self._fh is not sys.stdin:
            self._fh.close()


def _split_header_fields(body: str) -> List[str]:
    """Split 'a=1,b="x,y"' on commas outside quotes."""
    out, cur, inq = [], [], False
    for ch in body:
        if ch == '"':
            inq = not inq
            cur.append(ch)
        elif ch == "," and not inq:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


# byte-level lookup: allele char -> code (0 ref, 1..N alt index, 2 missing)
_ALLELE_CODE = np.full(256, 255, np.uint8)
_ALLELE_CODE[ord(".")] = 2
for _d in range(10):
    _ALLELE_CODE[ord("0") + _d] = min(_d, 1) if _d <= 1 else 255
# alleles >1 are multi-allelic; such sites are filtered before import,
# but mark chars 2-9 distinctly so ploidy_ok logic can still pass
for _d in range(2, 10):
    _ALLELE_CODE[ord("0") + _d] = 1  # collapsed; sites with n_allele>2 dropped

_SEP_PHASE = np.zeros(256, np.uint8)
_SEP_PHASE[ord("|")] = 1
_SEP_OK = np.zeros(256, np.bool_)
_SEP_OK[ord("|")] = True
_SEP_OK[ord("/")] = True


def _parse_gt_fields(gts: List[str], n_samples: int
                     ) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Parse diploid single-char-allele GT fields.

    Fast path assumes every sample's GT subfield is exactly 3 chars
    ('a|b' / 'a/b' / './.'); falls back to a tolerant per-sample parse
    otherwise. Returns (codes[(cA<<2)|cB], phase_bits, ploidy_ok).
    """
    if len(gts) != n_samples:
        return np.zeros(0, np.uint8), np.zeros(0, np.uint8), False
    arr = np.frombuffer(
        np.array(gts, dtype="S3").tobytes(), np.uint8).reshape(-1, 3)
    a, sep, b = arr[:, 0], arr[:, 1], arr[:, 2]
    ok = _SEP_OK[sep]
    ca = _ALLELE_CODE[a]
    cb = _ALLELE_CODE[b]
    if bool(np.all(ok & (ca != 255) & (cb != 255))):
        return (ca << 2) | cb, _SEP_PHASE[sep], True

    # tolerant path (haploid, multi-char alleles, etc.)
    codes = np.zeros(n_samples, np.uint8)
    phase = np.zeros(n_samples, np.uint8)
    for i, f in enumerate(gts):
        gt = f.split(":", 1)[0]
        if "|" in gt:
            parts = gt.split("|")
            phase[i] = 1
        elif "/" in gt:
            parts = gt.split("/")
        else:
            return np.zeros(0, np.uint8), np.zeros(0, np.uint8), False
        if len(parts) != 2:
            return np.zeros(0, np.uint8), np.zeros(0, np.uint8), False
        cs = []
        for p in parts:
            if p == "." or p == "":
                cs.append(2)
            else:
                try:
                    cs.append(min(int(p), 1))
                except ValueError:
                    return (np.zeros(0, np.uint8), np.zeros(0, np.uint8),
                            False)
        codes[i] = (cs[0] << 2) | cs[1]
    return codes, phase, True
