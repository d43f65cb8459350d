"""VCF -> .twk importer.

Mirrors the reference import pipeline (reference: lib/importer.cpp:25-337,
lib/genotype_encoder.h): per-site filters (duplicate position, diploid,
biallelic, canonical-SNP, missingness, sample count, invariance, HWE),
RLE genotype encoding with minimal word width, per-site allele statistics
and exact HWE p-value, and zstd block flushing at block_size or contig
change boundaries.
"""

import datetime
import struct
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .. import __version__
from ..ops.hwe import hwe_exact
from ..utils import log, pretty_int, Timer
from .constants import BASE_MAP
from .twk import Twk1Record, TwkWriter
from .vcf import VcfReader

FILTER_NAMES = ["Invariant", "Missing threshold", "Insufficient samples",
                "Mixed ploidy", "No genotypes", "No FORMAT",
                "Not biallelic", "Not SNP", "Hardy-Weinberg threshold",
                "Duplicate position"]


@dataclass
class ImportSettings:
    input: str = "-"
    output: str = "-"
    block_size: int = 500
    c_level: int = 1
    threshold_miss: float = 0.9
    hwe: float = 0.0
    remove_univariate: bool = True
    flip_major_minor: bool = False
    # parse worker processes (the reference parallelizes decode with
    # htslib threads, importer.cpp:33): chunks fan out to a process
    # pool running the native chunk parser and results assemble in
    # input order, so the .twk records are identical to a serial run.
    # 0 = auto (cpu_count - 1, min 1); 1 (default) = in-process
    # pipeline. The CLI passes 0, so command-line imports parallelize
    # on multi-core hosts automatically.
    workers: int = 1


@dataclass
class ImportStats:
    n_total: int = 0
    n_kept: int = 0
    n_dropped: int = 0
    filtered: List[int] = field(default_factory=lambda: [0] * 10)


def _choose_rle_width(run_lengths: np.ndarray, miss: bool) -> int:
    """Pick the cheapest RLE word width in bytes (1, 2 or 4), accounting
    for runs that must be split at each width's length limit
    (reference: lib/genotype_encoder.h:138-195 AssessGenotypes)."""
    best_w, best_cost = 1, None
    for w in (1, 2, 4):
        limit = (1 << (8 * w - 2 - 2 * int(miss))) - 1
        n_words = int(np.sum((run_lengths + limit - 1) // limit))
        cost = n_words * w
        if best_cost is None or cost < best_cost:
            best_w, best_cost = w, cost
    return best_w


def rle_encode(codes: np.ndarray, miss: bool):
    """RLE-encode per-sample symbols. Returns (runs, width_bytes).

    Symbols are 2-bit (a<<1|b) without missing, 4-bit (a<<2|b) with.
    Word = length << (2+2*miss) | symbol.
    """
    from ..native import rle_assess, rle_encode as native_rle
    width = rle_assess(codes, miss)
    if width is not None:
        words = native_rle(codes, width, miss)
        if words is not None:
            return words, width

    if not miss:
        # compress 4-bit codes to the 2-bit no-missing space
        syms_all = ((codes >> 2) << 1 | (codes & 0b11)).astype(np.uint32)
    else:
        syms_all = codes.astype(np.uint32)
    # run boundaries
    change = np.flatnonzero(syms_all[1:] != syms_all[:-1]) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [len(syms_all)]))
    lens = (ends - starts).astype(np.int64)
    syms = syms_all[starts]

    width = _choose_rle_width(lens, miss)
    shift = 2 + 2 * int(miss)
    limit = (1 << (8 * width - shift)) - 1

    # split runs longer than limit
    n_words = (lens + limit - 1) // limit
    if np.any(n_words > 1):
        reps = n_words.astype(np.int64)
        syms_r = np.repeat(syms, reps)
        lens_r = np.repeat(lens, reps)
        # position within each run's word group
        cum = np.concatenate(([0], np.cumsum(reps)))[:-1]
        word_idx = np.arange(reps.sum(), dtype=np.int64) - np.repeat(cum, reps)
        remaining = lens_r - word_idx * limit
        lens_out = np.minimum(remaining, limit)
        runs = (lens_out.astype(np.uint64) << shift) | syms_r.astype(np.uint64)
    else:
        runs = (lens.astype(np.uint64) << shift) | syms.astype(np.uint64)
    dt = {1: np.uint8, 2: np.uint16, 4: np.uint32}[width]
    return runs.astype(dt), width


def import_vcf(settings: ImportSettings) -> ImportStats:
    timer = Timer()
    from .bcf import BcfReader, is_bcf
    vcf = (BcfReader(settings.input) if settings.input != "-"
           and is_bcf(settings.input) else VcfReader(settings.input))
    n_samples = vcf.header.n_samples
    log("LOG", f"Samples: {pretty_int(n_samples)}...", sub="VCF")
    if n_samples == 0:
        raise ValueError("no samples in VCF")

    import_literals = (
        f"##tomahawk_tpu_torch_importVersion={__version__}\n"
        f"##tomahawk_tpu_torch_importCommand=import {settings.input}; "
        f"Date={datetime.datetime.now().isoformat()}\n")
    vcf.header.literals += import_literals

    out = settings.output
    if not out.endswith(".twk"):
        out = out + ".twk"

    stats = ImportStats()
    pending: List[Twk1Record] = []   # records awaiting batched HWE
    pending_het: List[int] = []
    pending_hom: List[List[int]] = []

    writer = TwkWriter(out, vcf.header, settings.c_level)
    sink = _BlockSink(writer, settings.block_size)

    prev = (-1, -1, False)  # rid, pos, dropped

    def flush_pending():
        """Compute HWE for queued records, apply the HWE filter, and emit
        them into blocks."""
        nonlocal pending, pending_het, pending_hom
        if not pending:
            return
        het = np.array(pending_het, np.int64)
        homs = np.array(pending_hom, np.int64)
        pv = hwe_exact(het, homs[:, 0], homs[:, 1])
        for rec, p in zip(pending, pv):
            rec.hwe = float(p)
            if p < settings.hwe:
                stats.filtered[8] += 1
                stats.n_dropped += 1
                continue
            sink.add_record(rec)
            stats.n_kept += 1
        pending, pending_het, pending_hom = [], [], []

    encoder = None
    from ..native import SiteEncoder, available as native_ok
    if native_ok():
        encoder = SiteEncoder(n_samples)

    def keep(rec: Twk1Record):
        pending.append(rec)
        pending_het.append(rec.n_het)
        pending_hom.append([rec.n_hom_ref, rec.n_hom])
        if len(pending) >= 8192:
            flush_pending()

    state = {"prev": prev}

    def process_site(site):
        stats.n_total += 1
        # duplicate consecutive site
        prev = state["prev"]
        if site.rid == prev[0] and site.pos == prev[1] and not prev[2]:
            state["prev"] = (site.rid, site.pos, True)
            stats.filtered[9] += 1
            stats.n_dropped += 1
            return
        dropped = True
        if site.codes is not None and len(site.codes) == 0:
            # reference attribution (importer.cpp:273-280): FORMAT
            # without GT -> "No genotypes" [4]; no FORMAT at all ->
            # "No FORMAT" [5]; otherwise a ploidy failure [3]
            if getattr(site, "fmt_state", 0) == 2:
                stats.filtered[5] += 1
            elif getattr(site, "fmt_state", 0) == 1:
                stats.filtered[4] += 1
            else:
                stats.filtered[4 if site.ploidy_ok else 3] += 1
        elif not site.ploidy_ok:
            stats.filtered[3] += 1
        elif site.n_alleles != 2:
            stats.filtered[6] += 1
        elif not site.is_snp:
            stats.filtered[7] += 1
        else:
            if site.codes is None and isinstance(site.raw_gt, tuple):
                rec = _encode_bcf_fused(site, encoder, n_samples,
                                        settings, stats)
            elif site.codes is None:
                rec = _encode_site_fused(site, encoder, n_samples,
                                         settings, stats)
            elif encoder is not None:
                res = encoder.encode_codes(site.codes, site.phase)
                rec = _finish_fused(site, res, encoder, n_samples,
                                    settings, stats)
            else:
                rec = _encode_site(site, n_samples, settings, stats)
            if rec is not None:
                dropped = False
                keep(rec)
        if dropped:
            stats.n_dropped += 1
        state["prev"] = (site.rid, site.pos, dropped)

    from .bcf import BcfReader as _BcfReader
    if encoder is not None and type(vcf) is VcfReader \
            and settings.input != "-":
        _import_body_chunked(vcf, settings, stats, n_samples,
                             process_site, state,
                             sink, flush_pending)
    elif encoder is not None and type(vcf) is _BcfReader \
            and vcf._gt_key is not None:
        _import_bcf_chunked(vcf, settings, stats, n_samples,
                            process_site, state,
                            sink, flush_pending)
    else:
        site_iter = (vcf.sites(raw=True) if encoder is not None
                     else vcf.sites())
        for site in site_iter:
            process_site(site)

    flush_pending()
    sink.flush_block()
    writer.close()
    vcf.close()

    log("LOG", f"Wrote: {pretty_int(stats.n_kept)} variants to "
        f"{pretty_int(writer.index.n)} blocks...")
    log("LOG", f"Finished: {timer.elapsed_string()}")
    log("LOG", f"Filtered out {pretty_int(stats.n_dropped)} sites:")
    for name, cnt in zip(FILTER_NAMES, stats.filtered):
        if cnt:
            log("LOG", f"   {name}: {pretty_int(cnt)}")
    return stats


_CHUNK_BYTES = 1 << 22   # bulk-import read size (patched in tests)


def _resolve_workers(settings) -> int:
    import os
    w = getattr(settings, "workers", 1)
    return w if w > 0 else max(1, (os.cpu_count() or 1) - 1)


# -- process-pool parse workers ---------------------------------------------
# The native chunk parse is the import's compute core; with workers > 1
# newline-/record-aligned chunks fan out to a spawn pool (safe while a
# TPU client is live in the parent) and span results assemble strictly
# in input order, so the output .twk is byte-identical to a serial run
# (reference analogue: htslib's decode thread pool, importer.cpp:33).

_POOL_CI = None


def _pool_init(n_samples: int):
    global _POOL_CI
    from ..native import ChunkImporter
    _POOL_CI = ChunkImporter(n_samples)


def _span_copy(meta, runs, n: int, off: int):
    """Pickle-sized copy of one parse result: meta rows + the used
    prefix of the runs buffer (row offsets stay valid)."""
    mm = meta[:n].copy()
    end = 0
    ok = mm[:, 3] == 0
    if ok.any():
        rows = mm[ok]
        end = int((rows[:, 10] + rows[:, 9] * rows[:, 6]).max())
    return off, n, mm, runs[:end].copy()


def _pool_parse_vcf(chunk: bytes):
    out = []
    off = 0
    while off < len(chunk):
        n, meta, runs, consumed = _POOL_CI.parse(chunk[off:])
        if n == 0 and consumed == 0:
            break
        out.append(_span_copy(meta, runs, n, off))
        if consumed <= 0:
            break
        off += consumed
    return out


def _pool_parse_bcf(chunk: bytes, gt_key: int):
    out = []
    off = 0
    while off < len(chunk):
        n, meta, runs, consumed = _POOL_CI.parse_bcf(chunk[off:], gt_key)
        if n == 0 and consumed == 0:
            break
        out.append(_span_copy(meta, runs, n, off))
        if consumed <= 0:
            break
        off += consumed
    return out


def _parallel_chunks(pool, chunks_iter, fn, in_flight: int, *args):
    """Submit chunks keeping `in_flight` outstanding; yield
    (chunk, spans) strictly in input order (assembly is order-dependent:
    block cuts, the duplicate-position filter, and record layout)."""
    from collections import deque
    q = deque()
    for chunk in chunks_iter:
        q.append((chunk, pool.submit(fn, chunk, *args)))
        while len(q) > in_flight:
            c, f = q.popleft()
            yield c, f.result()
    while q:
        c, f = q.popleft()
        yield c, f.result()


def _make_pool(n_workers: int, n_samples: int):
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(n_workers,
                               mp_context=mp.get_context("spawn"),
                               initializer=_pool_init,
                               initargs=(n_samples,))


def _frame_bcf(buf: bytes) -> int:
    """Byte length of the complete-record prefix of `buf` (each BCF
    record is framed by its l_shared/l_indiv header)."""
    off = 0
    n = len(buf)
    while off + 8 <= n:
        l_shared, l_indiv = struct.unpack_from("<II", buf, off)
        end = off + 8 + int(l_shared) + int(l_indiv)
        if end > n:
            break
        off = end
    return off


class _BlockSink:
    """Accumulates serialized record bytes into .twk blocks, applying
    the reference's block-cut rules: flush at block_size records or at
    a contig change, minpos/maxpos from the first/last record
    (reference: lib/importer.cpp:227-260). Accepts either one
    Twk1Record (slow path) or a pre-packed span of records (bulk
    native path) — both paths share one partial-block state so output
    order is exactly input order."""

    def __init__(self, writer: TwkWriter, block_size: int):
        self.writer = writer
        self.block_size = block_size
        self.parts: List[bytes] = []
        self.n = 0
        self.rid = -1
        self.minpos = 0
        self.maxpos = 0

    def room(self, rid: int) -> int:
        """Records that still fit the current block for this rid."""
        if self.n and self.rid == rid and self.n < self.block_size:
            return self.block_size - self.n
        return self.block_size

    def add_bytes(self, rid: int, first_pos: int, last_pos: int,
                  n: int, data: bytes):
        if self.n and (rid != self.rid or self.n >= self.block_size):
            self.flush_block()
        if self.n == 0:
            self.rid = rid
            self.minpos = first_pos + 1
        self.maxpos = last_pos + 1  # right non-inclusive
        self.parts.append(data)
        self.n += n

    def add_record(self, rec: Twk1Record):
        from .buffer import BufferWriter
        w = BufferWriter()
        rec.write(w)
        self.add_bytes(rec.rid, rec.pos, rec.pos, 1, w.getvalue())

    def flush_block(self):
        if self.n == 0:
            return
        payload = struct.pack("<III", self.n, max(self.n, 1),
                              self.rid) + b"".join(self.parts)
        self.writer.write_payload(self.rid, self.n, self.minpos,
                                  self.maxpos, payload)
        self.parts, self.n = [], 0


def _make_batch_sites(vcf, settings: ImportSettings, stats: ImportStats,
                      n_samples: int, state, sink: _BlockSink,
                      flush_pending):
    """Vectorized fast path for the bulk importers: one call filters,
    HWE-tests, natively serializes, and block-emits a whole span of
    parsed sites from the native meta matrix. The per-site semantics
    are exactly _make_fast_site's (dup > biallelic > SNP > missingness
    > sample count > invariant, then HWE; reference
    lib/importer.cpp:104-190), but as numpy masks plus one
    twk_pack_records call per block span instead of a Python loop."""
    from ..native import pack_records

    rid_cache = {}
    thresh_full = settings.threshold_miss * n_samples

    def rids_for(mm, chunk):
        """Contig id per row from the chrom column bytes: rows are
        compared to their predecessor with one vectorized byte-matrix
        diff, so name lookups run once per contig change."""
        n = len(mm)
        offs, lens = mm[:, 1], mm[:, 2]
        mx = int(lens.max())
        arr = np.frombuffer(chunk, np.uint8)
        idx = offs[:, None] + np.arange(mx)
        np.minimum(idx, len(chunk) - 1, out=idx)
        g = np.where(np.arange(mx) < lens[:, None], arr[idx], 0)
        change = np.empty(n, bool)
        change[0] = True
        if n > 1:
            change[1:] = (lens[1:] != lens[:-1]) \
                | (g[1:] != g[:-1]).any(axis=1)
        rids = np.empty(n, np.int64)
        cuts = np.flatnonzero(change).tolist() + [n]
        for s, e in zip(cuts[:-1], cuts[1:]):
            name = bytes(chunk[int(offs[s]):int(offs[s]) + int(lens[s])])
            rid = rid_cache.get(name)
            if rid is None:
                rid = vcf._rid_for(name.decode())
                rid_cache[name] = rid
            rids[s:e] = rid
        return rids

    def batch(meta, lo, hi, chunk, runs_buf, rids=None):
        """Process meta rows [lo, hi) — all pre-screened as native-ok
        (status 0/3/4, no flip re-feeds)."""
        n = hi - lo
        if n <= 0:
            return
        flush_pending()   # keep global record order with the slow path
        stats.n_total += n
        rows = np.arange(lo, hi)
        mm = meta[lo:hi]
        pos, status, n_full = mm[:, 0], mm[:, 3], mm[:, 18]
        if rids is None:
            rids = rids_for(mm, chunk)

        # per-site drop reasons, in fast_site's precedence order
        s3, s4 = status == 3, status == 4
        miss_m = ~s3 & ~s4 & (n_full < thresh_full)
        lt5 = ~s3 & ~s4 & ~miss_m & (n_full < 5)
        univ = np.zeros(n, bool)
        if settings.remove_univariate:
            univ = ~s3 & ~s4 & ~miss_m & ~lt5 & (
                (mm[:, 11] == n_full) | (mm[:, 12] == n_full)
                | (mm[:, 13] == n_full) | (mm[:, 14] == n_full))
        own_drop = s3 | s4 | miss_m | lt5 | univ

        # duplicate-consecutive-position filter: drop iff same (rid,
        # pos) as the previous site AND that site was not dropped --
        # sequential, but only rows with a position-equal predecessor
        # need the scalar resolution (rare)
        prid, ppos, pdrop = state["prev"]
        eq = np.empty(n, bool)
        eq[0] = (int(rids[0]) == prid) and (int(pos[0]) == ppos)
        eq[1:] = (rids[1:] == rids[:-1]) & (pos[1:] == pos[:-1])
        dropped = own_drop.copy()
        dup = np.zeros(n, bool)
        for i in np.flatnonzero(eq):
            if not (pdrop if i == 0 else dropped[i - 1]):
                dup[i] = True
                dropped[i] = True
        state["prev"] = (int(rids[-1]), int(pos[-1]), bool(dropped[-1]))

        stats.filtered[9] += int(dup.sum())
        rem = ~dup
        for f_idx, mask in ((6, s3), (7, s4), (1, miss_m), (2, lt5),
                            (0, univ)):
            stats.filtered[f_idx] += int((rem & mask).sum())
        kept = rem & ~own_drop
        kidx = np.flatnonzero(kept)
        stats.n_dropped += n - len(kidx)
        if not len(kidx):
            return

        pv = hwe_exact(mm[kidx, 12] + mm[kidx, 13], mm[kidx, 11],
                       mm[kidx, 14])
        if settings.hwe > 0:
            ok = pv >= settings.hwe
            n_bad = len(kidx) - int(ok.sum())
            stats.filtered[8] += n_bad
            stats.n_dropped += n_bad
            kidx, pv = kidx[ok], pv[ok]
            if not len(kidx):
                return
        stats.n_kept += len(kidx)

        krids, kpos = rids[kidx], pos[kidx]
        cuts = (np.flatnonzero(np.diff(krids)) + 1).tolist()
        for s, e in zip([0] + cuts, cuts + [len(kidx)]):
            rid0 = int(krids[s])
            i = s
            while i < e:
                j = min(e, i + sink.room(rid0))
                data = pack_records(meta, rows[kidx[i:j]],
                                    krids[i:j], pv[i:j], runs_buf)
                sink.add_bytes(rid0, int(kpos[i]), int(kpos[j - 1]),
                               j - i, data)
                i = j

    return batch


def _import_body_chunked(vcf, settings: ImportSettings,
                         stats: ImportStats, n_samples: int,
                         process_site, state,
                         sink=None, flush_pending=None):
    """Bulk import loop: the whole VCF body streams through
    twk_import_chunk (one native call per ~4 MB of text does column
    parsing, GT decode, stats, and RLE for every line), and Python only
    applies filters and assembles records for kept sites. Lines the
    native parser cannot classify (no GT FORMAT, unparsable genotypes,
    malformed) are re-fed through the exact single-site path."""
    import gzip

    from ..native import ChunkImporter, native_gzip_open

    path = settings.input
    if path.endswith((".gz", ".bgz")):
        fh = native_gzip_open(path) or gzip.open(path, "rb")
    else:
        fh = open(path, "rb")
    for line in fh:
        if line.startswith(b"#CHROM"):
            break

    ci = ChunkImporter(n_samples)
    batch = _make_batch_sites(vcf, settings, stats, n_samples, state,
                              sink, flush_pending)

    # Pipelined chunking: chunks are cut at newline boundaries so they
    # parse independently; while Python assembles chunk k (GIL-bound),
    # a worker thread runs the GIL-releasing native parse of chunk k+1
    # on a second ChunkImporter. Sites whose runs spill the per-call
    # buffer (consumed < len) are re-fed synchronously.
    from concurrent.futures import ThreadPoolExecutor

    ci2 = ChunkImporter(n_samples)
    tail = b""
    eof = False

    def next_chunk():
        nonlocal tail, eof
        while not eof:
            data = fh.read(_CHUNK_BYTES)
            if not data:
                eof = True
                break
            buf = tail + data
            cut = buf.rfind(b"\n") + 1
            tail = buf[cut:]
            if cut:
                return buf[:cut]
        if tail:
            t = tail if tail.endswith(b"\n") else tail + b"\n"
            tail = b""
            return t
        return None

    def handle(chunk, parsed):
        nonlocal lineno
        n, meta, runs_buf, consumed = parsed
        if n == 0:
            return consumed
        st = meta[:n, 3]
        # rows the vectorized path cannot take: parser fallbacks
        # (status 1/2/5, bad position) and major/minor flip re-feeds
        bad = (st == 1) | (st == 2) | (st == 5) | (meta[:n, 0] < 0)
        if settings.flip_major_minor:
            bad |= (st == 0) & (meta[:n, 16] > meta[:n, 17])
        prev_end = 0
        for b in np.flatnonzero(bad).tolist():
            batch(meta, prev_end, b, chunk, runs_buf)
            # exact-path fallback (raises on truly malformed input)
            line = _line_at(chunk, int(meta[b, 1]))
            site = vcf.parse_line(line.decode(), lineno + b + 1,
                                  raw=False)
            if site is not None:
                process_site(site)
            prev_end = b + 1
        batch(meta, prev_end, n, chunk, runs_buf)
        lineno += n
        return consumed

    lineno = 0
    n_workers = _resolve_workers(settings)
    if n_workers > 1:
        pool_p = _make_pool(n_workers, n_samples)
        try:
            def chunks():
                while True:
                    c = next_chunk()
                    if c is None:
                        return
                    yield c
            for chunk, spans in _parallel_chunks(
                    pool_p, chunks(), _pool_parse_vcf, n_workers + 2):
                for off, n, meta, runs in spans:
                    handle(chunk[off:], (n, meta, runs,
                                         len(chunk) - off))
        finally:
            pool_p.shutdown()
            fh.close()
        return
    pool = ThreadPoolExecutor(1)
    try:
        cur = next_chunk()
        cur_imp = ci
        fut = pool.submit(cur_imp.parse, cur) if cur is not None else None
        while fut is not None:
            nxt = next_chunk()
            nxt_imp = ci2 if cur_imp is ci else ci
            nxt_fut = (pool.submit(nxt_imp.parse, nxt)
                       if nxt is not None else None)
            parsed = fut.result()
            consumed = handle(cur, parsed)
            # runs-buffer spill: re-feed the unconsumed lines now, on
            # the importer the worker is NOT using
            while consumed < len(cur):
                cur = cur[consumed:]
                consumed = handle(cur, cur_imp.parse(cur))
            cur, cur_imp, fut = nxt, nxt_imp, nxt_fut
    finally:
        pool.shutdown()
        fh.close()


def _import_bcf_chunked(vcf, settings: ImportSettings,
                        stats: ImportStats, n_samples: int,
                        process_site, state,
                        sink=None, flush_pending=None):
    """Bulk BCF import loop: framed records stream through
    twk_bcf_import_chunk; unsupported layouts re-feed through the exact
    single-record path (BcfReader.parse_record)."""
    from ..native import ChunkImporter

    ci = ChunkImporter(n_samples)
    batch = _make_batch_sites(vcf, settings, stats, n_samples, state,
                              sink, flush_pending)
    gt_key = vcf._gt_key
    fh = vcf._s._fh   # decompressed stream, positioned at the body
    # ##contig IDX= dictionary remap for the bulk path: parse_record
    # applies _map_rid per record, but the chunked meta rows carry RAW
    # BCF rids and must remap the same way or records land on the
    # wrong contig
    rid_lut = None
    if vcf._rid_map is not None:
        rid_lut = np.full(max(vcf._rid_map) + 1, -1, np.int64)
        for bcf_rid, ours in vcf._rid_map.items():
            rid_lut[bcf_rid] = ours

    def map_rids(raw):
        if rid_lut is None:
            return raw
        if (raw >= len(rid_lut)).any() or (rid_lut[raw] < 0).any():
            raise ValueError(
                f"{vcf.path}: BCF record rid without a matching "
                f"##contig IDX= entry")
        return rid_lut[raw]

    def record_site(chunk, m):
        """Exact-path fallback from raw record bytes. Status 2/5 rows
        carry (offset, -length) in m[1:3]; ok-status rows store the
        offset as m[2] = -2 - off."""
        if int(m[3]) == 0 and int(m[2]) <= -2:
            off = -2 - int(m[2])
        else:
            off = int(m[1])
        l_shared, l_indiv = struct.unpack("<II", chunk[off:off + 8])
        rec = chunk[off + 8:off + 8 + l_shared + l_indiv]
        return vcf.parse_record(rec[:l_shared], rec[l_shared:])

    def handle(chunk, parsed=None):
        n, meta, runs_buf, consumed = (
            parsed if parsed is not None else ci.parse_bcf(chunk, gt_key))
        if n == 0:
            return consumed
        st = meta[:n, 3]
        bad = (st == 2) | (st == 5) | (meta[:n, 0] < 0) \
            | (meta[:n, 1] < 0)
        if settings.flip_major_minor:
            bad |= (st == 0) & (meta[:n, 16] > meta[:n, 17])
        prev_end = 0
        for b in np.flatnonzero(bad).tolist():
            batch(meta, prev_end, b, chunk, runs_buf,
                  rids=map_rids(meta[prev_end:b, 1]))
            site = record_site(chunk, meta[b])
            if site is not None:
                process_site(site)
            prev_end = b + 1
        batch(meta, prev_end, n, chunk, runs_buf,
              rids=map_rids(meta[prev_end:n, 1]))
        return consumed

    n_workers = _resolve_workers(settings)
    if n_workers > 1:
        pool_p = _make_pool(n_workers, n_samples)
        try:
            def chunks():
                carry = b""
                while True:
                    data = fh.read(_CHUNK_BYTES)
                    buf = carry + data
                    if not buf:
                        return
                    cut = _frame_bcf(buf)
                    if cut == 0:
                        if not data:
                            raise ValueError(
                                f"{settings.input}: truncated trailing "
                                "BCF record")
                        carry = buf
                        continue
                    carry = buf[cut:]
                    yield buf[:cut]
            for chunk, spans in _parallel_chunks(
                    pool_p, chunks(), _pool_parse_bcf, n_workers + 2,
                    gt_key):
                for off, n, meta, runs in spans:
                    handle(chunk[off:], (n, meta, runs,
                                         len(chunk) - off))
        finally:
            pool_p.shutdown()
        return
    carry = b""
    while True:
        data = fh.read(_CHUNK_BYTES)
        chunk = carry + data
        if not chunk:
            break
        consumed = handle(chunk)
        # drain the backlog before reading more (small records can pack
        # far more than max_sites into one read; without this the carry
        # grows toward the whole file with quadratic copying)
        while consumed < len(chunk) and consumed > 0:
            chunk = chunk[consumed:]
            consumed = handle(chunk)
        if consumed == 0:
            if not data:
                if chunk:
                    raise ValueError(f"{settings.input}: truncated "
                                     "trailing BCF record")
                break
            carry = chunk          # partial record: need more bytes
            continue
        carry = b""
        if not data:
            break


def _line_at(chunk, start: int) -> bytes:
    end = chunk.index(b"\n", start)
    return chunk[start:end]


def _encode_site(site, n_samples: int, settings: ImportSettings,
                 stats: ImportStats) -> Optional[Twk1Record]:
    from ..native import code_stats
    codes = site.codes
    st = code_stats(codes)
    if st is not None:
        (n_refref, n_refalt, n_altref, n_altalt, n_missing_alleles,
         n_alt, n_ref, n_full) = (int(x) for x in st)
        ca = cb = None
    else:
        ca, cb = codes >> 2, codes & 0b11
        n_missing_alleles = int(np.sum(ca == 2) + np.sum(cb == 2))
        full = (ca != 2) & (cb != 2)
        n_full = int(full.sum())
        fa, fb = ca[full], cb[full]
        n_refref = int(np.sum((fa == 0) & (fb == 0)))
        n_refalt = int(np.sum((fa == 0) & (fb == 1)))
        n_altref = int(np.sum((fa == 1) & (fb == 0)))
        n_altalt = int(np.sum((fa == 1) & (fb == 1)))
        n_alt = int(np.sum(ca == 1) + np.sum(cb == 1))
        n_ref = int(np.sum(ca == 0) + np.sum(cb == 0))

    # missingness / sample-count filters
    if n_full < settings.threshold_miss * n_samples:
        stats.filtered[1] += 1
        return None
    if n_full < 5:
        stats.filtered[2] += 1
        return None

    if settings.remove_univariate:
        if n_refref == n_full or n_refalt == n_full or \
           n_altref == n_full or n_altalt == n_full:
            stats.filtered[0] += 1
            return None

    flip = settings.flip_major_minor and (n_alt > n_ref)
    if flip:
        # swap ref<->alt codes (missing unchanged)
        if ca is None:
            ca, cb = codes >> 2, codes & 0b11
        ca = np.where(ca == 0, np.uint8(1), np.where(ca == 1, np.uint8(0), ca))
        cb = np.where(cb == 0, np.uint8(1), np.where(cb == 1, np.uint8(0), cb))
        codes = (ca << 2) | cb
        n_alt = n_ref

    miss = n_missing_alleles > 0
    runs, width = rle_encode(codes, miss)

    phase_known = (codes & 0b11) != 2
    if np.any(phase_known):
        ph = site.phase[phase_known]
        mixed = bool(np.any(ph != ph[0]))
        gt_phase = False if mixed else bool(ph[0])
    else:
        gt_phase = False

    rec = Twk1Record(
        pos=site.pos, rid=site.rid, ac=n_alt, an=n_missing_alleles,
        n_het=n_refalt + n_altref, n_hom=n_altalt,
        alleles=(BASE_MAP.get(site.ref, 0) << 4) | BASE_MAP.get(site.alt, 0),
        gt_ptype=width, gt_flipped=flip, gt_phase=gt_phase,
        gt_missing=miss, gt_runs=runs)
    # auxiliary count used only for the batched HWE computation
    rec.n_hom_ref = n_refref
    return rec


def _encode_site_fused(site, encoder, n_samples: int,
                       settings: ImportSettings,
                       stats: ImportStats) -> Optional[Twk1Record]:
    """Fast-path site encoding: one native call does GT parsing, code
    stats, RLE width choice and encoding (twk_native.cpp
    twk_encode_site). Parse failures and the rare major/minor flip fall
    back to the python path for exact filter semantics."""
    res = encoder.encode(site.raw_gt.encode())
    if res is None or isinstance(res, int):
        from .vcf import _parse_gt_fields
        codes, phase, ploidy_ok = _parse_gt_fields(
            site.raw_gt.split("\t"), n_samples)
        if len(codes) == 0 or not ploidy_ok:
            stats.filtered[3] += 1
            return None
        site.codes, site.phase, site.ploidy_ok = codes, phase, True
        return _encode_site(site, n_samples, settings, stats)
    return _finish_fused(site, res, encoder, n_samples, settings, stats)


def _finish_fused(site, res, encoder, n_samples: int,
                  settings: ImportSettings,
                  stats: ImportStats) -> Optional[Twk1Record]:
    """Filters + record assembly from a fused native encode result."""
    if res is None or isinstance(res, int):
        # runs-capacity overflow cannot happen (cap = 2N + 16); treat
        # any failure as a python-path fallback
        return _encode_site(site, n_samples, settings, stats)
    codes, st, width, phase_state, miss, runs = res
    (n_refref, n_refalt, n_altref, n_altalt, n_missing_alleles,
     n_alt, n_ref, n_full) = (int(x) for x in st)

    if n_full < settings.threshold_miss * n_samples:
        stats.filtered[1] += 1
        return None
    if n_full < 5:
        stats.filtered[2] += 1
        return None
    if settings.remove_univariate:
        if n_refref == n_full or n_refalt == n_full or \
           n_altref == n_full or n_altalt == n_full:
            stats.filtered[0] += 1
            return None
    if settings.flip_major_minor and n_alt > n_ref:
        # rare path: reuse the parsed codes through the python encoder
        site.codes = codes.copy()
        if site.phase is None:      # VCF deferred path: scratch holds it
            site.phase = encoder.phase.copy()
        site.ploidy_ok = True
        return _encode_site(site, n_samples, settings, stats)

    rec = Twk1Record(
        pos=site.pos, rid=site.rid, ac=n_alt, an=n_missing_alleles,
        n_het=n_refalt + n_altref, n_hom=n_altalt,
        alleles=(BASE_MAP.get(site.ref, 0) << 4) | BASE_MAP.get(site.alt, 0),
        gt_ptype=width, gt_flipped=False, gt_phase=phase_state == 1,
        gt_missing=miss, gt_runs=runs)
    rec.n_hom_ref = n_refref
    return rec


_BCF_GT_DT = {1: np.int8, 2: np.int16, 4: np.int32}


def _encode_bcf_fused(site, encoder, n_samples: int,
                      settings: ImportSettings,
                      stats: ImportStats) -> Optional[Twk1Record]:
    """BCF fast path: native GT-pair conversion into the encoder's
    scratch buffers, then the fused stats + RLE call."""
    gt_bytes, width = site.raw_gt
    vals = np.frombuffer(gt_bytes, _BCF_GT_DT[width]).reshape(-1, 2)
    if not encoder.bcf_gt(vals, width):
        stats.filtered[3] += 1        # haploid-in-diploid rows
        return None
    return _finish_fused(site, encoder.encode_codes(), encoder,
                         n_samples, settings, stats)
