"""`view`: convert .two to human-readable LD text (or filtered .two).

Mirrors the reference view subcommand (reference: lib/view.h): applies
the record filter chain and either prints the tab-separated LD format
(reference: lib/core.cpp:520-526 PrintLD), JSON arrays (core.cpp:528-532
PrintLDJson), or writes a filtered binary .two file. Text emission goes
through the native row formatter (tomahawk_tpu/native twk_format_ld)
with a pure-Python fallback.
"""

import sys
from typing import Optional


from ..io.two import TwoReader, TwoWriter
from .filters import TwoFilter
from .intervals import parse_intervals, interval_mask

LD_HEADER = ("FLAG\tCHROM_A\tPOS_A\tCHROM_B\tPOS_B\tREF_REF\tREF_ALT\t"
             "ALT_REF\tALT_ALT\tD\tDprime\tR\tR2\tP\tChiSqFisher\t"
             "ChiSqModel")


def _fmt(v: float) -> str:
    """C++ ostream default: 6 significant digits."""
    return f"{v:.6g}"


def _python_rows(sel, names, json_out):
    """Fallback formatter (one f-string per record)."""
    pos_a = (sel["packA"] >> 2) + 1
    pos_b = (sel["packB"] >> 2) + 1
    out = []
    for r, pa, pb in zip(sel, pos_a, pos_b):
        cnt = r["cnt"]
        fields = (f"{r['controller']}",
                  f"{r['ridA']}" if json_out
                  else f"{names.get(int(r['ridA']), r['ridA'])}",
                  f"{pa}",
                  f"{r['ridB']}" if json_out
                  else f"{names.get(int(r['ridB']), r['ridB'])}",
                  f"{pb}",
                  _fmt(cnt[0]), _fmt(cnt[1]), _fmt(cnt[2]), _fmt(cnt[3]),
                  _fmt(r['D']), _fmt(r['Dprime']), _fmt(r['R']),
                  _fmt(r['R2']), _fmt(r['P']), _fmt(r['ChiSqFisher']),
                  _fmt(r['ChiSqModel']))
        out.append("[" + ",".join(fields) + "]\n" if json_out
                   else "\t".join(fields) + "\n")
    return "".join(out)


def view(path: str, output: Optional[str] = None,
         filt: Optional[TwoFilter] = None, intervals=None,
         show_header: bool = True, binary: bool = False,
         header_only: bool = False, json_out: bool = False,
         out_stream=None):
    """Stream records; returns number of records emitted."""
    from .. import native
    import os as _os2
    reader = TwoReader(path)
    filt = filt or TwoFilter()
    ivals = parse_intervals(intervals, reader.header) if intervals else None

    n_out = 0
    writer = None
    stream = out_stream or sys.stdout
    if header_only:
        # reference view -h: emit only the stored literal header
        lit = reader.header.literals
        if lit:
            stream.write(lit if lit.endswith("\n") else lit + "\n")
        reader.close()
        return 0
    if binary:
        from ..utils.logging import stamp_literals
        stamp_literals(reader.header, "view", path)
        writer = TwoWriter(output or "-", reader.header)
    else:
        if show_header and not json_out:
            lit = reader.header.literals
            if lit:
                stream.write(lit if lit.endswith("\n") else lit + "\n")
            stream.write(LD_HEADER + "\n")

    names = {c.idx: c.name for c in reader.header.contigs}
    name_list = [names.get(i, str(i))
                 for i in range(max(names, default=-1) + 1)]
    unfiltered = not filt.active() and ivals is None
    from .intervals import interval_block_ids
    block_ids = interval_block_ids(reader, ivals)

    def select(recs):
        if unfiltered:
            return recs
        m = filt.mask(recs)
        if ivals is not None:
            m &= interval_mask(recs, ivals)
        return recs[m]

    if binary:
        for recs in reader.stream_blocks(block_ids, threads=min(4, _os2.cpu_count() or 1)):
            sel = select(recs)
            if len(sel):
                n_out += len(sel)
                writer.add(sel)
        writer.close()
        reader.close()
        return n_out

    use_native = native.available()
    out_buf = getattr(stream, "buffer", None)
    if use_native and out_buf is not None:
        stream.flush()   # keep ordering with the text-layer header write

    def emit(blob_or_text):
        if isinstance(blob_or_text, bytes):
            if out_buf is not None:
                out_buf.write(blob_or_text)
            else:
                stream.write(blob_or_text.decode())
        else:
            stream.write(blob_or_text)

    if use_native:
        # the native formatter releases the GIL: filter+format blocks in
        # a thread pool with a BOUNDED in-flight window (Executor.map
        # would submit every block eagerly and hold the whole
        # decompressed archive in memory), write in order
        import os as _os
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        def fmt(recs):
            sel = select(recs)
            return len(sel), native.format_ld(sel, name_list,
                                              json=json_out)
        n_workers = min(8, _os.cpu_count() or 1)
        if n_workers > 1:
            inflight = deque()
            with ThreadPoolExecutor(n_workers) as pool:
                for recs in reader.stream_blocks(block_ids, threads=min(4, _os2.cpu_count() or 1)):
                    inflight.append(pool.submit(fmt, recs))
                    if len(inflight) >= 2 * n_workers:
                        n_sel, blob = inflight.popleft().result()
                        n_out += n_sel
                        if blob:
                            emit(blob)
                while inflight:
                    n_sel, blob = inflight.popleft().result()
                    n_out += n_sel
                    if blob:
                        emit(blob)
        else:
            for recs in reader.stream_blocks(block_ids, threads=min(4, _os2.cpu_count() or 1)):
                n_sel, blob = fmt(recs)
                n_out += n_sel
                if blob:
                    emit(blob)
    else:
        for recs in reader.stream_blocks(block_ids, threads=min(4, _os2.cpu_count() or 1)):
            sel = select(recs)
            if len(sel):
                n_out += len(sel)
                emit(_python_rows(sel, names, json_out))
    reader.close()
    return n_out
