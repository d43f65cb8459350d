"""The port's archive inflation (tomahawk_tpu_torch/ops/inflate.py and
inflate.cpp): a super-block's .twk frames decompressed and decoded by
one native call into the load's stacked planes, on the CPU.

- The stacked arrays equal `bitpack.stack_planes([bitpack.block_to_planes(
  blk, n, pad_to=B) ...])` bit for bit, key by key, dtype too: archives of
  both packages' importers, and written archives of records with and
  without missing calls, flipped sites whose stored het / hom counts are
  stale, RLE words of 1, 2 and 4 bytes, runs across many words,
  super-blocks of several blocks, B above the records.
- Frames that do not decompress to their size, truncated payloads, a
  bad word width, runs that overflow or fall short, and more records
  than rows raise CorruptFileError, by either path, and a failed decode
  writes nothing outside its slot. Without the library the per-record
  path gives the same arrays and counts its records as `fallback`.
- `compute_ld` decodes through the engine's `block_to_planes` once a
  super-block and parses no record in Python; its `.two` is byte for
  byte the per-record path's, and its `calc.inflate` spans count the
  records, runs and fallback records.
"""

import datetime

import numpy as np
import pytest

import tomahawk_tpu_torch  # noqa: F401  (binds libzstd where needed)
import zstandard  # noqa: E402  (the port binds it where it is missing)

from tomahawk_tpu_torch import native, spans
from tomahawk_tpu_torch.compute import engine as E
from tomahawk_tpu_torch.compute.engine import CalcSettings, compute_ld
from tomahawk_tpu_torch.io import twk
from tomahawk_tpu_torch.io.errors import CorruptFileError
from tomahawk_tpu_torch.io.header import VcfContig, VcfHeader
from tomahawk_tpu_torch.ops import bitpack, inflate

from test_torch_host_copies import archives  # noqa: F401  (fixture)


def _runs(codes, missing: bool, width: int) -> np.ndarray:
    """RLE words of per-sample codes (codeA << 2 | codeB), runs split at
    the width's longest."""
    shift = 4 if missing else 2
    syms = codes if missing else ((codes >> 2) << 1) | (codes & 1)
    most = ((1 << (8 * width)) - 1) >> shift
    words = []
    s = 0
    while s < len(codes):
        e = s
        while e < len(codes) and syms[e] == syms[s] and e - s < most:
            e += 1
        words.append(((e - s) << shift) | int(syms[s]))
        s = e
    return np.array(words, {1: np.uint8, 2: np.uint16, 4: np.uint32}[width])


def _record(rng, n_samples, width, missing, pos, rid):
    """A record whose codes come in runs, some across many words; its
    stored het / hom counts are arbitrary (as a flipped site's are)."""
    codes = np.zeros(n_samples, np.uint8)
    s = 0
    while s < n_samples:
        run = int(rng.choice([1, 2, 3, 7, 40, 130]))
        a, b = rng.integers(0, 2, 2)
        if missing and rng.random() < 0.3:
            a, b = (2, b) if rng.random() < 0.5 else (2, 2)
        codes[s:s + run] = (a << 2) | b
        s += run
    if missing:
        codes[rng.integers(0, n_samples)] = (0 << 2) | 2
    return twk.Twk1Record(
        pos=pos, rid=rid, ac=int(rng.integers(0, 2 * n_samples)),
        an=int((codes >> 2 == 2).sum() + (codes & 3 == 2).sum()),
        n_het=int(rng.integers(0, n_samples)),
        n_hom=int(rng.integers(0, n_samples)),
        hwe=float(rng.random() * 10.0 ** -rng.integers(0, 30)),
        alleles=0x12, gt_ptype=width, gt_flipped=bool(rng.random() < 0.3),
        gt_phase=True, gt_missing=missing,
        gt_runs=_runs(codes, missing, width))


def _written(path, n_samples, widths, seed, n_blocks=7, per_block=11):
    """An archive of `n_blocks` blocks on one contig, record widths drawn
    from `widths`, half the records with missing calls."""
    rng = np.random.default_rng(seed)
    hdr = VcfHeader(samples=[f"S{i}" for i in range(n_samples)],
                    contigs=[VcfContig(idx=0, name="6")])
    pos = 2 ** 31 - 10_000
    with twk.TwkWriter(str(path), hdr) as w:
        for b in range(n_blocks):
            blk = twk.Twk1Block(rid=0)
            for _ in range(per_block - b % 3):
                pos += int(rng.integers(1, 50))
                blk.add(_record(rng, n_samples, int(rng.choice(widths)),
                                bool(rng.random() < 0.5), pos, 0))
            w.write_block(blk)
    return str(path)


def _groups(n_blocks, per=3):
    return [list(range(i, min(i + per, n_blocks)))
            for i in range(0, n_blocks, per)]


def _per_record(path, groups, B):
    with twk.TwkReader(path) as r:
        planes = []
        for g in groups:
            blk = r.read_block(g[0])
            for i in g[1:]:
                for rec in r.read_block(i).rcds:
                    blk.add(rec)
            planes.append(bitpack.block_to_planes(blk, r.n_samples, pad_to=B))
        return bitpack.stack_planes(planes)


def _decoded(path, groups, B):
    with twk.TwkReader(path) as r:
        out = inflate.new_planes(len(groups), B, r.n_samples)
        counts = [inflate.decode_super(inflate.read_super(r, g),
                                       r.n_samples, out, k)
                  for k, g in enumerate(groups)]
        recs = [rec for b in r.blocks() for rec in b.rcds]
    return out, counts, recs


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


#: archives: (the importer's package) or (samples, record widths) written
SOURCES = {
    "jax_importer": ("jax",), "port_importer": ("port",),
    "width1": (150, (1,)), "width2": (150, (2,)), "width4": (150, (4,)),
    "widths_64_samples": (64, (1, 2, 4)), "widths_33_samples": (33, (1, 2, 4)),
}


@pytest.fixture
def source(request, archives, tmp_path):  # noqa: F811
    """(path, written here)."""
    spec = SOURCES[request.param]
    if len(spec) == 1:
        return archives[spec[0]], False
    return _written(tmp_path / "w.twk", *spec, seed=len(request.param)), True


@pytest.mark.parametrize("pad", [0, 37])
@pytest.mark.parametrize("source", sorted(SOURCES), indirect=True)
def test_decoder_matches_the_per_record_path(source, pad):
    path, written = source
    with twk.TwkReader(path) as r:
        sizes = [e.n for e in r.index.ent]
    groups = _groups(len(sizes))
    assert len(groups[0]) > 1
    B = max(sum(sizes[i] for i in g) for g in groups) + pad
    got, counts, recs = _decoded(path, groups, B)
    _assert_same(got, _per_record(path, groups, B))
    assert sum(c["records"] for c in counts) == len(recs) == \
        got["n_rec"].sum()
    assert sum(c["runs"] for c in counts) == sum(r.n_runs for r in recs)
    assert all(c["fallback"] == 0 for c in counts)
    # the cases the decoder branches on are there
    assert any(r.gt_missing for r in recs) and \
        not all(r.gt_missing for r in recs)
    if written:
        assert any(r.gt_flipped for r in recs)
        assert any(r.n_hom != h for r, h in
                   zip(recs, got["n_hom"][got["valid"]]))


def test_written_archives_hold_every_width(tmp_path):
    path = _written(tmp_path / "w.twk", 64, (1, 2, 4), seed=5)
    with twk.TwkReader(path) as r:
        assert {rec.gt_ptype for rec in r.records()} == {1, 2, 4}


def test_fallback_gives_the_same_arrays(tmp_path, monkeypatch):
    path = _written(tmp_path / "f.twk", 150, (1, 2, 4), seed=9)
    groups = _groups(7)
    want, counts, recs = _decoded(path, groups, 64)
    assert inflate.get_lib() is not None
    monkeypatch.setattr(inflate, "get_lib", lambda: None)
    got, fell, _ = _decoded(path, groups, 64)
    _assert_same(got, want)
    assert [c["records"] for c in fell] == [c["records"] for c in counts]
    assert [c["runs"] for c in fell] == [c["runs"] for c in counts]
    assert [c["fallback"] for c in fell] == [c["records"] for c in counts]
    assert sum(c["fallback"] for c in fell) == len(recs)


N_FAULT = 100


def _payload(width=2, missing=False, seed=3):
    rng = np.random.default_rng(seed)
    blk = twk.Twk1Block(rid=0)
    for i in range(3):
        blk.add(_record(rng, N_FAULT, width, missing, 1000 + i, 0))
    return blk, blk.serialize()


def _with_runs(delta, missing):
    """A payload whose second record's last run is `delta` samples
    longer."""
    blk, _ = _payload(missing=missing)
    rec = blk.rcds[1]
    runs = rec.gt_runs.astype(np.int64)
    runs[-1] += delta << (4 if missing else 2)
    rec.gt_runs = runs.astype(np.uint16)
    return blk.serialize()


def _bad_width():
    _, p = _payload()
    b = bytearray(p)
    b[12] = (3 << 3) | (b[12] & 7)
    return bytes(b)


def _frames(*payloads) -> inflate.Frames:
    """A super-block of `payloads`, compressed as an archive holds them."""
    cctx = zstandard.ZstdCompressor(level=1)
    return inflate.Frames("x.twk", [cctx.compress(p) for p in payloads],
                          [len(p) for p in payloads],
                          [1234 + 100 * i for i in range(len(payloads))])


FAULTS = {
    "block_header_cut": lambda: _payload()[1][:8],
    "record_header_cut": lambda: _payload()[1][:12 + 20],
    "runs_cut": lambda: _payload()[1][:-1],
    "bad_width": _bad_width,
    "overflow": lambda: _with_runs(1, False),
    "overflow_missing": lambda: _with_runs(1, True),
    "short": lambda: _with_runs(-1, False),
    "short_missing": lambda: _with_runs(-1, True),
}


@pytest.mark.parametrize("path", ["native", "per_record"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_corrupt_payloads_raise(fault, path, monkeypatch):
    if path == "per_record":
        monkeypatch.setattr(inflate, "get_lib", lambda: None)
    out = inflate.new_planes(2, 8, N_FAULT)
    for v in out.values():
        v.view(np.uint8)[...] = 0xA5
    before = {k: v[1].copy() for k, v in out.items() if v.ndim > 1}
    sup = _frames(FAULTS[fault]())
    with pytest.raises(CorruptFileError) as e:
        inflate.decode_super(sup, N_FAULT, out, 0)
    assert e.value.path in ("x.twk", "<block>")
    for k, v in before.items():
        np.testing.assert_array_equal(out[k][1], v, err_msg=k)


@pytest.mark.parametrize("frame", ["garbage", "wrong_size"])
def test_corrupt_frames_raise(frame):
    sup = _frames(_payload()[1])
    if frame == "garbage":
        sup = sup._replace(frames=[b"\x00" * 40])
    else:
        sup = sup._replace(sizes=[sup.sizes[0] + 1])
    with pytest.raises(CorruptFileError, match="corrupt block") as e:
        inflate.decode_super(sup, N_FAULT, inflate.new_planes(1, 8, N_FAULT),
                             0)
    assert e.value.path == "x.twk" and e.value.offset == 1234


@pytest.mark.parametrize("bad", ["dtype", "samples", "strided"])
def test_slots_of_another_layout_are_refused(bad):
    """The native call writes only slots of `new_planes`' layout."""
    out = inflate.new_planes(2, 8, N_FAULT)
    if bad == "dtype":
        out["pos"] = out["pos"].astype(np.int64)
    elif bad == "samples":
        out = inflate.new_planes(2, 8, 3 * N_FAULT)
    else:
        out["het_bits"] = np.empty((2, 8, 8), np.uint32)[:, :, ::2]
    with pytest.raises(ValueError, match="not C-contiguous"):
        inflate.decode_super(_frames(_payload()[1]), N_FAULT, out, 0)


@pytest.mark.parametrize("path", ["native", "per_record"])
def test_more_records_than_rows_raise(path, monkeypatch):
    if path == "per_record":
        monkeypatch.setattr(inflate, "get_lib", lambda: None)
    _, p = _payload()
    out = inflate.new_planes(1, 5, N_FAULT)
    with pytest.raises(CorruptFileError, match="more than 5 records"):
        inflate.decode_super(_frames(p, p),
                             N_FAULT, out, 0)


def test_the_valid_payloads_of_the_fault_cases_decode():
    """The faults above are the only thing wrong with their payloads."""
    for missing in (False, True):
        blk, p = _payload(missing=missing)
        out = inflate.new_planes(1, 8, N_FAULT)
        got = inflate.decode_super(_frames(p),
                                   N_FAULT, out, 0)
        assert got["records"] == 3
        want = bitpack.stack_planes([bitpack.block_to_planes(
            blk, N_FAULT, pad_to=8)])
        _assert_same(out, want)


@pytest.fixture(scope="module")
def calc_archive(tmp_path_factory):
    """Missing calls on half the records, blocks of 11 or fewer."""
    d = tmp_path_factory.mktemp("torch_inflate")
    return _written(d / "calc.twk", 70, (1, 2, 4), seed=21, n_blocks=12)


class _Fixed(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2000, 1, 1)


@pytest.mark.parametrize("mode", [dict(force_phased=True),
                                  dict(backend="cpu"), dict()])
def test_calc_decodes_a_super_block_a_call(calc_archive, tmp_path,
                                           monkeypatch, mode):
    monkeypatch.setattr(E, "datetime",
                        type("dt", (), dict(datetime=_Fixed)))
    calls = dict(inflate=0, read=0, runs=0)

    def counting(name, real):
        def f(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return f
    monkeypatch.setattr(E, "block_to_planes",
                        counting("inflate", E.block_to_planes))
    monkeypatch.setattr(twk.Twk1Record, "read", classmethod(
        counting("read", twk.Twk1Record.read.__func__)))
    monkeypatch.setattr(native, "runs_to_planes",
                        counting("runs", native.runs_to_planes))
    with twk.TwkReader(calc_archive) as r:
        n_rec = sum(e.n for e in r.index.ent)
        n_super = len(E._super_ranges(r.index.ent, range(r.index.n), 32))

    def job(name):
        out = str(tmp_path / name)
        with spans.recording():
            compute_ld(CalcSettings(input=calc_archive, output=out,
                                    min_r2=0.0, tile_rows=32, threads=2,
                                    **mode), device="cpu")
        got = [s.attrs for s in spans.collect() if s.name == "calc.inflate"]
        sums = {k: sum(a[k] for a in got) for k in ("records", "fallback")}
        with open(out, "rb") as fh:
            return fh.read(), len(got), sums
    fast, n_spans, sums = job("fast.two")
    assert calls == dict(inflate=n_super, read=0, runs=0)
    assert n_spans == n_super
    assert sums == dict(records=n_rec, fallback=0)
    monkeypatch.setattr(inflate, "get_lib", lambda: None)
    slow, _, sums = job("slow.two")
    assert sums == dict(records=n_rec, fallback=n_rec)
    assert calls["read"] == n_rec and calls["runs"] > 0
    assert fast == slow
