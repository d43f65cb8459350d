"""Unpack layer: RLE blocks -> bitpacked device tensors.

The TPU-native analogue of the reference's twk1_ldd_blk::Inflate
(reference: lib/ld/ld_structs.cpp:125-203): instead of SIMD bitvectors /
index lists / EWAH bitmaps, every variant block becomes a set of
bit-planes packed into uint32 words, zero-padded to 128-lane multiples:

- haplotype level (length 2N, interleaved sample0_hapA, sample0_hapB, ...):
    alt_bits  : 1 where the haplotype carries the alternate allele
    miss_bits : 1 where the allele is missing
- sample level (length N), for the unphased 3x3 genotype table:
    het_bits   : fully-called heterozygotes
    hom_bits   : fully-called alt-homozygotes
    valid_bits : both alleles called

Bit k of word w is sample/haplotype index 32*w + k (little-endian
bit order). Padding bits are zero in every plane, so matmul
contingency counts are unaffected.
"""

from dataclasses import dataclass

import numpy as np

from ..io.twk import Twk1Block


def _pack_bits(rows: np.ndarray, n_words: int, pad_value: int = 0
               ) -> np.ndarray:
    """[B, L] bool -> [B, n_words] uint32, little-endian bit order.

    pad_value sets the bits beyond L: the missing-plane pads with 1 so
    that derived valid planes (~miss) are zero on padding lanes without
    any positional masking -- this keeps the count matmuls exact even
    when the word axis is sharded across devices."""
    B, L = rows.shape
    padded = np.full((B, n_words * 32), pad_value, np.uint8)
    padded[:, :L] = rows
    return np.packbits(padded, axis=1, bitorder="little").view(np.uint32)


_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], np.int32)


def _popcount_rows(words: np.ndarray) -> np.ndarray:
    """Per-row popcount of a [B, W] uint32 word array."""
    b = words.reshape(words.shape[0], -1).view(np.uint8)
    return _POPCNT8[b].sum(axis=1, dtype=np.int32)


def words_for(n_bits: int, lane_words: int = 4) -> int:
    """uint32 words covering n_bits, rounded up so that word count is a
    multiple of lane_words (4 words = 128 bits = one TPU lane row)."""
    w = (n_bits + 31) // 32
    return ((w + lane_words - 1) // lane_words) * lane_words


@dataclass
class BlockPlanes:
    """Device-ready representation of one variant block (possibly padded
    to a fixed record capacity)."""
    n_rec: int                 # real records (<= B)
    alt_bits: np.ndarray       # [B, Wh] uint32
    miss_bits: np.ndarray      # [B, Wh] uint32
    het_bits: np.ndarray       # [B, Ws] uint32
    hom_bits: np.ndarray       # [B, Ws] uint32
    valid_bits: np.ndarray     # [B, Ws] uint32
    pos: np.ndarray            # [B] int32
    rid: np.ndarray            # [B] int32
    ac: np.ndarray             # [B] int32
    an: np.ndarray             # [B] int32 (missing-allele count)
    n_het: np.ndarray          # [B] int32
    n_hom: np.ndarray          # [B] int32
    hwe: np.ndarray            # [B] float32
    has_missing: np.ndarray    # [B] bool
    valid: np.ndarray          # [B] bool (False for padding rows)


def block_to_planes(blk: Twk1Block, n_samples: int,
                    pad_to: int = None) -> BlockPlanes:
    from ..native import available as native_ok
    from ..native import runs_to_planes as native_runs_planes

    B = blk.n if pad_to is None else pad_to
    assert blk.n <= B
    Wh = words_for(2 * n_samples)
    Ws = words_for(n_samples)

    meta = {k: np.zeros(B, np.int32)
            for k in ("pos", "rid", "ac", "an", "n_het", "n_hom")}
    hwe = np.zeros(B, np.float32)
    has_missing = np.zeros(B, bool)
    valid = np.zeros(B, bool)

    def fill_meta(i, rec):
        meta["pos"][i] = rec.pos
        meta["rid"][i] = rec.rid
        meta["ac"][i] = rec.ac
        meta["an"][i] = rec.an
        hwe[i] = rec.hwe
        has_missing[i] = rec.gt_missing
        valid[i] = True

    if native_ok():
        # native path packs straight into uint32 words
        alt_w = np.zeros((B, Wh), np.uint32)
        mis_w = np.zeros((B, Wh), np.uint32)
        het_w = np.zeros((B, Ws), np.uint32)
        hom_w = np.zeros((B, Ws), np.uint32)
        val_w = np.zeros((B, Ws), np.uint32)
        # haplotype padding bits beyond 2N are "missing" (see _pack_bits)
        mis_w[:] = _pack_bits(np.zeros((1, 2 * n_samples), np.uint8),
                              Wh, pad_value=1)[0]
        for i, rec in enumerate(blk.rcds):
            got = native_runs_planes(rec.gt_runs, rec.gt_missing,
                                     alt_w[i], mis_w[i], het_w[i],
                                     hom_w[i], val_w[i], n_samples)
            if got != n_samples:
                from ..io.errors import CorruptFileError
                raise CorruptFileError(
                    "<block>", f"corrupt RLE genotypes at rid "
                    f"{rec.rid} pos {rec.pos}: runs decode to "
                    f"{got} of {n_samples} samples", None)
            fill_meta(i, rec)
        # het/hom meta come from the built planes, not the record
        # fields: the stored twk1_t.n_hom keeps the PRE-flip count for
        # -f flipped sites (a mirrored reference quirk, core.h:291-295
        # set from the unflipped summary in genotype_encoder.h:251-253),
        # while the unphased cell derivation needs counts consistent
        # with the (flipped) genotype planes -- the reference's kernels
        # recount from the flipped RLE data and never read that field
        meta["n_het"][:] = _popcount_rows(het_w)
        meta["n_hom"][:] = _popcount_rows(hom_w)
        return BlockPlanes(
            n_rec=blk.n, alt_bits=alt_w, miss_bits=mis_w, het_bits=het_w,
            hom_bits=hom_w, valid_bits=val_w,
            hwe=hwe, has_missing=has_missing, valid=valid, **meta)

    alt = np.zeros((B, 2 * n_samples), bool)
    mis = np.zeros((B, 2 * n_samples), bool)
    het = np.zeros((B, n_samples), bool)
    hom = np.zeros((B, n_samples), bool)
    val = np.zeros((B, n_samples), bool)

    for i, rec in enumerate(blk.rcds):
        codes = rec.decode_codes()
        ca, cb = codes >> 2, codes & 0b11
        # interleaved haplotype planes
        alt[i, 0::2] = ca == 1
        alt[i, 1::2] = cb == 1
        mis[i, 0::2] = ca == 2
        mis[i, 1::2] = cb == 2
        full = (ca != 2) & (cb != 2)
        val[i] = full
        het[i] = full & ((ca + cb) == 1)
        hom[i] = full & (ca == 1) & (cb == 1)
        fill_meta(i, rec)
        # plane-consistent counts (see the native-path comment above)
        meta["n_het"][i] = int(het[i].sum())
        meta["n_hom"][i] = int(hom[i].sum())

    return BlockPlanes(
        n_rec=blk.n,
        alt_bits=_pack_bits(alt, Wh),
        miss_bits=_pack_bits(mis, Wh, pad_value=1),
        het_bits=_pack_bits(het, Ws),
        hom_bits=_pack_bits(hom, Ws),
        valid_bits=_pack_bits(val, Ws),
        hwe=hwe, has_missing=has_missing, valid=valid, **meta)


def stack_planes(planes) -> dict:
    """Stack per-block BlockPlanes into [NB, ...] arrays for device
    residency."""
    out = {}
    for f in ("alt_bits", "miss_bits", "het_bits", "hom_bits", "valid_bits",
              "pos", "rid", "ac", "an", "n_het", "n_hom", "hwe",
              "has_missing", "valid"):
        out[f] = np.stack([getattr(p, f) for p in planes])
    out["n_rec"] = np.array([p.n_rec for p in planes], np.int32)
    return out
