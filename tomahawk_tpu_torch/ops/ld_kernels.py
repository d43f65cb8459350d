"""Plain PyTorch versions of the tile operations.

Counterpart of tomahawk_tpu/ops/ld_kernels.py (and of the candidate mask
of sweeps.tile_mask). These are the reference path of the hand kernels:
the CPU tests run them against the JAX functions, and the kernel
wrappers (ops/tiles.py, compute/sweeps.py) use them for tensors on the
CPU. A CUDA tensor never takes them inside the sweep; the on-card
comparison calls them directly.

Every f32 expression keeps the JAX function's order of operations, one
rounding per operation, so the kernels (built with -fmad=false) and
these versions make bit-identical decisions.

Uint32 bit planes are held as int32 views (torch's uint32 has almost no
operations), and bits are unpacked through a uint8 view, as the JAX
version does: `>>` is not implemented for uint32 on the CPU.
"""

import numpy as np
import torch

#: the D' bounds that switch the in-sweep D' filter off
DPRIME_OFF = (0.0, 100.0)


def unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """[..., W] int32 (uint32 bits) -> [..., W*32] int8 of 0/1,
    little-endian bit order (bit k of word w is lane 32*w + k)."""
    b8 = x.contiguous().view(torch.uint8)                 # [..., 4W]
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    bits = (b8.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*x.shape[:-1], x.shape[-1] * 32).to(torch.int8)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[I, L] x [J, L] 0/1 int8 -> [I, J] int32 contraction over L.
    int8 @ int8 wraps in torch, so the CPU contracts in int32; CUDA has
    no int32 matmul, so it contracts the 0/1 values in float32 with TF32
    off, which is exact while L stays below 2**24."""
    if a.is_cuda:
        if a.shape[-1] >= 1 << 24:
            raise ValueError("contraction too long for an exact f32 sum")
        torch.backends.cuda.matmul.allow_tf32 = False
        return torch.matmul(a.float(), b.float().T).to(torch.int32)
    return torch.matmul(a.to(torch.int32), b.to(torch.int32).T)


def phased_parts_tile(alt_a, alt_b, miss_a=None, miss_b=None):
    """Raw contractions of ld_kernels.phased_parts_tile: (ALTALT,) with
    no missing data; with the miss planes, (altalt, alt_val, val_alt,
    val_val), valid = 1 - unpack(miss). The miss planes carry ones on
    their padding bits, so padded lanes are never valid."""
    a = unpack_bits(alt_a)
    b = unpack_bits(alt_b)
    if miss_a is None:
        return (_dot(a, b),)
    va = (1 - unpack_bits(miss_a)).to(torch.int8)
    vb = (1 - unpack_bits(miss_b)).to(torch.int8)
    return (_dot(a, b), _dot(a, vb), _dot(va, b), _dot(va, vb))


def phased_cells(parts, ac_a, ac_b, n_samples: int):
    """(REFREF, REFALT, ALTREF, ALTALT) [I, J] from raw parts. Without
    missing data the table comes from per-variant allele counts (the
    reference's trick for skipping 3 of 4 popcount passes,
    ld_engine.cpp:683-685)."""
    if len(parts) == 4:
        altalt, alt_val, val_alt, val_val = parts
        altref = alt_val - altalt
        refalt = val_alt - altalt
        refref = val_val - altalt - altref - refalt
    else:
        (altalt,) = parts
        altref = ac_a[:, None] - altalt
        refalt = ac_b[None, :] - altalt
        refref = 2 * n_samples - (ac_a[:, None] + ac_b[None, :]) + altalt
    return refref, refalt, altref, altalt


def unphased_parts_tile(het_a, hom_a, valid_a, het_b, hom_b, valid_b,
                        has_missing: bool):
    """Raw contractions of ld_kernels.unphased_parts_tile: the 4
    het/hom class products, plus the 5 products against the valid
    plane when data are missing (T11, T12, T21, T22, hv, vh, ov, vo,
    vv)."""
    ha, oa = unpack_bits(het_a), unpack_bits(hom_a)
    hb, ob = unpack_bits(het_b), unpack_bits(hom_b)
    dots = [_dot(ha, hb), _dot(ha, ob), _dot(oa, hb), _dot(oa, ob)]
    if has_missing:
        va, vb = unpack_bits(valid_a), unpack_bits(valid_b)
        dots += [_dot(ha, vb), _dot(va, hb), _dot(oa, vb), _dot(va, ob),
                 _dot(va, vb)]
    return tuple(dots)


def unphased_cells(parts, n_het_a, n_hom_a, n_het_b, n_hom_b,
                   n_samples: int):
    """The 9 genotype-table cells T00..T22 (row = A's alt-allele count,
    col = B's) of ld_kernels.unphased_cells, over fully called sample
    pairs. Without missing data the marginals come from the per-variant
    het/hom counts and n_samples."""
    if len(parts) == 9:
        T11, T12, T21, T22, hv, vh, ov, vo, vv = parts
    else:
        T11, T12, T21, T22 = parts
        hv = n_het_a[:, None]
        vh = n_het_b[None, :]
        ov = n_hom_a[:, None]
        vo = n_hom_b[None, :]
        vv = n_samples
    T10 = hv - T11 - T12
    T20 = ov - T21 - T22
    T01 = vh - T11 - T21
    T02 = vo - T12 - T22
    T00 = vv - (T01 + T02 + T10 + T11 + T12 + T20 + T21 + T22)
    return (T00, T01, T02, T10, T11, T12, T20, T21, T22)


def local_parts_tile(planes_a, planes_b, table: str, has_missing: bool):
    """The raw contractions of one tile over the words given, as a
    tuple in the column order of `*_parts_tile`: the plain version of
    the parts-only kernel (pallas_tiles.tile_parts_pallas). `planes_a`
    and `planes_b` hold each side's planes in the order of
    tiles.plane_keys: (alt[, miss]) or (het, hom[, valid]). On a word
    slice of the planes these are the slice's share of the counts; the
    shares of all slices sum to the full-width parts, provided the miss
    plane's padding words are all ones."""
    if table == "phased":
        miss = (planes_a[1], planes_b[1]) if has_missing else (None, None)
        return phased_parts_tile(planes_a[0], planes_b[0], *miss)
    val_a, val_b = ((planes_a[2], planes_b[2]) if has_missing
                    else (None, None))
    return unphased_parts_tile(planes_a[0], planes_a[1], val_a,
                               planes_b[0], planes_b[1], val_b, has_missing)


def epilogue_tile(parts, pair_mask, table: str, n_samples: int,
                  min_r2: float, max_r2: float, ac_a, ac_b, n_het_a=None,
                  n_hom_a=None, n_het_b=None, n_hom_b=None,
                  dprime=DPRIME_OFF):
    """mask u8 [I, J] (0 = not a candidate, 1 = candidate, 2 = survivor
    of the f32 prefilter) from a tile's global `parts` and its candidate
    mask `pair_mask` (pair_mask_tile): the cells and the prefilter that
    sweeps.tile_prefilter runs after the psum of the samples-sharded
    sweep. The n_het/n_hom counts serve the unphased table only;
    `dprime` is (min_dprime, max_dprime)."""
    if table == "phased":
        cells = phased_cells(parts, ac_a, ac_b, n_samples)
        pf = phased_prefilter_cells(cells, pair_mask, min_r2, max_r2,
                                    *dprime)
    else:
        cells = unphased_cells(parts, n_het_a, n_hom_a, n_het_b, n_hom_b,
                               n_samples)
        pf = unphased_prefilter_cells(cells, pair_mask, min_r2, max_r2,
                                      *dprime)
    return pair_mask.to(torch.uint8) + pf.to(torch.uint8)


def pair_mask_tile(valid_a, valid_b, ac_a, ac_b, diagonal: bool,
                   cls: str = "all", an_a=None, an_b=None, window: int = 0,
                   pos_a=None, pos_b=None, rid_a=None, rid_b=None):
    """Candidate pairs of a tile (sweeps.tile_mask): both rows real,
    the reference's ac skip rule (ac_i + ac_j > 2,
    ld_engine.cpp:1910-1912), the upper triangle on diagonal tiles, with
    `window` > 0 the distance window (same contig `rid` and
    |pos_a - pos_b| <= window, int32), and the pair class of the mixed
    dispatch: "clean" keeps pairs whose two variants have no missing
    allele (`an` counts missing alleles), "missing" the others, "all"
    every pair."""
    m = valid_a[:, None] & valid_b[None, :]
    m &= (ac_a[:, None] + ac_b[None, :]) > 2
    if diagonal:
        i = torch.arange(m.shape[0], device=m.device)[:, None]
        j = torch.arange(m.shape[1], device=m.device)[None, :]
        m &= i < j
    if window > 0:
        same = rid_a[:, None] == rid_b[None, :]
        dist = (pos_a[:, None] - pos_b[None, :]).abs()
        m &= same & (dist <= window)
    if cls != "all":
        clean = (an_a[:, None] == 0) & (an_b[None, :] == 0)
        m &= clean if cls == "clean" else ~clean
    return m


def block_live(valid_i, valid_j, pos_i, pos_j, rid_i, rid_j, window: int,
               rows: int = 0, cols: int = 0, diag: bool = False):
    """Which blocks of `rows` x `cols` pairs of a tile can hold an
    in-window pair: bool [ceil(Bi / rows), ceil(Bj / cols)] (one block,
    the whole tile, when rows and cols are 0). The numpy statement of
    the dead-block test the tile kernels run per thread block
    (csrc/prefilter.cuh `block_live`; the TPU kernel's `block_live` on
    its own block size). Extrema of rid and pos run over valid rows
    only, with sentinels -+2**30 where a side has none. Live iff both
    sides have a valid row, the rid ranges meet, and not (both sides
    sit on one shared contig and the pos ranges lie further apart than
    `window`); on a diagonal tile a block wholly below the diagonal
    (every row index >= every column index) is dead too. Conservative:
    a dead block holds no candidate."""
    big = 1 << 30

    def extrema(x, v, step):
        x = np.asarray(x, np.int64)
        v = np.asarray(v, bool)
        step = step or max(len(x), 1)
        pad = -len(x) % step
        x = np.pad(x, (0, pad)).reshape(-1, step)
        v = np.pad(v, (0, pad)).reshape(-1, step)
        return (np.where(v, x, big).min(axis=1, initial=big),
                np.where(v, x, -big).max(axis=1, initial=-big))

    ri_lo, ri_hi = (e[:, None] for e in extrema(rid_i, valid_i, rows))
    pi_lo, pi_hi = (e[:, None] for e in extrema(pos_i, valid_i, rows))
    rj_lo, rj_hi = (e[None, :] for e in extrema(rid_j, valid_j, cols))
    pj_lo, pj_hi = (e[None, :] for e in extrema(pos_j, valid_j, cols))
    any_pair = (ri_hi >= 0) & (rj_hi >= 0)
    rid_meet = (ri_lo <= rj_hi) & (rj_lo <= ri_hi)
    one_rid = (ri_lo == ri_hi) & (rj_lo == rj_hi) & (ri_lo == rj_lo)
    far = (pj_lo - pi_hi > window) | (pi_lo - pj_hi > window)
    live = any_pair & rid_meet & ~(one_rid & far)
    if diag:
        row0 = np.arange(live.shape[0])[:, None] * (rows or len(valid_i))
        last = (np.arange(live.shape[1])[None, :] + 1) \
            * (cols or len(valid_j)) - 1
        live &= row0 < last
    return live


def prefilter_bounds(min_r2: float, max_r2: float):
    """(lo, hi, need_nonzero) of the phased f32 r2 range test, rounded
    exactly as ld_kernels.phased_prefilter_cells rounds them: lo is
    computed in double and cast, hi is computed in f32 after the
    cast."""
    lo_d = min_r2 * 0.999 - 1e-6
    lo = np.float32(max(lo_d, 0.0))
    hi = np.float32(max_r2) * np.float32(1.001) + np.float32(1e-6)
    return lo, hi, lo_d > 0


def unphased_bounds(min_r2: float, max_r2: float):
    """(lo, hi) of the unphased prefilter, rounded as
    ld_kernels.unphased_prefilter_cells rounds them: every step in f32,
    `float32(min_r2) * 0.98 - 1e-4` and `float32(max_r2) * 1.02 +
    1e-4`. These are not the phased margins."""
    f = np.float32
    lo = f(f(min_r2) * f(0.98)) - f(1e-4)
    hi = f(f(max_r2) * f(1.02)) + f(1e-4)
    return f(lo), f(hi)


def dprime_bounds(min_dprime: float, max_dprime: float):
    """(lo, hi) f32 of the in-sweep D' filter, rounded as
    ld_kernels.dprime_prefilter_cells rounds them, `float32(min) - 1e-3`
    and `float32(max) + 1e-3` in f32; (-inf, inf), which keeps every
    pair, for the default bounds, where the JAX package skips the term.
    The kernels take these two numbers as arguments."""
    if (min_dprime, max_dprime) == DPRIME_OFF:
        return np.float32(-np.inf), np.float32(np.inf)
    f = np.float32
    return f(f(min_dprime) - f(1e-3)), f(f(max_dprime) + f(1e-3))


def dprime_prefilter_cells(cells, min_dprime: float, max_dprime: float):
    """The in-sweep D' range filter of ld_kernels.dprime_prefilter_cells
    (f32, its expression order): D' = d_num / dmax_num in t**2 units, 0
    where dmax_num is 0, kept inside [min - 1e-3, max + 1e-3]; a pair
    whose d_num is cancellation-dominated (|d_num| within 8 f32 ulps of
    the products) passes untouched. The host filters survivors exactly."""
    rr, ra, ar, aa = (c.to(torch.float32) for c in cells)
    p1, p2 = rr * aa, ar * ra
    d_num = p1 - p2
    g0, g1 = rr + ra, ar + aa
    h0, h1 = rr + ar, ra + aa
    dmax_num = torch.where(d_num >= 0, torch.minimum(g0 * h1, h0 * g1),
                           -torch.minimum(g0 * g1, h0 * h1))
    nz = dmax_num != 0
    dprime = torch.where(nz, d_num / torch.where(nz, dmax_num, 1.0), 0.0)
    lo, hi = dprime_bounds(min_dprime, max_dprime)
    lo = torch.tensor(lo, device=d_num.device)
    hi = torch.tensor(hi, device=d_num.device)
    eps = torch.tensor(np.float32(8.0) * np.float32(1.2e-7),
                       device=d_num.device)
    trusted = d_num.abs() > eps * (p1 + p2)
    return ((dprime >= lo) & (dprime <= hi)) | ~trusted


def phased_prefilter_cells(cells, pair_mask, min_r2: float,
                           max_r2: float, min_dprime: float = 0.0,
                           max_dprime: float = 100.0):
    """Conservative f32 r2 filter, the expression order of
    ld_kernels.phased_prefilter_cells: integer guards, then D2 >= lo *
    denom and D2 <= hi * denom in multiplicative form, and with D'
    bounds other than the default the in-sweep D' filter. The host
    recomputes survivors exactly in f64."""
    refref, refalt, altref, altalt = cells
    t = refref + refalt + altref + altalt
    m = pair_mask & (t >= 5)
    guard = torch.where(refref < altalt,
                        refalt + altref + refref,
                        altalt + refalt + altref)
    m &= guard >= 5
    rr = refref.to(torch.float32)
    ra = refalt.to(torch.float32)
    ar = altref.to(torch.float32)
    aa = altalt.to(torch.float32)
    d_num = rr * aa - ar * ra
    d2 = d_num * d_num
    denom = (rr + ra) * (ar + aa) * (rr + ar) * (ra + aa)
    lo, hi, need_nonzero = prefilter_bounds(min_r2, max_r2)
    lo = torch.tensor(lo, device=d2.device)
    hi = torch.tensor(hi, device=d2.device)
    if need_nonzero:
        # exact-integer D = 0 means r2 ~ 0 < min_r2; also drops
        # zero-marginal tables (denom = 0 implies d_num = 0)
        m &= d_num != 0
    m &= (d2 >= lo * denom) & (d2 <= hi * denom)
    if (min_dprime, max_dprime) != DPRIME_OFF:
        m &= dprime_prefilter_cells(cells, min_dprime, max_dprime)
    return m


def phased_r2_cells(refref, refalt, altref, altalt):
    """Approximate r2 (f32) from 2x2 cells, ld_kernels.phased_r2_cells
    in its expression order: inf where a marginal is zero."""
    rr = refref.to(torch.float32)
    ra = refalt.to(torch.float32)
    ar = altref.to(torch.float32)
    aa = altalt.to(torch.float32)
    t = rr + ra + ar + aa
    ts = torch.where(t > 0, t, 1.0)
    D = (rr * aa - ar * ra) / (ts * ts)
    g0 = (rr + ra) / ts
    g1 = (ar + aa) / ts
    h0 = (rr + ar) / ts
    h1 = (ra + aa) / ts
    denom = g0 * g1 * h0 * h1
    pos = denom > 0
    return torch.where(pos, D * D / torch.where(pos, denom, 1.0),
                       float("inf"))


def unphased_prefilter_cells(cells, pair_mask, min_r2: float,
                             max_r2: float, min_dprime: float = 0.0,
                             max_dprime: float = 100.0):
    """The unphased superset prefilter of
    ld_kernels.unphased_prefilter_cells, in its expression order (f32):
    pairs with no double heterozygote take the exact phased fold's r2
    (and, with D' bounds, the D' filter on the fold's table); the others
    pass when the exact r2 range over the plausible haplotype-frequency
    interval [minhap, maxhap] meets [lo, hi]. The host redoes the
    cubic-EM root choice exactly in f64."""
    T00, T01, T02, T10, T11, T12, T20, T21, T22 = (
        c.to(torch.float32) for c in cells)
    n = T00 + T01 + T02 + T10 + T11 + T12 + T20 + T21 + T22
    m = pair_mask & (n >= 5)
    ns = torch.clamp(n, min=1.0)
    p = (2 * (T00 + T01 + T02) + (T10 + T11 + T12)) / (2 * ns)
    q = (2 * (T00 + T10 + T20) + (T01 + T11 + T21)) / (2 * ns)
    n11 = 2 * T00 + T01 + T10
    ndh = T11
    lo, hi = unphased_bounds(min_r2, max_r2)
    lo = torch.tensor(lo, device=n.device)
    hi = torch.tensor(hi, device=n.device)

    # fold case (no double hets): the exact phased table
    refref = 2 * T00 + T01 + T10
    refalt = 2 * T02 + T01 + T12
    altref = 2 * T20 + T10 + T21
    altalt = 2 * T22 + T21 + T12
    r2_fold = phased_r2_cells(refref, refalt, altref, altalt)
    t = refref + refalt + altref + altalt
    fold_ok = (t >= 5) & (r2_fold >= lo) & (r2_fold <= hi)
    if (min_dprime, max_dprime) != DPRIME_OFF:
        # the fold has an exact phased table; the EM case stays a
        # pass-through superset (its D' follows the host's root choice)
        fold_ok &= dprime_prefilter_cells(
            (refref, refalt, altref, altalt), min_dprime, max_dprime)

    # EM case: r2(f11) = (f11 - pq)^2 / denom over [minhap, maxhap]
    minhap = n11 / (2.0 * ns)
    maxhap = (n11 + ndh) / (2.0 * ns)
    tol = 1e-4
    pq = p * q
    lo_h = minhap - tol
    hi_h = maxhap + tol
    dmin = torch.clamp(torch.maximum(lo_h - pq, pq - hi_h), min=0.0)
    dmax = torch.maximum(hi_h - pq, pq - lo_h)
    denom = p * (1 - p) * q * (1 - q)
    pos = denom > 0
    denom_s = torch.where(pos, denom, 1.0)
    inf = float("inf")
    r2_min = torch.where(pos, dmin * dmin / denom_s, inf)
    r2_max = torch.where(pos, dmax * dmax / denom_s, inf)
    em_ok = (r2_min <= hi) & (r2_max >= lo)

    no_dh = ndh == 0
    return m & ((no_dh & fold_ok) | (~no_dh & em_ok))


#: unphased_screen_cells' answers (csrc/prefilter.cuh's kReject, kKeep,
#: kUndecided)
SCREEN_REJECT, SCREEN_KEEP, SCREEN_UNDECIDED = 0, 1, 2


def _screenable(b) -> bool:
    """Whether a bound lets the screen decide: 0, +-inf, or a magnitude
    in [2**-64, 2**40] (prefilter.cuh's screenable)."""
    a = abs(float(b))
    return a == 0.0 or a == float("inf") or 2.0 ** -64 <= a <= 2.0 ** 40


def screen_margin(lo, hi, n_samples: int):
    """(up, dn, n_max) f32, the launch's screen as prefilter.cuh's
    screen_for computes it on the host: the relative margin m = 2**-6 +
    2**-22 * 2 n_max, up = 1 + m, dn = 1 - m, and n_max = n_samples, the
    most samples a pair may count; n_max 0 (every pair undecided) where a
    bound is not screenable or n_samples > 2**19."""
    f = np.float32
    on = _screenable(lo) and _screenable(hi) and n_samples <= 1 << 19
    n_max = n_samples if on else 0
    m = f(2.0 ** -6) + f(2.0 ** -22) * f(2 * n_max)
    return f(f(1.0) + m), f(f(1.0) - m), n_max


def unphased_screen_cells(cells, n_samples: int, min_r2: float,
                          max_r2: float, min_dprime: float = 0.0,
                          max_dprime: float = 100.0):
    """The division-free screen of csrc/prefilter.cuh's unphased_screen,
    one f32 expression for each of the device's, in a launch over pairs
    of at most `n_samples` samples: int8 SCREEN_REJECT or SCREEN_KEEP
    where a margin proves what unphased_prefilter_cells decides for the
    table (pair_mask all true), SCREEN_UNDECIDED where it does not. The
    fold half (T11 = 0) compares d_num**2 with lo and hi times the
    marginals' product; the EM half compares dmax and dmin, scaled by
    X**2 (X = 2n), with lo and hi times Np (X - Np) Nq (X - Nq).
    Undecided: a launch the screen does not take (`screen_margin`), a
    cell outside [0, 2**20), n < 5, n > n_samples, a fold marginal of
    0."""
    T = [c.to(torch.int32) for c in cells]
    T00, T01, T02, T10, T11, T12, T20, T21, T22 = T
    f = lambda x: x.to(torch.float32)
    lo, hi = unphased_bounds(min_r2, max_r2)
    up, dn, n_max = screen_margin(lo, hi, n_samples)
    dev = T00.device
    lo, hi = torch.tensor(lo, device=dev), torch.tensor(hi, device=dev)
    up, dn = torch.tensor(up, device=dev), torch.tensor(dn, device=dev)
    bits = T00 | T01 | T02 | T10 | T11 | T12 | T20 | T21 | T22
    n = T00 + T01 + T02 + T10 + T11 + T12 + T20 + T21 + T22
    ok = (bits >= 0) & (bits < 1 << 20) & (n >= 5) & (n <= n_max)
    fold = T11 == 0
    # fold half: r2 = d_num**2 / (G0 G1 H0 H1), d_num as the statement
    # rounds it
    rr = 2 * T00 + T01 + T10
    ra = 2 * T02 + T01 + T12
    ar = 2 * T20 + T10 + T21
    aa = 2 * T22 + T21 + T12
    frr, fra, far, faa = f(rr), f(ra), f(ar), f(aa)
    ds = frr * faa - far * fra
    qs = ds * ds
    ms = (frr + fra) * (far + faa) * (frr + far) * (fra + faa)
    # EM half, scaled by X**2: dmax X**2 = max(-A, -B) + tau X**2, dmin X**2
    # = max(max(A, B) - tau X**2, 0); denom X**4 = Np (X - Np) Nq (X - Nq)
    X = f(2 * n)
    fnp = f(2 * (T00 + T01 + T02) + (T10 + T11 + T12))
    fnq = f(2 * (T00 + T10 + T20) + (T01 + T11 + T21))
    fn11 = f(2 * T00 + T01 + T10)
    fnh = fn11 + f(T11)
    nn = fnp * fnq
    A = fn11 * X - nn
    Bv = nn - fnh * X
    xx = X * X
    tx = torch.tensor(np.float32(1e-4), device=dev) * xx
    dx = torch.maximum(-A, -Bv) + tx
    den = fnp * (X - fnp) * fnq * (X - fnq)
    dm = torch.clamp(torch.maximum(A, Bv) - tx, min=0.0)
    gm = dm + torch.tensor(np.float32(2.0 ** -20), device=dev) * xx
    # fold: qs against lo and hi times ms; EM: dx**2 against lo, gm**2
    # against hi, times den
    qlo = torch.where(fold, qs, dx * dx)
    qhi = torch.where(fold, qs, gm * gm)
    dd = torch.where(fold, ms, den)
    L, H = lo * dd, hi * dd
    reject = (qlo * up < L) | (fold & (qlo * dn > H))
    keep = (qlo * dn >= L) & (qhi * up <= H)
    marg = (rr + ra > 0) & (ar + aa > 0) & (rr + ar > 0) & (ra + aa > 0)
    live = ok & (~fold | marg)
    rej = live & reject
    keep = live & ~reject & keep
    if (min_dprime, max_dprime) != DPRIME_OFF:
        dp = dprime_prefilter_cells((rr, ra, ar, aa), min_dprime,
                                    max_dprime)
        rej |= keep & fold & ~dp
        keep &= ~fold | dp
    out = torch.full(T00.shape, SCREEN_UNDECIDED, dtype=torch.int8,
                     device=dev)
    out[rej] = SCREEN_REJECT
    out[keep] = SCREEN_KEEP
    return out


def compact_indices_small(mask: torch.Tensor, cap: int):
    """(n_pass, idx[cap] int32): the flat indices of the first `cap`
    set bits of `mask`, ascending. Slots k >= n_pass hold the
    out-of-range index mask.numel(); callers read only the first
    n_pass (the contract of ld_kernels.compact_indices_small)."""
    flat = mask.reshape(-1)
    idx = torch.nonzero(flat).reshape(-1)
    out = torch.full((cap,), flat.numel(), dtype=torch.int32,
                     device=mask.device)
    k = min(idx.numel(), cap)
    out[:k] = idx[:k].to(torch.int32)
    return torch.tensor(idx.numel(), dtype=torch.int32), out
