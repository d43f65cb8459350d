// The candidate mask, the window's dead-block test and the f32 prefilter
// epilogues shared by the tile kernels.
//
// Each function follows its plain PyTorch version in ops/ld_kernels.py
// (itself the JAX package's tomahawk_tpu/ops/ld_kernels.py) expression by
// expression. The library is built with -fmad=false and without fast math,
// so every product, sum and quotient rounds on its own as IEEE f32 (nvcc's
// default -prec-div=true divides exactly), and the decisions are
// bit-identical to the plain versions'. The bounds arrive from the host
// (Bounds), rounded the way the JAX package rounds them.

#pragma once

#include <cstdint>

namespace twk {

// The distance window of a sweep: window > 0 keeps a pair only when its
// variants share a contig (rid) and lie within `window` bp (pos); 0 means
// no window, and the pointers may then be null.
struct Window {
  const int32_t* pos_i;
  const int32_t* pos_j;
  const int32_t* rid_i;
  const int32_t* rid_j;
  int window;
};

// Candidate mask of sweeps.tile_mask: real rows, the reference's ac skip
// rule, the upper triangle on diagonal tiles, the distance window, and the
// pair class of the mixed dispatch (cls 0 = all, 1 = clean: neither
// variant has a missing allele, 2 = missing: the others). an_* may be
// null when cls is 0. Positions are non-negative int32, so their
// difference cannot overflow.
__device__ __forceinline__ bool candidate(bool valid_i, bool valid_j,
                                          int ac_i, int ac_j, int k, int l,
                                          int diag, int cls,
                                          const int32_t* an_i,
                                          const int32_t* an_j,
                                          const Window& win) {
  bool m = valid_i && valid_j && ac_i + ac_j > 2 && (!diag || k < l);
  if (win.window > 0 && m) {
    const int d = win.pos_i[k] - win.pos_j[l];
    m = win.rid_i[k] == win.rid_j[l] && (d < 0 ? -d : d) <= win.window;
  }
  if (cls != 0 && m) {
    const bool clean = an_i[k] == 0 && an_j[l] == 0;
    m = cls == 1 ? clean : !clean;
  }
  return m;
}

// Whether the thread block whose rows are [row0, row0 + n_rows) of side i
// and whose columns are [col0, col0 + n_cols) of side j can hold an
// in-window pair: the TPU kernel's block_live on this kernel's own unit of
// work (ops/ld_kernels.block_live states it in numpy). Every thread of the
// block must call it, before any other barrier; all get the same answer.
// The extrema of rid and pos run over valid rows inside [0, B) only, with
// sentinels -+2^30 where a side has none: each warp reduces its strided
// share with shuffles, warp leaders fold into shared memory with atomics.
// Live iff both sides have a valid row, the rid ranges meet, and not (both
// sides sit on one shared contig and the pos ranges are further apart than
// the window). On a diagonal tile a block wholly below the diagonal
// (every k >= every l) holds no candidate either and is dead as well.
// The test is conservative: a dead block's mask is all zero.
__device__ __forceinline__ bool block_live(const Window& win,
                                           const uint8_t* valid_i,
                                           const uint8_t* valid_j, int row0,
                                           int n_rows, int col0, int n_cols,
                                           int B, int diag) {
  constexpr int kBig = 1 << 30;
  // rid lo/hi, pos lo/hi of side i, then of side j
  __shared__ int ext[8];
  if (threadIdx.x < 8) ext[threadIdx.x] = (threadIdx.x & 1) ? -kBig : kBig;
  __syncthreads();
  int v[8] = {kBig, -kBig, kBig, -kBig, kBig, -kBig, kBig, -kBig};
  for (int e = threadIdx.x; e < n_rows + n_cols; e += blockDim.x) {
    const bool side_j = e >= n_rows;
    const int g = side_j ? col0 + e - n_rows : row0 + e;
    if (g >= B || (side_j ? valid_j[g] : valid_i[g]) == 0) continue;
    const int r = side_j ? win.rid_j[g] : win.rid_i[g];
    const int p = side_j ? win.pos_j[g] : win.pos_i[g];
    const int o = side_j ? 4 : 0;
    v[o + 0] = min(v[o + 0], r);
    v[o + 1] = max(v[o + 1], r);
    v[o + 2] = min(v[o + 2], p);
    v[o + 3] = max(v[o + 3], p);
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const int other = __shfl_xor_sync(0xffffffffu, v[q], s);
      v[q] = (q & 1) ? max(v[q], other) : min(v[q], other);
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q & 1) atomicMax(&ext[q], v[q]);
      else atomicMin(&ext[q], v[q]);
    }
  }
  __syncthreads();
  const int ri_lo = ext[0], ri_hi = ext[1], pi_lo = ext[2], pi_hi = ext[3];
  const int rj_lo = ext[4], rj_hi = ext[5], pj_lo = ext[6], pj_hi = ext[7];
  const bool any_pair = ri_hi >= 0 && rj_hi >= 0;
  if (!any_pair) return false;
  const bool rid_meet = ri_lo <= rj_hi && rj_lo <= ri_hi;
  const bool one_rid = ri_lo == ri_hi && rj_lo == rj_hi && ri_lo == rj_lo;
  const bool far = (long long)pj_lo - pi_hi > win.window ||
                   (long long)pi_lo - pj_hi > win.window;
  const bool below_diag = diag && row0 >= col0 + n_cols - 1;
  return rid_meet && !(one_rid && far) && !below_diag;
}

// The bounds of the f32 prefilter, as the host rounds them: the r2 range
// [lo, hi] (with need_nonzero: exact D = 0 fails), and the D' range
// [dp_lo, dp_hi] with its 1e-3 slack already applied; (-inf, inf) when the
// run sets no D' bounds, which keeps every pair and skips the term.
struct Bounds {
  float lo, hi, dp_lo, dp_hi;
  int need_nonzero;
};

__device__ __forceinline__ bool dprime_on(const Bounds& bnd) {
  return bnd.dp_lo != -__int_as_float(0x7f800000) ||
         bnd.dp_hi != __int_as_float(0x7f800000);
}

// ld_kernels.dprime_prefilter_cells on one 2x2 table of f32 cells: D' =
// d_num / dmax_num in t^2 units (D and Dmax share the t^2 factor), 0 where
// dmax_num is 0, inside [dp_lo, dp_hi]; a pair whose d_num is within 8 f32
// ulps of its products (cancellation) passes, since its f32 sign is not to
// be trusted. One IEEE division, every product and sum rounded on its own
// (-fmad=false), so the decision is the plain version's.
__device__ __forceinline__ bool dprime_ok(float rr, float ra, float ar,
                                          float aa, float dp_lo,
                                          float dp_hi) {
  const float p1 = rr * aa;
  const float p2 = ar * ra;
  const float d_num = p1 - p2;
  const float g0 = rr + ra, g1 = ar + aa;
  const float h0 = rr + ar, h1 = ra + aa;
  const float dmax_num = d_num >= 0.0f ? fminf(g0 * h1, h0 * g1)
                                       : -fminf(g0 * g1, h0 * h1);
  const float dprime = dmax_num != 0.0f ? __fdiv_rn(d_num, dmax_num) : 0.0f;
  constexpr float kEps = 8.0f * 1.2e-7f;  // exact: a power of two times
  const bool trusted = fabsf(d_num) > kEps * (p1 + p2);
  return (dprime >= dp_lo && dprime <= dp_hi) || !trusted;
}

// ld_kernels.phased_prefilter_cells on one 2x2 table; with DP the D' term
// too. A kernel takes the DP instance where dprime_on(bnd), by one uniform
// branch around its whole epilogue, so that the instance without D' bounds
// carries no code of the term (predicated, its division would run for
// every pair).
template <bool DP>
__device__ __forceinline__ bool phased_prefilter(int refref, int refalt,
                                                 int altref, int altalt,
                                                 const Bounds& bnd) {
  const int t = refref + refalt + altref + altalt;
  const int guard = refref < altalt ? refalt + altref + refref
                                    : altalt + refalt + altref;
  bool pf = t >= 5 && guard >= 5;
  const float rr = (float)refref;
  const float ra = (float)refalt;
  const float ar = (float)altref;
  const float aa = (float)altalt;
  const float d_num = rr * aa - ar * ra;
  const float d2 = d_num * d_num;
  const float denom = (rr + ra) * (ar + aa) * (rr + ar) * (ra + aa);
  if (bnd.need_nonzero) pf = pf && d_num != 0.0f;
  pf = pf && d2 >= bnd.lo * denom && d2 <= bnd.hi * denom;
  if constexpr (DP) {
    if (pf) pf = dprime_ok(rr, ra, ar, aa, bnd.dp_lo, bnd.dp_hi);
  }
  return pf;
}

// ld_kernels.phased_r2_cells: approximate r2, inf where a marginal is 0.
__device__ __forceinline__ float phased_r2(float rr, float ra, float ar,
                                           float aa) {
  const float t = rr + ra + ar + aa;
  const float ts = t > 0.0f ? t : 1.0f;
  const float D = (rr * aa - ar * ra) / (ts * ts);
  const float g0 = (rr + ra) / ts;
  const float g1 = (ar + aa) / ts;
  const float h0 = (rr + ar) / ts;
  const float h1 = (ra + aa) / ts;
  const float denom = g0 * g1 * h0 * h1;
  return denom > 0.0f ? D * D / denom : __int_as_float(0x7f800000);
}

// ld_kernels.unphased_prefilter_cells on one 3x3 genotype table
// (T[0..8] = T00, T01, T02, T10, T11, T12, T20, T21, T22): the phased
// fold's r2 (and D', with D' bounds) when there is no double
// heterozygote, else the exact r2 range of the EM estimator over the
// plausible interval [minhap, maxhap]. DP as phased_prefilter's.
template <bool DP>
__device__ __forceinline__ bool unphased_prefilter(const int* T,
                                                   const Bounds& bnd) {
  const float lo = bnd.lo, hi = bnd.hi;
  const float t00 = (float)T[0], t01 = (float)T[1], t02 = (float)T[2];
  const float t10 = (float)T[3], t11 = (float)T[4], t12 = (float)T[5];
  const float t20 = (float)T[6], t21 = (float)T[7], t22 = (float)T[8];
  const float n = t00 + t01 + t02 + t10 + t11 + t12 + t20 + t21 + t22;
  const bool m = n >= 5.0f;
  const float ns = n > 1.0f ? n : 1.0f;
  const float p = (2.0f * (t00 + t01 + t02) + (t10 + t11 + t12)) /
                  (2.0f * ns);
  const float q = (2.0f * (t00 + t10 + t20) + (t01 + t11 + t21)) /
                  (2.0f * ns);
  const float n11 = 2.0f * t00 + t01 + t10;
  const float ndh = t11;

  // fold case (no double hets): the exact phased table
  const float refref = 2.0f * t00 + t01 + t10;
  const float refalt = 2.0f * t02 + t01 + t12;
  const float altref = 2.0f * t20 + t10 + t21;
  const float altalt = 2.0f * t22 + t21 + t12;
  const float r2_fold = phased_r2(refref, refalt, altref, altalt);
  const float t = refref + refalt + altref + altalt;
  bool fold_ok = t >= 5.0f && r2_fold >= lo && r2_fold <= hi;
  if constexpr (DP) {
    if (fold_ok)
      fold_ok = dprime_ok(refref, refalt, altref, altalt, bnd.dp_lo,
                          bnd.dp_hi);
  }

  // EM case: r2(f11) = (f11 - pq)^2 / denom over [minhap, maxhap]
  const float minhap = n11 / (2.0f * ns);
  const float maxhap = (n11 + ndh) / (2.0f * ns);
  const float tol = (float)1e-4;  // the JAX package's weak-typed 1e-4
  const float pq = p * q;
  const float lo_h = minhap - tol;
  const float hi_h = maxhap + tol;
  const float a = lo_h - pq;
  const float b = pq - hi_h;
  const float ab = a > b ? a : b;
  const float dmin = ab > 0.0f ? ab : 0.0f;
  const float c = hi_h - pq;
  const float d = pq - lo_h;
  const float dmax = c > d ? c : d;
  const float denom = p * (1.0f - p) * q * (1.0f - q);
  const bool pos = denom > 0.0f;
  const float inf = __int_as_float(0x7f800000);
  const float r2_min = pos ? dmin * dmin / denom : inf;
  const float r2_max = pos ? dmax * dmax / denom : inf;
  const bool em_ok = r2_min <= hi && r2_max >= lo;

  const bool no_dh = ndh == 0.0f;
  return m && ((no_dh && fold_ok) || (!no_dh && em_ok));
}

// unphased_screen's answers (ld_kernels.SCREEN_REJECT, SCREEN_KEEP,
// SCREEN_UNDECIDED)
constexpr int kReject = 0, kKeep = 1, kUndecided = 2;

// What unphased_screen takes beyond Bounds, fixed for a launch: its
// relative margin, up = 1 + m and dn = 1 - m with m = 2^-6 + 2^-22 Xmax,
// and n_max, the most samples a pair may count (Xmax = 2 n_max alleles);
// n_max 0 makes every pair undecided.
struct Screen {
  float up, dn;
  int n_max;
};

// Whether the screen may decide against bound b: 0, +-inf, or a magnitude
// in [2^-64, 2^40], so that b times any screened product (at most 2^82)
// stays finite and normal or is 0 or +-inf.
__host__ __device__ inline bool screenable(float b) {
  const float a = b < 0.0f ? -b : b;
  return a == 0.0f || a == __builtin_huge_valf() ||
         (a >= 0x1p-64f && a <= 0x1p40f);
}

// The Screen of a launch over pairs of at most n_samples samples (the
// host computes it once; ld_kernels.screen_margin states it): n_max 0
// where a bound is not screenable(), where need_nonzero is set (the
// unphased statement does not read it) or where n_samples > 2^19.
__host__ __device__ inline Screen screen_for(const Bounds& bnd,
                                             int n_samples) {
  const bool on = screenable(bnd.lo) && screenable(bnd.hi) &&
                  !bnd.need_nonzero && n_samples <= (1 << 19);
  const float m = 0x1p-6f + 0x1p-22f * (float)(2 * (on ? n_samples : 0));
  return {1.0f + m, 1.0f - m, on ? n_samples : 0};
}

// unphased_prefilter's decision without a division, wherever a margin
// proves it: kReject or kKeep is the decision unphased_prefilter<DP> makes
// on T, kUndecided leaves it to unphased_prefilter. ld_kernels
// .unphased_screen_cells states it in PyTorch, expression by expression.
//
// Undecided: a launch whose Screen is off (n_max 0), a cell outside [0,
// 2^20), n < 5, n > n_max, and in the fold half a marginal of 0 (the
// statement's r2 is then inf). Otherwise every cell and every integer
// below is exact in f32.
//
// The proof. u = 2^-24; each f32 operation is x(1 + e), |e| <= u, for the
// operands here (no result underflows but the subnormal squares treated
// below; none overflows: X = 2n <= Xmax <= 2^20 keeps every product under
// 2^82, and a bound's product is finite, 0 or +-inf by screenable()). m >=
// 2^-6 + 2^-22 X; the roundings of m, up and dn are below the slack left
// in each step.
//
// Fold half (T11 = 0; t = 2n >= 10). Ds = rr*aa - ar*ra is the statement's
// own d_num, bit for bit, and M = G0 G1 H0 H1 > 0 its marginals' product.
// phased_r2 rounds 13 times after Ds (t*t, D, D*D, the four marginal
// quotients, three products, the last quotient), so its r2 lies in
// Ds^2/M [(1-u)^4/(1+u)^9, (1+u)^4/(1-u)^9], all its intermediates normal
// or 0. The screen's qs = Ds^2(1 +- u), ms = M(1 +- u)^3, L = lo ms(1 +- u),
// qs*up and qs*dn one rounding more. qs*up < L implies lo > 0 and r2 <
// lo (1+u)^8 / ((1-u)^11 up) < lo: the statement rejects; qs*dn >= L
// implies r2 >= lo (lo <= 0 holds for every r2 >= 0). The same for hi,
// with qs*dn > H a reject. A keep with DP still runs dprime_ok on the
// statement's own table.
//
// EM half (T11 > 0). Scaled by X^2: Np = pX, Nq = qX, n11, nh = n11 + ndh
// are integers, and 1 <= T11 <= Np, X - Np, Nq, X - Nq (a het is on both
// sides), so the statement's denom > 0. The exact dmax* = max(c*, d*),
// c* = nh/X + tau - PQ, d* = PQ - n11/X + tau, P = Np/X, Q = Nq/X, tau =
// f32(1e-4); c* + d* >= 2 tau, so dmax* >= tau; dmin* = max(-c*, -d*, 0).
// Statement: pq = PQ(1 +- 3u); lo_h is n11/X - tau within 2u max(n11/X,
// tau) + u tau, hi_h likewise; |pq - lo_h|, |hi_h - pq| <= 1 + tau + 3u;
// so its c and d lie within E = 6.01u of c* and d* (P, Q, n11/X, nh/X <=
// 1), and dmax, dmin within E of dmax*, dmin* (a = -d, b = -c exactly).
// Screen: A = n11 X - Np Nq and Bv = Np Nq - nh X within 3.001u X^2
// (three roundings of numbers <= X^2); tx = tau X^2 (1 +- 2u); dx =
// max(-A, -Bv) + tx, a sum of two positive numbers (max(-A*, -B*) >= X/2 >
// 3.001u X^2 as X <= 2^20), within Es = 4.001u X^2 of dmax* X^2, and dm =
// max(max(A, Bv) - tx, 0) within Es of dmin* X^2. So dmax lies in dx/X^2
// (1 +- eta), eta = (E + Es/X^2 + 2^-70)/(tau - 4.001u) < 5.99e-3. denom:
// p, q and the three products round 5 times; fl(1 - p) differs from 1 - P
// by at most u(1 + u), a share phi <= u(1 + u) X of 1 - P >= 1/X, and the
// same for q; den = Np (X-Np) Nq (X-Nq) (1 +- u)^3. Hence r2_max = fl(fl(
// dmax^2)/denom) lies in dx^2/den [(1-eta)^2 (1-u)^5 / ((1+u)^5 (1+phi)^2),
// (1+eta)^2 (1+u)^5 / ((1-u)^5 (1-phi)^2)]. With qlo = dx*dx, L = lo*den
// (one rounding each): qlo*up < L gives r2_max < lo, as up >= 1.01201 +
// 2.32 u X covers (1+eta)^2 (1+13.01u) / (1 - 2.0001 u X) for u X <=
// 2^-4; qlo*dn >= L gives r2_max >= lo, as dn <= 0.98802 - 2.04 u X.
// dmin is not relative (dmin* may be 0): gm = dm + 2^-20 X^2 >= (1 - u)
// (dmin + 2^-70) X^2, the 2^-70 covering a subnormal fl(dmin^2); then
// r2_min <= gm^2/den (1+u)^5 / ((1-u)^7 (1 - 2.0001 u X)), and qhi*up <=
// H = hi*den, qhi = gm*gm, gives r2_min <= hi (hi <= 0 never passes; a
// subnormal r2_min's absolute 2^-150 is far inside the slack of hi >=
// 2^-64). The EM half rejects only by r2_max < lo, keeps only by r2_max
// >= lo and r2_min <= hi; it has no D' term.
template <bool DP>
__device__ __forceinline__ int unphased_screen(const int* T,
                                               const Bounds& bnd,
                                               const Screen& scr) {
  const int bits = T[0] | T[1] | T[2] | T[3] | T[4] | T[5] | T[6] | T[7] |
                   T[8];
  const int n = T[0] + T[1] + T[2] + T[3] + T[4] + T[5] + T[6] + T[7] + T[8];
  if (bits < 0 || bits >= (1 << 20) || n < 5 || n > scr.n_max)
    return kUndecided;
  // both halves, then the pair's by selection: the lanes of a warp mix
  // them, and branches would run both in turn
  const bool fold = T[4] == 0;
  const int rr = 2 * T[0] + T[1] + T[3];
  const int ra = 2 * T[2] + T[1] + T[5];
  const int ar = 2 * T[6] + T[3] + T[7];
  const int aa = 2 * T[8] + T[7] + T[5];
  const bool marg = rr + ra > 0 && ar + aa > 0 && rr + ar > 0 && ra + aa > 0;
  const float frr = (float)rr, fra = (float)ra;
  const float far = (float)ar, faa = (float)aa;
  const float ds = frr * faa - far * fra;
  const float qs = ds * ds;
  const float ms = (frr + fra) * (far + faa) * (frr + far) * (fra + faa);
  const float X = (float)(2 * n);
  const float fnp = (float)(2 * (T[0] + T[1] + T[2]) + (T[3] + T[4] + T[5]));
  const float fnq = (float)(2 * (T[0] + T[3] + T[6]) + (T[1] + T[4] + T[7]));
  const float fn11 = (float)(2 * T[0] + T[1] + T[3]);
  const float fnh = fn11 + (float)T[4];
  const float nn = fnp * fnq;
  const float A = fn11 * X - nn;
  const float Bv = nn - fnh * X;
  const float xx = X * X;
  const float tx = (float)1e-4 * xx;
  const float dx = fmaxf(-A, -Bv) + tx;
  const float dm = fmaxf(fmaxf(A, Bv) - tx, 0.0f);
  const float gm = dm + 0x1p-20f * xx;
  const float den = fnp * (X - fnp) * fnq * (X - fnq);
  // fold: qs against lo and hi times ms; EM: dx^2 against lo, gm^2
  // against hi, times den
  const float qlo = fold ? qs : dx * dx;
  const float qhi = fold ? qs : gm * gm;
  const float dd = fold ? ms : den;
  const float L = bnd.lo * dd, H = bnd.hi * dd;
  const bool reject = qlo * scr.up < L || (fold && qlo * scr.dn > H);
  const bool keep = qlo * scr.dn >= L && qhi * scr.up <= H;
  if (fold && !marg) return kUndecided;
  if (reject) return kReject;
  if (!keep) return kUndecided;
  if constexpr (DP) {
    if (fold)
      return dprime_ok(frr, fra, far, faa, bnd.dp_lo, bnd.dp_hi) ? kKeep
                                                                 : kReject;
  }
  return kKeep;
}

// unphased_prefilter in its two halves, for a kernel that runs only the
// half a pair takes (csrc/epilogue.cu; parts_tile runs the branch-free
// statement above on the pairs unphased_screen leaves undecided). Each half
// restates unphased_prefilter's expressions, so under -fmad=false its
// decision is bit for bit the same.

// The f32 cells T00..T22 of one 3x3 genotype table (T as
// unphased_prefilter's) and their sum n.
struct Table9 {
  float t00, t01, t02, t10, t11, t12, t20, t21, t22, n;
};

__device__ __forceinline__ Table9 table9(const int* T) {
  Table9 c;
  c.t00 = (float)T[0], c.t01 = (float)T[1], c.t02 = (float)T[2];
  c.t10 = (float)T[3], c.t11 = (float)T[4], c.t12 = (float)T[5];
  c.t20 = (float)T[6], c.t21 = (float)T[7], c.t22 = (float)T[8];
  c.n = c.t00 + c.t01 + c.t02 + c.t10 + c.t11 + c.t12 + c.t20 + c.t21 +
        c.t22;
  return c;
}

// The fold half (the JAX package's tomahawk_tpu/ops/ld_kernels.py:409-422):
// a pair with no double heterozygote has an exact phased table, whose r2
// (and D', with DP) must lie in the bounds.
template <bool DP>
__device__ __forceinline__ bool unphased_fold_ok(const Table9& c,
                                                 const Bounds& bnd) {
  const float refref = 2.0f * c.t00 + c.t01 + c.t10;
  const float refalt = 2.0f * c.t02 + c.t01 + c.t12;
  const float altref = 2.0f * c.t20 + c.t10 + c.t21;
  const float altalt = 2.0f * c.t22 + c.t21 + c.t12;
  const float r2_fold = phased_r2(refref, refalt, altref, altalt);
  const float t = refref + refalt + altref + altalt;
  bool fold_ok = t >= 5.0f && r2_fold >= bnd.lo && r2_fold <= bnd.hi;
  if constexpr (DP) {
    if (fold_ok)
      fold_ok = dprime_ok(refref, refalt, altref, altalt, bnd.dp_lo,
                          bnd.dp_hi);
  }
  return fold_ok;
}

// The EM half (ld_kernels.py:424-446 there, with ns, p, q, n11 and ndh of
// :400-404): r2(f11) = (f11 - pq)^2 / denom over the plausible interval
// [minhap, maxhap] must meet the r2 bounds.
__device__ __forceinline__ bool unphased_em_ok(const Table9& c,
                                               const Bounds& bnd) {
  const float ns = c.n > 1.0f ? c.n : 1.0f;
  const float p = (2.0f * (c.t00 + c.t01 + c.t02) + (c.t10 + c.t11 + c.t12)) /
                  (2.0f * ns);
  const float q = (2.0f * (c.t00 + c.t10 + c.t20) + (c.t01 + c.t11 + c.t21)) /
                  (2.0f * ns);
  const float n11 = 2.0f * c.t00 + c.t01 + c.t10;
  const float ndh = c.t11;
  const float minhap = n11 / (2.0f * ns);
  const float maxhap = (n11 + ndh) / (2.0f * ns);
  const float tol = (float)1e-4;  // the JAX package's weak-typed 1e-4
  const float pq = p * q;
  const float lo_h = minhap - tol;
  const float hi_h = maxhap + tol;
  const float a = lo_h - pq;
  const float b = pq - hi_h;
  const float ab = a > b ? a : b;
  const float dmin = ab > 0.0f ? ab : 0.0f;
  const float cc = hi_h - pq;
  const float d = pq - lo_h;
  const float dmax = cc > d ? cc : d;
  const float denom = p * (1.0f - p) * q * (1.0f - q);
  const bool pos = denom > 0.0f;
  const float inf = __int_as_float(0x7f800000);
  const float r2_min = pos ? dmin * dmin / denom : inf;
  const float r2_max = pos ? dmax * dmax / denom : inf;
  return r2_min <= bnd.hi && r2_max >= bnd.lo;
}

// unphased_prefilter's decision from the half the pair takes alone: each
// half is a pure function of the cells, so leaving the other out changes
// no bit of the result. Lanes of a warp that take different halves run
// both.
template <bool DP>
__device__ __forceinline__ bool unphased_prefilter_taken(const int* T,
                                                         const Bounds& bnd) {
  const Table9 c = table9(T);
  if (!(c.n >= 5.0f)) return false;
  return c.t11 == 0.0f ? unphased_fold_ok<DP>(c, bnd) : unphased_em_ok(c, bnd);
}

}  // namespace twk
