// The f32 prefilter epilogues shared by the tile kernels.
//
// Each function follows its plain PyTorch version in ops/ld_kernels.py
// (itself the JAX package's tomahawk_tpu/ops/ld_kernels.py) expression by
// expression. The library is built with -fmad=false and without fast math,
// so every product, sum and quotient rounds on its own as IEEE f32 (nvcc's
// default -prec-div=true divides exactly), and the decisions are
// bit-identical to the plain versions'. lo and hi arrive from the host,
// rounded the way the JAX package rounds them.

#pragma once

#include <cstdint>

namespace twk {

// Candidate mask of sweeps.tile_mask without a window: real rows, the
// reference's ac skip rule, the upper triangle on diagonal tiles, and the
// pair class of the mixed dispatch (cls 0 = all, 1 = clean: neither
// variant has a missing allele, 2 = missing: the others). an_* may be
// null when cls is 0.
__device__ __forceinline__ bool candidate(bool valid_i, bool valid_j,
                                          int ac_i, int ac_j, int k, int l,
                                          int diag, int cls,
                                          const int32_t* an_i,
                                          const int32_t* an_j) {
  bool m = valid_i && valid_j && ac_i + ac_j > 2 && (!diag || k < l);
  if (cls != 0 && m) {
    const bool clean = an_i[k] == 0 && an_j[l] == 0;
    m = cls == 1 ? clean : !clean;
  }
  return m;
}

// ld_kernels.phased_prefilter_cells (default D' bounds) on one 2x2 table.
__device__ __forceinline__ bool phased_prefilter(int refref, int refalt,
                                                 int altref, int altalt,
                                                 float lo, float hi,
                                                 int need_nonzero) {
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
  if (need_nonzero) pf = pf && d_num != 0.0f;
  return pf && d2 >= lo * denom && d2 <= hi * denom;
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
// fold's r2 when there is no double heterozygote, else the exact r2 range
// of the EM estimator over the plausible interval [minhap, maxhap].
__device__ __forceinline__ bool unphased_prefilter(const int* T, float lo,
                                                   float hi) {
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
  const bool fold_ok = t >= 5.0f && r2_fold >= lo && r2_fold <= hi;

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

}  // namespace twk
