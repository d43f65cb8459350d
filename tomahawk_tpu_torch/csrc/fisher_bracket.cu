// The in-sweep Fisher bracket of a segment's survivor rows.
//
// Replaces tomahawk_tpu/ops/fisher_dev.py::fisher_bracket and
// tomahawk_tpu/compute/sweeps.py::append_fisher_col (with the volume gate
// of sweeps.fused_sweep): per survivor of a phased segment, the bracket
// P / q of the two-sided Fisher exact test, which the host turns into P
// with the exact f64 q (ops/fisher_dev.py host_p_from_bracket), or -1 for
// the host's exact recompute. The walk is ops/fisher_dev.py fisher_bracket's,
// step for step: from the observed cell (pmf / q = 1) each side steps
// outward with the hypergeometric ratio recurrence, skips the cells whose
// next cell is still inside the reference's tie band, decides the stopping
// cell, then sums the tail until a term falls under 1e-18 of the side's
// sum. The TPU walked every lane of the buffer in lock-step chunks of
// double-single f32; the H100 has native f64, so a thread walks one row
// in f64, with the value as a mantissa in [0.5, 1) and an int exponent
// (pmf / q reaches e^+3000 across the bulk at 2,504 samples). Built with
// -fmad=false, so every product rounds on its own, as the plain version's;
// only the ratio's division is this file's own (div_rn).
//
// Rows: the segment's fused survivor buffer (compute/sweeps.py
// fused_sweep), int32 [outcap, ld], tile t's rows at [ends[t] - n_pass[t],
// ends[t]) with ends the inclusive sum of n_pass, for the tiles the host
// keeps from the fused pass (n_pass[t] <= cap, ends[t] <= outcap - cap);
// the rows of other tiles are repaired on the host's side and get nothing.
// A first launch, one block, sums n_pass (the volume gate, the host's
// FISHER_MIN_ROWS rule from the same integers) and writes ends; below
// min_rows the second writes nothing. Nothing waits for the host.
//
// Cells: phased with missing data, the 4 parts (pair-packed or one a
// column); without, ALTALT and the per-variant allele counts ac of the
// tile's super-blocks (pi, pj on the device). Output: with `packed`, the
// bracket as bf16 in the top 16 bits of payload column 1 (its low 16 bits,
// ALTALT, kept), bf16 NaN where the lane is flagged or P may be >= 1e-4;
// otherwise the f32 bracket's bits in column `fcol`.
//
// What bounds it on the H100: the walk's f64 arithmetic, a division and a
// few operations a step, data-dependent: thousands of steps for a row in
// strong LD at 2,504 samples, against 12 bytes of the buffer a row. A
// warp runs as long as its longest walk. Threads past the segment's
// survivors leave at once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr double kBand = 1e-8;
constexpr double kGuard = 1.2e-9;
constexpr float kLog2PGate = -13.28f;
constexpr int kBf16Nan = 0x7FC0;
constexpr int kEndsThreads = 1024;
constexpr int kThreads = 128;

struct Table {
  long long a, n1, m1, nm, kmin, kmax;
};

// frexp(v): v = m * 2^e with m in [0.5, 1), from the bits (0 gives 0, 0),
// so that no exponent takes a trip through local memory
__device__ __forceinline__ double split(double v, int& e) {
  if (v == 0.0) {
    e = 0;
    return 0.0;
  }
  int adj = 0;
  long long bits = __double_as_longlong(v);
  if (((bits >> 52) & 0x7FF) == 0) {  // subnormal: scale into range first
    bits = __double_as_longlong(v * 18014398509481984.0);  // 2^54
    adj = -54;
  }
  e = (int)((bits >> 52) & 0x7FF) - 1022 + adj;
  return __longlong_as_double((bits & ~(0x7FFLL << 52)) | (1022LL << 52));
}

// ldexp(m, e) for m in [0.5, 1): m * 2^h * 2^(e - h), each factor a
// normal power of two, so the result rounds once, as ldexp's does (inf
// above 2^1024, 0 below 2^-1075). The library's ldexp costs the kernel a
// stack frame.
__device__ __forceinline__ double scale(double m, int e) {
  if (e > 1024) return __longlong_as_double(0x7FF0000000000000LL);
  if (e < -1075) return 0.0;
  const int h = e / 2;
  return m * __longlong_as_double((long long)(h + 1023) << 52) *
         __longlong_as_double((long long)(e - h + 1023) << 52);
}

// a / b for integer-valued a >= 0 and b >= 1 below 2^31: the reciprocal's
// approximation (rcp.approx.ftz.f64), two Newton steps and the quotient's
// correction, each a fused multiply-add. The quotient is the IEEE one but
// in rare cases one ulp off (the plain version divides): a drift of 1e-16
// against the walk's guard of 1.2e-9. The `/` operator's slow path is a
// called subroutine, which would cost the kernel a stack frame.
__device__ __forceinline__ double div_rn(double a, double b) {
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(b));
  double e = __fma_rn(-b, y, 1.0);
  y = __fma_rn(y, e, y);
  e = __fma_rn(-b, y, 1.0);
  y = __fma_rn(y, e, y);
  const double q = a * y;
  const double r = __fma_rn(-b, q, a);
  return __fma_rn(r, y, q);
}

// pmf(k + side) / pmf(k): integer products, exact in f64, and one
// division; 0 off the support
__device__ __forceinline__ double ratio(const Table& x, long long k,
                                        int side) {
  long long num, den;
  if (side > 0) {
    num = (x.n1 - k) * (x.m1 - k);
    den = (k + 1) * (x.nm + k + 1);
  } else {
    num = k * (x.nm + k);
    den = (x.n1 - k + 1) * (x.m1 - k + 1);
  }
  return den == 0 ? 0.0 : div_rn((double)num, (double)den);
}

// One side of the walk; adds its sum to total, its steps to steps and
// raises pm * 2^pe to the largest pmf / q it passes. Returns whether the
// lane must go to the host.
__device__ __forceinline__ bool walk_side(const Table& x, int side,
                                          int max_steps, double& total,
                                          long long& steps, double& pm,
                                          int& pe) {
  const long long end = side > 0 ? x.kmax : x.kmin;
  long long k = x.a;
  double m = 0.5, acc = 0.0, pp = 0.0;
  int e = 1;
  bool skip = true, tail = false, unc = false;
  for (int it = 0; it < max_steps && (skip || tail); ++it) {
    ++steps;
    const double r = ratio(x, k, side);
    if (skip) {
      int fe;
      const double fm = split(m * r, fe);
      const int ne = e + fe;
      const double nxt = scale(fm, ne);
      const bool at_end = k == end;
      if (at_end || nxt - 1.0 < -kBand) {
        // the stopping cell: included when below the band's top
        const double here = scale(m, e);
        const double vh = here - 1.0;
        unc |= fabs(vh + kBand) < kGuard || fabs(vh - kBand) < kGuard ||
               (!at_end && fabs(nxt - 1.0 + kBand) < kGuard);
        if (vh < kBand) acc = here;
        skip = false;
        if (!at_end) {
          pp = nxt;
          k += side;
          tail = true;
        }
      } else {
        k += side;
        if (ne > pe || (ne == pe && fm > pm)) {
          pm = fm;
          pe = ne;
        }
        m = fm;
        e = ne;
      }
    } else {
      const bool inside = side > 0 ? k <= end : k >= end;
      if (pp > 0.0 && pp > acc * 1e-18 && inside) {
        acc = acc + pp;
        pp = pp * r;
        k += side;
      } else {
        tail = false;
      }
    }
  }
  total += acc;
  return unc || skip || tail;
}

// The bracket of one table (fisher_bracket's), and log2 of a bound on P.
__device__ __forceinline__ float bracket(int rr, int ra, int ar, int aa,
                                         int max_steps, float& log2_pb,
                                         long long& steps) {
  Table x;
  x.a = max(rr, 0);
  const long long b = max(ra, 0), c = max(ar, 0), d = max(aa, 0);
  x.n1 = x.a + b;
  x.m1 = x.a + c;
  const long long n = x.n1 + c + d;
  const long long n2 = n - x.n1;
  x.nm = n2 - x.m1;
  x.kmin = max(x.m1 - n2, 0LL);
  x.kmax = min(x.n1, x.m1);
  if (n <= 0 || x.kmax <= x.kmin) {
    log2_pb = 0.0f;
    return 1.0f;
  }
  double total = 0.0, pm = 0.5;
  int pe = 1;
  bool unc = walk_side(x, 1, max_steps, total, steps, pm, pe);
  unc |= walk_side(x, -1, max_steps, total, steps, pm, pe);
  log2_pb = (float)(log2(fmax(total, 1e-30)) - (log2(pm) + (double)pe));
  return unc ? -1.0f : (float)total;
}

// f32 -> bf16 bits, round to nearest even (the bracket is finite)
__device__ __forceinline__ int bf16_bits(float v) {
  const unsigned u = __float_as_uint(v);
  return (int)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

// ends[t] = n_pass[0] + ... + n_pass[t] (int64) and ends[T] the total, in
// one block: a scan of kEndsThreads tiles a pass with a running carry
__global__ void __launch_bounds__(kEndsThreads)
ends_kernel(const int32_t* __restrict__ n_pass, int T,
            long long* __restrict__ ends) {
  __shared__ long long part[kEndsThreads];
  long long carry = 0;
  for (int t0 = 0; t0 < T; t0 += kEndsThreads) {
    const int t = t0 + threadIdx.x;
    long long v = t < T ? (long long)n_pass[t] : 0;
    part[threadIdx.x] = v;
    __syncthreads();
    for (int d = 1; d < kEndsThreads; d <<= 1) {
      const long long y = threadIdx.x >= d ? part[threadIdx.x - d] : 0;
      __syncthreads();
      part[threadIdx.x] += y;
      __syncthreads();
    }
    if (t < T) ends[t] = carry + part[threadIdx.x];
    carry += part[kEndsThreads - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) ends[T] = carry;
}

struct Args {
  int32_t* buf;
  int ld, has_missing, pack16, packed, fcol;
  int B, n_hap, cap, outcap, T, max_steps;
  long long min_rows;
  const int32_t* n_pass;
  const long long* ends;  // [T + 1]: inclusive sums, then the total
  const int32_t* ac;      // [NB, B]; null with missing data
  const int32_t* pi;      // [T] super-blocks of each tile; null likewise
  const int32_t* pj;
  unsigned long long* steps;  // null, or the sum of every row's steps
};

__global__ void __launch_bounds__(kThreads) fisher_kernel(const Args a) {
  const long long total = a.ends[a.T];
  if (total < a.min_rows) return;  // the volume gate: nothing written
  const long long rows = min(total, (long long)a.outcap);
  long long my_steps = 0;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
       r < rows; r += (long long)gridDim.x * kThreads) {
    // the row's tile: the first t with ends[t] > r
    int lo = 0, hi = a.T - 1;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (a.ends[mid] > r) hi = mid;
      else lo = mid + 1;
    }
    const int t = lo;
    if (a.n_pass[t] > a.cap || a.ends[t] > (long long)(a.outcap - a.cap))
      continue;  // a tile the host repairs
    int32_t* row = a.buf + r * a.ld;
    int rr, ra, ar, aa;
    if (a.has_missing) {
      int altalt, alt_val, val_alt, val_val;
      if (a.pack16) {
        const unsigned c0 = (unsigned)row[1], c1 = (unsigned)row[2];
        altalt = (int)(c0 & 0xFFFFu);
        alt_val = (int)(c0 >> 16);
        val_alt = (int)(c1 & 0xFFFFu);
        val_val = (int)(c1 >> 16);
      } else {
        altalt = row[1];
        alt_val = row[2];
        val_alt = row[3];
        val_val = row[4];
      }
      aa = altalt;
      ar = alt_val - altalt;
      ra = val_alt - altalt;
      rr = val_val - altalt - ar - ra;
    } else {
      const int idx = row[0];
      const int k = idx / a.B, l = idx % a.B;
      aa = a.pack16 ? (int)((unsigned)row[1] & 0xFFFFu) : row[1];
      const int ac_a = a.ac[(size_t)a.pi[t] * a.B + k];
      const int ac_b = a.ac[(size_t)a.pj[t] * a.B + l];
      ar = ac_a - aa;
      ra = ac_b - aa;
      rr = a.n_hap - ac_a - ac_b + aa;
    }
    float log2_pb;
    const float br = bracket(rr, ra, ar, aa, a.max_steps, log2_pb,
                             my_steps);
    if (a.packed) {
      const bool bad = log2_pb > kLog2PGate || br < 0.0f;
      const int bits = bad ? kBf16Nan : bf16_bits(br);
      row[1] = (int32_t)(((unsigned)row[1] & 0xFFFFu) |
                         ((unsigned)bits << 16));
    } else {
      row[a.fcol] = __float_as_int(br);
    }
  }
  if (a.steps != nullptr && my_steps != 0)
    atomicAdd(a.steps, (unsigned long long)my_steps);
}

}  // namespace

// buf: int32 [outcap, ld], the fused sweep's survivor rows, payload in
// columns 1.. (pack16: parts pair-packed), the bracket written in place.
// n_pass: int32 [T], the sweep's per-tile survivor counts; ends: int64
// [T + 1] scratch. has_missing: the 4-part phased payload, else ALTALT with
// ac [NB, B], pi, pj [T] (int32, on the device). packed: the bf16 layout
// in column 1, else the f32 column fcol. n_hap: 2 * samples. min_rows: the
// volume gate. steps: null, or a uint64 the rows' walk steps are added to.
extern "C" int twk_fisher_bracket(void* buf, int ld, int has_missing,
                                  int pack16, int packed, int fcol, int B,
                                  int n_hap, int cap, int outcap,
                                  const void* n_pass, int T, void* ends,
                                  const void* ac, const void* pi,
                                  const void* pj, long long min_rows,
                                  int max_steps, void* steps, void* stream) {
  const int ncol = has_missing ? (pack16 ? 3 : 5) : 2;
  if (!buf || !n_pass || !ends || T <= 0 || B <= 0 || cap <= 0 ||
      cap > outcap || ld < ncol || max_steps <= 0 ||
      (packed && (has_missing || !pack16)) ||
      (!packed && (fcol < ncol || fcol >= ld)) ||
      (!has_missing && (!ac || !pi || !pj)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  ends_kernel<<<1, kEndsThreads, 0, s>>>((const int32_t*)n_pass, T,
                                         (long long*)ends);
  Args a;
  a.buf = (int32_t*)buf;
  a.ld = ld;
  a.has_missing = has_missing;
  a.pack16 = pack16;
  a.packed = packed;
  a.fcol = fcol;
  a.B = B;
  a.n_hap = n_hap;
  a.cap = cap;
  a.outcap = outcap;
  a.T = T;
  a.max_steps = max_steps;
  a.min_rows = min_rows;
  a.n_pass = (const int32_t*)n_pass;
  a.ends = (const long long*)ends;
  a.ac = (const int32_t*)ac;
  a.pi = (const int32_t*)pi;
  a.pj = (const int32_t*)pj;
  a.steps = (unsigned long long*)steps;
  // one thread a row, at most 16 blocks an SM's worth, the rest in a
  // grid-stride loop
  const long long want = ((long long)outcap + kThreads - 1) / kThreads;
  const int grid = (int)min(want, 132LL * 16);
  fisher_kernel<<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
