// The in-sweep Fisher bracket of a segment's survivor rows.
//
// Replaces tomahawk_tpu/ops/fisher_dev.py::fisher_bracket and
// tomahawk_tpu/compute/sweeps.py::append_fisher_col (with the volume gate
// of sweeps.fused_sweep): per survivor of a phased segment, the bracket
// P / q of the two-sided Fisher exact test, which the host turns into P
// with the exact f64 q (ops/fisher_dev.py host_p_from_bracket), or -1 for
// the host's exact recompute. The plain version is ops/fisher_dev.py
// fisher_bracket_search, operation for operation.
//
// The TPU walked each side outward from the observed cell, one ratio
// recurrence step a cell, because a gather of a table cost it ~10 ns a
// lane. Almost all of a walk's steps (~620 a row at 2,504 samples) cross
// the distribution's bulk, the run of cells whose pmf stays within the
// reference's tie band of q or above it. On the H100 the log-factorial
// table (40 KB at 2,504 samples) sits in shared memory or L1, where a
// lookup costs a few cycles, so a thread finds each run's far end by
// bisection: d(k) = L(k) - L(a), L(k) = -lf[k] - lf[n1-k] - lf[m1-k] -
// lf[nm+k], is log(pmf(k) / q), and since pmf is unimodal the cells from a
// with d >= cut_lo = log1p(-1e-8) form one run, ended in
// ceil(log2(support)) probes of four lookups each. The stopping decision
// and the walk's three guard tests are made on d against the host's
// thresholds (fisher_dev.search_cuts: a decision within g of a cut flags
// the lane, g small enough that the walk would flag it too). The
// stopping cell's term and the tail's seed are exp(d) (exp_, the plain
// version's polynomial); the tail is the walk's recurrence, one exact
// integer ratio and one division a step, ~10 steps a side. The walk's
// step count is computed from the run's length, so a side whose run and
// tail outrun max_steps is flagged as the walk flags it.
//
// Every operation is an IEEE f64 addition, multiplication or division
// (built with -fmad=false; div_rn is correctly rounded for these
// operands), so the kernel reproduces the plain version bit for bit, but
// for log2 in the bf16 gate's bound.
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
// tile's super-blocks (the tile list on the device). Output: with
// `packed`, the bracket as bf16 in the top 16 bits of payload column 1 (its low 16 bits,
// ALTALT, kept), bf16 NaN where the lane is flagged or P may be >= 1e-4;
// otherwise the f32 bracket's bits in column `fcol`.
//
// What bounds it on the H100: a row reads 12 bytes of the buffer and
// makes ~24 probes of the table and tail steps, each waiting on the last;
// a warp runs as long as its longest row. The table is read through the
// read-only path (L1): staged in shared memory by every block it took
// longer at 2,504 samples (a copy timed against this kernel), and
// at 32,768 haplotypes (262 KB) it would not fit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kLog2PGate = -13.28f;
constexpr int kBf16Nan = 0x7FC0;
constexpr int kEndsThreads = 1024;
constexpr int kThreads = 128;

// exp's constants (fisher_dev.py's _INV_LN2, _LN2_HI, _LN2_LO, _EXP_COEF,
// _EXP_MIN, the same literals)
constexpr double kInvLn2 = 1.4426950408889634;
constexpr double kLn2Hi = 0.6931471803691238;
constexpr double kLn2Lo = 1.9082149292705877e-10;
constexpr double kExpMin = -1080.0;
__constant__ double kExpCoef[14] = {
    1.0, 1.0, 0.5, 0.16666666666666666, 0.041666666666666664,
    0.008333333333333333, 0.001388888888888889, 0.0001984126984126984,
    2.48015873015873e-05, 2.7557319223985893e-06, 2.755731922398589e-07,
    2.505210838544172e-08, 2.08767569878681e-09, 1.6059043836821613e-10};

struct Table {
  long long a, n1, m1, nm, kmin, kmax;
};

// 2^e for e in [-1022, 1023], from the bits
__device__ __forceinline__ double pow2(long long e) {
  return __longlong_as_double((e + 1023) << 52);
}

// exp(x) for x <= 1, as fisher_dev._exp: x = n ln 2 + r, a Taylor
// polynomial of degree 13 in r, then 2^n in two normal factors, so that a
// subnormal result rounds once
__device__ __forceinline__ double exp_(double x) {
  x = fmax(x, kExpMin);
  const double n = rint(x * kInvLn2);
  const double r = (x - n * kLn2Hi) - n * kLn2Lo;
  double p = kExpCoef[13];
#pragma unroll
  for (int i = 12; i >= 0; --i) p = p * r + kExpCoef[i];
  const long long ni = (long long)n;
  const long long h = ni / 2;
  return p * pow2(h) * pow2(ni - h);
}

// a / b for integer-valued a >= 0 and b >= 1 below 2^31: the reciprocal's
// approximation (rcp.approx.ftz.f64), two Newton steps and the quotient's
// correction, each a fused multiply-add. Correctly rounded for these
// operands: y is within ~2^-52 of 1 / b, so q and the remainder r (exact,
// as q is within 1.5 ulp) put q + r y within ~2^-103 q of a / b, while a /
// b lies at least 2^-85 a / b from any midpoint of two doubles. So it is
// IEEE division, the plain version's. The `/` operator's slow path is a
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
  const double* lf;  // [n_hap + 2]: log k! (fisher_dev.search_table)
  int n_lf;
  double cut_lo, cut_hi, g;  // fisher_dev.search_cuts
  // null, or [2]: the walk's steps for the same rows, and the probes and
  // tail steps made
  unsigned long long* steps;
};

// The table's entry i, through the read-only path
__device__ __forceinline__ double at(const double* lf, long long i) {
  return __ldg(lf + i);
}

// One table's search: its observed cell's four entries, and d(k)
struct Search {
  const Table x;
  const double* lf;
  double la0, la1, la2, la3;

  __device__ __forceinline__ Search(const Table& t, const double* table)
      : x(t), lf(table) {
    la0 = at(lf, x.a);
    la1 = at(lf, x.n1 - x.a);
    la2 = at(lf, x.m1 - x.a);
    la3 = at(lf, x.nm + x.a);
  }

  __device__ __forceinline__ double d(long long k) const {
    return ((la0 - at(lf, k)) + (la1 - at(lf, x.n1 - k))) +
           ((la2 - at(lf, x.m1 - k)) +
            (la3 - at(lf, x.nm + k)));
  }

  // One side: the run's far end by bisection, the stopping decision, the
  // tail. Adds the side's sum to total, the walk's steps to steps and the
  // probes and tail steps to work; sets unc where the host must recompute.
  __device__ __forceinline__ void one_side(int side, const Args& p,
                                           double& total, bool& unc,
                                           long long& steps,
                                           long long& work) const {
    const long long end = side > 0 ? x.kmax : x.kmin;
    const long long span = (end - x.a) * side;
    // distances from a: lo's cell is in the run, hi's is not or lies past
    // the support's end
    long long lo = 0, hi = span + 1;
    double d_lo = 0.0, d_hi = 0.0;
    while (hi - lo > 1) {
      const long long mid = (lo + hi) >> 1;
      const double dm = d(x.a + side * mid);
      if (dm >= p.cut_lo) {
        lo = mid;
        d_lo = dm;
      } else {
        hi = mid;
        d_hi = dm;
      }
      ++work;
    }
    const bool at_end = hi == span + 1;
    unc |= fabs(d_lo - p.cut_lo) < p.g || fabs(d_lo - p.cut_hi) < p.g ||
           (!at_end && fabs(d_hi - p.cut_lo) < p.g);
    double acc = d_lo < p.cut_hi ? exp_(d_lo) : 0.0;
    if (lo + 1 > p.max_steps) {  // the walk's skip outruns its cap
      steps += p.max_steps;
      unc = true;
    } else {
      steps += lo + 1;
      const long long rem = p.max_steps - lo - 1;
      if (!at_end && rem == 0) {
        unc = true;
      } else if (!at_end) {
        double pp = exp_(d_hi);
        long long k = x.a + side * (lo + 1);
        long long used = 0;
        bool done = false;
        while (used < rem) {
          ++used;
          const double r = ratio(x, k, side);
          const bool inside = side > 0 ? k <= end : k >= end;
          if (pp > 0.0 && pp > acc * 1e-18 && inside) {
            acc = acc + pp;
            pp = pp * r;
            k += side;
          } else {
            done = true;
            break;
          }
        }
        unc |= !done;
        steps += used;
        work += used;
      }
    }
    total += acc;
  }
};

// The bracket of one table (fisher_bracket_search's), and log2 of a bound
// on P.
__device__ __forceinline__ float bracket(int rr, int ra, int ar, int aa,
                                         const Args& p, const double* lf,
                                         float& log2_pb, long long& steps,
                                         long long& work) {
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
  log2_pb = 0.0f;
  if (n <= 0 || x.kmax <= x.kmin) return 1.0f;
  if (n > p.n_hap) return -1.0f;  // past the table
  const Search s(x, lf);
  double total = 0.0;
  bool unc = false;
  s.one_side(1, p, total, unc, steps, work);
  s.one_side(-1, p, total, unc, steps, work);
  // the walk's largest pmf / q passed: the mode's, which every run
  // reaches (the cells from a to the mode lie at or above 1)
  const long long mode = (x.n1 + 1) * (x.m1 + 1) / (n + 2);
  const double l2pm = fmax(s.d(mode), 0.0) * kInvLn2;
  log2_pb = (float)(log2(fmax(total, 1e-30)) - l2pm);
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

__global__ void __launch_bounds__(kThreads) fisher_kernel(const Args a) {
  const long long total = a.ends[a.T];
  if (total < a.min_rows) return;  // the volume gate: nothing written
  const double* lf = a.lf;
  const long long rows = min(total, (long long)a.outcap);
  long long my_steps = 0, my_work = 0;
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
    const float br = bracket(rr, ra, ar, aa, a, lf, log2_pb, my_steps,
                             my_work);
    if (a.packed) {
      const bool bad = log2_pb > kLog2PGate || br < 0.0f;
      const int bits = bad ? kBf16Nan : bf16_bits(br);
      row[1] = (int32_t)(((unsigned)row[1] & 0xFFFFu) |
                         ((unsigned)bits << 16));
    } else {
      row[a.fcol] = __float_as_int(br);
    }
  }
  if (a.steps != nullptr) {
    if (my_steps != 0) atomicAdd(a.steps, (unsigned long long)my_steps);
    if (my_work != 0) atomicAdd(a.steps + 1, (unsigned long long)my_work);
  }
}

}  // namespace

// buf: int32 [outcap, ld], the fused sweep's survivor rows, payload in
// columns 1.. (pack16: parts pair-packed), the bracket written in place.
// n_pass: int32 [T], the sweep's per-tile survivor counts; ends: int64
// [T + 1] scratch. has_missing: the 4-part phased payload, else ALTALT with
// ac [NB, B] and pi, pj [T] int32 on the device. packed: the bf16 layout
// in column 1, else the f32 column fcol. n_hap: 2 * samples. min_rows: the
// volume gate. lf: f64 [n_lf] on the device, n_lf = n_hap + 2 (the search
// table). cut_lo, cut_hi, g: the search's thresholds. steps: null, or
// uint64 [2] the rows' walk-equivalent steps and their probes + tail
// steps are added to.
extern "C" int twk_fisher_bracket(void* buf, int ld, int has_missing,
                                  int pack16, int packed, int fcol, int B,
                                  int n_hap, int cap, int outcap,
                                  const void* n_pass, int T, void* ends,
                                  const void* ac, const void* pi,
                                  const void* pj, long long min_rows,
                                  int max_steps, const void* lf, int n_lf,
                                  double cut_lo, double cut_hi, double g,
                                  void* steps, void* stream) {
  const int ncol = has_missing ? (pack16 ? 3 : 5) : 2;
  if (!buf || !n_pass || !ends || !lf || T <= 0 || B <= 0 || cap <= 0 ||
      cap > outcap || ld < ncol || max_steps <= 0 || n_hap <= 0 ||
      n_lf < n_hap + 2 || !(g > 0.0) ||
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
  a.lf = (const double*)lf;
  a.n_lf = n_lf;
  a.cut_lo = cut_lo;
  a.cut_hi = cut_hi;
  a.g = g;
  a.steps = (unsigned long long*)steps;
  // one thread a row, at most 16 blocks an SM's worth, the rest in a
  // grid-stride loop
  const long long want = ((long long)outcap + kThreads - 1) / kThreads;
  const int grid = (int)min(want, 132LL * 16);
  fisher_kernel<<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
