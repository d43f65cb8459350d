// One tile of variant pairs -> (candidate/survivor mask, P raw parts,
// per-segment survivor and candidate counts), for the tile instances with
// more than one contraction, on the tensor cores.
//
// Replaces tomahawk_tpu/ops/pallas_tiles.py::_make_kernel (built by
// _build_call, reached through sweeps.tile_prefilter) in its instances
// with P = 4 or 9 parts, with and without a window, and with them
// tools/probe_pallas.py's `fused` probe, whose 4 het/hom contractions are
// the unphased P = 4 instance with a toy epilogue:
//
//   kind  table, missing data   planes per side   parts (column order)
//   0     phased, missing       alt, miss         altalt, alt_val,
//                                                 val_alt, val_val
//   1     unphased, none        het, hom          T11, T12, T21, T22
//   2     unphased, missing     het, hom, valid   T11, T12, T21, T22, hv,
//                                                 vh, ov, vo, vv
//
// (valid = ~miss for the phased table), each with the pair class cls of
// the mixed dispatch (all, clean, missing). Like the TPU kernel it writes
// mask = 0 (not a candidate), 1 (candidate) or 2 (survivor of the f32
// prefilter) and the parts, i32 [P, B, B] in the column order of
// pallas_tiles._chunk_parts; unlike it, it applies the diagonal triangle
// itself. csrc/phased_tile.cu serves the phased no-missing instance (P=1).
//
// The contraction: each part is the popcount of the AND of two packed
// rows of W words, which the H100's 1-bit MMA (mma.sync.m16n8k256.b1
// .and.popc, SASS BMMA.168256.AND.POPC) computes on the packed words;
// mma_tile.cuh holds the staging and MMA loop (twk::mma::Contraction, the
// products in _chunk_parts' order as twk::mma::Products). valid = ~miss is
// taken at fragment load, the words past W of the last K step masked back
// to zero (route (a): the zero fill of the staging would otherwise turn
// into ones); the miss plane's padding bits inside W are ones (bitpack and
// the samples-sharded upload pad them so), so ~miss adds nothing there.
//
// What bounds it on the H100: at B = 4096 and 2,504 samples a tile is 4 x
// 4096^2 x 160 pair-words (phased P=4), 4 x 4096^2 x 80 (unphased P=4) or
// 9 x 4096^2 x 80 (P=9): 0.067 / 0.034 / 0.076 ms of 1-bit MMA at 10.2e15
// operations a second, under its bytes (1 + 4P bytes a pair written: 0.088
// / 0.087 / 0.188 ms at HBM rate). The accumulators are P per pair, so the
// block is smaller than phased_tile's 128 x 128: 64 x 64 for P = 4 (warp
// tile 32 x 16, 64 accumulators a thread) and 32 x 64 for P = 9 (16 x 16,
// 72), with 16-word stages for P = 9 so that two blocks share an SM (64 x
// 32, with 6 more fragment registers, spilled at the 128-register cap of
// two blocks an SM; one block an SM, or 32-word stages, took 1.7x as
// long). Each operand row then comes from L2 B / 64 (+ B / 32) times: ~670
// MB a tile for phased P = 4, ~750 MB for P = 9, which at the ~3.7 TB/s
// phased_tile's loop reads from L2 is ~0.18-0.2 ms, above both bounds
// (thread-block clusters sharing stages through distributed shared memory
// would cut it). Cut out of the kernel one at a time (time_variants.py,
// NVIDIA H100 80GB HBM3, 700 W): phased P = 4 spends ~0.2 of its 0.33 ms
// in the loop. The unphased instances spent ~0.39 of 0.58 ms (P = 4) and
// ~0.43 of 0.84 ms (P = 9) in the unphased prefilter's f32 statement (a
// dozen IEEE divisions a pair), which two blocks of 8 warps an SM cannot
// hide; with the division-free screen below, one call on one card took
// 0.472 / 0.745 ms (P = 4 / 9) against 0.648 / 0.971 with the statement
// for every pair and 0.215 / 0.490 with no prefilter at all. What is left
// above the latter is the screen's ~100 instructions a pair, latency-bound
// at the register cap, and on the benchmark's planes its rare undecided
// pairs; below it, the loop and the stores.
//
// The unphased prefilter: twk::unphased_screen settles each candidate's
// decision with products and a margin proved in prefilter.cuh, and only
// the pairs it leaves undecided (a zero fold marginal, a pair within the
// margin of a bound) run the f32 statement, out of line (exact_unphased):
// the decision is bit for bit the statement's. With `screen` given (kinds
// 1 and 2), the kernel adds the candidates screened and those left
// undecided into screen[0] and screen[1] (int64), with `counts` given: a
// block adds its candidates from its row counts with one atomic a warp of
// rows, and each undecided pair adds itself on its rare branch, so no
// register or barrier is added to the pairs' path. The engine's sweeps
// give it for every unphased tile; null, the counting epilogue (an
// instance of its own) is not run.
//
// The epilogue runs in the MMA's C layout, in registers: a thread holds
// the same (row, column) pairs for every product, rows wr + 16 mi + 8 h + g
// and columns wc + 8 ni + 2t + e, so each pair's cells, candidate test and
// prefilter need no shared-memory pass. It follows ops/ld_kernels
// .phased_cells / unphased_cells and the prefilters of prefilter.cuh
// (built with -fmad=false: bit-identical to the plain versions). Without
// missing data the unphased marginals come from the per-variant het/hom
// counts and n_samples, as the host table does. The two adjacent columns
// of a thread go out as one 2-byte mask store and one 8-byte store a part
// (a quad: 32 contiguous bytes), the parts with a streaming hint (the
// compaction reads them only at survivors). Padding rows (valid = 0) are
// never candidates.
//
// Counts: with `counts` given, the kernel also adds each row's survivors
// and candidates of its columns, n_survivors | n_candidates << 16, into
// counts[k, col0 / 128] (int32 [B, ceil(B / 128)], the cell phased_tile
// writes and csrc/compact.cu reads): a quad's lanes are summed by
// shuffles, a block's warps in shared memory, and the 128 / TJ blocks of a
// segment with one global atomicAdd a row (none for a zero). The C entry
// zeroes the buffer on the stream first.
//
// Window mode (window > 0, a runtime argument) is phased_tile's: the
// candidate test adds same contig and |pos_i - pos_j| <= window, and a
// block whose 64 x 64 (P = 4) or 32 x 64 (P = 9) pairs can hold no
// in-window pair (twk::block_live) writes its mask region as 0, adds
// nothing to the counts, leaves its parts unwritten and returns before the
// staging loop.

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_tile.cuh"
#include "prefilter.cuh"

namespace {

constexpr int kThreads = twk::mma::kThreads;
constexpr int kSeg = 128;  // mask columns of one counts cell

struct Args {
  const uint32_t* pi[3];  // planes of the row super-block
  const uint32_t* pj[3];  // planes of the column super-block
  const int32_t* ac_i;
  const int32_t* ac_j;
  const uint8_t* valid_i;
  const uint8_t* valid_j;
  const int32_t* an_i;  // null unless cls != 0
  const int32_t* an_j;
  const int32_t* nhet_i;  // kind 1 only
  const int32_t* nhom_i;
  const int32_t* nhet_j;
  const int32_t* nhom_j;
  twk::Window win;
  int cls, B, W, n_samples;
  twk::Bounds bnd;
  twk::Screen scr;  // the unphased kinds' screen (twk::screen_for)
  int diag;
  uint8_t* mask;
  int32_t* parts;
  int32_t* counts;  // null: none
  unsigned long long* screen;  // null: none (kinds 1 and 2 only)
};

// planes a side, parts, MMA patches a warp (rows x columns), words a stage
template <int KIND>
struct Shape;
template <>
struct Shape<0> {  // phased, missing data
  static constexpr int kPlanes = 2, kParts = 4, kMi = 2, kNi = 2, kWords = 32;
};
template <>
struct Shape<1> {  // unphased, no missing data
  static constexpr int kPlanes = 2, kParts = 4, kMi = 2, kNi = 2, kWords = 32;
};
template <>
struct Shape<2> {  // unphased, missing data
  static constexpr int kPlanes = 3, kParts = 9, kMi = 1, kNi = 2, kWords = 16;
};

template <int KIND>
using TileOf =
    twk::mma::Contraction<Shape<KIND>::kPlanes, Shape<KIND>::kParts,
                          Shape<KIND>::kMi, Shape<KIND>::kNi,
                          twk::mma::Products<KIND == 0>, Shape<KIND>::kWords>;

// survivors | candidates << 16 of one mask byte (0, 1 or 2)
__device__ __forceinline__ unsigned count_byte(unsigned m) {
  return (m >> 1) | (m != 0 ? 1u << 16 : 0u);
}

// ld_kernels.unphased_cells: the 9 cells T00..T22 of pair (k, l) from its
// P parts v (kind 1: the marginals from the per-variant het/hom counts and
// n_samples).
template <int KIND>
__device__ __forceinline__ void unphased_cells(const Args& a, const int* v,
                                               int k, int l, int (&T)[9]) {
  const int T11 = v[0], T12 = v[1], T21 = v[2], T22 = v[3];
  int hv, vh, ov, vo, vv;
  if constexpr (KIND == 2) {
    hv = v[4];
    vh = v[5];
    ov = v[6];
    vo = v[7];
    vv = v[8];
  } else {
    hv = a.nhet_i[k];
    ov = a.nhom_i[k];
    vh = a.nhet_j[l];
    vo = a.nhom_j[l];
    vv = a.n_samples;
  }
  const int T10 = hv - T11 - T12;
  const int T20 = ov - T21 - T22;
  const int T01 = vh - T11 - T21;
  const int T02 = vo - T12 - T22;
  const int T00 = vv - (T01 + T02 + T10 + T11 + T12 + T20 + T21 + T22);
  T[0] = T00, T[1] = T01, T[2] = T02, T[3] = T10, T[4] = T11, T[5] = T12;
  T[6] = T20, T[7] = T21, T[8] = T22;
}

// twk::unphased_prefilter out of line: only the rare pairs the screen
// leaves undecided take it, and inlined, its registers and schedule would
// weigh on every pair.
template <bool DP>
__device__ __noinline__ bool exact_unphased(const int* T,
                                            const twk::Bounds bnd) {
  return twk::unphased_prefilter<DP>(T, bnd);
}

// The mask byte of pair (k, l) from its P parts v; DP: with the D' term.
// The unphased kinds decide a candidate by twk::unphased_screen and run
// twk::unphased_prefilter only where it leaves the pair undecided. COUNT
// adds each undecided one to a.screen[1], on that rare branch alone.
template <int KIND, bool DP, bool COUNT>
__device__ __forceinline__ unsigned pair_mask(const Args& a, const int* v,
                                              int k, int l, int aci,
                                              bool vi) {
  if (!twk::candidate(vi, a.valid_j[l] != 0, aci, a.ac_j[l], k, l, a.diag,
                      a.cls, a.an_i, a.an_j, a.win))
    return 0;
  if constexpr (KIND == 0) {
    // ld_kernels.phased_cells, 4-part branch
    const int altalt = v[0];
    const int altref = v[1] - altalt;
    const int refalt = v[2] - altalt;
    const int refref = v[3] - altalt - altref - refalt;
    return twk::phased_prefilter<DP>(refref, refalt, altref, altalt, a.bnd)
               ? 2u
               : 1u;
  } else {
    int T[9];
    unphased_cells<KIND>(a, v, k, l, T);
    const int s = twk::unphased_screen<DP>(T, a.bnd, a.scr);
    if (s == twk::kUndecided) {
      if constexpr (COUNT) atomicAdd(a.screen + 1, 1ull);
      return exact_unphased<DP>(T, a.bnd) ? 2u : 1u;
    }
    return s == twk::kKeep ? 2u : 1u;
  }
}

// The epilogue of a block from its accumulators: the mask bytes, the
// parts and the row counts; DP: with the D' term; COUNT (a.counts given):
// the block's candidates, every one screened, from its row counts into
// a.screen[0] with one atomic (pair_mask adds the undecided).
template <int KIND, bool DP, bool COUNT>
__device__ __forceinline__ void epilogue(
    const Args& a,
    const int (&acc)[Shape<KIND>::kParts][Shape<KIND>::kMi]
                    [Shape<KIND>::kNi][4],
    uint32_t* smem, int row0, int col0) {
  using S = Shape<KIND>;
  constexpr int P = S::kParts, kMi = S::kMi, kNi = S::kNi;
  constexpr int TI = TileOf<KIND>::kRows;
  const int B = a.B;
  // the row counts of the block, in the freed staging buffers
  unsigned* srow = reinterpret_cast<unsigned*>(smem);
  if (a.counts != nullptr) {
    for (int r = threadIdx.x; r < TI; r += kThreads) srow[r] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wr = (warp / twk::mma::kWarpsN) * kMi * 16;
  const int wc = (warp % twk::mma::kWarpsN) * kNi * 8;
  const size_t BB = (size_t)B * B;
  const bool even = B % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr + mi * 16 + h * 8 + g;
      const int k = row0 + r;
      const bool row_in = k < B;
      const int aci = row_in ? a.ac_i[k] : 0;
      const bool vi = row_in && a.valid_i[k] != 0;
      unsigned n = 0;
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni) {
        const int l0 = col0 + wc + ni * 8 + 2 * t;
        if (!row_in || l0 >= B) continue;
        const size_t f = (size_t)k * B + l0;
        unsigned m2 = 0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (l0 + e >= B) continue;
          int v[P];
#pragma unroll
          for (int p = 0; p < P; ++p) v[p] = acc[p][mi][ni][2 * h + e];
          const unsigned m =
              pair_mask<KIND, DP, COUNT>(a, v, k, l0 + e, aci, vi);
          m2 |= m << (8 * e);
          n += count_byte(m);
        }
        if (even) {
          *reinterpret_cast<uint16_t*>(a.mask + f) = (uint16_t)m2;
#pragma unroll
          for (int p = 0; p < P; ++p)
            __stcs(reinterpret_cast<int2*>(a.parts + p * BB + f),
                   make_int2(acc[p][mi][ni][2 * h], acc[p][mi][ni][2 * h + 1]));
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (l0 + e < B) {
              a.mask[f + e] = (uint8_t)(m2 >> (8 * e));
#pragma unroll
              for (int p = 0; p < P; ++p)
                __stcs(a.parts + p * BB + f + e, acc[p][mi][ni][2 * h + e]);
            }
        }
      }
      if (a.counts != nullptr) {  // uniform across the block
        n += __shfl_xor_sync(0xffffffffu, n, 1);
        n += __shfl_xor_sync(0xffffffffu, n, 2);
        if (t == 0 && n != 0) atomicAdd(srow + r, n);
      }
    }
  if (a.counts == nullptr) return;
  __syncthreads();
  const int n_seg = (B + kSeg - 1) / kSeg;
  unsigned cand = 0;
  for (int r = threadIdx.x; r < TI; r += kThreads)
    if (srow[r] != 0 && row0 + r < B) {
      atomicAdd(reinterpret_cast<unsigned*>(a.counts) +
                    (size_t)(row0 + r) * n_seg + col0 / kSeg,
                srow[r]);
      cand += srow[r] >> 16;
    }
  if constexpr (COUNT) {
    if (threadIdx.x < TI) {  // the warps that hold rows (TI % 32 == 0)
      cand = __reduce_add_sync(0xffffffffu, cand);
      if (lane == 0 && cand != 0)
        atomicAdd(a.screen, (unsigned long long)cand);
    }
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads, 2) parts_tile_kernel(const Args a) {
  using S = Shape<KIND>;
  using Tile = TileOf<KIND>;
  constexpr int P = S::kParts, kMi = S::kMi, kNi = S::kNi;
  constexpr int TI = Tile::kRows, TJ = Tile::kCols;
  static_assert(kSeg % TJ == 0, "a block lies in one counts segment");
  static_assert(TI * 4 <= Tile::kSmemBytes && TI % 32 == 0,
                "row counts fit, whole warps hold them");
  extern __shared__ __align__(16) uint32_t smem[];
  const int row0 = blockIdx.y * TI;
  const int col0 = blockIdx.x * TJ;
  const int B = a.B;

  if (a.win.window > 0 &&
      !twk::block_live(a.win, a.valid_i, a.valid_j, row0, TI, col0, TJ, B,
                       a.diag)) {
    for (int e = threadIdx.x; e < TI * TJ; e += kThreads) {
      const int k = row0 + e / TJ;
      const int l = col0 + e % TJ;
      if (k < B && l < B) a.mask[(size_t)k * B + l] = 0;
    }
    return;
  }

  int acc[P][kMi][kNi][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][mi][ni][q] = 0;
  const uint32_t* const xa[3] = {a.pi[0], a.pi[1], a.pi[2]};
  const uint32_t* const xb[3] = {a.pj[0], a.pj[1], a.pj[2]};
  Tile::run(smem, xa, xb, row0, col0, B, a.W, acc);
  if constexpr (KIND != 0) {
    if (a.screen != nullptr) {
      if (twk::dprime_on(a.bnd))
        epilogue<KIND, true, true>(a, acc, smem, row0, col0);
      else
        epilogue<KIND, false, true>(a, acc, smem, row0, col0);
      return;
    }
  }
  if (twk::dprime_on(a.bnd))
    epilogue<KIND, true, false>(a, acc, smem, row0, col0);
  else
    epilogue<KIND, false, false>(a, acc, smem, row0, col0);
}

template <int KIND>
int launch(const Args& a, cudaStream_t s) {
  using Tile = TileOf<KIND>;
  if (a.counts != nullptr) {
    const size_t n_seg = (a.B + kSeg - 1) / kSeg;
    const cudaError_t rc =
        cudaMemsetAsync(a.counts, 0, (size_t)a.B * n_seg * 4, s);
    if (rc != cudaSuccess) return (int)rc;
  }
  // per device, so set on every launch (a host-side call of about 1 us)
  const cudaError_t rc = cudaFuncSetAttribute(
      parts_tile_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile::kSmemBytes);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((a.B + Tile::kCols - 1) / Tile::kCols,
                  (a.B + Tile::kRows - 1) / Tile::kRows);
  parts_tile_kernel<KIND><<<grid, kThreads, Tile::kSmemBytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 0 phased with missing data (x = alt, y = miss), 1 unphased
// (x = het, y = hom), 2 unphased with missing data (z = valid).
// cls: 0 all, 1 clean, 2 missing (needs an_*). n_het/n_hom: kind 1 only.
// window: 0 none, else bp (needs pos_* and rid_*). counts: int32
// [B, ceil(B / 128)] or null. screen: int64 [2] or null (kinds 1 and 2,
// with counts), added the candidate pairs screened and those the screen
// left undecided.
extern "C" int twk_parts_tile(
    int kind, const void* x_i, const void* y_i, const void* z_i,
    const void* x_j, const void* y_j, const void* z_j, const void* ac_i,
    const void* ac_j, const void* valid_i, const void* valid_j,
    const void* an_i, const void* an_j, const void* nhet_i,
    const void* nhom_i, const void* nhet_j, const void* nhom_j,
    const void* pos_i, const void* pos_j, const void* rid_i,
    const void* rid_j, int window, int cls, int B, int W, int n_samples,
    float lo, float hi, float dp_lo, float dp_hi, int need_nonzero, int diag,
    void* mask, void* parts, void* counts, void* screen, void* stream) {
  const bool bad =
      B <= 0 || W <= 0 || kind < 0 || kind > 2 || cls < 0 || cls > 2 ||
      !x_i || !y_i || !x_j || !y_j || !ac_i || !ac_j || !valid_i ||
      !valid_j || !mask || !parts || (kind == 2 && (!z_i || !z_j)) ||
      (cls != 0 && (!an_i || !an_j)) || window < 0 ||
      (window > 0 && (!pos_i || !pos_j || !rid_i || !rid_j)) ||
      (kind == 1 && (!nhet_i || !nhom_i || !nhet_j || !nhom_j)) ||
      (screen && (kind == 0 || !counts));
  if (bad) return (int)cudaErrorInvalidValue;
  Args a;
  a.pi[0] = (const uint32_t*)x_i;
  a.pi[1] = (const uint32_t*)y_i;
  a.pi[2] = (const uint32_t*)z_i;
  a.pj[0] = (const uint32_t*)x_j;
  a.pj[1] = (const uint32_t*)y_j;
  a.pj[2] = (const uint32_t*)z_j;
  a.ac_i = (const int32_t*)ac_i;
  a.ac_j = (const int32_t*)ac_j;
  a.valid_i = (const uint8_t*)valid_i;
  a.valid_j = (const uint8_t*)valid_j;
  a.an_i = (const int32_t*)an_i;
  a.an_j = (const int32_t*)an_j;
  a.nhet_i = (const int32_t*)nhet_i;
  a.nhom_i = (const int32_t*)nhom_i;
  a.nhet_j = (const int32_t*)nhet_j;
  a.nhom_j = (const int32_t*)nhom_j;
  a.win = {(const int32_t*)pos_i, (const int32_t*)pos_j,
           (const int32_t*)rid_i, (const int32_t*)rid_j, window};
  a.cls = cls;
  a.B = B;
  a.W = W;
  a.n_samples = n_samples;
  a.bnd = {lo, hi, dp_lo, dp_hi, need_nonzero};
  a.scr = twk::screen_for(a.bnd, n_samples);
  a.diag = diag;
  a.mask = (uint8_t*)mask;
  a.parts = (int32_t*)parts;
  a.counts = (int32_t*)counts;
  a.screen = (unsigned long long*)screen;
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0) return launch<0>(a, s);
  if (kind == 1) return launch<1>(a, s);
  return launch<2>(a, s);
}
