// One phased tile of variant pairs -> (candidate/survivor mask, ALTALT,
// per-segment survivor and candidate counts), on the tensor cores.
//
// Replaces tomahawk_tpu/ops/pallas_tiles.py::_make_kernel (built by
// _build_call, reached through sweeps.tile_prefilter; its _unpack and
// _chunk_parts unpack the packed planes to int8 and contract them on the
// TPU's matrix unit) in its phased / no-missing instances, with and
// without a window, with the pair class cls "all" (the -p sweep and the
// mixed dispatch's tiles without missing data) or "clean" (the mixed
// dispatch's phased half of tiles with missing data: pairs whose variants
// have no missing allele, read from the per-variant `an`).
// csrc/parts_tile.cu serves the other instances. Like the TPU kernel it
// writes mask = 0 (not a candidate), 1 (candidate) or 2 (survivor of the
// f32 prefilter) and the raw contraction ALTALT; unlike it, it applies the
// diagonal upper-triangle rule itself (the TPU path did that outside the
// kernel only to dodge a Mosaic lowering crash).
//
// The contraction: ALTALT[k,l] counts the haplotypes carrying the alt
// allele at both variants, the popcount of the AND of two packed rows of
// W words. The H100's tensor cores do exactly that on the packed words
// (mma.sync.m16n8k256.b1.and.popc), with no unpack to int8; mma_tile.cuh
// holds the staging and MMA loop and the fragment layout it relies on. On
// an NVIDIA H100 80GB HBM3 (700 W) that instruction runs at 10.2-10.5e15
// bit-operations a second (csrc/mma_probe.cu), so a 4096 x 4096 tile over
// 160 words (1.72e11 operations) needs 0.017 ms of it, against 0.639 ms of
// AND + __popc on the CUDA cores, the design this kernel had before (it
// took 0.737 ms a tile).
//
// What bounds it on the H100 now: its operand traffic from L2, its output
// and the epilogue's arithmetic, one after the other. A tile writes 5
// bytes a pair (84 MB at B = 4096, 0.025 ms at HBM rate) from 5 MB of
// input, which its 1,024 blocks read 32 times over (168 MB from L2), and
// every pair runs the f32 prefilter on the CUDA cores. Measured on the
// card with parts of the kernel cut out (time_variants.py; NVIDIA
// H100 80GB HBM3, 700 W): the whole 0.098 ms, without the staging + MMA
// loop 0.053, without the prefilter 0.072, the stores alone 0.029: the
// three overlap only in part. So the epilogue is laid out for the stores
// and for few instructions a pair. The counts leave the MMA layout through
// shared memory (the freed staging buffers, rows kAccLd words apart so
// that the int2 stores of a quad and the int4 loads of a quarter warp hit
// 32 distinct banks); then a warp owns 16 whole rows
// of the block and a lane 4 adjacent columns of each: ALTALT leaves as one
// int4 a lane, 512 contiguous bytes a warp, with a streaming hint (the
// compaction reads ALTALT only at survivors); the mask as 4 bytes a lane,
// one 128-byte line a warp; the rows' metadata is loaded once, a row a
// lane, and handed round by shuffles, and a column's stays in registers,
// so that no row waits on a load; rows go four at a time so that one
// row's warp reduction and stores do not hold back the next row's
// arithmetic. The same pass counts each row segment's survivors and
// candidates with that warp reduction and writes them as
// n_survivors | n_candidates << 16 into counts[k, block column], so the
// compaction (csrc/compact.cu) need not read the mask to count it. Every
// block writes its own cells; nothing is cleared and there are no atomics.
//
// The epilogue follows ops/ld_kernels.phased_cells (no-missing branch) and
// phased_prefilter_cells (prefilter.cuh's phased_prefilter, the one
// statement of it that every kernel shares, with its D' term where the run
// sets D' bounds), bit for bit (-fmad=false).
// Padding rows (valid = 0) and rows past B are never candidates, and
// padding words are zero, so they add nothing. A second form of the
// prefilter that took the table's marginals from the row and the column,
// where they are constant, and converted one count a pair instead of four
// was tried and bought nothing (0.0986 against 0.0988 ms a tile, same
// card): the kernel does not wait on that arithmetic.
//
// Window mode (window > 0, a runtime argument: one compiled instance
// serves both modes): the candidate test adds same contig and |pos_i -
// pos_j| <= window, and before anything else the block runs the TPU
// kernel's dead-block test on its own 128 x 128 pairs (twk::block_live).
// A dead block writes its mask region and its counts as 0, leaves ALTALT
// unwritten and returns before the staging loop, so a windowed tile costs
// the contraction of its live blocks only.

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_tile.cuh"
#include "prefilter.cuh"

namespace {

struct OnePlane {
  static __host__ __device__ constexpr int a(int) { return 0; }
  static __host__ __device__ constexpr int b(int) { return 0; }
  static __host__ __device__ constexpr bool inverted(int) { return false; }
};

constexpr int kMi = 4;  // 16-row MMA patches a warp: 64 rows
constexpr int kNi = 4;  // 8-column MMA patches a warp: 32 columns
using Tile = twk::mma::Contraction<1, 1, kMi, kNi, OnePlane>;
constexpr int kTile = Tile::kRows;  // pairs per block edge, and the
                                    // columns of one counts segment
static_assert(Tile::kRows == 128 && Tile::kCols == 128, "128 x 128 blocks");
constexpr int kThreads = twk::mma::kThreads;
constexpr int kAccLd = kTile + 8;  // words between rows of the counts in
                                   // shared memory: banks 8g + 2t (+1)
constexpr int kWarpRows = kTile / (kThreads / 32);  // epilogue rows a warp
static_assert(kTile * kAccLd * 4 <= Tile::kSmemBytes, "counts tile fits");
static_assert(kTile == 32 * 4, "a lane holds 4 columns of a row");
static_assert(kWarpRows <= 32, "a lane holds the metadata of one row");
static_assert(kWarpRows % 4 == 0, "rows go four at a time");

// Per-variant metadata of the 4 columns a lane holds in the epilogue.
struct Cols {
  int ac[4];
  bool valid[4];
  bool clean[4];  // an == 0 (read when cls != 0)
  int pos[4];     // read when window > 0
  int rid[4];
};

// What the epilogue reads beside the counts: the kernel's scalar arguments.
struct Scalars {
  twk::Window win;
  int cls, B, n_hap, diag, n_seg;
  twk::Bounds bnd;
};

// Metadata of one row, the same in every lane.
struct Row {
  int k, ac, pos, rid;
  bool valid, clean;
};

// survivors | candidates << 16 among 4 mask bytes (0, 1 or 2): bit 1 marks
// a survivor, either bit a candidate
__device__ __forceinline__ unsigned count_bytes(uint32_t m4) {
  return __popc(m4 & 0x02020202u) |
         __popc((m4 | (m4 >> 1)) & 0x01010101u) << 16;
}

// The mask bytes of row `row` at the lane's 4 columns, from their counts
// aa; DP: with the D' term.
template <bool DP>
__device__ __forceinline__ uint32_t row_mask(const Scalars& s, const Cols& col,
                                             const Row& row, const int (&aa)[4],
                                             int l0) {
  uint32_t m4 = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // twk::candidate on the hoisted metadata
    bool m = row.valid && col.valid[q] && row.ac + col.ac[q] > 2 &&
             (!s.diag || row.k < l0 + q);
    if (s.win.window > 0 && m) {
      const int d = row.pos - col.pos[q];
      m = row.rid == col.rid[q] && (d < 0 ? -d : d) <= s.win.window;
    }
    if (s.cls != 0 && m) {
      const bool clean = row.clean && col.clean[q];
      m = s.cls == 1 ? clean : !clean;
    }
    const int altref = row.ac - aa[q];
    const int refalt = col.ac[q] - aa[q];
    const int refref = s.n_hap - (row.ac + col.ac[q]) + aa[q];
    const bool pf =
        twk::phased_prefilter<DP>(refref, refalt, altref, aa[q], s.bnd);
    m4 |= (m ? (pf ? 2u : 1u) : 0u) << (8 * q);
  }
  return m4;
}

// Store one row segment's mask bytes (m4, one byte a column), its counts
// cell n (the warp's sum of count_bytes) and, when `aa` is given, its
// ALTALT. 32 lanes hold the 128 columns.
__device__ __forceinline__ void store_row(const Scalars& s, uint32_t m4,
                                          unsigned n, const int4* aa, int k,
                                          int l0, uint8_t* __restrict__ mask,
                                          int32_t* __restrict__ altalt,
                                          int32_t* __restrict__ counts) {
  const int B = s.B;
  if (k >= B) return;  // uniform across the warp
  if (threadIdx.x % 32 == 0 && counts != nullptr)
    counts[(size_t)k * s.n_seg + blockIdx.x] = (int32_t)n;
  const size_t f = (size_t)k * B + l0;
  if (B % 4 == 0) {
    if (l0 < B) {
      *reinterpret_cast<uint32_t*>(mask + f) = m4;
      if (aa != nullptr) __stcs(reinterpret_cast<int4*>(altalt + f), *aa);
    }
  } else {
    const int v[4] = {aa ? aa->x : 0, aa ? aa->y : 0, aa ? aa->z : 0,
                      aa ? aa->w : 0};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (l0 + q < B) {
        mask[f + q] = (uint8_t)(m4 >> (8 * q));
        if (aa != nullptr) __stcs(altalt + f + q, v[q]);
      }
  }
}

// The epilogue of one warp: kWarpRows whole rows of the block from the
// counts in shared memory (rows kAccLd apart), a lane 4 adjacent columns
// of each. Rows go kBatch at a time: first the arithmetic of all of
// them, then their warp reductions, then their stores, so that the
// reductions and the stores' branches of one row do not hold back the
// next (one row at a time took a fifth of the kernel longer).
template <bool DP>
__device__ __forceinline__ void warp_rows(
    const Scalars& s, const Cols& col, const int* sacc, int row0, int l0,
    const int32_t* __restrict__ ac_i, const uint8_t* __restrict__ valid_i,
    const int32_t* __restrict__ an_i, uint8_t* __restrict__ mask,
    int32_t* __restrict__ altalt, int32_t* __restrict__ counts) {
  constexpr int kBatch = 4;
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const int first = (threadIdx.x / 32) * kWarpRows;
  // lane i holds the metadata of the warp's row i, handed round by
  // shuffles, so no row waits on a load of its own
  int my_ac = 0, my_flags = 0, my_pos = 0, my_rid = 0;
  {
    const int k = row0 + first + lane % kWarpRows;
    if (k < s.B) {
      my_ac = ac_i[k];
      my_flags = (valid_i[k] != 0 ? 1 : 0) |
                 (s.cls != 0 && an_i[k] == 0 ? 2 : 0);
      if (s.win.window > 0) {
        my_pos = s.win.pos_i[k];
        my_rid = s.win.rid_i[k];
      }
    }
  }
  for (int i0 = 0; i0 < kWarpRows; i0 += kBatch) {
    int4 aa4[kBatch];
    uint32_t m4[kBatch];
    unsigned n[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u;
      const int flags = __shfl_sync(kAll, my_flags, i);
      Row row;
      row.k = row0 + first + i;
      row.ac = __shfl_sync(kAll, my_ac, i);
      row.valid = (flags & 1) != 0;
      row.clean = (flags & 2) != 0;
      row.pos = s.win.window > 0 ? __shfl_sync(kAll, my_pos, i) : 0;
      row.rid = s.win.window > 0 ? __shfl_sync(kAll, my_rid, i) : 0;
      aa4[u] = *reinterpret_cast<const int4*>(sacc + (first + i) * kAccLd +
                                              4 * lane);
      const int aa[4] = {aa4[u].x, aa4[u].y, aa4[u].z, aa4[u].w};
      m4[u] = row_mask<DP>(s, col, row, aa, l0);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      n[u] = __reduce_add_sync(kAll, count_bytes(m4[u]));
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      store_row(s, m4[u], n[u], &aa4[u], row0 + first + i0 + u, l0, mask,
                altalt, counts);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
phased_tile_kernel(const uint32_t* __restrict__ alt_i,
                   const uint32_t* __restrict__ alt_j,
                   const int32_t* __restrict__ ac_i,
                   const int32_t* __restrict__ ac_j,
                   const uint8_t* __restrict__ valid_i,
                   const uint8_t* __restrict__ valid_j,
                   const int32_t* __restrict__ an_i,
                   const int32_t* __restrict__ an_j,
                   const twk::Window win, int cls, int B, int W, int n_hap,
                   const twk::Bounds bnd, int diag,
                   uint8_t* __restrict__ mask,
                   int32_t* __restrict__ altalt,
                   int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int l0 = col0 + 4 * lane;  // the lane's first epilogue column
  const Scalars s = {win, cls, B, n_hap, diag, (int)gridDim.x, bnd};

  if (win.window > 0 &&
      !twk::block_live(win, valid_i, valid_j, row0, kTile, col0, kTile, B,
                       diag)) {
    for (int i = 0; i < kWarpRows; ++i)
      store_row(s, 0u, 0u, nullptr, row0 + warp * kWarpRows + i, l0, mask,
                altalt, counts);
    return;
  }

  int acc[1][kMi][kNi][4];
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[0][mi][ni][q] = 0;
  const uint32_t* const xa[1] = {alt_i};
  const uint32_t* const xb[1] = {alt_j};
  Tile::run(smem, xa, xb, row0, col0, B, W, acc);

  // The counts leave the MMA layout through shared memory: the thread's
  // pairs are rows wr + 16 mi + 8 h + g, columns wc + 8 ni + 2t + e.
  int* sacc = reinterpret_cast<int*>(smem);
  {
    const int g = lane / 4;
    const int t = lane % 4;
    const int wr = (warp / twk::mma::kWarpsN) * kMi * 16;
    const int wc = (warp % twk::mma::kWarpsN) * kNi * 8;
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < kNi; ++ni)
          *reinterpret_cast<int2*>(sacc + (wr + mi * 16 + h * 8 + g) * kAccLd +
                                   wc + ni * 8 + 2 * t) =
              make_int2(acc[0][mi][ni][2 * h], acc[0][mi][ni][2 * h + 1]);
  }
  __syncthreads();

  // Epilogue: a warp takes kWarpRows whole rows of the block, a lane 4
  // adjacent columns of each, whose metadata stays in registers.
  Cols col;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int l = l0 + q;
    const bool in = l < B;
    col.ac[q] = in ? ac_j[l] : 0;
    col.valid[q] = in && valid_j[l] != 0;
    col.clean[q] = cls != 0 && in ? an_j[l] == 0 : false;
    col.pos[q] = win.window > 0 && in ? win.pos_j[l] : 0;
    col.rid[q] = win.window > 0 && in ? win.rid_j[l] : 0;
  }
  if (twk::dprime_on(bnd))
    warp_rows<true>(s, col, sacc, row0, l0, ac_i, valid_i, an_i, mask,
                    altalt, counts);
  else
    warp_rows<false>(s, col, sacc, row0, l0, ac_i, valid_i, an_i, mask,
                     altalt, counts);
}

}  // namespace

// counts: int32 [B, ceil(B / 128)] or null.
extern "C" int twk_phased_tile(const void* alt_i, const void* alt_j,
                               const void* ac_i, const void* ac_j,
                               const void* valid_i, const void* valid_j,
                               const void* an_i, const void* an_j,
                               const void* pos_i, const void* pos_j,
                               const void* rid_i, const void* rid_j,
                               int window, int cls, int B, int W, int n_hap,
                               float lo, float hi, float dp_lo, float dp_hi,
                               int need_nonzero, int diag, void* mask,
                               void* altalt, void* counts, void* stream) {
  if (B <= 0 || W <= 0 || cls < 0 || cls > 2 ||
      (cls != 0 && (an_i == nullptr || an_j == nullptr)) || window < 0 ||
      (window > 0 && (!pos_i || !pos_j || !rid_i || !rid_j)))
    return (int)cudaErrorInvalidValue;
  const twk::Window win = {(const int32_t*)pos_i, (const int32_t*)pos_j,
                           (const int32_t*)rid_i, (const int32_t*)rid_j,
                           window};
  // per device, so set on every launch (a host-side call of about 1 us)
  const cudaError_t rc = cudaFuncSetAttribute(
      phased_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile::kSmemBytes);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((B + kTile - 1) / kTile, (B + kTile - 1) / kTile);
  phased_tile_kernel<<<grid, kThreads, Tile::kSmemBytes,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)alt_i, (const uint32_t*)alt_j,
      (const int32_t*)ac_i, (const int32_t*)ac_j,
      (const uint8_t*)valid_i, (const uint8_t*)valid_j,
      (const int32_t*)an_i, (const int32_t*)an_j, win, cls, B, W, n_hap,
      twk::Bounds{lo, hi, dp_lo, dp_hi, need_nonzero}, diag, (uint8_t*)mask,
      (int32_t*)altalt, (int32_t*)counts);
  return (int)cudaGetLastError();
}

extern "C" const char* twk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
