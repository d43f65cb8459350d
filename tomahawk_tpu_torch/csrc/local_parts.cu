// One tile of variant pairs -> the P raw parts of a LOCAL word slice, on
// the tensor cores.
//
// Replaces tomahawk_tpu/ops/pallas_tiles.py::_make_parts_kernel (built by
// _build_parts_call, cached by get_parts_call, called by tile_parts_pallas
// from sweeps.tile_prefilter's psum branch): the parts-only kernel of the
// samples-sharded sweep. Each rank holds words [s*W/S, (s+1)*W/S) of every
// packed plane; this kernel contracts that slice, the caller sums the parts
// over the ranks (all_reduce) and csrc/epilogue.cu turns the global counts
// into the mask. There is no mask, no epilogue and no dead-block skip here:
// every lane of parts [P, B, B] is written, because the all-reduce adds
// whole tensors.
//
//   kind  table, missing data   planes per side   parts (column order)
//   0     phased, none          alt               altalt
//   1     phased, missing       alt, miss         altalt, alt_val, val_alt,
//                                                 val_val
//   2     unphased, none        het, hom          T11, T12, T21, T22
//   3     unphased, missing     het, hom, valid   T11, T12, T21, T22, hv, vh,
//                                                 ov, vo, vv
//
// (valid = ~miss for the phased table), the column order of
// pallas_tiles._chunk_parts.
//
// The contraction is the fused tile kernels': twk::mma::Contraction of
// mma_tile.cuh (1-bit AND+POPC MMAs on the packed words), with
// phased_tile's 128 x 128 block for P = 1, parts_tile's 64 x 64 for P = 4
// and 64 x 32 for P = 9 (127 registers, no spill: with no epilogue beside
// the accumulators it needs not parts_tile's 32 x 64); the counts leave
// the MMA's C layout straight to device memory, 8 bytes (two adjacent
// columns) a part a lane. Any W_local
// >= 1 is taken: rows that are not 16-byte aligned (three ranks at W = 160
// hold 54 words each) are staged 4 bytes a request. valid = ~miss is taken
// at fragment load with the words past W_local masked to zero; the miss
// plane's padding words are all ones (the upload pads them so), so ~miss
// is zero there and padding adds to no part, and the slices' parts sum to
// the whole row's.
//
// What bounds it on the H100: its output, P * B * B * 4 bytes (0.020 ms a
// part at B = 4096 and HBM rate), over its operations (64 a pair-word at
// 10.2e15 a second: 0.008 ms for P = 1 on an 80-word slice).

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_tile.cuh"

namespace {

constexpr int kThreads = twk::mma::kThreads;

struct Args {
  const uint32_t* pi[3];  // planes of the row super-block
  const uint32_t* pj[3];  // planes of the column super-block
  int B, W;
  int32_t* parts;
};

// planes a side, parts, MMA patches a warp (rows x columns), words a stage
template <int KIND>
struct Shape;
template <>
struct Shape<0> {  // phased, no missing data
  static constexpr int kPlanes = 1, kParts = 1, kMi = 4, kNi = 4, kWords = 32;
};
template <>
struct Shape<1> {  // phased, missing data
  static constexpr int kPlanes = 2, kParts = 4, kMi = 2, kNi = 2, kWords = 32;
};
template <>
struct Shape<2> {  // unphased, no missing data
  static constexpr int kPlanes = 2, kParts = 4, kMi = 2, kNi = 2, kWords = 32;
};
template <>
struct Shape<3> {  // unphased, missing data
  static constexpr int kPlanes = 3, kParts = 9, kMi = 2, kNi = 1, kWords = 16;
};

template <int KIND>
using TileOf =
    twk::mma::Contraction<Shape<KIND>::kPlanes, Shape<KIND>::kParts,
                          Shape<KIND>::kMi, Shape<KIND>::kNi,
                          twk::mma::Products<KIND == 1>, Shape<KIND>::kWords>;

template <int KIND>
__global__ void __launch_bounds__(kThreads, 2)
local_parts_kernel(const Args a) {
  using S = Shape<KIND>;
  using Tile = TileOf<KIND>;
  constexpr int P = S::kParts, kMi = S::kMi, kNi = S::kNi;
  extern __shared__ __align__(16) uint32_t smem[];
  const int row0 = blockIdx.y * Tile::kRows;
  const int col0 = blockIdx.x * Tile::kCols;
  const int B = a.B;

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
      const int k = row0 + wr + mi * 16 + h * 8 + g;
      if (k >= B) continue;
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni) {
        const int l0 = col0 + wc + ni * 8 + 2 * t;
        if (l0 >= B) continue;
        const size_t f = (size_t)k * B + l0;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (even) {
            *reinterpret_cast<int2*>(a.parts + p * BB + f) =
                make_int2(acc[p][mi][ni][2 * h], acc[p][mi][ni][2 * h + 1]);
          } else {
            a.parts[p * BB + f] = acc[p][mi][ni][2 * h];
            if (l0 + 1 < B) a.parts[p * BB + f + 1] = acc[p][mi][ni][2 * h + 1];
          }
        }
      }
    }
}

template <int KIND>
int launch(const Args& a, cudaStream_t s) {
  using Tile = TileOf<KIND>;
  // per device, so set on every launch (a host-side call of about 1 us)
  const cudaError_t rc = cudaFuncSetAttribute(
      local_parts_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile::kSmemBytes);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((a.B + Tile::kCols - 1) / Tile::kCols,
                  (a.B + Tile::kRows - 1) / Tile::kRows);
  local_parts_kernel<KIND><<<grid, kThreads, Tile::kSmemBytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 0 phased (x = alt), 1 phased with missing data (x = alt, y = miss),
// 2 unphased (x = het, y = hom), 3 unphased with missing data (z = valid).
// W: the words of this rank's slice of every plane. parts: i32 [P, B, B].
extern "C" int twk_local_parts(int kind, const void* x_i, const void* y_i,
                               const void* z_i, const void* x_j,
                               const void* y_j, const void* z_j, int B, int W,
                               void* parts, void* stream) {
  const bool bad = B <= 0 || W <= 0 || kind < 0 || kind > 3 || !x_i || !x_j ||
                   !parts || (kind >= 1 && (!y_i || !y_j)) ||
                   (kind == 3 && (!z_i || !z_j));
  if (bad) return (int)cudaErrorInvalidValue;
  Args a;
  a.pi[0] = (const uint32_t*)x_i;
  a.pi[1] = (const uint32_t*)y_i;
  a.pi[2] = (const uint32_t*)z_i;
  a.pj[0] = (const uint32_t*)x_j;
  a.pj[1] = (const uint32_t*)y_j;
  a.pj[2] = (const uint32_t*)z_j;
  a.B = B;
  a.W = W;
  a.parts = (int32_t*)parts;
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0) return launch<0>(a, s);
  if (kind == 1) return launch<1>(a, s);
  if (kind == 2) return launch<2>(a, s);
  return launch<3>(a, s);
}
