// One tile of variant pairs -> the P raw parts of a LOCAL word slice.
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
// What bounds it on the H100: the POPC rate, as for the fused tile kernels.
// A part is the popcount of the AND of two packed rows of W_local words, so
// a tile is P * B * B * W_local popcounts against about 4.2e12 a second,
// and P * B * B * 4 bytes written (0.02 ms a part at B = 4096). The design
// is the fused kernels': a block stages its rows' and columns' words of
// every plane in shared memory (transposed, padded against bank conflicts)
// and each of its 256 threads keeps R x C pairs x P parts in registers
// (8 x 8 for P = 1, 4 x 4 for P = 4, 4 x 2 for P = 9), so each word read
// from shared memory feeds C (or R) AND+POPC+ADD steps per part. AND+POPC
// over packed words counts exactly what the TPU's int8 contraction of
// unpacked bits counts.
//
// Any W_local >= 1 is taken: loads are one word a thread, so a row need not
// be 16-byte aligned (three ranks at W = 160 hold 54 words each). The miss
// plane's padding words are all ones (the upload pads them so), and words
// staged from past a row's end are filled the same way, so ~miss is zero
// there and padding adds to no part.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads

struct Args {
  const uint32_t* pi[3];  // planes of the row super-block
  const uint32_t* pj[3];  // planes of the column super-block
  int B, W;
  int32_t* parts;
};

template <int KIND>
struct Shape;
template <>
struct Shape<0> {  // phased, no missing data
  static constexpr int kPlanes = 1, kParts = 1, kR = 8, kC = 8, kWords = 32;
};
template <>
struct Shape<1> {  // phased, missing data
  static constexpr int kPlanes = 2, kParts = 4, kR = 4, kC = 4, kWords = 16;
};
template <>
struct Shape<2> {  // unphased, no missing data
  static constexpr int kPlanes = 2, kParts = 4, kR = 4, kC = 4, kWords = 16;
};
template <>
struct Shape<3> {  // unphased, missing data
  static constexpr int kPlanes = 3, kParts = 9, kR = 4, kC = 2, kWords = 16;
};

// the value a word past the row's end stands for
template <int KIND>
__device__ __forceinline__ uint32_t pad_word(int plane) {
  return (KIND == 1 && plane == 1) ? 0xffffffffu : 0u;
}

template <int KIND>
__global__ void __launch_bounds__(kThreads) local_parts_kernel(const Args a) {
  using S = Shape<KIND>;
  constexpr int NP = S::kPlanes, P = S::kParts, R = S::kR, C = S::kC;
  constexpr int KW = S::kWords;
  constexpr int TI = 16 * R, TJ = 16 * C;
  __shared__ uint32_t si[NP][KW][TI + 1];
  __shared__ uint32_t sj[NP][KW][TJ + 1];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * TI;
  const int col0 = blockIdx.x * TJ;
  const int B = a.B;
  const int W = a.W;

  int acc[P][R][C];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[p][r][c] = 0;

  for (int w0 = 0; w0 < W; w0 += KW) {
    // coalesced loads: consecutive threads read consecutive words of a row
    for (int e = threadIdx.x; e < TI * KW; e += kThreads) {
      const int r = e / KW;
      const int k = e % KW;
      const int w = w0 + k;
      const int g = row0 + r;
      const bool in = g < B && w < W;
      const size_t o = (size_t)g * W + w;
#pragma unroll
      for (int pl = 0; pl < NP; ++pl)
        si[pl][k][r] = in ? a.pi[pl][o] : pad_word<KIND>(pl);
    }
    for (int e = threadIdx.x; e < TJ * KW; e += kThreads) {
      const int r = e / KW;
      const int k = e % KW;
      const int w = w0 + k;
      const int g = col0 + r;
      const bool in = g < B && w < W;
      const size_t o = (size_t)g * W + w;
#pragma unroll
      for (int pl = 0; pl < NP; ++pl)
        sj[pl][k][r] = in ? a.pj[pl][o] : pad_word<KIND>(pl);
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < KW; ++k) {
      uint32_t x[NP][R], y[NP][C];
#pragma unroll
      for (int pl = 0; pl < NP; ++pl) {
#pragma unroll
        for (int r = 0; r < R; ++r) x[pl][r] = si[pl][k][ty + 16 * r];
#pragma unroll
        for (int c = 0; c < C; ++c) y[pl][c] = sj[pl][k][tx + 16 * c];
      }
      if constexpr (KIND == 1) {
        // valid = NOT missing, inverted at the packed-word level
#pragma unroll
        for (int r = 0; r < R; ++r) x[1][r] = ~x[1][r];
#pragma unroll
        for (int c = 0; c < C; ++c) y[1][c] = ~y[1][c];
      }
      // phased: x, y = (alt[, valid]); unphased: (het, hom[, valid])
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc[0][r][c] += __popc(x[0][r] & y[0][c]);
          if constexpr (P >= 4) {
            acc[1][r][c] += __popc(x[0][r] & y[1][c]);
            acc[2][r][c] += __popc(x[1][r] & y[0][c]);
            acc[3][r][c] += __popc(x[1][r] & y[1][c]);
          }
          if constexpr (P == 9) {
            acc[4][r][c] += __popc(x[0][r] & y[2][c]);
            acc[5][r][c] += __popc(x[2][r] & y[0][c]);
            acc[6][r][c] += __popc(x[1][r] & y[2][c]);
            acc[7][r][c] += __popc(x[2][r] & y[1][c]);
            acc[8][r][c] += __popc(x[2][r] & y[2][c]);
          }
        }
    }
    __syncthreads();
  }

  const size_t BB = (size_t)B * B;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = row0 + ty + 16 * r;
    if (k >= B) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int l = col0 + tx + 16 * c;
      if (l >= B) continue;
      const size_t f = (size_t)k * B + l;
#pragma unroll
      for (int p = 0; p < P; ++p) a.parts[p * BB + f] = acc[p][r][c];
    }
  }
}

template <int KIND>
int launch(const Args& a, cudaStream_t s) {
  using S = Shape<KIND>;
  const int TI = 16 * S::kR, TJ = 16 * S::kC;
  const dim3 grid((a.B + TJ - 1) / TJ, (a.B + TI - 1) / TI);
  local_parts_kernel<KIND><<<grid, kThreads, 0, s>>>(a);
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
