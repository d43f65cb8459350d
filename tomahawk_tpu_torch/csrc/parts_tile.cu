// One tile of variant pairs -> (candidate/survivor mask, P raw parts), for
// the tile instances with more than one contraction.
//
// Replaces tomahawk_tpu/ops/pallas_tiles.py::_make_kernel (built by
// _build_call, reached through sweeps.tile_prefilter) in its instances
// with P = 4 or 9 parts, with and without a window, and with them
// tools/probe_pallas.py's `fused` probe, whose 4 het/hom contractions are the unphased P = 4
// instance with a toy epilogue:
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
// What bounds it on the H100: POPC issue, as for phased_tile. Each part is
// the popcount of the AND of two packed rows of W words, so a B x B tile
// is P * B * B * W popcounts: at B = 4096 and 2,504 samples, 10.7e9 for
// the phased P=4 instance (W = 160), 5.4e9 for unphased P=4 and 12.1e9 for
// P=9 (W = 80), against about 4.2e12 popcounts/s on 132 SMs. The design is
// phased_tile's: a block stages its rows' and columns' words of every
// plane in shared memory (transposed, padded against bank conflicts), and
// each of its 256 threads keeps R x C pairs x P parts in registers, so each
// word read from shared memory feeds C (or R) AND+POPC+ADD steps per part.
// R x C is 4 x 4 for P = 4 and 4 x 2 for P = 9 (64 and 72 accumulators),
// which keeps every instance under the register limit with no spills.
// AND+POPC over packed words counts exactly what the TPU's int8
// contraction of unpacked bits counts.
//
// Padding: every padding word of a miss plane is all ones (bitpack pads
// the bits past 2N with 1), so ~miss is zero there; words staged from past
// the row's end are filled the same way (all ones for miss, zero for the
// other planes), so padding adds to no part. Padding rows (valid = 0) are
// never candidates.
//
// The epilogue follows ops/ld_kernels.phased_cells / unphased_cells and
// the prefilters of prefilter.cuh, which keep the plain versions'
// expression order. Without missing data the unphased marginals come from
// the per-variant het/hom counts and n_samples, as the host table does.
//
// Window mode (window > 0, a runtime argument) is phased_tile's: the
// candidate test adds same contig and |pos_i - pos_j| <= window, and a
// block whose 64 x 64 (P = 4) or 64 x 32 (P = 9) pairs can hold no
// in-window pair (twk::block_live) writes its mask region as 0, leaves its
// parts unwritten and returns before the staging loop.

#include <cstdint>
#include <cuda_runtime.h>

#include "prefilter.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kWords = 16;     // packed words staged per step (divides
                               // W = 80 and 160 at 2,504 samples)

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
  float lo, hi;
  int need_nonzero, diag;
  uint8_t* mask;
  int32_t* parts;
};

template <int KIND>
struct Shape;
template <>
struct Shape<0> {  // phased, missing data
  static constexpr int kPlanes = 2, kParts = 4, kR = 4, kC = 4;
};
template <>
struct Shape<1> {  // unphased, no missing data
  static constexpr int kPlanes = 2, kParts = 4, kR = 4, kC = 4;
};
template <>
struct Shape<2> {  // unphased, missing data
  static constexpr int kPlanes = 3, kParts = 9, kR = 4, kC = 2;
};

// the value a word past the row's end stands for
template <int KIND>
__device__ __forceinline__ uint32_t pad_word(int plane) {
  return (KIND == 0 && plane == 1) ? 0xffffffffu : 0u;
}

template <int KIND>
__global__ void __launch_bounds__(kThreads) parts_tile_kernel(const Args a) {
  using S = Shape<KIND>;
  constexpr int NP = S::kPlanes, P = S::kParts, R = S::kR, C = S::kC;
  constexpr int TI = 16 * R, TJ = 16 * C;
  __shared__ uint32_t si[NP][kWords][TI + 1];
  __shared__ uint32_t sj[NP][kWords][TJ + 1];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * TI;
  const int col0 = blockIdx.x * TJ;
  const int B = a.B;
  const int W = a.W;

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

  int acc[P][R][C];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[p][r][c] = 0;

  for (int w0 = 0; w0 < W; w0 += kWords) {
    // coalesced loads: consecutive threads read consecutive words of a row
    for (int e = threadIdx.x; e < TI * kWords; e += kThreads) {
      const int r = e / kWords;
      const int k = e % kWords;
      const int w = w0 + k;
      const int g = row0 + r;
      const bool in = g < B && w < W;
      const size_t o = (size_t)g * W + w;
#pragma unroll
      for (int pl = 0; pl < NP; ++pl)
        si[pl][k][r] = in ? a.pi[pl][o] : pad_word<KIND>(pl);
    }
    for (int e = threadIdx.x; e < TJ * kWords; e += kThreads) {
      const int r = e / kWords;
      const int k = e % kWords;
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
    for (int k = 0; k < kWords; ++k) {
      uint32_t x[NP][R], y[NP][C];
#pragma unroll
      for (int pl = 0; pl < NP; ++pl) {
#pragma unroll
        for (int r = 0; r < R; ++r) x[pl][r] = si[pl][k][ty + 16 * r];
#pragma unroll
        for (int c = 0; c < C; ++c) y[pl][c] = sj[pl][k][tx + 16 * c];
      }
      if constexpr (KIND == 0) {
        // valid = NOT missing, inverted at the packed-word level
#pragma unroll
        for (int r = 0; r < R; ++r) x[1][r] = ~x[1][r];
#pragma unroll
        for (int c = 0; c < C; ++c) y[1][c] = ~y[1][c];
      }
      // phased: x, y = (alt, valid); unphased: (het, hom[, valid])
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc[0][r][c] += __popc(x[0][r] & y[0][c]);
          acc[1][r][c] += __popc(x[0][r] & y[1][c]);
          acc[2][r][c] += __popc(x[1][r] & y[0][c]);
          acc[3][r][c] += __popc(x[1][r] & y[1][c]);
          if constexpr (KIND == 2) {
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
    const int aci = a.ac_i[k];
    const bool vi = a.valid_i[k] != 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int l = col0 + tx + 16 * c;
      if (l >= B) continue;
      const size_t f = (size_t)k * B + l;
      uint8_t m = 0;
      if (twk::candidate(vi, a.valid_j[l] != 0, aci, a.ac_j[l], k, l, a.diag,
                         a.cls, a.an_i, a.an_j, a.win)) {
        bool pf;
        if constexpr (KIND == 0) {
          // ld_kernels.phased_cells, 4-part branch
          const int altalt = acc[0][r][c];
          const int altref = acc[1][r][c] - altalt;
          const int refalt = acc[2][r][c] - altalt;
          const int refref = acc[3][r][c] - altalt - altref - refalt;
          pf = twk::phased_prefilter(refref, refalt, altref, altalt, a.lo,
                                     a.hi, a.need_nonzero);
        } else {
          // ld_kernels.unphased_cells
          const int T11 = acc[0][r][c], T12 = acc[1][r][c];
          const int T21 = acc[2][r][c], T22 = acc[3][r][c];
          int hv, vh, ov, vo, vv;
          if constexpr (KIND == 2) {
            hv = acc[4][r][c];
            vh = acc[5][r][c];
            ov = acc[6][r][c];
            vo = acc[7][r][c];
            vv = acc[8][r][c];
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
          const int T00 =
              vv - (T01 + T02 + T10 + T11 + T12 + T20 + T21 + T22);
          const int T[9] = {T00, T01, T02, T10, T11, T12, T20, T21, T22};
          pf = twk::unphased_prefilter(T, a.lo, a.hi);
        }
        m = pf ? 2 : 1;
      }
      a.mask[f] = m;
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
  parts_tile_kernel<KIND><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 0 phased with missing data (x = alt, y = miss), 1 unphased
// (x = het, y = hom), 2 unphased with missing data (z = valid).
// cls: 0 all, 1 clean, 2 missing (needs an_*). n_het/n_hom: kind 1 only.
// window: 0 none, else bp (needs pos_* and rid_*).
extern "C" int twk_parts_tile(
    int kind, const void* x_i, const void* y_i, const void* z_i,
    const void* x_j, const void* y_j, const void* z_j, const void* ac_i,
    const void* ac_j, const void* valid_i, const void* valid_j,
    const void* an_i, const void* an_j, const void* nhet_i,
    const void* nhom_i, const void* nhet_j, const void* nhom_j,
    const void* pos_i, const void* pos_j, const void* rid_i,
    const void* rid_j, int window, int cls, int B, int W, int n_samples, float lo, float hi, int need_nonzero,
    int diag, void* mask, void* parts, void* stream) {
  const bool bad =
      B <= 0 || W <= 0 || kind < 0 || kind > 2 || cls < 0 || cls > 2 ||
      !x_i || !y_i || !x_j || !y_j || !ac_i || !ac_j || !valid_i ||
      !valid_j || !mask || !parts || (kind == 2 && (!z_i || !z_j)) ||
      (cls != 0 && (!an_i || !an_j)) || window < 0 ||
      (window > 0 && (!pos_i || !pos_j || !rid_i || !rid_j)) ||
      (kind == 1 && (!nhet_i || !nhom_i || !nhet_j || !nhom_j));
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
  a.lo = lo;
  a.hi = hi;
  a.need_nonzero = need_nonzero;
  a.diag = diag;
  a.mask = (uint8_t*)mask;
  a.parts = (int32_t*)parts;
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0) return launch<0>(a, s);
  if (kind == 1) return launch<1>(a, s);
  return launch<2>(a, s);
}
