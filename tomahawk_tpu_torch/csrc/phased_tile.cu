// One phased tile of variant pairs -> (candidate/survivor mask, ALTALT).
//
// Replaces tomahawk_tpu/ops/pallas_tiles.py::_make_kernel (built by
// _build_call, reached through sweeps.tile_prefilter) in its phased /
// no-missing instances, with and without a window, with the pair class
// cls "all" (the -p sweep and the mixed dispatch's tiles without missing
// data) or "clean" (the mixed dispatch's phased half of tiles with missing data: pairs
// whose variants have no missing allele, read from the per-variant `an`).
// csrc/parts_tile.cu serves the other instances. Like the TPU kernel it
// writes mask = 0 (not a candidate), 1 (candidate) or 2 (survivor of the
// f32 prefilter) and the raw contraction ALTALT; unlike it, it applies the
// diagonal upper-triangle rule itself (the TPU path did that outside the
// kernel only to dodge a Mosaic lowering crash).
//
// What bounds it on the H100: the contraction. ALTALT[k,l] counts the
// haplotypes carrying the alt allele at both variants, the popcount of
// the AND of two packed rows of W words, so a B x B tile is B*B*W
// AND+POPC+ADD steps (4096 * 4096 * 160 = 2.7e9 at 2,504 samples) against
// 2*B*W*4 bytes of input (5 MB) and 5 bytes of output per pair. POPC
// runs at a quarter of the rate of the integer adds and logic, so it is
// the bound. The design feeds it from registers: a block stages 128 rows
// x 32 words of each operand in shared memory (transposed, padded so the
// staging stores do not conflict), and each of its 256 threads keeps an
// 8 x 8 block of pair counts in registers, so every word read from shared
// memory feeds 8 popcounts. No unpack to int8 is needed: AND+POPC over the
// packed words counts exactly what the TPU's int8 contraction counts.
// Tensor-core routes (int8 MMA on unpacked operands, the 1-bit AND+POPC
// MMA) are faster in principle and are left for later work.
//
// The epilogue follows ops/ld_kernels.phased_cells (no-missing branch) and
// phased_prefilter_cells (prefilter.cuh). Padding rows (valid = 0) are
// never candidates, and padding words are zero, so they add nothing.
//
// Window mode (window > 0, a runtime argument: one compiled instance
// serves both modes): the candidate test adds same contig and |pos_i -
// pos_j| <= window, and before anything else the block runs the TPU
// kernel's dead-block test on its own 128 x 128 pairs (twk::block_live).
// A dead block writes its mask region as 0 -- the compaction reads every
// mask byte -- leaves ALTALT unwritten and returns before the staging
// loop, so a windowed tile costs the contraction of its live blocks only.

#include <cstdint>
#include <cuda_runtime.h>

#include "prefilter.cuh"

namespace {

constexpr int kTile = 128;      // pairs per block edge
constexpr int kWords = 32;      // packed words staged per step
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kReg = 8;         // 8 x 8 pairs per thread
constexpr int kLd = kTile + 1;  // padded shared row

__global__ void __launch_bounds__(kThreads)
phased_tile_kernel(const uint32_t* __restrict__ alt_i,
                   const uint32_t* __restrict__ alt_j,
                   const int32_t* __restrict__ ac_i,
                   const int32_t* __restrict__ ac_j,
                   const uint8_t* __restrict__ valid_i,
                   const uint8_t* __restrict__ valid_j,
                   const int32_t* __restrict__ an_i,
                   const int32_t* __restrict__ an_j,
                   const twk::Window win, int cls, int B, int W, int n_hap,
                   float lo, float hi,
                   int need_nonzero, int diag,
                   uint8_t* __restrict__ mask,
                   int32_t* __restrict__ altalt) {
  __shared__ uint32_t sa[kWords][kLd];
  __shared__ uint32_t sb[kWords][kLd];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  if (win.window > 0 &&
      !twk::block_live(win, valid_i, valid_j, row0, kTile, col0, kTile, B,
                       diag)) {
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int k = row0 + e / kTile;
      const int l = col0 + e % kTile;
      if (k < B && l < B) mask[(size_t)k * B + l] = 0;
    }
    return;
  }

  int acc[kReg][kReg];
#pragma unroll
  for (int r = 0; r < kReg; ++r)
#pragma unroll
    for (int c = 0; c < kReg; ++c) acc[r][c] = 0;

  for (int w0 = 0; w0 < W; w0 += kWords) {
    // coalesced loads: consecutive threads read consecutive words of a row
    for (int e = threadIdx.x; e < kTile * kWords; e += kThreads) {
      const int r = e / kWords;
      const int k = e % kWords;
      const int w = w0 + k;
      const int gi = row0 + r;
      const int gj = col0 + r;
      sa[k][r] = (gi < B && w < W) ? alt_i[(size_t)gi * W + w] : 0u;
      sb[k][r] = (gj < B && w < W) ? alt_j[(size_t)gj * W + w] : 0u;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kWords; ++k) {
      uint32_t a[kReg], b[kReg];
#pragma unroll
      for (int r = 0; r < kReg; ++r) a[r] = sa[k][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < kReg; ++c) b[c] = sb[k][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < kReg; ++r)
#pragma unroll
        for (int c = 0; c < kReg; ++c) acc[r][c] += __popc(a[r] & b[c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kReg; ++r) {
    const int k = row0 + ty + 16 * r;
    if (k >= B) continue;
    const int aci = ac_i[k];
    const bool vi = valid_i[k] != 0;
#pragma unroll
    for (int c = 0; c < kReg; ++c) {
      const int l = col0 + tx + 16 * c;
      if (l >= B) continue;
      const int aa = acc[r][c];
      const int acj = ac_j[l];
      uint8_t m = 0;
      if (twk::candidate(vi, valid_j[l] != 0, aci, acj, k, l, diag, cls,
                         an_i, an_j, win)) {
        const int altref = aci - aa;
        const int refalt = acj - aa;
        const int refref = n_hap - (aci + acj) + aa;
        m = twk::phased_prefilter(refref, refalt, altref, aa, lo, hi,
                                  need_nonzero) ? 2 : 1;
      }
      mask[(size_t)k * B + l] = m;
      altalt[(size_t)k * B + l] = aa;
    }
  }
}

}  // namespace

extern "C" int twk_phased_tile(const void* alt_i, const void* alt_j,
                               const void* ac_i, const void* ac_j,
                               const void* valid_i, const void* valid_j,
                               const void* an_i, const void* an_j,
                               const void* pos_i, const void* pos_j,
                               const void* rid_i, const void* rid_j,
                               int window, int cls, int B, int W, int n_hap, float lo, float hi,
                               int need_nonzero, int diag, void* mask,
                               void* altalt, void* stream) {
  if (B <= 0 || W <= 0 || cls < 0 || cls > 2 ||
      (cls != 0 && (an_i == nullptr || an_j == nullptr)) || window < 0 ||
      (window > 0 && (!pos_i || !pos_j || !rid_i || !rid_j)))
    return (int)cudaErrorInvalidValue;
  const twk::Window win = {(const int32_t*)pos_i, (const int32_t*)pos_j,
                           (const int32_t*)rid_i, (const int32_t*)rid_j,
                           window};
  const dim3 grid((B + kTile - 1) / kTile, (B + kTile - 1) / kTile);
  phased_tile_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)alt_i, (const uint32_t*)alt_j,
      (const int32_t*)ac_i, (const int32_t*)ac_j,
      (const uint8_t*)valid_i, (const uint8_t*)valid_j,
      (const int32_t*)an_i, (const int32_t*)an_j, win, cls, B, W, n_hap, lo,
      hi,
      need_nonzero, diag, (uint8_t*)mask, (int32_t*)altalt);
  return (int)cudaGetLastError();
}

extern "C" const char* twk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
