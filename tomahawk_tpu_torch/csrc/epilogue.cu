// Global parts of one tile -> the candidate/survivor mask.
//
// Replaces the jnp epilogue that tomahawk_tpu/compute/sweeps.py::
// tile_prefilter runs after the psum of the samples-sharded sweep
// (tile_mask, ld_kernels.phased_cells / unphased_cells and the f32
// prefilters, left to XLA there): parts i32 [P, B, B], summed over the
// ranks, and the per-variant metadata give mask u8 [B, B] = 0 (not a
// candidate), 1 (candidate) or 2 (survivor of the f32 prefilter), with the
// pair class cls, the distance window and the diagonal triangle applied.
// The kinds are csrc/local_parts.cu's (0 phased, 1 phased with missing data,
// 2 unphased, 3 unphased with missing data).
//
// It calls the candidate test, the cells and the prefilters the fused tile
// kernels call (prefilter.cuh), built like them with -fmad=false and IEEE
// division, so the samples-sharded sweep makes bit-identical decisions.
//
// What bounds it on the H100: bytes. One thread per pair reads P parts and
// writes one mask byte, (4 P + 1) * B * B bytes a tile (0.025 ms at P = 1,
// 0.185 ms at P = 9, B = 4096, at 3.35e12 bytes a second) against a few
// dozen f32 operations. Consecutive threads take consecutive pairs of a row,
// so every load and the store coalesce; a pair that is no candidate reads no
// part.

#include <cstdint>
#include <cuda_runtime.h>

#include "prefilter.cuh"

namespace {

constexpr int kThreads = 256;

struct Args {
  const int32_t* parts;
  const int32_t* ac_i;
  const int32_t* ac_j;
  const uint8_t* valid_i;
  const uint8_t* valid_j;
  const int32_t* an_i;  // null unless cls != 0
  const int32_t* an_j;
  const int32_t* nhet_i;  // kind 2 only
  const int32_t* nhom_i;
  const int32_t* nhet_j;
  const int32_t* nhom_j;
  twk::Window win;
  int cls, B, n_samples;
  twk::Bounds bnd;
  int diag;
  uint8_t* mask;
};

// The mask byte of one pair; DP: with the D' term.
template <int KIND, bool DP>
__device__ __forceinline__ void pair_mask(const Args& a) {
  const int B = a.B;
  const size_t BB = (size_t)B * B;
  // one grid row per variant k, so no thread divides by B
  const int k = blockIdx.y;
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= B) return;
  const size_t f = (size_t)k * B + l;
  const int aci = a.ac_i[k];
  const int acj = a.ac_j[l];
  uint8_t m = 0;
  if (twk::candidate(a.valid_i[k] != 0, a.valid_j[l] != 0, aci, acj, k, l,
                     a.diag, a.cls, a.an_i, a.an_j, a.win)) {
    bool pf;
    if constexpr (KIND == 0) {
      // ld_kernels.phased_cells, 1-part branch
      const int altalt = a.parts[f];
      const int altref = aci - altalt;
      const int refalt = acj - altalt;
      const int refref = 2 * a.n_samples - (aci + acj) + altalt;
      pf = twk::phased_prefilter<DP>(refref, refalt, altref, altalt,
                                     a.bnd);
    } else if constexpr (KIND == 1) {
      // ld_kernels.phased_cells, 4-part branch
      const int altalt = a.parts[f];
      const int altref = a.parts[BB + f] - altalt;
      const int refalt = a.parts[2 * BB + f] - altalt;
      const int refref = a.parts[3 * BB + f] - altalt - altref - refalt;
      pf = twk::phased_prefilter<DP>(refref, refalt, altref, altalt,
                                     a.bnd);
    } else {
      // ld_kernels.unphased_cells
      const int T11 = a.parts[f], T12 = a.parts[BB + f];
      const int T21 = a.parts[2 * BB + f], T22 = a.parts[3 * BB + f];
      int hv, vh, ov, vo, vv;
      if constexpr (KIND == 3) {
        hv = a.parts[4 * BB + f];
        vh = a.parts[5 * BB + f];
        ov = a.parts[6 * BB + f];
        vo = a.parts[7 * BB + f];
        vv = a.parts[8 * BB + f];
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
      const int T[9] = {T00, T01, T02, T10, T11, T12, T20, T21, T22};
      pf = twk::unphased_prefilter<DP>(T, a.bnd);
    }
    m = pf ? 2 : 1;
  }
  a.mask[f] = m;
}

template <int KIND>
__global__ void __launch_bounds__(kThreads) epilogue_kernel(const Args a) {
  if (twk::dprime_on(a.bnd))
    pair_mask<KIND, true>(a);
  else
    pair_mask<KIND, false>(a);
}

template <int KIND>
int launch(const Args& a, cudaStream_t s) {
  const dim3 grid((a.B + kThreads - 1) / kThreads, a.B);
  epilogue_kernel<KIND><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: as twk_local_parts. cls: 0 all, 1 clean, 2 missing (needs an_*).
// n_het/n_hom: kind 2 only. window: 0 none, else bp (needs pos_* and rid_*).
// parts: i32 [P, B, B], the global counts. mask: u8 [B, B].
extern "C" int twk_tile_epilogue(
    int kind, const void* parts, const void* ac_i, const void* ac_j,
    const void* valid_i, const void* valid_j, const void* an_i,
    const void* an_j, const void* nhet_i, const void* nhom_i,
    const void* nhet_j, const void* nhom_j, const void* pos_i,
    const void* pos_j, const void* rid_i, const void* rid_j, int window,
    int cls, int B, int n_samples, float lo, float hi, float dp_lo,
    float dp_hi, int need_nonzero, int diag, void* mask, void* stream) {
  const bool bad =
      B <= 0 || B > 46340 || kind < 0 || kind > 3 || cls < 0 || cls > 2 ||
      !parts || !ac_i || !ac_j || !valid_i || !valid_j || !mask ||
      (cls != 0 && (!an_i || !an_j)) || window < 0 ||
      (window > 0 && (!pos_i || !pos_j || !rid_i || !rid_j)) ||
      (kind == 2 && (!nhet_i || !nhom_i || !nhet_j || !nhom_j));
  if (bad) return (int)cudaErrorInvalidValue;
  Args a;
  a.parts = (const int32_t*)parts;
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
  a.n_samples = n_samples;
  a.bnd = {lo, hi, dp_lo, dp_hi, need_nonzero};
  a.diag = diag;
  a.mask = (uint8_t*)mask;
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0) return launch<0>(a, s);
  if (kind == 1) return launch<1>(a, s);
  if (kind == 2) return launch<2>(a, s);
  return launch<3>(a, s);
}
