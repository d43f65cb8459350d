// Survivor compaction of one tile at a running offset.
//
// Replaces what the JAX package leaves to XLA on the sweep path:
// tomahawk_tpu/ops/ld_kernels.py::compact_indices_small (with
// _rank_locate and _bsearch_cols), sweeps._pack_cols, and the clamped
// running offset + dynamic_update_slice of sweeps.fused_sweep. In PyTorch
// the same step through nonzero() or boolean indexing would sync with the
// host on every tile and serialize the sweep; these kernels keep the
// offset on the device, so a whole segment of tiles runs without a sync.
//
// Contract (the one resume, the .two byte order and the parity tests rely
// on): of the n survivors (mask == 2) of a B x B tile, the first
// min(n, cap) in ascending flat index k*B + l are written as int32 rows
// [k*B + l, payload...] starting at row min(off, outcap - cap) of buf;
// then n_pass[t] = n, n_cand[t] = #(mask != 0) and off = min(off + n,
// outcap). The payload is the survivor's P parts (parts i32 [P, B, B];
// P = 1, 4 or 9) in _pack_cols' layout: with ncol = 1 + ceil(P/2) columns
// the parts ride two per column as lo | hi << 16, an odd last part
// unshifted (the caller picks this layout when every part fits uint16);
// with ncol = 1 + P, one part per column. With P = 1 both are the part
// unshifted.
//
// What bounds it on the H100: reading the B*B mask bytes twice (16 MB at
// B = 4096, a few microseconds at HBM rate) and three launches; survivors
// are sparse, so the writes (and the gathers of their parts) are small. Design: (1) one warp per row counts
// survivors and candidates, (2) one block scans the row counts into row
// offsets and advances the offset, (3) one warp per row with survivors
// writes them in column order, each lane placing its survivor by the
// popcount of the ballot below it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowThreads = 256;    // 8 rows per block in kernels 1 and 3
constexpr int kScanThreads = 1024;

__global__ void row_counts_kernel(const uint8_t* __restrict__ mask, int B,
                                  int* __restrict__ row_pass,
                                  int* __restrict__ row_cand) {
  const int k = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (k >= B) return;  // uniform across the warp
  const uint8_t* row = mask + (size_t)k * B;
  int p = 0, c = 0;
  for (int l = lane; l < B; l += 32) {
    const uint8_t m = row[l];
    p += m == 2;
    c += m != 0;
  }
  for (int d = 16; d > 0; d >>= 1) {
    p += __shfl_down_sync(kFull, p, d);
    c += __shfl_down_sync(kFull, c, d);
  }
  if (lane == 0) {
    row_pass[k] = p;
    row_cand[k] = c;
  }
}

// info[0] = first buffer row of this tile, info[1] = rows to write
__global__ void scan_kernel(const int* __restrict__ row_pass,
                            const int* __restrict__ row_cand, int B,
                            int* __restrict__ row_off, int* off, int cap,
                            int outcap, int* n_pass, int* n_cand, int t,
                            int* info) {
  __shared__ int warp_pass[32];
  __shared__ int warp_cand[32];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wid = tid / 32;
  const int n_warps = blockDim.x / 32;
  const int per = (B + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * per, B);
  const int hi = min(lo + per, B);
  int sp = 0, sc = 0;
  for (int i = lo; i < hi; ++i) {
    sp += row_pass[i];
    sc += row_cand[i];
  }
  int incl = sp;  // inclusive scan of sp within the warp
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  for (int d = 16; d > 0; d >>= 1) sc += __shfl_down_sync(kFull, sc, d);
  if (lane == 31) warp_pass[wid] = incl;
  if (lane == 0) warp_cand[wid] = sc;
  __syncthreads();
  if (wid == 0) {
    int v = lane < n_warps ? warp_pass[lane] : 0;
    int cv = lane < n_warps ? warp_cand[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += y;
    }
    for (int d = 16; d > 0; d >>= 1) cv += __shfl_down_sync(kFull, cv, d);
    warp_pass[lane] = v;  // inclusive over warps
    if (lane == 0) warp_cand[0] = cv;
  }
  __syncthreads();
  int run = incl - sp + (wid > 0 ? warp_pass[wid - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    row_off[i] = run;
    run += row_pass[i];
  }
  if (tid == 0) {
    const int n = warp_pass[n_warps - 1];
    const int o = *off;
    info[0] = min(o, outcap - cap);
    info[1] = min(n, cap);
    n_pass[t] = n;
    n_cand[t] = warp_cand[0];
    *off = (int)min((long long)o + n, (long long)outcap);
  }
}

__global__ void write_kernel(const uint8_t* __restrict__ mask,
                             const int32_t* __restrict__ parts, int P,
                             int ncol, int B,
                             const int* __restrict__ row_pass,
                             const int* __restrict__ row_off,
                             const int* __restrict__ info,
                             int32_t* __restrict__ buf) {
  const int k = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (k >= B || row_pass[k] == 0) return;  // uniform across the warp
  const int base = info[0];
  const int end = min(row_off[k] + row_pass[k], info[1]);
  int run = row_off[k];
  const uint8_t* row = mask + (size_t)k * B;
  for (int c0 = 0; c0 < B && run < end; c0 += 32) {
    const int l = c0 + lane;
    const bool s = l < B && row[l] == 2;
    const unsigned bal = __ballot_sync(kFull, s);
    if (s) {
      const int pos = run + __popc(bal & ((1u << lane) - 1u));
      if (pos < end) {
        int32_t* dst = buf + (size_t)(base + pos) * ncol;
        const size_t f = (size_t)k * B + l;
        const size_t BB = (size_t)B * B;
        dst[0] = k * B + l;
        if (ncol == 1 + P) {
          for (int p = 0; p < P; ++p) dst[1 + p] = parts[p * BB + f];
        } else {
          for (int p = 0; p < P; p += 2) {
            uint32_t v = (uint32_t)parts[p * BB + f];
            if (p + 1 < P) v |= (uint32_t)parts[(p + 1) * BB + f] << 16;
            dst[1 + p / 2] = (int32_t)v;
          }
        }
      }
    }
    run += __popc(bal);
  }
}

}  // namespace

// scratch: int32 [3 * B + 2] (row survivor counts, row candidate counts,
// row offsets, info)
extern "C" int twk_compact(const void* mask, const void* parts, int P,
                           int ncol, int B, void* off, int cap, int outcap,
                           void* n_pass, void* n_cand, int t, void* scratch,
                           void* buf, void* stream) {
  if (B <= 0 || cap <= 0 || cap > outcap || P <= 0 ||
      (ncol != 1 + P && ncol != 1 + (P + 1) / 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int* row_pass = (int*)scratch;
  int* row_cand = row_pass + B;
  int* row_off = row_cand + B;
  int* info = row_off + B;
  const int row_blocks = (B * 32 + kRowThreads - 1) / kRowThreads;
  row_counts_kernel<<<row_blocks, kRowThreads, 0, s>>>(
      (const uint8_t*)mask, B, row_pass, row_cand);
  scan_kernel<<<1, kScanThreads, 0, s>>>(row_pass, row_cand, B, row_off,
                                         (int*)off, cap, outcap,
                                         (int*)n_pass, (int*)n_cand, t,
                                         info);
  write_kernel<<<row_blocks, kRowThreads, 0, s>>>(
      (const uint8_t*)mask, (const int32_t*)parts, P, ncol, B, row_pass,
      row_off, info, (int32_t*)buf);
  return (int)cudaGetLastError();
}
