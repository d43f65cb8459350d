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
// [k*B + l, payload...] starting at row min(off, outcap - cap) of buf
// (rows `ld` int32 apart: a buffer may carry columns past the payload);
// then n_pass[t] = n, n_cand[t] = #(mask != 0) and off = min(off + n,
// outcap). The payload is the survivor's P parts (parts i32 [P, B, B];
// P = 1, 4 or 9) in _pack_cols' layout: with ncol = 1 + ceil(P/2) columns
// the parts ride two per column as lo | hi << 16, an odd last part
// unshifted (the caller picks this layout when every part fits uint16);
// with ncol = 1 + P, one part per column. With P = 1 both are the part
// unshifted.
//
// What bounds it on the H100: launches and mask bytes. The work is tiny
// (16 MB of mask at B = 4096 is 5 us at HBM rate, and survivors are
// sparse), so each dependent launch (2-3 us) and each pass over the mask
// counts. Design: everything runs from per-(row, 128-column segment)
// counts, n_survivors | n_candidates << 16 in an int32 [B, ceil(B / 128)].
// The tile kernels (csrc/phased_tile.cu, csrc/parts_tile.cu,
// csrc/epilogue.cu) write them from the registers that hold the mask
// bytes, and then the mask is read here only where a segment has a
// survivor. (1) One launch sums each row's segments across its blocks,
// and the block that finishes last scans the row totals into row offsets
// and advances the offset (a ticket counter, no block waits: a single
// block summing all B * B / 128 cells is latency-bound and several times
// slower), and (2) one warp a row with survivors walks the row's
// non-empty segments (128 mask bytes a request, 4 a lane) and writes the
// survivors in column order, each lane placing its own by a shuffle scan
// of the lanes' counts. The scan stays a launch of its own: folding it
// into (2) behind a flag or a look-back would save one launch gap (~2 us)
// at the price of blocks that spin on another block's progress.
//
// The ticket is the scan's only state that outlives a call: a scan that
// dies between its blocks' draws would leave it non-zero, and every later
// scan on that stream would then elect its "last" block wrongly and write
// wrong offsets. So nothing trusts it: the last block resets it by
// subtracting the grid's draws, not by storing 0, and (2) takes it back
// to 0 and finds it 0 after a sound scan; a ticket that was v != 0 on
// entry is v or v + grid there. Then (2) writes n_pass[t] = -1, the mark
// the host reads at its one sync of the sweep and raises for
// (sweeps.host_counts), and its writes stay inside the tile's cap rows of
// the buffer whatever the scratch holds. The next call finds the ticket 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSeg = 128;           // mask columns of one counts cell
constexpr int kRowThreads = 256;    // 8 rows per block in write_kernel
constexpr int kScanThreads = 1024;
constexpr int kScanRows = kScanThreads / 8;  // rows a scan block totals

// Row totals, then their scan, in one launch. Every block sums the
// segment counts of kScanRows rows (8 lanes a row) into row_tot[k] =
// survivors | candidates << 16 and takes a ticket; the block that draws
// the last ticket, when every row total is written, scans them: row_off[k]
// (exclusive scan of the survivors), info[0] = first buffer row of this
// tile, info[1] = rows to write, the tile's counts and the new offset. No
// block waits for another. *ticket is 0 on entry; the last block takes
// the grid's draws off it again.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const uint32_t* __restrict__ counts, int B, int n_seg,
            uint32_t* row_tot, int* __restrict__ row_off, int* off, int cap,
            int outcap, int* n_pass, int* n_cand, int t, int* info,
            unsigned* ticket) {
  __shared__ int warp_pass[32];
  __shared__ int warp_cand[32];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wid = tid / 32;
  {
    const int k = blockIdx.x * kScanRows + tid / 8;
    uint32_t n = 0;
    if (k < B)
      for (int s = lane % 8; s < n_seg; s += 8)
        n += counts[(size_t)k * n_seg + s];
    n += __shfl_xor_sync(kFull, n, 1);
    n += __shfl_xor_sync(kFull, n, 2);
    n += __shfl_xor_sync(kFull, n, 4);
    if (lane % 8 == 0 && k < B) row_tot[k] = n;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  const int n_warps = blockDim.x / 32;
  const int per = (B + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * per, B);
  const int hi = min(lo + per, B);
  int sp = 0, sc = 0;
#pragma unroll 4
  for (int i = lo; i < hi; ++i) {
    const uint32_t v = __ldcg(row_tot + i);
    sp += v & 0xffff;
    sc += v >> 16;
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
#pragma unroll 4
  for (int i = lo; i < hi; ++i) {
    row_off[i] = run;
    run += __ldcg(row_tot + i) & 0xffff;
  }
  if (tid == 0) {
    const int n = warp_pass[n_warps - 1];
    const int o = *off;
    info[0] = min(o, outcap - cap);
    info[1] = min(n, cap);
    n_pass[t] = n;
    n_cand[t] = warp_cand[0];
    *off = (int)min((long long)o + n, (long long)outcap);
    atomicSub(ticket, gridDim.x);
  }
}

// Every survivor row of the tile, after the scan; first the ticket check
// (see the top of the file). Rows go to buffer rows base + [0, end) with
// 0 <= base <= outcap - cap and end <= cap, so that a scan that ran on a
// bad ticket can spoil only this tile's rows.
__global__ void write_kernel(const uint8_t* __restrict__ mask,
                             const int32_t* __restrict__ parts, int P,
                             int ncol, int ld, int B, int n_seg,
                             const uint32_t* __restrict__ counts,
                             const uint32_t* __restrict__ row_tot,
                             const int* __restrict__ row_off,
                             const int* __restrict__ info, int cap,
                             int outcap, unsigned* ticket, int* n_pass, int t,
                             int32_t* __restrict__ buf) {
  if (blockIdx.x == 0 && threadIdx.x == 0 && atomicExch(ticket, 0u) != 0u)
    n_pass[t] = -1;
  const int k = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (k >= B) return;  // uniform across the warp, like the next
  const int row_pass = row_tot[k] & 0xffff;
  if (row_pass == 0) return;
  const int base = min(max(info[0], 0), outcap - cap);
  const int end = (int)min(min((long long)row_off[k] + row_pass,
                               (long long)info[1]), (long long)cap);
  int run = row_off[k];
  const uint8_t* row = mask + (size_t)k * B;
  const size_t BB = (size_t)B * B;
  const bool vec = B % 4 == 0;
  for (int s0 = 0; s0 < n_seg && run < end; s0 += 32) {
    const int mine = s0 + lane < n_seg
        ? counts[(size_t)k * n_seg + s0 + lane] & 0xffff : 0;
    unsigned live = __ballot_sync(kFull, mine != 0);
    while (live != 0 && run < end) {
      const int seg = s0 + __ffs(live) - 1;
      live &= live - 1;
      const int l0 = seg * kSeg + 4 * lane;
      uint32_t w = 0;
      if (vec) {
        if (l0 < B) w = *reinterpret_cast<const uint32_t*>(row + l0);
      } else {
        for (int q = 0; q < 4; ++q)
          if (l0 + q < B) w |= (uint32_t)row[l0 + q] << (8 * q);
      }
      w &= 0x02020202u;
      const int cnt = __popc(w);
      int incl = cnt;  // inclusive scan of the lanes' survivor counts
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += y;
      }
      int pos = run + incl - cnt;
      for (int q = 0; q < 4 && w != 0; ++q, w >>= 8) {
        if ((w & 0xff) == 0) continue;
        if (pos >= 0 && pos < end) {
          const int l = l0 + q;
          int32_t* dst = buf + (size_t)(base + pos) * ld;
          const size_t f = (size_t)k * B + l;
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
        ++pos;
      }
      run += __shfl_sync(kFull, incl, 31);
    }
  }
}

}  // namespace

// counts: int32 [B, ceil(B / 128)] cells n_survivors | n_candidates << 16
// of the mask's row segments, as the tile kernels write them; null is
// refused. scratch: int32 [2 * B + 2], which need not be initialised: row
// totals, row offsets, info [2]. ticket: the scan's counter, one uint32
// that is 0 on entry and is left 0; calls that may overlap (other
// streams) need one each. Found not 0, it is set to 0 and n_pass[t] to
// -1. ld: the buffer's row stride, ncol or more (the columns past ncol
// are left alone).
extern "C" int twk_compact(const void* mask, const void* parts,
                           const void* counts, int P, int ncol, int ld, int B,
                           void* off, int cap, int outcap, void* n_pass,
                           void* n_cand, int t, void* scratch, void* ticket,
                           void* buf, void* stream) {
  if (counts == nullptr || B <= 0 || B >= 1 << 16 || cap <= 0 ||
      cap > outcap || P <= 0 || (ncol != 1 + P && ncol != 1 + (P + 1) / 2) ||
      ld < ncol)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_seg = (B + kSeg - 1) / kSeg;
  uint32_t* row_tot = (uint32_t*)scratch;
  int* row_off = (int*)scratch + B;
  int* info = row_off + B;
  const uint32_t* seg_counts = (const uint32_t*)counts;
  scan_kernel<<<(B + kScanRows - 1) / kScanRows, kScanThreads, 0, s>>>(
      seg_counts, B, n_seg, row_tot, row_off, (int*)off, cap, outcap,
      (int*)n_pass, (int*)n_cand, t, info, (unsigned*)ticket);
  const int row_blocks = (B * 32 + kRowThreads - 1) / kRowThreads;
  write_kernel<<<row_blocks, kRowThreads, 0, s>>>(
      (const uint8_t*)mask, (const int32_t*)parts, P, ncol, ld, B, n_seg,
      seg_counts, row_tot, row_off, info, cap, outcap, (unsigned*)ticket,
      (int*)n_pass, t, (int32_t*)buf);
  return (int)cudaGetLastError();
}
