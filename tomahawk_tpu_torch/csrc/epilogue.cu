// Global parts of one tile -> the candidate/survivor mask and its
// per-segment counts.
//
// Replaces the jnp epilogue that tomahawk_tpu/compute/sweeps.py::
// tile_prefilter runs after the psum of the samples-sharded sweep
// (tile_mask, ld_kernels.phased_cells / unphased_cells and the f32
// prefilters, left to XLA there): parts i32 [P, B, B], summed over the
// ranks, and the per-variant metadata give mask u8 [B, B] = 0 (not a
// candidate), 1 (candidate) or 2 (survivor of the f32 prefilter), with the
// pair class cls, the distance window and the diagonal triangle applied.
// The kinds are csrc/local_parts.cu's (0 phased, 1 phased with missing data,
// 2 unphased, 3 unphased with missing data). With `counts` given it also
// writes the counts the fused tile kernels write for the compaction
// (csrc/compact.cu): int32 [B, ceil(B / 128)], n_survivors |
// n_candidates << 16 of each 128-column segment of each mask row.
//
// It calls the candidate test, the cells and the prefilters the fused tile
// kernels call (prefilter.cuh), built like them with -fmad=false and IEEE
// division, so the samples-sharded sweep makes bit-identical decisions.
//
// What bounds it on the H100: the bytes, 4 P bytes of parts read for each
// candidate and the mask written, (4 P + 1) * B * B a tile where nearly
// every pair is a candidate (0.025 ms at P = 1, 0.085 at P = 4, 0.185 at
// P = 9, B = 4096, at 3.35e12 bytes a second). The f32 operations of the
// prefilter (20 SASS instructions a pair phased, 92-97 unphased, over
// 33.5e12 a second without FMA under -fmad=false) stay under that bound,
// but with the integer work around them they take about as long as the
// bytes, so the design keeps instructions a pair few and the loads in
// flight while they run:
// - Many pairs a lane: a lane takes C consecutive columns of a row (16 at
//   P = 1, 8 in the phased P = 4 instance, 4 in the unphased ones, the
//   fastest of 16, 8 and 4 on the card) and issues all its 16-byte loads
//   of every part plane before the first use (in the phased instances a
//   row ahead, before the prefilter of the row before), then one C-byte
//   mask store; a warp covers 32 C columns of a row, 128 / C lanes a
//   counts segment, whose cell one lane writes after a shuffle sum. Every
//   cell is written once, so the counts need no memset and no atomics.
// - A block owns a strip of 32 C columns and a run of kRows rows. It
//   stages the strip's column metadata once in shared memory (each lane's
//   C columns a padded row, so a warp's reads hit 32 banks), and a lane
//   turns its columns' valid, an and ac into bit masks, so the candidate
//   test of a row is a few mask operations for all C pairs (the window
//   one comparison a pair); a row's metadata is one uniform load. A
//   16-byte group of parts whose 4 pairs are no candidates is not read.
// - The unphased instances evaluate only the half of the prefilter a pair
//   takes (twk::unphased_prefilter_taken); the mask is the same, bit for
//   bit, as the branch-free statement's.
// - A block that holds no candidate (wholly below the diagonal of a
//   diagonal tile, or dead by twk::block_live in a window sweep) writes
//   its mask and counts as 0 and reads no part.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "prefilter.cuh"

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kSeg = 128;  // mask columns of one counts cell
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;  // rows of a block, kRows / kWarps a warp

// The shape of an instance: its parts; the consecutive columns (pairs) of
// a row a lane takes, C, the fastest of 16, 8 and 4 on the card
// (time_variants.py): the more parts and prefilter a pair holds in
// registers, the fewer pairs a lane keeps enough warps on an SM (at 16
// the unphased instances also spill, P = 9: 255 registers); and whether a
// lane loads its next row's parts before this row's prefilter, which the
// phased instances gain from and the unphased ones, whose registers it
// doubles, lose by (6-23% slower).
template <int KIND>
struct Kind {
  static constexpr int kParts = KIND == 0 ? 1 : KIND == 3 ? 9 : 4;
  static constexpr int kCols = KIND == 0 ? 16 : KIND == 1 ? 8 : 4;
  static constexpr bool kAhead = KIND < 2;
};

template <int C>
struct Lanes {
  static_assert(C == 4 || C == 8 || C == 16, "one store a row");
  static constexpr int kSegLanes = kSeg / C;  // lanes a counts segment
  static constexpr int kStrip = 32 * C;       // columns of a block
  static constexpr int kPad = C + 1;  // shared index lane * kPad + e: no
                                      // bank conflict
};

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
  int cls, B, n_samples, n_seg;
  twk::Bounds bnd;
  int diag;
  bool vec;  // parts rows 16-byte aligned: B % 4 == 0, aligned base
  uint8_t* mask;
  int32_t* counts;  // null: none
};

// The strip's column metadata a row's pairs read, in shared memory (ac,
// valid and an then move to registers), each lane's C columns a padded
// row of kPad.
template <int C>
struct Strip {
  static constexpr int kLen = 32 * Lanes<C>::kPad;
  int ac[kLen];
  int flags[kLen];  // bit 0: valid; bit 1: an == 0 (cls != 0)
  int nhet[kLen];   // kind 2
  int nhom[kLen];
  int pos[kLen];  // window > 0
  int rid[kLen];
};

// survivors | candidates << 16 among 4 mask bytes (0, 1 or 2)
__device__ __forceinline__ unsigned count_bytes(uint32_t m4) {
  return __popc(m4 & 0x02020202u) |
         __popc((m4 | (m4 >> 1)) & 0x01010101u) << 16;
}

// Store one row's C mask bytes of the lane (m4, columns c0..c0 + C - 1)
// in one store and the counts of its segment (every lane of the warp
// calls it).
template <int C>
__device__ __forceinline__ void store_row(const Args& a, int k, int c0,
                                          int col0,
                                          const uint32_t (&m4)[C / 4]) {
  constexpr int kSegLanes = Lanes<C>::kSegLanes;
  const int B = a.B;
  const size_t f = (size_t)k * B + c0;
  uint8_t* dst = a.mask + f;
  if (c0 + C <= B && (reinterpret_cast<uintptr_t>(dst) & (C - 1)) == 0) {
    if constexpr (C == 16)
      *reinterpret_cast<uint4*>(dst) = make_uint4(m4[0], m4[1], m4[2], m4[3]);
    else if constexpr (C == 8)
      *reinterpret_cast<uint2*>(dst) = make_uint2(m4[0], m4[1]);
    else
      *reinterpret_cast<uint32_t*>(dst) = m4[0];
  } else {
#pragma unroll
    for (int e = 0; e < C; ++e)
      if (c0 + e < B) dst[e] = (uint8_t)(m4[e / 4] >> (8 * (e % 4)));
  }
  if (a.counts == nullptr) return;  // uniform
  unsigned n = 0;
#pragma unroll
  for (int q = 0; q < C / 4; ++q) n += count_bytes(m4[q]);
#pragma unroll
  for (int s = 1; s < kSegLanes; s <<= 1) n += __shfl_xor_sync(kAll, n, s);
  const int lane = threadIdx.x % 32;
  const int seg0 = col0 + (lane / kSegLanes) * kSeg;
  if (lane % kSegLanes == 0 && seg0 < B)
    a.counts[(size_t)k * a.n_seg + seg0 / kSeg] = (int32_t)n;
}

// The P parts of the lane's C pairs of row k, 16 bytes a load, all issued
// before the first use; a group of 4 pairs none of which is a candidate
// (cand bits) stays unread, as does every pair that is no candidate on
// the unaligned path.
template <int P, int C>
__device__ __forceinline__ void load_parts(const Args& a, int k, int c0,
                                           uint32_t cand, int (&v)[P][C]) {
  const size_t BB = (size_t)a.B * a.B;
  const size_t f = (size_t)k * a.B + c0;
  if (a.vec && c0 + C <= a.B) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int4* src = reinterpret_cast<const int4*>(a.parts + p * BB + f);
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        int4 x = make_int4(0, 0, 0, 0);
        if ((cand >> (4 * q)) & 0xFu) x = __ldcs(src + q);
        v[p][4 * q] = x.x;
        v[p][4 * q + 1] = x.y;
        v[p][4 * q + 2] = x.z;
        v[p][4 * q + 3] = x.w;
      }
    }
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int e = 0; e < C; ++e)
        v[p][e] = (cand >> e) & 1u ? __ldcs(a.parts + p * BB + f + e) : 0;
  }
}

// The metadata of row k, the same in every lane of the warp.
struct Row {
  int ac, pos, rid, nhet, nhom;
  bool valid, clean;
};

// The prefilter of one candidate pair from its P parts (v[p][e]); DP: with
// the D' term.
template <int KIND, bool DP, int P, int C>
__device__ __forceinline__ bool pair_pf(const Args& a, const Strip<C>& sm,
                                        const Row& row, int acj, int s,
                                        const int (&v)[P][C], int e) {
  if constexpr (KIND == 0) {
    // ld_kernels.phased_cells, 1-part branch
    const int altalt = v[0][e];
    const int altref = row.ac - altalt;
    const int refalt = acj - altalt;
    const int refref = 2 * a.n_samples - (row.ac + acj) + altalt;
    return twk::phased_prefilter<DP>(refref, refalt, altref, altalt, a.bnd);
  } else if constexpr (KIND == 1) {
    // ld_kernels.phased_cells, 4-part branch
    const int altalt = v[0][e];
    const int altref = v[1][e] - altalt;
    const int refalt = v[2][e] - altalt;
    const int refref = v[3][e] - altalt - altref - refalt;
    return twk::phased_prefilter<DP>(refref, refalt, altref, altalt, a.bnd);
  } else {
    // ld_kernels.unphased_cells
    const int T11 = v[0][e], T12 = v[1][e], T21 = v[2][e], T22 = v[3][e];
    int hv, vh, ov, vo, vv;
    if constexpr (KIND == 3) {
      hv = v[4][e];
      vh = v[5][e];
      ov = v[6][e];
      vo = v[7][e];
      vv = v[8][e];
    } else {
      hv = row.nhet;
      ov = row.nhom;
      vh = sm.nhet[s];
      vo = sm.nhom[s];
      vv = a.n_samples;
    }
    const int T10 = hv - T11 - T12;
    const int T20 = ov - T21 - T22;
    const int T01 = vh - T11 - T21;
    const int T02 = vo - T12 - T22;
    const int T00 = vv - (T01 + T02 + T10 + T11 + T12 + T20 + T21 + T22);
    const int T[9] = {T00, T01, T02, T10, T11, T12, T20, T21, T22};
    return twk::unphased_prefilter_taken<DP>(T, a.bnd);
  }
}

template <int KIND, bool DP>
__global__ void __launch_bounds__(kThreads) epilogue_kernel(const Args a) {
  constexpr int P = Kind<KIND>::kParts, C = Kind<KIND>::kCols;
  constexpr bool kAhead = Kind<KIND>::kAhead;
  constexpr int kStrip = Lanes<C>::kStrip, kPad = Lanes<C>::kPad;
  __shared__ Strip<C> sm;
  const int B = a.B;
  const int col0 = blockIdx.x * kStrip, row0 = blockIdx.y * kRows;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = col0 + lane * C;  // the lane's first column
  const int window = a.win.window;
  // a dead block: every thread takes the same branch
  bool live = !(a.diag && row0 >= col0 + kStrip - 1);
  if (window > 0)
    live = twk::block_live(a.win, a.valid_i, a.valid_j, row0, kRows, col0,
                           kStrip, B, a.diag);
  if (!live) {
    const uint32_t zero[C / 4] = {};
    for (int r = warp; r < kRows && row0 + r < B; r += kWarps)
      store_row<C>(a, row0 + r, c0, col0, zero);
    return;
  }

  // the strip's column metadata, read once (coalesced), in shared memory
  for (int c = threadIdx.x; c < kStrip; c += kThreads) {
    const int l = col0 + c;
    const int s = (c / C) * kPad + c % C;
    const bool in = l < B;
    sm.ac[s] = in ? a.ac_j[l] : 0;
    sm.flags[s] = in && a.valid_j[l] != 0
                      ? 1 | (a.cls != 0 && a.an_j[l] == 0 ? 2 : 0)
                      : 0;
    if constexpr (KIND == 2) {
      sm.nhet[s] = in ? a.nhet_j[l] : 0;
      sm.nhom[s] = in ? a.nhom_j[l] : 0;
    }
    if (window > 0) {
      sm.pos[s] = in ? a.win.pos_j[l] : 0;
      sm.rid[s] = in ? a.win.rid_j[l] : 0;
    }
  }
  __syncthreads();
  // the lane's columns as bit masks (bit e: column c0 + e): valid, an == 0,
  // and ac >= 1, 2, 3 for the reference's skip rule ac_i + ac_j > 2
  constexpr uint32_t kAllC = (1u << C) - 1;
  const int base = lane * kPad;
  int acj[C];  // the phased cells' (kind 0) column ac
  uint32_t valid_j = 0, clean_j = 0, ge1 = 0, ge2 = 0, ge3 = 0;
#pragma unroll
  for (int e = 0; e < C; ++e) {
    const int ac = sm.ac[base + e];
    acj[e] = ac;
    const int fl = sm.flags[base + e];
    valid_j |= (uint32_t)(fl & 1) << e;
    clean_j |= (uint32_t)((fl >> 1) & 1) << e;
    ge1 |= (uint32_t)(ac >= 1) << e;
    ge2 |= (uint32_t)(ac >= 2) << e;
    ge3 |= (uint32_t)(ac >= 3) << e;
  }

  // row k's metadata (the same in every lane) and twk::candidate for the
  // lane's C pairs at once, a bit a pair (ac >= 0)
  auto row_at = [&](int k, Row& row) -> uint32_t {
    row.ac = a.ac_i[k];
    row.valid = a.valid_i[k] != 0;
    row.clean = a.cls != 0 && a.an_i[k] == 0;
    row.pos = window > 0 ? a.win.pos_i[k] : 0;
    row.rid = window > 0 ? a.win.rid_i[k] : 0;
    row.nhet = KIND == 2 ? a.nhet_i[k] : 0;
    row.nhom = KIND == 2 ? a.nhom_i[k] : 0;
    uint32_t cand = row.valid ? valid_j : 0;
    cand &= row.ac >= 3   ? kAllC
            : row.ac == 2 ? ge1
            : row.ac == 1 ? ge2
                          : ge3;
    if (a.diag) {  // k < l: the columns past k - c0
      const int d = k - c0 + 1;
      cand &= d <= 0 ? kAllC : d >= C ? 0u : (kAllC << d) & kAllC;
    }
    if (window > 0) {
      uint32_t near = 0;
#pragma unroll
      for (int e = 0; e < C; ++e) {
        const int d = row.pos - sm.pos[base + e];
        near |= (uint32_t)(row.rid == sm.rid[base + e] &&
                           (d < 0 ? -d : d) <= window)
                << e;
      }
      cand &= near;
    }
    if (a.cls == 1) cand &= row.clean ? clean_j : 0u;
    if (a.cls == 2) cand &= row.clean ? ~clean_j : kAllC;
    return cand;
  };

  // the prefilter of row k's candidates from their parts, the mask and
  // the counts stored
  auto finish = [&](int k, const Row& row, uint32_t cand,
                    const int (&v)[P][C]) {
    uint32_t m4[C / 4] = {};
#pragma unroll
    for (int e = 0; e < C; ++e) {
      if ((cand >> e) & 1u) {
        const bool pf =
            pair_pf<KIND, DP, P, C>(a, sm, row, acj[e], base + e, v, e);
        m4[e / 4] |= (pf ? 2u : 1u) << (8 * (e % 4));
      }
    }
    store_row<C>(a, k, c0, col0, m4);
  };

  // a warp's rows, kWarps apart
  if constexpr (!kAhead) {
    for (int r = warp; r < kRows && row0 + r < B; r += kWarps) {
      Row row;
      const uint32_t cand = row_at(row0 + r, row);
      int v[P][C];
      load_parts<P, C>(a, row0 + r, c0, cand, v);
      finish(row0 + r, row, cand, v);
    }
  } else {
    // the next row's parts are loaded before this row's prefilter runs,
    // so loads stay in flight while it does
    int r = warp;
    if (r >= kRows || row0 + r >= B) return;  // uniform across the warp
    Row row;
    uint32_t cand = row_at(row0 + r, row);
    int v[P][C];
    load_parts<P, C>(a, row0 + r, c0, cand, v);
    for (;; r += kWarps) {
      const int k = row0 + r;
      const bool more = r + kWarps < kRows && k + kWarps < B;  // uniform
      Row next;
      uint32_t next_cand = 0;
      int nv[P][C];
      if (more) {
        next_cand = row_at(k + kWarps, next);
        load_parts<P, C>(a, k + kWarps, c0, next_cand, nv);
      }
      finish(k, row, cand, v);
      if (!more) break;
      row = next;
      cand = next_cand;
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int e = 0; e < C; ++e) v[p][e] = nv[p][e];
    }
  }
}

template <int KIND, bool DP>
int launch(const Args& a, cudaStream_t s) {
  constexpr int kStrip = Lanes<Kind<KIND>::kCols>::kStrip;
  const dim3 grid((a.B + kStrip - 1) / kStrip, (a.B + kRows - 1) / kRows);
  epilogue_kernel<KIND, DP><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch(const Args& a, cudaStream_t s) {
  // twk::dprime_on, decided here: one instance of the kernel each way
  const bool dp = a.bnd.dp_lo != -INFINITY || a.bnd.dp_hi != INFINITY;
  return dp ? launch<KIND, true>(a, s) : launch<KIND, false>(a, s);
}

}  // namespace

// kind: as twk_local_parts. cls: 0 all, 1 clean, 2 missing (needs an_*).
// n_het/n_hom: kind 2 only. window: 0 none, else bp (needs pos_* and rid_*).
// parts: i32 [P, B, B], the global counts. mask: u8 [B, B]. counts: int32
// [B, ceil(B / 128)] or null.
extern "C" int twk_tile_epilogue(
    int kind, const void* parts, const void* ac_i, const void* ac_j,
    const void* valid_i, const void* valid_j, const void* an_i,
    const void* an_j, const void* nhet_i, const void* nhom_i,
    const void* nhet_j, const void* nhom_j, const void* pos_i,
    const void* pos_j, const void* rid_i, const void* rid_j, int window,
    int cls, int B, int n_samples, float lo, float hi, float dp_lo,
    float dp_hi, int need_nonzero, int diag, void* mask, void* counts,
    void* stream) {
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
  a.n_seg = (B + kSeg - 1) / kSeg;
  a.bnd = {lo, hi, dp_lo, dp_hi, need_nonzero};
  a.diag = diag;
  a.vec = B % 4 == 0 && (reinterpret_cast<uintptr_t>(parts) & 15) == 0;
  a.mask = (uint8_t*)mask;
  a.counts = (int32_t*)counts;
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0) return launch<0>(a, s);
  if (kind == 1) return launch<1>(a, s);
  if (kind == 2) return launch<2>(a, s);
  return launch<3>(a, s);
}
