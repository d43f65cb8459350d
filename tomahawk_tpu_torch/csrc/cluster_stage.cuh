// The contraction main loop of parts_tile's wide instance: operand stages
// copied by the Tensor Memory Accelerator (TMA) and shared by the blocks
// of a thread-block cluster (TMA multicast), then the 1-bit MMAs of
// mma_tile.cuh's Contraction on them, in its warp layout and fragment
// order.
//
// A cluster is kCy blocks along rows x kCx along columns, each block a
// Contraction block of kRows x kCols pairs (32 x 64). The kCx blocks of a
// cluster row need the same operand rows, the kCy blocks of a cluster
// column the same operand columns. A stage holds kStageWords (32) words
// of the block's rows and columns, every plane; the block at (by, bx) of
// its cluster loads box bx of its rows (kRows / kCx of them) into the
// blocks of its cluster row and box by of its columns (kCols / kCy) into
// the blocks of its cluster column, one TMA a plane and side
// (cp.async.bulk.tensor.2d ... .multicast::cluster). Every block issues
// the same share, and each operand word comes from L2 once a cluster row
// or column, not once a block.
//
// Each stage slot has a "full" mbarrier in every block (one arrival, the
// block's own expected bytes: its whole stage, whoever issued the boxes)
// and an "empty" one (an arrival from each warp of each block the
// block's boxes go to: its cluster row and column, kCx + kCy - 1 blocks).
// A warp that has run a stage's MMAs arrives, at cluster scope, on the
// empty barrier of every block that fills that stage of it; thread 0 of a
// block refills a slot once its own empty barrier completes. Thread 0
// also computes (no producer warp: the 8 warps at 128 registers are what
// two blocks an SM allow), so it waits for a slot only when its own block
// needs that stage next and otherwise looks once a stage: a thread 0 that
// waited each stage for the slowest block its boxes go to paced the whole
// cluster by a round trip between SMs a stage (16-word stages took longer
// than Contraction's cp.async stages so). The TMA fills words past W and
// rows past B with zeros, which add nothing to a count, so no plane may
// be contracted as its complement here (Pairing::inverted), and a block
// past B (the grid is padded to whole clusters) loads its boxes like any
// other and stores nothing.
//
// Shared memory rows are 128 bytes, written with the 128-byte swizzle
// (CU_TENSOR_MAP_SWIZZLE_128B: 16-byte chunk c of row r lands at chunk c
// ^ (r & 7)), so no padding is needed: the fragments come out with
// ldmatrix.x4 (one a plane and side each K step), each 8-row matrix's rows
// on 8 distinct 4-bank groups. The fragment of a lane is the word the
// m16n8k256 .b1 layout of mma_tile.cuh gives it: an 8 x 8 b16 matrix row
// is 16 bytes, 4 words, and lane 4 g + t receives word t of row g. Three
// 32-word stages are 108 KB a block, the most two blocks an SM hold.
//
// A block must call `leave` before it exits (a cluster barrier): another
// block may still be copying into it, or arriving on its barriers.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "mma_tile.cuh"

namespace twk {
namespace cluster {

constexpr int kStageWords = 32;  // words of a stage: a 128-byte row
constexpr int kRowBytes = 4 * kStageWords;
constexpr int kAlign = 1024;  // of the stages: whole swizzle patterns
constexpr int kWarps = mma::kThreads / 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// `p` rounded up to kAlign in the shared window (the same offset in every
// block, as multicast needs)
__device__ __forceinline__ uint8_t* aligned(uint8_t* p) {
  return p + (kAlign - smem_addr(p) % kAlign) % kAlign;
}

__device__ __forceinline__ uint32_t ctaid_x() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctaid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t ctaid_y() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctaid.y;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

// one look at the barrier: whether the phase of `parity` has completed
__device__ __forceinline__ bool bar_test(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// arrive on the barrier at `bar`'s offset in block `rank` of the cluster
__device__ __forceinline__ void bar_arrive_at(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 r;\n"
      "mapa.shared::cluster.u32 r, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [r];\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// a box of `map` at (word x, row y) into `dst` of every block in `mask`,
// completing on `bar` of each
__device__ __forceinline__ void tma_multicast(void* dst,
                                              const CUtensorMap* map, int x,
                                              int y, uint64_t* bar,
                                              uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

template <int kPlanes, int kProducts, int kMi, int kNi, class Pairing,
          int kStages, int kCx_, int kCy_>
struct Staged {
  // blocks of a cluster along columns (x) and along rows (y)
  static constexpr int kCx = kCx_, kCy = kCy_;
  static constexpr int kRows = mma::kWarpsM * kMi * 16;
  static constexpr int kCols = mma::kWarpsN * kNi * 8;
  // rows of the boxes a block loads: its share of its cluster row's rows
  // and of its cluster column's columns, whole swizzle patterns
  static constexpr int kBoxA = kRows / kCx, kBoxB = kCols / kCy;
  static_assert(kBoxA * kCx == kRows && kBoxB * kCy == kCols &&
                    kBoxA % 8 == 0 && kBoxB % 8 == 0,
                "each block of a cluster row loads a box of its rows, "
                "each of a cluster column a box of its columns");
  static_assert(kMi == 1 && kNi == 2,
                "one ldmatrix.x4 a plane and side each K step");
  static_assert(kStages >= 2, "a slot ahead");
  // words of one stage: every plane of side A, then every plane of side B
  static constexpr int kStageBytes = kPlanes * (kRows + kCols) * kRowBytes;
  static_assert(kStageBytes % kAlign == 0, "slots keep the alignment");
  static constexpr int kBarOffset = kStages * kStageBytes;
  // the stages, the full and empty barriers, and the alignment's slack
  static constexpr int kSmemBytes = kAlign + kBarOffset + 2 * kStages * 8;

  static __host__ __device__ constexpr bool none_inverted() {
    for (int p = 0; p < kPlanes; ++p)
      if (Pairing::inverted(p)) return false;
    return true;
  }

  // acc[p][0][ni][0..3] += product p's counts of the block's pairs over all
  // W words; ma, mb: the tensor maps (kernel parameters) of each side's
  // kPlanes [B, W] planes, boxes of kBoxA (ma) or kBoxB (mb) rows x
  // kStageWords words, 128-byte swizzle. `smem` holds kSmemBytes - kAlign
  // bytes, kAlign-aligned. Every thread of every block of the cluster
  // calls it. On return every copy into this block has landed, so the
  // caller may reuse the stages; the block calls `leave` before it exits.
  static __device__ __forceinline__ void run(
      uint8_t* smem, const CUtensorMap* ma, const CUtensorMap* mb, int row0,
      int col0, int W, int (&acc)[kProducts][kMi][kNi][4]) {
    static_assert(none_inverted(), "the TMA's zero fill would count as "
                  "ones in an inverted plane");
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
    uint64_t* empty = full + kStages;
    const int bx = (int)ctaid_x();
    const int by = (int)ctaid_y();
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        bar_init(full + s, 1);
        bar_init(empty + s, kWarps * (kCx + kCy - 1));
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // no copy or arrival before every barrier of the cluster is set up
    cluster_arrive();
    cluster_wait();

    const int n_stage = (W + kStageWords - 1) / kStageWords;
    // this block's boxes go to its cluster row and to its cluster column
    uint16_t row_mask = ((1u << kCx) - 1) << (kCx * by);
    uint16_t col_mask = 0;
#pragma unroll
    for (int y = 0; y < kCy; ++y) col_mask |= 1u << (bx + kCx * y);
    // stage j's slot is free once every block it goes to released stage
    // j - kStages: that round's phase of the empty barrier (for j <
    // kStages the phase before the first, which counts as completed)
    auto parity = [](int j) { return (j / kStages + 1) & 1; };
    auto issue = [&](int j) {
      const int s = j % kStages;
      bar_expect(full + s, kStageBytes);
      uint8_t* st = smem + s * kStageBytes;
      const int w0 = j * kStageWords;
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        tma_multicast(st + (p * kRows + bx * kBoxA) * kRowBytes, ma + p, w0,
                      row0 + bx * kBoxA, full + s, row_mask);
        tma_multicast(
            st + (kPlanes * kRows + p * kCols + by * kBoxB) * kRowBytes,
            mb + p, w0, col0 + by * kBoxB, full + s, col_mask);
      }
    };

    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int wr = (warp / mma::kWarpsN) * kMi * 16;
    const int wc = (warp % mma::kWarpsN) * kNi * 8;
    // the row this lane addresses for ldmatrix (matrix lane / 8, its row
    // lane % 8) and the 16-byte chunk's swizzle there: every row of a
    // stage region starts on a multiple of 8 rows, so row % 8 = lane % 8
    const int m = lane >> 3;
    const int sw = lane & 7;
    // A: (rows 0-7, words 0-3), (8-15, 0-3), (0-7, 4-7), (8-15, 4-7) of the
    // warp's 16 rows = a0..a3; B: (columns 0-7, words 0-3), (0-7, 4-7),
    // (8-15, 0-3), (8-15, 4-7) = b[0][0], b[0][1], b[1][0], b[1][1]
    const int a_row = wr + (m & 1) * 8 + (lane & 7);
    const int a_half = m >> 1;
    const int b_row = kPlanes * kRows + wc + (m >> 1) * 8 + (lane & 7);
    const int b_half = m & 1;
    // the release of a slot: lane k < kCx arrives at block k of the
    // cluster row, lane kCx + y at block y of the cluster column (the
    // block itself once)
    const bool releases = lane < kCx + kCy && lane != kCx + by;
    const uint32_t target = lane < kCx ? kCx * by + lane
                                       : bx + kCx * (lane - kCx);
    const uint32_t base = smem_addr(smem);

    // thread 0: stage kt, waiting for its slot if need be, then every
    // later one whose slot a look finds free
    int issued = 0;
    auto produce = [&](int kt) {
      for (; issued <= kt; ++issued) {
        bar_wait(empty + issued % kStages, parity(issued));
        issue(issued);
      }
      for (; issued < n_stage && issued < kt + kStages &&
             bar_test(empty + issued % kStages, parity(issued));
           ++issued)
        issue(issued);
    };
    for (int kt = 0; kt < n_stage; ++kt) {
      if (threadIdx.x == 0) produce(kt);
      const int s = kt % kStages;
      bar_wait(full + s, (kt / kStages) & 1);
      const uint32_t st = base + s * kStageBytes;
      const int left = W - kt * kStageWords;
#pragma unroll
      for (int ks = 0; ks < kStageWords / mma::kStepWords; ++ks) {
        if (ks * mma::kStepWords >= left) break;  // only zeros from here on
        uint32_t a[kPlanes][kMi][4];
        uint32_t b[kPlanes][kNi][2];
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
          ldsm_x4(a[p][0][0], a[p][0][1], a[p][0][2], a[p][0][3],
                  st + (p * kRows + a_row) * kRowBytes +
                      (((2 * ks + a_half) ^ sw) << 4));
          ldsm_x4(b[p][0][0], b[p][0][1], b[p][1][0], b[p][1][1],
                  st + (b_row + p * kCols) * kRowBytes +
                      (((2 * ks + b_half) ^ sw) << 4));
        }
#pragma unroll
        for (int p = 0; p < kProducts; ++p)
#pragma unroll
          for (int ni = 0; ni < kNi; ++ni)
            mma::bmma(acc[p][0][ni], a[Pairing::a(p)][0],
                      b[Pairing::b(p)][ni]);
      }
      // the slot to the blocks that fill it; no later stage refills the
      // last kStages
      if (kt + kStages < n_stage) {
        __syncwarp();
        if (releases) bar_arrive_at(empty + s, target);
      }
    }
    // every warp of the block past its last fragment load before the
    // caller reuses the stages
    __syncthreads();
    cluster_arrive();
  }

  // the cluster barrier `run` arrived at: no block exits while another may
  // still copy into it
  static __device__ __forceinline__ void leave() { cluster_wait(); }
};

}  // namespace cluster
}  // namespace twk
