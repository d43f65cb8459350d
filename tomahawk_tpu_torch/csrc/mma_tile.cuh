// The contraction main loop of a tile kernel on the tensor cores: staged
// packed words -> 1-bit AND+POPC MMAs -> int32 pair counts in registers.
//
// A count of a tile is popcount(x_row & y_col) over W packed words. The
// H100 runs that as mma.sync.m16n8k256.b1.and.popc (SASS
// BMMA.168256.AND.POPC) on the operands exactly as the planes store them,
// [variant, word] row-major on both sides, so nothing is unpacked or
// transposed: on an NVIDIA H100 80GB HBM3 (700 W) the probe of
// csrc/mma_probe.cu runs it at 10.2-10.5e15 bit-operations a second,
// against 1.26-1.29e15 for mma.sync.m16n8k32.s8 and 1.94-1.98e15 for wgmma
// m64n128k32.s8 (which would also need every word unpacked to 32 bytes
// first).
//
// Layout relied on (PTX ISA, matrix fragments of mma.m16n8k256 .b1), for
// lane = 4 * g + t of a warp and one K step of 8 words:
//   A (16 rows x 8 words): a0 = row g word t, a1 = row g + 8 word t,
//                          a2 = row g word 4 + t, a3 = row g + 8 word 4 + t
//   B (8 columns x 8 words): b0 = column g word t, b1 = column g word 4 + t
//   C (16 x 8 int32): c0, c1 = row g, columns 2t, 2t + 1;
//                     c2, c3 = row g + 8, the same columns
// The order of the bits inside a K step does not matter to a count as long
// as both operands use the same one.
//
// A block of 8 warps (2 along rows x 4 along columns) owns kRows x kCols
// pairs; a warp owns kMi x kNi MMA patches of 16 x 8. Each stage holds
// kStageWords words of every row of both operands, copied with cp.async
// (16 bytes a request when rows are 16-byte aligned, W % 4 == 0, else 4
// bytes), kStages deep. Rows are kLd = kStageWords + 4 words apart in
// shared memory: the fragment loads of a warp then hit bank (kLd g + t) %
// 32, all 32 distinct for kStageWords = 32 or 16. Words past W and rows
// past B are filled with zeros (a cp.async of source size 0), so they add
// nothing to any count.
//
// kPlanes operand planes a side and kProducts products (Pairing::a(p),
// Pairing::b(p) name the planes of product p) are template parameters; the
// phased no-missing tile is one plane, one product. A plane for which
// Pairing::inverted(plane) holds is contracted as its complement (the
// phased tables' valid = ~miss): its fragments are inverted as they leave
// shared memory, and the words past W in the last K step, which the zero
// fill would turn into ones, are masked back to zero. Rows past B are not
// masked: their counts are never stored. The MMA has no complemented
// operand, and inverting in place would need a pass over shared memory.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace twk {
namespace mma {

constexpr int kThreads = 256;
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kStages = 3;
constexpr int kStepWords = 8;  // words of one m16n8k256 K step

__device__ __forceinline__ void bmma(int (&c)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t* dst, const uint32_t* src,
                                         bool on) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = on ? kBytes : 0;
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The products of pallas_tiles._chunk_parts' column order, (a plane, b
// plane): (0,0), (0,1), (1,0), (1,1), then for 9 parts (0,2), (2,0),
// (1,2), (2,1), (2,2); one nibble a product. kInvert1: plane 1 is miss,
// contracted as valid = ~miss (the phased table with missing data).
template <bool kInvert1>
struct Products {
  static __host__ __device__ constexpr int a(int p) {
    return (int)((0x221201100ull >> (4 * p)) & 0xf);
  }
  static __host__ __device__ constexpr int b(int p) {
    return (int)((0x212021010ull >> (4 * p)) & 0xf);
  }
  static __host__ __device__ constexpr bool inverted(int plane) {
    return kInvert1 && plane == 1;
  }
};

template <int kPlanes, int kProducts, int kMi, int kNi, class Pairing,
          int kStageWords = 32>
struct Contraction {
  static_assert(kStageWords == 32 || kStageWords == 16,
                "bank-conflict-free fragment loads");
  static constexpr int kLd = kStageWords + 4;
  static constexpr int kRows = kWarpsM * kMi * 16;
  static constexpr int kCols = kWarpsN * kNi * 8;
  // words of one stage: every plane of side A, then every plane of side B
  static constexpr int kStageSize = kPlanes * (kRows + kCols) * kLd;
  static constexpr int kSmemBytes = kStages * kStageSize * 4;

  // Copy words [w0, w0 + kStageWords) of `n_rows` rows from row `first` of
  // a [B, W] plane into `dst` (rows kLd apart), kVec words a request.
  template <int kVec>
  static __device__ __forceinline__ void load_rows(
      uint32_t* dst, const uint32_t* __restrict__ plane, int first,
      int n_rows, int B, int W, int w0) {
    constexpr int kPerRow = kStageWords / kVec;
    for (int e = threadIdx.x; e < n_rows * kPerRow; e += kThreads) {
      const int r = e / kPerRow;
      const int w = (e % kPerRow) * kVec;
      const bool on = first + r < B && w0 + w < W;
      const uint32_t* src =
          on ? plane + (size_t)(first + r) * W + w0 + w : plane;
      cp_async<4 * kVec>(dst + r * kLd + w, src, on);
    }
  }

  static __device__ __forceinline__ void load_stage(
      uint32_t* stage, const uint32_t* const* xa, const uint32_t* const* xb,
      int row0, int col0, int B, int W,
      int w0, bool vec16) {
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      uint32_t* da = stage + p * kRows * kLd;
      uint32_t* db = stage + (kPlanes * kRows + p * kCols) * kLd;
      if (vec16) {
        load_rows<4>(da, xa[p], row0, kRows, B, W, w0);
        load_rows<4>(db, xb[p], col0, kCols, B, W, w0);
      } else {
        load_rows<1>(da, xa[p], row0, kRows, B, W, w0);
        load_rows<1>(db, xb[p], col0, kCols, B, W, w0);
      }
    }
  }

  // acc[p][mi][ni][0..3] += product p's counts of the block's pairs over
  // all W words; xa, xb hold the kPlanes [B, W] planes of each side.
  // `smem` holds kSmemBytes, 16-byte aligned. Every thread of the block
  // calls it; on return no copy is in flight and every thread has passed a
  // barrier after its last read, so the caller may reuse `smem`.
  static __device__ __forceinline__ void run(
      uint32_t* smem, const uint32_t* const* xa, const uint32_t* const* xb,
      int row0, int col0, int B, int W, int (&acc)[kProducts][kMi][kNi][4]) {
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int wr = (warp / kWarpsN) * kMi * 16;
    const int wc = (warp % kWarpsN) * kNi * 8;
    bool vec16 = W % 4 == 0;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
      vec16 = vec16 && ((uintptr_t)xa[p] | (uintptr_t)xb[p]) % 16 == 0;
    const int n_stage = (W + kStageWords - 1) / kStageWords;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_stage)
        load_stage(smem + s * kStageSize, xa, xb, row0, col0, B, W,
                   s * kStageWords, vec16);
      cp_async_commit();
    }
    for (int kt = 0; kt < n_stage; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      // the slot read in step kt - 1 is free: every thread passed the barrier
      const int next = kt + kStages - 1;
      if (next < n_stage)
        load_stage(smem + (next % kStages) * kStageSize, xa, xb, row0, col0,
                   B, W, next * kStageWords, vec16);
      cp_async_commit();

      const uint32_t* stage = smem + (kt % kStages) * kStageSize;
      const int left = W - kt * kStageWords;
#pragma unroll
      for (int ks = 0; ks < kStageWords / kStepWords; ++ks) {
        if (ks * kStepWords >= left) break;  // only zeros from here on
        // all ones where the lane's words (t, 4 + t of the K step) lie
        // inside W: what an inverted plane keeps
        const uint32_t keep_lo = ks * kStepWords + t < left ? ~0u : 0u;
        const uint32_t keep_hi = ks * kStepWords + 4 + t < left ? ~0u : 0u;
        uint32_t a[kPlanes][kMi][4];
        uint32_t b[kPlanes][kNi][2];
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
          const uint32_t* sa = stage + (p * kRows + wr + g) * kLd +
                               ks * kStepWords + t;
          const uint32_t* sb = stage +
                               (kPlanes * kRows + p * kCols + wc + g) * kLd +
                               ks * kStepWords + t;
#pragma unroll
          for (int mi = 0; mi < kMi; ++mi) {
            a[p][mi][0] = sa[(mi * 16) * kLd];
            a[p][mi][1] = sa[(mi * 16 + 8) * kLd];
            a[p][mi][2] = sa[(mi * 16) * kLd + 4];
            a[p][mi][3] = sa[(mi * 16 + 8) * kLd + 4];
          }
#pragma unroll
          for (int ni = 0; ni < kNi; ++ni) {
            b[p][ni][0] = sb[(ni * 8) * kLd];
            b[p][ni][1] = sb[(ni * 8) * kLd + 4];
          }
          if (Pairing::inverted(p)) {
#pragma unroll
            for (int mi = 0; mi < kMi; ++mi) {
              a[p][mi][0] = ~a[p][mi][0] & keep_lo;
              a[p][mi][1] = ~a[p][mi][1] & keep_lo;
              a[p][mi][2] = ~a[p][mi][2] & keep_hi;
              a[p][mi][3] = ~a[p][mi][3] & keep_hi;
            }
#pragma unroll
            for (int ni = 0; ni < kNi; ++ni) {
              b[p][ni][0] = ~b[p][ni][0] & keep_lo;
              b[p][ni][1] = ~b[p][ni][1] & keep_hi;
            }
          }
        }
#pragma unroll
        for (int p = 0; p < kProducts; ++p)
#pragma unroll
          for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
            for (int ni = 0; ni < kNi; ++ni)
              bmma(acc[p][mi][ni], a[Pairing::a(p)][mi], b[Pairing::b(p)][ni]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }
};

}  // namespace mma
}  // namespace twk
