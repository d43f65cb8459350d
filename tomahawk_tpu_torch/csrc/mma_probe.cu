// Rate probe of the tensor-core instructions a tile contraction
// could be built on. Not on any calc path: chip_smoke.py times it to put
// the card's measured rates beside the tile kernels' times.
//
// Every warp of every SM runs back-to-back MMAs from registers (eight
// independent accumulator sets, so the chain of one never stalls the next)
// or, for wgmma, from a zeroed shared-memory tile. kind:
//   0  mma.sync.m16n8k256 .b1 .and.popc  (65,536 bit-operations each)
//   1  mma.sync.m16n8k32  .s8            (8,192 operations each)
//   2  wgmma.mma_async.m64n128k32 .s8    (524,288 operations each, one
//                                         per warpgroup of four warps)
// An "operation" is one multiply (AND) or one add of the contraction, the
// unit the data sheet's TOP/s counts, so the three rates compare directly
// for a contraction over haplotype bits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;

__device__ __forceinline__ void mma_b1(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int kKind>
__global__ void __launch_bounds__(kThreads)
mma_sync_probe(int iters, int32_t* __restrict__ out) {
  const uint32_t seed = threadIdx.x * 2654435761u + blockIdx.x;
  uint32_t a[4], b[2];
  int c[kChains][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) a[q] = seed >> q;
  b[0] = seed ^ 0x55555555u;
  b[1] = ~seed;
  if (kKind == 1) {  // keep the int8 values 0/1 as the tile kernel's are
#pragma unroll
    for (int q = 0; q < 4; ++q) a[q] &= 0x01010101u;
    b[0] &= 0x01010101u;
    b[1] &= 0x01010101u;
  }
#pragma unroll
  for (int s = 0; s < kChains; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[s][q] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < kChains; ++s) {
      if (kKind == 0) mma_b1(c[s], a, b);
      else mma_s8(c[s], a, b);
    }
  }
  int sum = 0;
#pragma unroll
  for (int s = 0; s < kChains; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) sum += c[s][q];
  out[blockIdx.x * kThreads + threadIdx.x] = sum;
}

// shared-memory matrix descriptor, no swizzle: 8-row x 16-byte core
// matrices, 128 bytes apart along K (LBO), 256 bytes apart along rows (SBO)
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)8 << 16) |
         ((uint64_t)16 << 32);
}

__global__ void __launch_bounds__(kThreads)
wgmma_probe(int iters, int32_t* __restrict__ out) {
  __shared__ __align__(128) uint8_t tile[2][8192];
  for (int e = threadIdx.x; e < 2 * 8192 / 4; e += kThreads)
    ((uint32_t*)tile)[e] = 0x01010101u;
  __syncthreads();
  const uint64_t da = smem_desc(tile[0]);
  const uint64_t db = smem_desc(tile[1]);
  int d[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) d[q] = 0;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "setp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, "
          "%8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, "
          "%24, %25, %26, %27, %28, %29, %30, %31, "
          "%32, %33, %34, %35, %36, %37, %38, %39, "
          "%40, %41, %42, %43, %44, %45, %46, %47, "
          "%48, %49, %50, %51, %52, %53, %54, %55, "
          "%56, %57, %58, %59, %60, %61, %62, %63}, "
          "%64, %65, p;\n"
          "}\n"
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
            "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
            "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
            "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
            "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
            "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
            "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
            "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
            "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
            "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
            "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
            "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
            "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
          : "l"(da), "l"(db), "r"(1));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  int sum = 0;
#pragma unroll
  for (int q = 0; q < 64; ++q) sum += d[q];
  out[blockIdx.x * kThreads + threadIdx.x] = sum;
}

}  // namespace

// out: int32 [blocks * 256]. Launches `blocks` blocks of 256 threads that
// each run `iters` rounds of MMAs: 8 a warp for kinds 0 and 1, 4 a
// warpgroup for kind 2.
extern "C" int twk_mma_probe(int kind, int blocks, int iters, void* out,
                             void* stream) {
  if (kind < 0 || kind > 2 || blocks <= 0 || iters <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0)
    mma_sync_probe<0><<<blocks, kThreads, 0, s>>>(iters, (int32_t*)out);
  else if (kind == 1)
    mma_sync_probe<1><<<blocks, kThreads, 0, s>>>(iters, (int32_t*)out);
  else
    wgmma_probe<<<blocks, kThreads, 0, s>>>(iters, (int32_t*)out);
  return (int)cudaGetLastError();
}
