// A segment's tile loop, enqueued from C.
//
// Replaces the tile loop the JAX package runs on the device as one
// program, the lax.scan of tomahawk_tpu/compute/sweeps.py::fused_sweep
// (:380-431) and its repair, extract_sweep (:477). Here the loop runs on
// the host, in C: for each live tile of the segment's tile list it calls
// the fused tile kernel's launcher (twk_phased_tile, or twk_parts_tile in
// its instance) with the counts buffer, then the compaction's
// (twk_compact), in tile order, on one stream, with no host sync. The
// Python wrapper (compute/sweeps.py::_launch_sweep) checks every tensor
// once a sweep and makes one call, where a Python loop made two ctypes
// calls a tile and checked every input again each time.
//
// What bounds it: the host's enqueue of 3-4 launches a tile (a few
// microseconds each) against ~0.1 ms of device work a tile at B = 4096;
// nothing here runs on the device. No __global__ function, no
// allocation: the buffers are the wrapper's.

#include <cuda_runtime.h>

#include <cstdint>

extern "C" int twk_phased_tile(const void* alt_i, const void* alt_j,
                               const void* ac_i, const void* ac_j,
                               const void* valid_i, const void* valid_j,
                               const void* an_i, const void* an_j,
                               const void* pos_i, const void* pos_j,
                               const void* rid_i, const void* rid_j,
                               int window, int cls, int B, int W, int n_hap,
                               float lo, float hi, float dp_lo, float dp_hi,
                               int need_nonzero, int diag, void* mask,
                               void* altalt, void* counts, void* stream);
extern "C" int twk_parts_tile(
    int kind, const void* x_i, const void* y_i, const void* z_i,
    const void* x_j, const void* y_j, const void* z_j, const void* ac_i,
    const void* ac_j, const void* valid_i, const void* valid_j,
    const void* an_i, const void* an_j, const void* nhet_i,
    const void* nhom_i, const void* nhet_j, const void* nhom_j,
    const void* pos_i, const void* pos_j, const void* rid_i,
    const void* rid_j, int window, int cls, int B, int W, int n_samples,
    float lo, float hi, float dp_lo, float dp_hi, int need_nonzero, int diag,
    void* mask, void* parts, void* counts, void* screen, void* stream);
extern "C" int twk_parts_tile_wide(int kind, int window, int W,
                                   const void* x_i, const void* y_i,
                                   const void* z_i, const void* x_j,
                                   const void* y_j, const void* z_j);
extern "C" int twk_compact(const void* mask, const void* parts,
                           const void* counts, int P, int ncol, int ld, int B,
                           void* off, int cap, int outcap, void* n_pass,
                           void* n_cand, int t, void* scratch, void* ticket,
                           void* buf, void* stream);

namespace {

// Row s of an [NB, B, ...] array of `row_bytes` bytes a super-block, or
// null where the array is not given.
inline const void* at(const void* base, int s, long long row_bytes) {
  return base == nullptr
             ? nullptr
             : static_cast<const char*>(base) + (long long)s * row_bytes;
}

}  // namespace

// kind: -1 phased_tile (P = 1); 0, 1, 2 parts_tile's instances (phased
// with missing data, unphased, unphased with missing data). x, y, z: the
// word planes int32 [NB, B, W] a side reads (y and z null where the
// instance reads fewer). ac, an, nhet, nhom, pos, rid: int32 [NB, B];
// valid: bool [NB, B]; null where the sweep group reads none. n_samples:
// the samples (phased_tile takes 2 * n_samples haplotypes). lo, hi, dp_lo,
// dp_hi, need_nonzero: the prefilter's bounds (prefilter.cuh's Bounds; the
// D' pair -inf, inf when the run sets none). pi, pj: int32
// [T] super-block indices; dg: uint8 [T] diagonal flags; live: uint8 [T]
// or null (every tile live); host memory, all of them. mask, parts,
// counts: the tile buffers every tile reuses. screen: int64 [2] on the
// device or null; parts_tile's unphased kinds (1, 2) add to it the
// candidates their prefilter's screen saw and those it left undecided
// (the other kinds ignore it). P, ncol, ld: the compaction's
// parts, payload layout and buffer row stride. off: int32 on the device,
// one running offset, or with per_tile_off an [T] array whose slot t tile
// t compacts at. n_pass, n_cand: int32 [T] on the device. done: int32 [3]
// on the host, set to the tile kernels and the compactions launched, and
// the tile kernels of them that took parts_tile's wide instance.
// Returns the first nonzero code of a launcher, or 0.
extern "C" int twk_sweep(int kind, const void* x, const void* y,
                         const void* z, int W, const void* ac,
                         const void* valid, const void* an, const void* nhet,
                         const void* nhom, const void* pos, const void* rid,
                         int window, int cls, int B, int n_samples, float lo,
                         float hi, float dp_lo, float dp_hi, int need_nonzero,
                         int T, const int32_t* pi,
                         const int32_t* pj, const uint8_t* dg,
                         const uint8_t* live, void* mask, void* parts,
                         void* counts, void* screen, int P, int ncol, int ld,
                         void* off, int per_tile_off, int cap, int outcap,
                         void* n_pass, void* n_cand, void* scratch,
                         void* ticket, void* buf, void* stream,
                         int32_t* done) {
  done[0] = done[1] = done[2] = 0;
  if (kind < -1 || kind > 2 || B <= 0 || W <= 0 || T < 0 || !x || !ac ||
      !valid)
    return (int)cudaErrorInvalidValue;
  const long long plane = (long long)B * W * 4, meta = (long long)B * 4;
  void* const scr = kind >= 1 ? screen : nullptr;
  for (int t = 0; t < T; ++t) {
    if (live != nullptr && !live[t]) continue;
    const int i = pi[t], j = pj[t];
    int rc;
    if (kind < 0)
      rc = twk_phased_tile(at(x, i, plane), at(x, j, plane), at(ac, i, meta),
                           at(ac, j, meta), at(valid, i, B), at(valid, j, B),
                           at(an, i, meta), at(an, j, meta), at(pos, i, meta),
                           at(pos, j, meta), at(rid, i, meta),
                           at(rid, j, meta), window, cls, B, W, 2 * n_samples,
                           lo, hi, dp_lo, dp_hi, need_nonzero, dg[t], mask,
                           parts, counts, stream);
    else
      rc = twk_parts_tile(
          kind, at(x, i, plane), at(y, i, plane), at(z, i, plane),
          at(x, j, plane), at(y, j, plane), at(z, j, plane), at(ac, i, meta),
          at(ac, j, meta), at(valid, i, B), at(valid, j, B), at(an, i, meta),
          at(an, j, meta), at(nhet, i, meta), at(nhom, i, meta),
          at(nhet, j, meta), at(nhom, j, meta), at(pos, i, meta),
          at(pos, j, meta), at(rid, i, meta), at(rid, j, meta), window, cls, B,
          W, n_samples, lo, hi, dp_lo, dp_hi, need_nonzero, dg[t], mask,
          parts, counts, scr, stream);
    if (rc != 0) return rc;
    ++done[0];
    if (kind >= 0)
      done[2] += twk_parts_tile_wide(kind, window, W, at(x, i, plane),
                                     at(y, i, plane), at(z, i, plane),
                                     at(x, j, plane), at(y, j, plane),
                                     at(z, j, plane));
    void* o = per_tile_off ? static_cast<void*>(static_cast<int32_t*>(off) + t)
                           : off;
    rc = twk_compact(mask, parts, counts, P, ncol, ld, B, o, cap, outcap,
                     n_pass, n_cand, t, scratch, ticket, buf, stream);
    if (rc != 0) return rc;
    ++done[1];
  }
  return 0;
}
