// What the forward (K1, composite_fwd.cu) and the backward (K2,
// composite_bwd.cu) share: the compositing decisions, the packed
// per-Gaussian record and the staging of a batch of records into shared
// memory. The segment sum (K4, segment_sum.cu) stages with the same
// cp.async helpers.
//
// K2 differentiates the image K1 made only if it keeps, skips and stops on
// exactly the entries K1 did, and recomputes the same transmittance bit for
// bit. Both kernels therefore decide every (pixel, entry) pair with the
// functions below, compiled from this one header with the same flags.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gstk {

constexpr int kBlock = 16;
constexpr int kPixels = kBlock * kBlock;  // threads per CTA, one per pixel
constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kTCutoff = 1e-4f;

// sigma rounded op by op, in the plain twin's order, with no FMA
// contraction: an alpha within rounding of the 1/255 cutoff then falls the
// same way in the kernels and in the twins.
__device__ __forceinline__ float sigma_of(float a, float b, float c, float dx,
                                          float dy) {
  const float qa = __fmul_rn(__fmul_rn(a, dx), dx);
  const float qc = __fmul_rn(__fmul_rn(c, dy), dy);
  const float qb = __fmul_rn(__fmul_rn(b, dx), dy);
  return __fadd_rn(__fmul_rn(0.5f, __fadd_rn(qa, qc)), qb);
}

// The three decisions, in the order both kernels take them inline: an entry
// with sigma < 0 is skipped; so is one whose clamped alpha is below 1/255;
// and a pixel stops for good, without applying the entry, where T
// (1 - alpha) would fall to 1e-4 or below.
__device__ __forceinline__ float clamped_alpha(float raw) {
  return fminf(kAlphaClamp, raw);
}

__device__ __forceinline__ bool stops(float t, float alpha, float& next_t) {
  next_t = t * (1.0f - alpha);
  return next_t <= kTCutoff;
}

// The per-Gaussian record both kernels read, built by
// ops/raster_cuda.py::pack_records: 12 floats, 48 B, three float4
//     [x, y, a, b | c, op, col0, col1 | col2, col3, 0, 0]
// with colors past ch zero. One entry of a batch is three 16-B copies.
constexpr int kRecordFloats = 12;
constexpr int kRecordChunks = kRecordFloats / 4;
enum RecordField { kX = 0, kY = 1, kA = 2, kB = 3, kC = 4, kOp = 5, kCol = 6 };

// 16 B from global to shared memory without passing through registers; with
// `valid` false nothing is read and the 16 B are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `kPending` of this thread's committed groups are in
// flight; a barrier afterwards makes every thread's copies visible.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The id of entry `e` of the batch at `b0` of the range ending at `end`: the
// sentinel n past the range.
__device__ __forceinline__ int batch_gid(const int32_t* __restrict__ gids,
                                         int b0, int e, int end, int n) {
  return b0 + e < end ? gids[b0 + e] : n;
}

// Starts copying Gaussian `gid`'s record into slot `e` of a staged batch. A
// sentinel or an id out of range gets zeros, an entry whose alpha (0) is
// below the cutoff: it is skipped, as the twins skip it. Call cp_async_commit
// after the last copy of the batch.
__device__ __forceinline__ void stage_record(float4* batch,
                                             const float4* __restrict__ records,
                                             int gid, int n, int e) {
  const bool valid = gid >= 0 && gid < n;
  const float4* src = records + (size_t)(valid ? gid : 0) * kRecordChunks;
#pragma unroll
  for (int j = 0; j < kRecordChunks; ++j) {
    cp_async16(batch + e * kRecordChunks + j, src + j, valid);
  }
}

}  // namespace gstk
