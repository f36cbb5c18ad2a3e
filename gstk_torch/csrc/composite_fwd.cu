// Tile compositing forward (kernel K1).
//
// Replaces gstk_tpu/ops/raster_pallas.py::_fwd_kernel, launched there by
// composite_tiles_fwd. Each 16x16 tile composites its depth-sorted range
// [start, end) of the intersection list front to back; per pixel and entry
//
//     sigma = 0.5 (a dx^2 + c dy^2) + b dx dy,   alpha = min(0.999, op e^-sigma)
//
// entries with sigma < 0 or alpha < 1/255 are skipped, and the pixel stops
// for good at the first entry where T (1 - alpha) <= 1e-4, without applying
// that entry. Outputs are the accumulated colors (no background) and the
// final transmittance T of every pixel.
//
// Design: one CTA of 256 threads per tile, one thread per pixel. The tile's
// range is walked in batches of 256 entries. Thread e stages entry e of a
// batch: the Gaussian's 48-B packed record (composite_common.cuh), three
// 16-B cp.async into a double buffer, so batch i + 1 is in flight while
// batch i is composited; the id of the batch after that is loaded into a
// register one batch ahead. One barrier per batch both publishes the
// landed batch and frees the buffer of the one before. Every pixel then
// composites the batch sequentially in f32; a pixel that stops leaves the
// loop, and a warp whose pixels have all stopped waits at the next barrier.
// Every keep / skip / stop decision comes from composite_common.cuh, which
// the backward kernel K2 shares. The tile exits early once every pixel is
// done (__syncthreads_count). Sentinel ids (>= N) get a zero record.
//
// Bound: operations. Per (pixel, entry) pair evaluated, about 20 FLOP and
// one exp (85 M pairs at the render point, 0.027 ms at 67 TFLOP/s); per
// intersection the kernel reads the id and a 48-B record, and it writes
// T * 256 * (CH + 1) * 4 B. What the design does about it: the staging
// costs each thread three asynchronous copies per batch, overlapped with
// the compositing of the batch before, and one barrier. The per-pair
// arithmetic takes the header's steps inline, in its order: x, y, a, b and
// c, op, col0, col1 come as two 16-B shared loads, so the opacity is loaded
// before sigma's test but used only after it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using gstk::kBlock;
using gstk::kPixels;

constexpr int kBatch = kPixels;  // entries per staged batch, one per thread

template <int CH>
__global__ void __launch_bounds__(kPixels) composite_fwd_kernel(
    const float4* __restrict__ records,     // (N, 3) packed records
    int n,
    const int32_t* __restrict__ gids,       // (cap,) sorted by (tile, depth)
    const int32_t* __restrict__ tile_bins,  // (T, 2) [start, end)
    int tiles_x,
    float* __restrict__ acc,      // (T, 256, CH)
    float* __restrict__ final_t)  // (T, 256)
{
  __shared__ float4 s_rec[2][kBatch * gstk::kRecordChunks];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const float px = static_cast<float>((tile % tiles_x) * kBlock + p % kBlock);
  const float py = static_cast<float>((tile / tiles_x) * kBlock + p / kBlock);
  const int start = tile_bins[2 * tile];
  const int end = tile_bins[2 * tile + 1];

  float t = 1.0f;
  bool done = false;
  float out[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) out[c] = 0.0f;

  gstk::stage_record(s_rec[0], records, gstk::batch_gid(gids, start, p, end, n),
                     n, p);
  gstk::cp_async_commit();
  int gid_next = gstk::batch_gid(gids, start + kBatch, p, end, n);
  for (int b0 = start, i = 0; b0 < end; b0 += kBatch, ++i) {
    gstk::cp_async_wait<0>();
    // batch i has landed for every thread, and every thread is done with
    // batch i - 1, whose buffer takes batch i + 1
    if (__syncthreads_count(done) == kPixels) break;
    if (b0 + kBatch < end) {
      gstk::stage_record(s_rec[(i + 1) & 1], records, gid_next, n, p);
      gid_next = gstk::batch_gid(gids, b0 + 2 * kBatch, p, end, n);
    }
    gstk::cp_async_commit();
    const float* batch = reinterpret_cast<const float*>(s_rec[i & 1]);
    const int count = min(kBatch, end - b0);
    for (int k = 0; k < count && !done; ++k) {
      // the decisions of composite_common.cuh, inline
      const float* r = batch + k * gstk::kRecordFloats;
      const float dx = r[gstk::kX] - px;
      const float dy = r[gstk::kY] - py;
      const float sigma =
          gstk::sigma_of(r[gstk::kA], r[gstk::kB], r[gstk::kC], dx, dy);
      if (sigma < 0.0f) continue;
      const float alpha = gstk::clamped_alpha(r[gstk::kOp] * expf(-sigma));
      if (alpha < gstk::kAlphaCutoff) continue;
      float next_t;
      if (gstk::stops(t, alpha, next_t)) {
        done = true;
        break;
      }
      const float w = alpha * t;
#pragma unroll
      for (int c = 0; c < CH; ++c) out[c] += w * r[gstk::kCol + c];
      t = next_t;
    }
  }
  // an empty range never waited for its first batch's (zero-filled) copies:
  // none may land after the CTA has exited
  gstk::cp_async_wait<0>();
  float* acc_px = acc + ((size_t)tile * kPixels + p) * CH;
#pragma unroll
  for (int c = 0; c < CH; ++c) acc_px[c] = out[c];
  final_t[(size_t)tile * kPixels + p] = t;
}

template <int CH>
cudaError_t launch(const void* records, int n, const void* gids,
                   const void* tile_bins, int num_tiles, int tiles_x, void* acc,
                   void* final_t, cudaStream_t stream) {
  composite_fwd_kernel<CH><<<num_tiles, kPixels, 0, stream>>>(
      static_cast<const float4*>(records), n, static_cast<const int32_t*>(gids),
      static_cast<const int32_t*>(tile_bins), tiles_x,
      static_cast<float*>(acc), static_cast<float*>(final_t));
  return cudaGetLastError();
}

}  // namespace

// Channel counts this kernel is instantiated for; the wrapper raises on
// any other.
extern "C" int gstk_composite_fwd(const void* records, int ch, int n,
                                  const void* gids, const void* tile_bins,
                                  int num_tiles, int tiles_x, void* acc,
                                  void* final_t, void* stream) {
  if (num_tiles <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ch) {
    case 3:
      return static_cast<int>(launch<3>(records, n, gids, tile_bins, num_tiles,
                                        tiles_x, acc, final_t, s));
    case 4:
      return static_cast<int>(launch<4>(records, n, gids, tile_bins, num_tiles,
                                        tiles_x, acc, final_t, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Resident CTAs of K1 per SM at `ch` channels, into *blocks.
extern "C" int gstk_composite_fwd_occupancy(int ch, int* blocks) {
  switch (ch) {
    case 3:
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, composite_fwd_kernel<3>, kPixels, 0));
    case 4:
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, composite_fwd_kernel<4>, kPixels, 0));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
