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
// range is walked in batches of 256 entries; each batch is gathered
// cooperatively into shared memory straight from the per-Gaussian arrays
// (gid -> xy, conic, opacity, CH colors), then every pixel composites the
// batch sequentially in f32. Every keep / skip / stop decision comes from
// composite_common.cuh, which the backward kernel K2 shares. The tile exits
// early once every pixel is done (__syncthreads_count). Entries past `end`
// and sentinel ids (>= N) are never read.
//
// Bound: per intersection the kernel reads the gid and 4 (6 + CH) B of
// attributes (40 B at CH = 4), and writes T * 256 * (CH + 1) * 4 B; the work
// is about 20 FLOP and one exp per (pixel, entry) pair processed. This first
// design does nothing about either bound yet: gathers are uncoalesced,
// batches are not double-buffered, and a warp's pixels that finish early
// idle until the whole batch is done.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using gstk::kBlock;
using gstk::kPixels;

template <int CH>
__global__ void __launch_bounds__(kPixels) composite_fwd_kernel(
    const float* __restrict__ xys,        // (N, 2)
    const float* __restrict__ conics,     // (N, 3)
    const float* __restrict__ opacities,  // (N,)
    const float* __restrict__ colors,     // (N, CH)
    int n,
    const int32_t* __restrict__ gids,       // (cap,) sorted by (tile, depth)
    const int32_t* __restrict__ tile_bins,  // (T, 2) [start, end)
    int tiles_x,
    float* __restrict__ acc,      // (T, 256, CH)
    float* __restrict__ final_t)  // (T, 256)
{
  __shared__ float s_xy[kPixels][2];
  __shared__ float s_conic[kPixels][3];
  __shared__ float s_op[kPixels];
  __shared__ float s_col[kPixels][CH];

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

  for (int b0 = start; b0 < end; b0 += kPixels) {
    // also the barrier that keeps the previous batch until all have used it
    if (__syncthreads_count(done) == kPixels) break;
    const int idx = b0 + p;
    const int g = idx < end ? gids[idx] : n;
    if (g >= 0 && g < n) {
      s_xy[p][0] = xys[2 * g];
      s_xy[p][1] = xys[2 * g + 1];
      s_conic[p][0] = conics[3 * g];
      s_conic[p][1] = conics[3 * g + 1];
      s_conic[p][2] = conics[3 * g + 2];
      s_op[p] = opacities[g];
#pragma unroll
      for (int c = 0; c < CH; ++c) s_col[p][c] = colors[(size_t)g * CH + c];
    } else {  // alpha 0 < 1/255: skipped (not reached within range)
      s_xy[p][0] = s_xy[p][1] = 0.0f;
      s_conic[p][0] = s_conic[p][1] = s_conic[p][2] = 0.0f;
      s_op[p] = 0.0f;
    }
    __syncthreads();
    const int count = min(kPixels, end - b0);
    for (int k = 0; k < count && !done; ++k) {
      // gstk::decide's steps, inline: s_op is read only past sigma's test
      const float dx = s_xy[k][0] - px;
      const float dy = s_xy[k][1] - py;
      const float sigma =
          gstk::sigma_of(s_conic[k][0], s_conic[k][1], s_conic[k][2], dx, dy);
      if (sigma < 0.0f) continue;
      const float alpha = gstk::clamped_alpha(s_op[k] * expf(-sigma));
      if (alpha < gstk::kAlphaCutoff) continue;
      float next_t;
      if (gstk::stops(t, alpha, next_t)) {
        done = true;
        break;
      }
      const float w = alpha * t;
#pragma unroll
      for (int c = 0; c < CH; ++c) out[c] += w * s_col[k][c];
      t = next_t;
    }
  }
  float* acc_px = acc + ((size_t)tile * kPixels + p) * CH;
#pragma unroll
  for (int c = 0; c < CH; ++c) acc_px[c] = out[c];
  final_t[(size_t)tile * kPixels + p] = t;
}

template <int CH>
cudaError_t launch(const void* xys, const void* conics, const void* opacities,
                   const void* colors, int n, const void* gids,
                   const void* tile_bins, int num_tiles, int tiles_x, void* acc,
                   void* final_t, cudaStream_t stream) {
  composite_fwd_kernel<CH><<<num_tiles, kPixels, 0, stream>>>(
      static_cast<const float*>(xys), static_cast<const float*>(conics),
      static_cast<const float*>(opacities), static_cast<const float*>(colors),
      n, static_cast<const int32_t*>(gids),
      static_cast<const int32_t*>(tile_bins), tiles_x,
      static_cast<float*>(acc), static_cast<float*>(final_t));
  return cudaGetLastError();
}

}  // namespace

// Channel counts this kernel is instantiated for; the wrapper raises on
// any other.
extern "C" int gstk_composite_fwd(const void* xys, const void* conics,
                                  const void* opacities, const void* colors,
                                  int ch, int n, const void* gids,
                                  const void* tile_bins, int num_tiles,
                                  int tiles_x, void* acc, void* final_t,
                                  void* stream) {
  if (num_tiles <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ch) {
    case 3:
      return static_cast<int>(launch<3>(xys, conics, opacities, colors, n,
                                        gids, tile_bins, num_tiles, tiles_x,
                                        acc, final_t, s));
    case 4:
      return static_cast<int>(launch<4>(xys, conics, opacities, colors, n,
                                        gids, tile_bins, num_tiles, tiles_x,
                                        acc, final_t, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
