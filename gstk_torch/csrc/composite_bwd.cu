// Tile compositing backward (kernel K2).
//
// Replaces gstk_tpu/ops/raster_pallas.py::_bwd_kernel / _bwd_tile, launched
// there by composite_tiles_bwd; the math is that of
// gstk_tpu/ops/rasterize.py::_composite_bwd_loop. Given the forward's
// outputs acc (no background) and final_t, and their cotangents g (per
// pixel and channel) and g_T, every pixel walks its tile's depth-sorted
// range [start, end) front to back again, recomputing alpha and T exactly
// as K1 did, and for each entry it kept
//
//     v_alpha = T_prev <g, c> - (<g, acc> - prefix_incl) / max(1 - alpha, 1e-3)
//               - g_T T_final / max(1 - alpha, 1e-3)
//
// with prefix_incl = sum of T alpha <g, c> over the kept entries up to this
// one. Where the clamp was not hit (raw = op e^-sigma <= 0.999),
// v_sigma = -alpha v_alpha gives the entry's gradients for the mean (x, y)
// and the conic (a, b, c), and e^-sigma v_alpha the opacity gradient; the
// colors get T_prev alpha g. Summed over the tile's pixels, these are the
// entry's row of gout (cap, 6 + CH) = [x, y, a, b, c, opacity, colors],
// indexed by sorted position. Rows the tile never reached (it stopped
// early) keep the zeros the wrapper wrote; the per-Gaussian sums are K4's.
//
// Design: one CTA of 256 threads per tile, one thread per pixel, as K1.
// Batches of 256 entries are gathered by Gaussian id into shared memory.
// Every keep / skip / stop decision comes from composite_common.cuh, shared
// with K1, and T is recomputed as K1 does (T *= 1 - alpha), so T_prev
// equals the forward's bit for bit. The walk is front to back, the order of
// the reference formula, so it needs nothing from the forward but acc and
// final_t. The reduction over pixels is deterministic: per entry, each warp
// sums its 32 pixels with a shuffle tree (skipped when no pixel of the warp
// kept the entry) and lane 0 stores the warp's partial in shared memory
// [8][256][6 + CH]; after the batch, thread k sums entry k's 8 partials in
// warp order and writes its row. A tile owns its range, so no write races
// and no atomics are needed. The loop over a batch is uniform across the
// CTA, because the shuffles need every lane; a pixel that is done adds
// zeros.
//
// Bound: operations. Per (pixel, entry) pair evaluated, the recompute takes
// about 15 operations (dx, dy, sigma's 9, exp, raw, min, 1 - alpha, T);
// per pair kept, the gradient takes 37 + 4 CH more: <g, c> (2 CH), w and
// the prefix (3), 1 / max(1 - alpha, 1e-3) (3), v_alpha (6), v_sigma (2),
// the x, y, a, b, c products (16), the opacity (1), the colors (CH) and the
// sum over pixels (6 + CH). Per intersection the kernel moves the gid, 40 B
// of attributes and a 40 B row (at CH = 4), per pixel 4 (2 CH + 2) B of
// acc, final_t and cotangents: far fewer bytes than the 67 TFLOP/s f32 rate
// needs. This first design does nothing about the bound yet: the shuffle
// tree costs 5 (6 + CH) shuffles per warp and kept entry, gathers are
// uncoalesced, and pixels that are done idle through the batch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using gstk::kBlock;
using gstk::kPixels;

constexpr int kWarps = kPixels / 32;
constexpr unsigned kFull = 0xffffffffu;
// floor of 1 - alpha in the divisions: f32(1 - 0.999) as the reference has
// it, not 1.0f - 0.999f
constexpr float kOneMinusAlphaFloor = 0.001f;

// batch attributes [256][6 + CH] + warp partials [8][256][6 + CH]
template <int CH>
constexpr size_t kSmemBytes = sizeof(float) * (1 + kWarps) * kPixels * (6 + CH);

template <int CH>
__global__ void __launch_bounds__(kPixels) composite_bwd_kernel(
    const float* __restrict__ xys,        // (N, 2)
    const float* __restrict__ conics,     // (N, 3)
    const float* __restrict__ opacities,  // (N,)
    const float* __restrict__ colors,     // (N, CH)
    int n,
    const int32_t* __restrict__ gids,       // (cap,) sorted by (tile, depth)
    const int32_t* __restrict__ tile_bins,  // (T, 2) [start, end)
    int tiles_x,
    const float* __restrict__ acc,        // (T, 256, CH) forward output
    const float* __restrict__ final_t,    // (T, 256) forward output
    const float* __restrict__ g_acc,      // (T, 256, CH) cotangent
    const float* __restrict__ g_final_t,  // (T, 256) cotangent
    float* __restrict__ gout)             // (cap, 6 + CH), zeroed
{
  constexpr int kOut = 6 + CH;
  extern __shared__ float smem[];
  float* s_attr = smem;                   // [kPixels][kOut]
  float* s_part = smem + kPixels * kOut;  // [kWarps][kPixels][kOut]

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p >> 5;
  const int lane = p & 31;
  const float px = static_cast<float>((tile % tiles_x) * kBlock + p % kBlock);
  const float py = static_cast<float>((tile / tiles_x) * kBlock + p / kBlock);
  const int start = tile_bins[2 * tile];
  const int end = tile_bins[2 * tile + 1];

  const size_t pix = (size_t)tile * kPixels + p;
  float g[CH];
  float g_dot_acc = 0.0f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    g[c] = g_acc[pix * CH + c];
    g_dot_acc += g[c] * acc[pix * CH + c];
  }
  const float gt_tf = g_final_t[pix] * final_t[pix];

  float t = 1.0f;
  float g_prefix = 0.0f;
  bool done = false;

  for (int b0 = start; b0 < end; b0 += kPixels) {
    // also the barrier that keeps the previous batch and its partials
    // until every thread has used them
    if (__syncthreads_count(done) == kPixels) break;
    const int idx = b0 + p;
    const int gid = idx < end ? gids[idx] : n;
    float* row = s_attr + p * kOut;
    if (gid >= 0 && gid < n) {
      row[0] = xys[2 * gid];
      row[1] = xys[2 * gid + 1];
      row[2] = conics[3 * gid];
      row[3] = conics[3 * gid + 1];
      row[4] = conics[3 * gid + 2];
      row[5] = opacities[gid];
#pragma unroll
      for (int c = 0; c < CH; ++c) row[6 + c] = colors[(size_t)gid * CH + c];
    } else {  // alpha 0 < 1/255: skipped (not reached within range)
#pragma unroll
      for (int i = 0; i < kOut; ++i) row[i] = 0.0f;
    }
    __syncthreads();
    const int count = min(kPixels, end - b0);
    for (int k = 0; k < count; ++k) {
      const float* e_row = s_attr + k * kOut;
      float v[kOut];
#pragma unroll
      for (int i = 0; i < kOut; ++i) v[i] = 0.0f;
      bool kept = false;
      if (!done) {
        const float a = e_row[2], b = e_row[3], c = e_row[4];
        const float dx = e_row[0] - px;
        const float dy = e_row[1] - py;
        float e, raw, alpha, next_t;
        const gstk::Decision d =
            gstk::decide(a, b, c, e_row[5], dx, dy, t, e, raw, alpha, next_t);
        if (d == gstk::kStop) {
          done = true;
        } else if (d == gstk::kKeep) {
          kept = true;
          float g_dot_col = 0.0f;
#pragma unroll
          for (int ch = 0; ch < CH; ++ch) g_dot_col += g[ch] * e_row[6 + ch];
          const float w = t * alpha;
          const float prefix_incl = g_prefix + w * g_dot_col;
          const float inv_one_m = 1.0f / fmaxf(1.0f - alpha, kOneMinusAlphaFloor);
          const float v_alpha = t * g_dot_col -
                                (g_dot_acc - prefix_incl) * inv_one_m -
                                gt_tf * inv_one_m;
          if (!(raw > gstk::kAlphaClamp)) {  // a clamped alpha passes none
            const float v_sigma = -alpha * v_alpha;
            v[0] = (a * dx + b * dy) * v_sigma;
            v[1] = (c * dy + b * dx) * v_sigma;
            v[2] = 0.5f * dx * dx * v_sigma;
            v[3] = dx * dy * v_sigma;
            v[4] = 0.5f * dy * dy * v_sigma;
            v[5] = e * v_alpha;
          }
#pragma unroll
          for (int ch = 0; ch < CH; ++ch) v[6 + ch] = w * g[ch];
          g_prefix = prefix_incl;
          t = next_t;
        }
      }
      if (__any_sync(kFull, kept)) {
#pragma unroll
        for (int i = 0; i < kOut; ++i) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            v[i] += __shfl_down_sync(kFull, v[i], off);
          }
        }
      }
      if (lane == 0) {
        float* part = s_part + ((size_t)warp * kPixels + k) * kOut;
#pragma unroll
        for (int i = 0; i < kOut; ++i) part[i] = v[i];
      }
    }
    __syncthreads();
    if (p < count) {
      float* dst = gout + (size_t)(b0 + p) * kOut;
#pragma unroll
      for (int i = 0; i < kOut; ++i) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          s += s_part[((size_t)w * kPixels + p) * kOut + i];
        }
        dst[i] = s;
      }
    }
  }
}

template <int CH>
cudaError_t launch(const void* xys, const void* conics, const void* opacities,
                   const void* colors, int n, const void* gids,
                   const void* tile_bins, int num_tiles, int tiles_x,
                   const void* acc, const void* final_t, const void* g_acc,
                   const void* g_final_t, void* gout, cudaStream_t stream) {
  const size_t smem = kSmemBytes<CH>;
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  composite_bwd_kernel<CH><<<num_tiles, kPixels, smem, stream>>>(
      static_cast<const float*>(xys), static_cast<const float*>(conics),
      static_cast<const float*>(opacities), static_cast<const float*>(colors),
      n, static_cast<const int32_t*>(gids),
      static_cast<const int32_t*>(tile_bins), tiles_x,
      static_cast<const float*>(acc), static_cast<const float*>(final_t),
      static_cast<const float*>(g_acc), static_cast<const float*>(g_final_t),
      static_cast<float*>(gout));
  return cudaGetLastError();
}

}  // namespace

// Channel counts this kernel is instantiated for; the wrapper raises on
// any other.
extern "C" int gstk_composite_bwd(const void* xys, const void* conics,
                                  const void* opacities, const void* colors,
                                  int ch, int n, const void* gids,
                                  const void* tile_bins, int num_tiles,
                                  int tiles_x, const void* acc,
                                  const void* final_t, const void* g_acc,
                                  const void* g_final_t, void* gout,
                                  void* stream) {
  if (num_tiles <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ch) {
    case 3:
      return static_cast<int>(launch<3>(xys, conics, opacities, colors, n,
                                        gids, tile_bins, num_tiles, tiles_x,
                                        acc, final_t, g_acc, g_final_t, gout,
                                        s));
    case 4:
      return static_cast<int>(launch<4>(xys, conics, opacities, colors, n,
                                        gids, tile_bins, num_tiles, tiles_x,
                                        acc, final_t, g_acc, g_final_t, gout,
                                        s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
