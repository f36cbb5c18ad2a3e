// Ablation clones of the tile compositing forward K1 (probe P1).
//
// Replaces tools/ablate_fwd.py::build_variant, the TPU probe that times
// clones of gstk_tpu/ops/raster_pallas.py::_fwd_kernel with one part removed
// each. Here every clone is K1's loop (composite_fwd.cu) instantiated from
// one template, so that composite_fwd.cu itself does not change: 256-thread
// CTAs, one tile a CTA and one pixel a thread; 48-B records staged by three
// 16-B cp.async a thread into a double buffer; one barrier a batch of 256
// entries. The variants:
//
//   kFull        K1's function, statement for statement: its output equals
//                composite_tiles_fwd's bit for bit on the same inputs.
//   kNoExit      no __syncthreads_count tile exit and no per-pixel break: a
//                stopped pixel still walks every later entry and skips each
//                one, so the output equals kFull's bit for bit. The time
//                over kFull's is what the loop's early exits save or cost.
//   kDmaOnly     the staging floor: the staging, the barrier and the batch
//                loop, and no compositing. Pixel thread p adds word p mod 12
//                of the batch's record p (the record thread p staged; zero
//                past the range) once a batch. acc[p][0] holds that sum,
//                every other channel 0, and T is 1.
//   kMargNone    the marginal path with nothing removed: kFull's code, a
//                separate instantiation (its time beside kFull's is the
//                spread of the measurement). Equals kFull bit for bit.
//   kMargSigma   the conic's quadratic form replaced by the placeholder
//                product sigma = (a dx) dx (the tool's marg_sigmadot).
//   kMargExp     exp(-sigma) replaced by 1 - sigma / 2 (marg_exp).
//   kMargContrib the color FMAs replaced by one running sum of the weights,
//                written to every channel (marg_contrib).
//
// The marg variants' outputs are wrong by design: they are for timing, and
// each is held against its plain twin, which removes the same part.
//
// Bound: as K1's, operations for the same (pixel, entry) pairs, about 20
// FLOP and one exp a pair; kDmaOnly's is bytes, the 4-B id and 48-B record
// of each entry read and the planes written.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using gstk::kBlock;
using gstk::kPixels;

constexpr int kBatch = kPixels;  // entries per staged batch, one per thread
constexpr int kCh = 4;           // the channels the probe composites

enum Variant : int {
  kFull = 0,
  kNoExit = 1,
  kDmaOnly = 2,
  kMargNone = 3,
  kMargSigma = 4,
  kMargExp = 5,
  kMargContrib = 6,
};

template <int V>
__global__ void __launch_bounds__(kPixels) ablate_fwd_kernel(
    const float4* __restrict__ records,     // (N, 3) packed records
    int n,
    const int32_t* __restrict__ gids,       // (cap,) sorted by (tile, depth)
    const int32_t* __restrict__ tile_bins,  // (T, 2) [start, end)
    int tiles_x,
    float* __restrict__ acc,      // (T, 256, kCh)
    float* __restrict__ final_t)  // (T, 256)
{
  constexpr bool kExits = V != kNoExit;
  __shared__ float4 s_rec[2][kBatch * gstk::kRecordChunks];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const float px = static_cast<float>((tile % tiles_x) * kBlock + p % kBlock);
  const float py = static_cast<float>((tile / tiles_x) * kBlock + p / kBlock);
  const int start = tile_bins[2 * tile];
  const int end = tile_bins[2 * tile + 1];

  float t = 1.0f;
  bool done = false;
  float out[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) out[c] = 0.0f;

  gstk::stage_record(s_rec[0], records, gstk::batch_gid(gids, start, p, end, n),
                     n, p);
  gstk::cp_async_commit();
  int gid_next = gstk::batch_gid(gids, start + kBatch, p, end, n);
  for (int b0 = start, i = 0; b0 < end; b0 += kBatch, ++i) {
    gstk::cp_async_wait<0>();
    if constexpr (kExits) {
      if (__syncthreads_count(done) == kPixels) break;
    } else {
      __syncthreads();
    }
    if (b0 + kBatch < end) {
      gstk::stage_record(s_rec[(i + 1) & 1], records, gid_next, n, p);
      gid_next = gstk::batch_gid(gids, b0 + 2 * kBatch, p, end, n);
    }
    gstk::cp_async_commit();
    const float* batch = reinterpret_cast<const float*>(s_rec[i & 1]);
    if constexpr (V == kDmaOnly) {
      out[0] += batch[p * gstk::kRecordFloats + p % gstk::kRecordFloats];
      continue;
    }
    const int count = min(kBatch, end - b0);
    for (int k = 0; k < count && !(kExits && done); ++k) {
      if (!kExits && done) continue;
      const float* r = batch + k * gstk::kRecordFloats;
      const float dx = r[gstk::kX] - px;
      const float dy = r[gstk::kY] - py;
      float sigma;
      if constexpr (V == kMargSigma) {
        sigma = __fmul_rn(__fmul_rn(r[gstk::kA], dx), dx);
      } else {
        sigma = gstk::sigma_of(r[gstk::kA], r[gstk::kB], r[gstk::kC], dx, dy);
      }
      if (sigma < 0.0f) continue;
      float falloff;
      if constexpr (V == kMargExp) {
        falloff = __fsub_rn(1.0f, __fmul_rn(0.5f, sigma));
      } else {
        falloff = expf(-sigma);
      }
      const float alpha = gstk::clamped_alpha(r[gstk::kOp] * falloff);
      if (alpha < gstk::kAlphaCutoff) continue;
      float next_t;
      if (gstk::stops(t, alpha, next_t)) {
        done = true;
        if constexpr (kExits) {
          break;
        } else {
          continue;
        }
      }
      const float w = alpha * t;
      if constexpr (V == kMargContrib) {
        out[0] += w;
      } else {
#pragma unroll
        for (int c = 0; c < kCh; ++c) out[c] += w * r[gstk::kCol + c];
      }
      t = next_t;
    }
  }
  // an empty range never waited for its first batch's (zero-filled) copies:
  // none may land after the CTA has exited
  gstk::cp_async_wait<0>();
  if constexpr (V == kMargContrib) {
#pragma unroll
    for (int c = 1; c < kCh; ++c) out[c] = out[0];
  }
  if constexpr (V == kDmaOnly) t = 1.0f;
  float* acc_px = acc + ((size_t)tile * kPixels + p) * kCh;
#pragma unroll
  for (int c = 0; c < kCh; ++c) acc_px[c] = out[c];
  final_t[(size_t)tile * kPixels + p] = t;
}

template <int V>
cudaError_t launch(const void* records, int n, const void* gids,
                   const void* tile_bins, int num_tiles, int tiles_x, void* acc,
                   void* final_t, cudaStream_t stream) {
  ablate_fwd_kernel<V><<<num_tiles, kPixels, 0, stream>>>(
      static_cast<const float4*>(records), n, static_cast<const int32_t*>(gids),
      static_cast<const int32_t*>(tile_bins), tiles_x,
      static_cast<float*>(acc), static_cast<float*>(final_t));
  return cudaGetLastError();
}

}  // namespace

// `variant` is the Variant code above (the order of
// gstk_torch/tools/ablate_fwd.py::VARIANTS); only ch 4 is instantiated.
extern "C" int gstk_ablate_fwd(int variant, const void* records, int ch, int n,
                               const void* gids, const void* tile_bins,
                               int num_tiles, int tiles_x, void* acc,
                               void* final_t, void* stream) {
  if (ch != kCh) return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
#define GSTK_ABLATE_CASE(V)                                                  \
  case V:                                                                    \
    return static_cast<int>(launch<V>(records, n, gids, tile_bins, num_tiles, \
                                      tiles_x, acc, final_t, s));
    GSTK_ABLATE_CASE(kFull)
    GSTK_ABLATE_CASE(kNoExit)
    GSTK_ABLATE_CASE(kDmaOnly)
    GSTK_ABLATE_CASE(kMargNone)
    GSTK_ABLATE_CASE(kMargSigma)
    GSTK_ABLATE_CASE(kMargExp)
    GSTK_ABLATE_CASE(kMargContrib)
#undef GSTK_ABLATE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
