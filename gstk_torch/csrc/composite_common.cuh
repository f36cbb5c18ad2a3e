// The compositing decisions shared by the forward (K1, composite_fwd.cu) and
// the backward (K2, composite_bwd.cu).
//
// K2 differentiates the image K1 made only if it keeps, skips and stops on
// exactly the entries K1 did, and recomputes the same transmittance bit for
// bit. Both kernels therefore decide every (pixel, entry) pair with the
// functions below, compiled from this one header with the same flags.

#pragma once

#include <cuda_runtime.h>

namespace gstk {

constexpr int kBlock = 16;
constexpr int kPixels = kBlock * kBlock;  // threads per CTA = batch length
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

// The three decisions, in the order both kernels take them: an entry with
// sigma < 0 is skipped; so is one whose clamped alpha is below 1/255; and a
// pixel stops for good, without applying the entry, where T (1 - alpha)
// would fall to 1e-4 or below. K1 takes them inline in this order, K2
// through `decide`.
__device__ __forceinline__ float clamped_alpha(float raw) {
  return fminf(kAlphaClamp, raw);
}

__device__ __forceinline__ bool stops(float t, float alpha, float& next_t) {
  next_t = t * (1.0f - alpha);
  return next_t <= kTCutoff;
}

enum Decision { kSkip = 0, kStop = 1, kKeep = 2 };

// One entry at one pixel whose transmittance is `t`: kSkip leaves the pixel
// as it is, kStop ends it, kKeep composites the entry with `alpha`, and T
// becomes `next_t`. For kStop and kKeep, `e` is exp(-sigma) and `raw` =
// op * e before the clamp.
__device__ __forceinline__ Decision decide(float a, float b, float c,
                                           float op, float dx, float dy,
                                           float t, float& e, float& raw,
                                           float& alpha, float& next_t) {
  const float sigma = sigma_of(a, b, c, dx, dy);
  if (sigma < 0.0f) return kSkip;
  e = expf(-sigma);
  raw = op * e;
  alpha = clamped_alpha(raw);
  if (alpha < kAlphaCutoff) return kSkip;
  return stops(t, alpha, next_t) ? kStop : kKeep;
}

}  // namespace gstk
