// Projection and SH colour of every Gaussian, forward: one launch a view.
//
// Replaces no TPU kernel: gstk_tpu leaves this elementwise work to XLA,
// which fuses it (gstk_tpu/models/vanilla.py::splat_inputs). In PyTorch it
// was a few hundred ops, each a pass over every lane. Per lane it computes
// what models/vanilla.py::splat_inputs_plain returns: normalize(quats),
// exp(scales) and sigmoid(opacities); the 3D covariance, view transform,
// clamped EWA Jacobian, the 2D covariance with the +0.3 blur and its
// compensation; conic, radius, the pixel centre through fullmat, the tile
// bbox and its area, and the near-plane / det mask; the SH colour at the
// lane's view direction (or sigmoid(features_dc) at degree 0 when the model
// has no SH), and the alive and crop mask; the opacity, times the
// compensation when antialiased. All of it in f32, in the plain path's
// order of operations (project_common.cuh).
//
// Bound: bytes. A lane reads 44 B of geometry, 12 B of DC colour, 12 B a
// higher SH basis and its alive flag, and writes 52 B (xys, depth, radius,
// conic, tile count, RGB + depth, opacity); about 237 B read at degree 3.
// Design: one thread a lane, 128 lanes a CTA. The lanes' features_rest
// rows (180 B a lane at degree 3) are one contiguous run, which the CTA
// copies into shared memory with 16-B loads before any thread reads its
// own; the narrow per-lane fields are read directly (a warp's reads cover
// contiguous bytes). The colour and depth go out as one 16-B store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "project_common.cuh"

namespace {

using namespace gstk_project;

struct Outputs {
  float* xys;        // (N, 2)
  float* depths;     // (N,)
  int32_t* radii;    // (N,)
  float* conics;     // (N, 3)
  int32_t* tiles;    // (N,)
  float* colors;     // (N, 4): RGB + depth
  float* opacities;  // (N,)
};

template <int kBases>
__global__ void __launch_bounds__(kThreads) project_fwd_kernel(Args a,
                                                               Outputs o) {
  extern __shared__ float4 s_rest4[];
  float* s_rest = reinterpret_cast<float*>(s_rest4);
  const int i0 = blockIdx.x * kThreads;
  const int row = a.rest_rows * 3;  // floats of a lane's features_rest
  if constexpr (kBases > 1) {
    stage_in(a.features_rest + static_cast<size_t>(i0) * row, s_rest,
             min(kThreads, a.n - i0) * row);
    __syncthreads();
  }
  const int i = i0 + threadIdx.x;
  if (i >= a.n) return;

  const View v = load_view(a);
  const Geometry g = project_lane(v, a, i);
  const bool alive = a.alive[i] != 0;
  const bool mask = g.mask;

  float rgb[3];
  if (a.sigmoid_colors) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      rgb[ch] = sigmoid(__ldg(a.features_dc + 3 * i + ch));
    }
  } else {
    float bases[kBases];
    view_bases<kBases>(v, a, i, bases);
    const float* rest = s_rest + threadIdx.x * row;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float pre = sh_channel<kBases>(
          bases, __ldg(a.features_dc + 3 * i + ch), rest, ch);
      rgb[ch] = tmax(pre, 0.0f);
    }
  }

  float opac = sigmoid(__ldg(a.opacities + i));
  if (a.antialiased) opac = opac * (mask ? g.comp : 0.0f);
  const float depth = mask ? g.t[2] : 0.0f;

  reinterpret_cast<float2*>(o.xys)[i] =
      mask ? make_float2(g.u, g.v) : make_float2(0.0f, 0.0f);
  o.depths[i] = depth;
  o.radii[i] = alive && mask ? __float2int_rz(g.radius) : 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) o.conics[3 * i + k] = mask ? g.conic[k] : 0.0f;
  o.tiles[i] = alive && mask ? g.area : 0;
  reinterpret_cast<float4*>(o.colors)[i] =
      make_float4(rgb[0], rgb[1], rgb[2], depth);
  o.opacities[i] = alive ? opac : 0.0f;
}

template <int kBases>
cudaError_t launch(const Args& a, const Outputs& o, cudaStream_t stream) {
  const int blocks = (a.n + kThreads - 1) / kThreads;
  const size_t smem =
      kBases > 1 ? sizeof(float) * kThreads * a.rest_rows * 3 : 0;
  project_fwd_kernel<kBases><<<blocks, kThreads, smem, stream>>>(a, o);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gstk_project_fwd(
    int n, int rest_rows, int sh_degree, int sigmoid_colors, int antialiased,
    int width, int height, int block, const void* means, const void* scales,
    const void* quats, const void* features_dc, const void* features_rest,
    const void* opacities, const void* alive, const void* view, void* xys, void* depths, void* radii, void* conics, void* tiles,
    void* colors, void* opacities_out, void* stream) {
  const int bases = (sh_degree + 1) * (sh_degree + 1);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (sh_degree < 0 || sh_degree > 4 || rest_rows > kMaxRestRows ||
      bases - 1 > rest_rows || block <= 0 ||
      (sigmoid_colors && sh_degree != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{n, rest_rows, width, height, block, sigmoid_colors, antialiased,
               static_cast<const float*>(means),
               static_cast<const float*>(scales),
               static_cast<const float*>(quats),
               static_cast<const float*>(opacities),
               static_cast<const float*>(features_dc),
               static_cast<const float*>(features_rest),
               static_cast<const uint8_t*>(alive),
               static_cast<const float*>(view)};
  const Outputs o{static_cast<float*>(xys), static_cast<float*>(depths),
                  static_cast<int32_t*>(radii), static_cast<float*>(conics),
                  static_cast<int32_t*>(tiles), static_cast<float*>(colors),
                  static_cast<float*>(opacities_out)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (sh_degree) {
    case 0: err = launch<1>(a, o, s); break;
    case 1: err = launch<4>(a, o, s); break;
    case 2: err = launch<9>(a, o, s); break;
    case 3: err = launch<16>(a, o, s); break;
    default: err = launch<25>(a, o, s); break;
  }
  return static_cast<int>(err);
}
