// Projection and SH colour of every Gaussian, backward: one launch a
// backward pass.
//
// Replaces no TPU kernel: gstk_tpu differentiates the XLA-fused projection
// with jax.grad; in PyTorch it was autograd over a few hundred ops, one of
// them a batched GEMM (the SH einsum's gradient). From the forward's output
// gradients (xys, depths, conics, colors with depth in channel 3,
// opacities; a null pointer stands for zeros) it returns the gradients of
// means, scales, quats, opacities, features_dc and features_rest, and when
// asked (camera optimisation) those of the view's matrices: viewmat rows
// 0-2 and fullmat rows 0, 1 and 3, the entries the projection reads. Each
// lane's 24 terms are summed over the CTA (warp shuffles, then the warps in
// order) into one partial a CTA, and a second launch sums each term's
// partials in a fixed order, so the sum is the same from run to run.
//
// It saves nothing from the forward: each lane's projection is recomputed
// from the raw parameters by the forward's own code (project_common.cuh,
// both sources compiled alike), so masks and clamps are the forward's bit
// for bit. The gradient follows autograd of the plain path: torch.minimum /
// torch.maximum give half the gradient at a tie (the +-1.3 tan(fov) clamp,
// max(rgb, 0), max(ratio, 0), max(|quat|, 1e-12)); the torch.where guards
// (|tz| < 1e-6, |det_blur| < 1e-12, det != 0, the projection mask, dead
// lanes) pass zero; a lane whose output gradients are all zero gets zero.
//
// Bound: bytes. A lane reads the forward's 237 B at degree 3 and 40 B of
// output gradients, and writes 236 B of gradients (180 B of them
// features_rest's). Design: as the forward, 128 lanes a CTA; the CTA
// stages the lanes' features_rest in shared memory with 16-B loads, each
// thread computes its colour and writes its features_rest gradient rows
// (zero past the active degree) over its own staged rows, and the CTA
// stores them with 16-B stores; then each thread differentiates its
// projection. The view's gradient is a template flag: the path without it
// keeps none of its registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "project_common.cuh"

namespace {

using namespace gstk_project;

struct Cotangents {  // any may be null: zero
  const float* xys;        // (N, 2)
  const float* depths;     // (N,)
  const float* conics;     // (N, 3)
  const float* colors;     // (N, 4)
  const float* opacities;  // (N,)
};

struct Grads {
  float* means;          // (N, 3)
  float* scales;         // (N, 3)
  float* quats;          // (N, 4)
  float* opacities;      // (N, 1)
  float* features_dc;    // (N, 3)
  float* features_rest;  // (N, rest_rows, 3)
};

// viewmat rows 0-2 (12) and fullmat rows 0, 1 and 3 (12): the terms of a
// lane's view gradient, at these places of the (35,) view
constexpr int kViewTerms = 24;
__device__ __forceinline__ int view_index(int term) {
  return term < 20 ? term : term + 4;  // fullmat row 2 is never read
}
constexpr int kReduceThreads = 256;  // the partials' sum: one CTA a term

__device__ __forceinline__ float load_or_zero(const float* p, int k) {
  return p ? __ldg(p + k) : 0.0f;
}

// One lane's gradients past the colour: opacity, means, scales, quats, and
// with kViewGrad its view terms into `gview` (left zero where the lane
// passes no gradient).
template <bool kViewGrad>
__device__ __forceinline__ void lane_backward(const View& v, const Args& a,
                                              const Cotangents& gin,
                                              const Grads& gout, int i,
                                              float* gview) {
  // the opacity: sigmoid(logit), times the compensation when antialiased;
  // dead lanes' opacity is a constant 0
  const float g_opac = a.alive[i] ? load_or_zero(gin.opacities, i) : 0.0f;
  const float gu = load_or_zero(gin.xys, 2 * i);
  const float gv = load_or_zero(gin.xys, 2 * i + 1);
  const float gk0 = load_or_zero(gin.conics, 3 * i);
  const float gk1 = load_or_zero(gin.conics, 3 * i + 1);
  const float gk2 = load_or_zero(gin.conics, 3 * i + 2);
  const float g_depth =
      load_or_zero(gin.depths, i) + load_or_zero(gin.colors, 4 * i + 3);
  float* gm = gout.means + 3 * i;
  float* gs = gout.scales + 3 * i;
  float* gq = gout.quats + 4 * i;
  if (gu == 0.0f && gv == 0.0f && gk0 == 0.0f && gk1 == 0.0f &&
      gk2 == 0.0f && g_depth == 0.0f && g_opac == 0.0f) {
#pragma unroll
    for (int k = 0; k < 3; ++k) gm[k] = gs[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) gq[k] = 0.0f;
    gout.opacities[i] = 0.0f;
    return;
  }

  const Geometry g = project_lane(v, a, i);
  const float sig = sigmoid(__ldg(a.opacities + i));
  float g_sig = g_opac, g_comp = 0.0f;
  if (a.antialiased) {
    g_sig = g_opac * (g.mask ? g.comp : 0.0f);
    g_comp = g.mask ? g_opac * sig : 0.0f;
  }
  gout.opacities[i] = g_sig * (1.0f - sig) * sig;
  if (!g.mask) {  // xys, depth, conic and compensation are zeroed there
#pragma unroll
    for (int k = 0; k < 3; ++k) gm[k] = gs[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) gq[k] = 0.0f;
    return;
  }

  // conic = (c, -b, a) / det, det = a c - b^2 (blurred a, c)
  float ga = gk2 * g.inv_det, gb = -(gk1 * g.inv_det), gc = gk0 * g.inv_det;
  if (g.valid) {
    const float g_inv = gk0 * g.c + gk1 * -g.b + gk2 * g.a;
    const float g_det = -g_inv * (g.inv_det * g.inv_det);
    ga += g_det * g.c;
    gc += g_det * g.a;
    gb -= 2.0f * g.b * g_det;
  }
  float ga0 = 0.0f, gc0 = 0.0f;
  // compensation = sqrt(max(det_orig / det_blur, 0))
  if (g_comp != 0.0f && g.ratio >= 0.0f) {
    const float g_ratio =
        g_comp / (2.0f * g.comp) * max_share(g.ratio, 0.0f);
    const float g_do = g_ratio / g.dbs;
    const float g_db = g.dbs_small ? 0.0f : -g_ratio * (g.ratio / g.dbs);
    ga += g_db * g.c;
    gc += g_db * g.a;
    gb -= 2.0f * g.b * g_db;
    ga0 += g_do * g.c0;
    gc0 += g_do * g.a0;
    gb -= 2.0f * g.b * g_do;
  }
  ga0 += ga;  // the +0.3 blur
  gc0 += gc;

  // a0 = T0' S T0, b = T0' S T1, c0 = T1' S T1, S the 3D covariance
  const float* cv = g.cov;
  const float* T = g.T;
  const float s0[3] = {cv[0] * T[0] + cv[1] * T[1] + cv[2] * T[2],
                       cv[1] * T[0] + cv[3] * T[1] + cv[4] * T[2],
                       cv[2] * T[0] + cv[4] * T[1] + cv[5] * T[2]};
  const float s1[3] = {cv[0] * T[3] + cv[1] * T[4] + cv[2] * T[5],
                       cv[1] * T[3] + cv[3] * T[4] + cv[4] * T[5],
                       cv[2] * T[3] + cv[4] * T[4] + cv[5] * T[5]};
  float gT[6];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    gT[j] = 2.0f * ga0 * s0[j] + gb * s1[j];
    gT[3 + j] = gb * s0[j] + 2.0f * gc0 * s1[j];
  }
  auto g_cov_term = [&](int p, int q) {  // d(a0, b, c0) / d S_pq, p != q
    return ga0 * 2.0f * T[p] * T[q] + gb * (T[p] * T[3 + q] + T[q] * T[3 + p]) +
           gc0 * 2.0f * T[3 + p] * T[3 + q];
  };
  auto g_cov_diag = [&](int p) {
    return ga0 * T[p] * T[p] + gb * T[p] * T[3 + p] + gc0 * T[3 + p] * T[3 + p];
  };
  const float gcov[6] = {g_cov_diag(0), g_cov_term(0, 1), g_cov_term(0, 2),
                         g_cov_diag(1), g_cov_term(1, 2), g_cov_diag(2)};

  // T0j = fx rz W0j - fx tx rz^2 W2j, T1j = fy rz W1j - fy ty rz^2 W2j
  const float* W = v.w;
  const float g_fxr = gT[0] * W[0] + gT[1] * W[1] + gT[2] * W[2];
  const float g_fyr = gT[3] * W[4] + gT[4] * W[5] + gT[5] * W[6];
  const float g_gx = -(gT[0] * W[8] + gT[1] * W[9] + gT[2] * W[10]);
  const float g_gy = -(gT[3] * W[8] + gT[4] * W[9] + gT[5] * W[10]);
  const float tz = g.t[2];
  float g_rz = v.fx * g_fxr + v.fy * g_fyr;
  const float g_tx = g_gx * v.fx * g.rz2;
  const float g_ty = g_gy * v.fy * g.rz2;
  g_rz += 2.0f * g.rz * (g_gx * v.fx * g.tx + g_gy * v.fy * g.ty);
  float g_tz = g_tx * g.clx + g_ty * g.cly + g_depth;
  // tx = tz clamp(t0 rz, +-lim_x): torch.maximum, then torch.minimum
  const float g_ux = g_tx * tz * max_share(g.ux, -v.lim_x) *
                     min_share(tmax(g.ux, -v.lim_x), v.lim_x);
  const float g_uy = g_ty * tz * max_share(g.uy, -v.lim_y) *
                     min_share(tmax(g.uy, -v.lim_y), v.lim_y);
  float g_t[3] = {g_ux * g.rz, g_uy * g.rz, 0.0f};
  g_rz += g_ux * g.t[0] + g_uy * g.t[1];
  if (!g.tz_small) g_tz += -g_rz * (g.rz * g.rz);
  g_t[2] = g_tz;

  // t = W m + p, and the pixel centre through fullmat
  const float* F = v.f;
  const float g_ph0 = gu * g.rw * v.half_w;
  const float g_ph1 = gv * g.rw * v.half_h;
  const float g_rw = gu * (v.half_w * g.ph0) + gv * (v.half_h * g.ph1);
  const float g_pw = -g_rw * (g.rw * g.rw);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    gm[j] = W[j] * g_t[0] + W[4 + j] * g_t[1] + W[8 + j] * g_t[2] +
            F[j] * g_ph0 + F[4 + j] * g_ph1 + F[12 + j] * g_pw;
  }
  if constexpr (kViewGrad) {
    // t_r = W_r . m + W_r3; T0j = fx rz W0j - gx W2j, T1j = fy rz W1j - gy
    // W2j; ph_r = F_r . m + F_r3 (rows 0, 1 and 3)
    const float m[3] = {__ldg(a.means + 3 * i), __ldg(a.means + 3 * i + 1),
                        __ldg(a.means + 3 * i + 2)};
    const float fxr = v.fx * g.rz, fyr = v.fy * g.rz;
    const float gx = v.fx * g.tx * g.rz2, gy = v.fy * g.ty * g.rz2;
    const float g_ph[3] = {g_ph0, g_ph1, g_pw};
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        gview[4 * r + j] = g_t[r] * m[j];
        gview[12 + 4 * r + j] = g_ph[r] * m[j];
      }
      gview[4 * r + 3] = g_t[r];
      gview[12 + 4 * r + 3] = g_ph[r];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      gview[j] += gT[j] * fxr;
      gview[4 + j] += gT[3 + j] * fyr;
      gview[8 + j] -= gT[j] * gx + gT[3 + j] * gy;
    }
  }

  // cov = M M', M_ij = R_ij s_j
  float m[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) m[k] = g.r[k] * g.s[k % 3];
  float g_r[9];
  float g_s[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float g_m0 = 2.0f * gcov[0] * m[j] + gcov[1] * m[3 + j] + gcov[2] * m[6 + j];
    const float g_m1 = gcov[1] * m[j] + 2.0f * gcov[3] * m[3 + j] + gcov[4] * m[6 + j];
    const float g_m2 = gcov[2] * m[j] + gcov[4] * m[3 + j] + 2.0f * gcov[5] * m[6 + j];
    g_r[j] = g_m0 * g.s[j];
    g_r[3 + j] = g_m1 * g.s[j];
    g_r[6 + j] = g_m2 * g.s[j];
    g_s[j] = g_m0 * g.r[j] + g_m1 * g.r[3 + j] + g_m2 * g.r[6 + j];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) gs[j] = g_s[j] * g.s[j];  // exp

  // R(q) for the normalized wxyz quaternion
  const float w = g.q[0], x = g.q[1], y = g.q[2], z = g.q[3];
  const float g_q[4] = {
      2.0f * (-z * g_r[1] + y * g_r[2] + z * g_r[3] - x * g_r[5] -
              y * g_r[6] + x * g_r[7]),
      2.0f * (y * g_r[1] + z * g_r[2] + y * g_r[3] - 2.0f * x * g_r[4] -
              w * g_r[5] + z * g_r[6] + w * g_r[7] - 2.0f * x * g_r[8]),
      2.0f * (-2.0f * y * g_r[0] + x * g_r[1] + w * g_r[2] + x * g_r[3] +
              z * g_r[5] - w * g_r[6] + z * g_r[7] - 2.0f * y * g_r[8]),
      2.0f * (-2.0f * z * g_r[0] - w * g_r[1] + x * g_r[2] + w * g_r[3] -
              2.0f * z * g_r[4] + y * g_r[5] + x * g_r[6] + y * g_r[7])};
  // q = raw / max(|raw|, 1e-12)
  float raw[4];
  float g_qd = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    raw[k] = __ldg(a.quats + 4 * i + k);
    g_qd -= g_q[k] * raw[k] / (g.qd * g.qd);
  }
  const float g_qn = g_qd * max_share(g.qn, 1e-12f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    gq[k] = g_q[k] / g.qd + (g.qn == 0.0f ? 0.0f : g_qn * raw[k] / g.qn);
  }
}

template <int kBases, bool kViewGrad>
__global__ void __launch_bounds__(kThreads) project_bwd_kernel(
    Args a, Cotangents gin, Grads gout, float* view_partials) {
  extern __shared__ float4 s_rest4[];
  float* s_rest = reinterpret_cast<float*>(s_rest4);
  const int i0 = blockIdx.x * kThreads;
  const int lanes = min(kThreads, a.n - i0);
  const int row = a.rest_rows * 3;
  const int i = i0 + threadIdx.x;
  const bool live = i < a.n;
  if constexpr (kBases > 1) {
    stage_in(a.features_rest + static_cast<size_t>(i0) * row, s_rest,
             lanes * row);
    __syncthreads();
  }
  const View v = load_view(a);

  // the colour: max(sum_k B_k coeff_k + 0.5, 0), or sigmoid(features_dc)
  float g_rgb[3] = {0.0f, 0.0f, 0.0f};
  float bases[kBases];
  if (live) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) g_rgb[ch] = load_or_zero(gin.colors, 4 * i + ch);
    if (a.sigmoid_colors) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float y = sigmoid(__ldg(a.features_dc + 3 * i + ch));
        gout.features_dc[3 * i + ch] = g_rgb[ch] * (1.0f - y) * y;
      }
    } else {
      view_bases<kBases>(v, a, i, bases);
      const float* rest = s_rest + threadIdx.x * row;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float pre = sh_channel<kBases>(
            bases, __ldg(a.features_dc + 3 * i + ch), rest, ch);
        g_rgb[ch] = g_rgb[ch] * max_share(pre, 0.0f);
        gout.features_dc[3 * i + ch] = bases[0] * g_rgb[ch];
      }
    }
  }
  if constexpr (kBases > 1) {
    // each thread overwrites only its own staged rows, after reading them
    if (live) {
      float* rest = s_rest + threadIdx.x * row;
#pragma unroll
      for (int k = 1; k < kBases; ++k) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) rest[3 * (k - 1) + ch] = bases[k] * g_rgb[ch];
      }
      for (int f = 3 * (kBases - 1); f < row; ++f) rest[f] = 0.0f;
    }
    __syncthreads();
    stage_out(s_rest, gout.features_rest + static_cast<size_t>(i0) * row,
              lanes * row);
  }
  float gview[kViewGrad ? kViewTerms : 1];
#pragma unroll
  for (int k = 0; k < (kViewGrad ? kViewTerms : 1); ++k) gview[k] = 0.0f;
  if (live) lane_backward<kViewGrad>(v, a, gin, gout, i, gview);
  if constexpr (kViewGrad) {
    // the CTA's sum of each term: within each warp, then the warps in order
    __shared__ float s_view[kThreads / 32][kViewTerms];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < kViewTerms; ++k) {
      float x = gview[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        x += __shfl_xor_sync(0xffffffffu, x, off);
      }
      if (lane == 0) s_view[warp][k] = x;
    }
    __syncthreads();
    if (threadIdx.x < kViewTerms) {
      float acc = s_view[0][threadIdx.x];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) acc += s_view[w][threadIdx.x];
      view_partials[static_cast<size_t>(threadIdx.x) * gridDim.x +
                    blockIdx.x] = acc;
    }
  }
}

// The view's gradient: term blockIdx.x's partials, one a CTA of the
// backward, summed in a fixed order into its place of the (35,) view.
__global__ void __launch_bounds__(kReduceThreads) view_grad_sum_kernel(
    const float* __restrict__ partials, int ctas, float* __restrict__ d_view) {
  __shared__ float s_sum[kReduceThreads];
  const float* row = partials + static_cast<size_t>(blockIdx.x) * ctas;
  float acc = 0.0f;
  for (int k = threadIdx.x; k < ctas; k += kReduceThreads) acc += row[k];
  s_sum[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) s_sum[threadIdx.x] += s_sum[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) d_view[view_index(blockIdx.x)] = s_sum[0];
}

template <int kBases>
cudaError_t launch(const Args& a, const Cotangents& gin, const Grads& gout,
                   float* d_view, float* partials, cudaStream_t stream) {
  const int blocks = (a.n + kThreads - 1) / kThreads;
  const size_t smem =
      kBases > 1 ? sizeof(float) * kThreads * a.rest_rows * 3 : 0;
  if (d_view == nullptr) {
    project_bwd_kernel<kBases, false><<<blocks, kThreads, smem, stream>>>(
        a, gin, gout, nullptr);
    return cudaGetLastError();
  }
  project_bwd_kernel<kBases, true><<<blocks, kThreads, smem, stream>>>(
      a, gin, gout, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  view_grad_sum_kernel<<<kViewTerms, kReduceThreads, 0, stream>>>(
      partials, blocks, d_view);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gstk_project_bwd(
    int n, int rest_rows, int sh_degree, int sigmoid_colors, int antialiased,
    int width, int height, int block, const void* means, const void* scales,
    const void* quats, const void* features_dc, const void* features_rest,
    const void* opacities, const void* alive, const void* view,
    const void* g_xys, const void* g_depths, const void* g_conics,
    const void* g_colors, const void* g_opacities, void* d_means,
    void* d_scales, void* d_quats, void* d_features_dc, void* d_features_rest,
    void* d_opacities, void* d_view, void* view_partials,
    long long partial_floats, void* stream) {
  // d_view (35 floats, its unread entries left as they are) may be null:
  // no view gradient; else view_partials holds kViewTerms floats a CTA
  const int bases = (sh_degree + 1) * (sh_degree + 1);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const long long ctas = (n + kThreads - 1) / kThreads;
  if (sh_degree < 0 || sh_degree > 4 || rest_rows > kMaxRestRows ||
      bases - 1 > rest_rows || block <= 0 ||
      (sigmoid_colors && sh_degree != 0) ||
      (d_view != nullptr &&
       (view_partials == nullptr || partial_floats < kViewTerms * ctas))) {
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
  const Cotangents gin{static_cast<const float*>(g_xys),
                       static_cast<const float*>(g_depths),
                       static_cast<const float*>(g_conics),
                       static_cast<const float*>(g_colors),
                       static_cast<const float*>(g_opacities)};
  const Grads gout{static_cast<float*>(d_means), static_cast<float*>(d_scales),
                   static_cast<float*>(d_quats),
                   static_cast<float*>(d_opacities),
                   static_cast<float*>(d_features_dc),
                   static_cast<float*>(d_features_rest)};
  float* dv = static_cast<float*>(d_view);
  float* vp = static_cast<float*>(view_partials);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (sh_degree) {
    case 0: err = launch<1>(a, gin, gout, dv, vp, s); break;
    case 1: err = launch<4>(a, gin, gout, dv, vp, s); break;
    case 2: err = launch<9>(a, gin, gout, dv, vp, s); break;
    case 3: err = launch<16>(a, gin, gout, dv, vp, s); break;
    default: err = launch<25>(a, gin, gout, dv, vp, s); break;
  }
  return static_cast<int>(err);
}
