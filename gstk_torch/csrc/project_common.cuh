// One Gaussian lane's projection and SH colour, shared by the forward
// (project_fwd.cu) and backward (project_bwd.cu) projection kernels.
//
// The arithmetic is the plain path's (models/vanilla.py::splat_inputs_plain,
// ops/projection.py, ops/sh.py, utils/math.py::normalize) operation by
// operation and in its order: each PyTorch op rounds once, so both sources
// are compiled with -fmad=false (gstk_torch/_build.py), and no product and
// sum here is contracted into one fma. The radii, tile counts and masks then
// come out of the same IEEE-rounded operations as the plain path's on the
// card, and the backward recomputes exactly the forward's mask. Two sums
// follow PyTorch's CUDA reduction over a short row (|quat|^2 and |dir|^2,
// below), as read from PyTorch 2.11 (CUDA 12.8); a PyTorch whose reduction
// adds in another order would flip a radius or a tile count here and there,
// so rerun the projection tests of tests/test_torch_gpu.py after an upgrade.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gstk_project {

constexpr int kThreads = 128;     // lanes a CTA, one a thread
constexpr int kMaxRestRows = 24;  // degree 4: 25 bases, 24 in features_rest

// Per-view constants, the wrapper's (35,) float32 tensor: viewmat rows 0-2
// ([R | t], 12), fullmat (16), fx, fy, cx, cy, the camera position (3).
struct View {
  float w[12];
  float f[16];
  float fx, fy, cx, cy;
  float pos[3];
  float lim_x, lim_y;      // 1.3 tan(fov), as project_gaussians rounds it
  float half_w, half_h;    // 0.5 * width, 0.5 * height
  float inv_block;         // 1 / block_width, as PyTorch divides by a scalar
  int tiles_x, tiles_y;
};

struct Args {
  int n, rest_rows, width, height, block;
  int sigmoid_colors, antialiased;
  const float* means;          // (N, 3)
  const float* scales;         // (N, 3) log scales
  const float* quats;          // (N, 4) wxyz, not normalized
  const float* opacities;      // (N, 1) logits
  const float* features_dc;    // (N, 3)
  const float* features_rest;  // (N, rest_rows, 3)
  const uint8_t* alive;        // (N,) bool, crop box applied
  const float* view;           // (35,)
};

__device__ __forceinline__ View load_view(const Args& a) {
  View v;
#pragma unroll
  for (int k = 0; k < 12; ++k) v.w[k] = __ldg(a.view + k);
#pragma unroll
  for (int k = 0; k < 16; ++k) v.f[k] = __ldg(a.view + 12 + k);
  v.fx = __ldg(a.view + 28);
  v.fy = __ldg(a.view + 29);
  v.cx = __ldg(a.view + 30);
  v.cy = __ldg(a.view + 31);
#pragma unroll
  for (int k = 0; k < 3; ++k) v.pos[k] = __ldg(a.view + 32 + k);
  v.half_w = 0.5f * static_cast<float>(a.width);
  v.half_h = 0.5f * static_cast<float>(a.height);
  // project_gaussians: tan_fovx = 0.5 * W / fx, which PyTorch evaluates as
  // reciprocal(fx) * (0.5 * W); then 1.3 * tan_fovx in f32
  v.lim_x = 1.3f * ((1.0f / v.fx) * v.half_w);
  v.lim_y = 1.3f * ((1.0f / v.fy) * v.half_h);
  v.inv_block = 1.0f / static_cast<float>(a.block);
  v.tiles_x = (a.width + a.block - 1) / a.block;
  v.tiles_y = (a.height + a.block - 1) / a.block;
  return v;
}

// torch.maximum / torch.minimum (NaN passes) and torch.clamp(x, min=lo)
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

// The share of the gradient that torch.maximum(x, lo) passes to x: all of
// it above, half at a tie, none below; torch.minimum(x, hi) the mirror.
__device__ __forceinline__ float max_share(float x, float lo) {
  return x > lo ? 1.0f : (x == lo ? 0.5f : 0.0f);
}
__device__ __forceinline__ float min_share(float x, float hi) {
  return x < hi ? 1.0f : (x == hi ? 0.5f : 0.0f);
}

// Everything the backward needs of one lane's projection.
struct Geometry {
  float qn, qd;        // |quat|, max(|quat|, 1e-12)
  float q[4];          // normalized wxyz
  float s[3];          // exp(scales)
  float r[9];          // rotation, row-major
  float cov[6];        // 3D covariance: c00 c01 c02 c11 c12 c22
  float t[3];          // view-space mean
  bool tz_small;       // |tz| < 1e-6 (rz = 1 / 1e-6)
  float rz, ux, uy, clx, cly, tx, ty, rz2;
  float T[6];          // J W: T00 T01 T02 T10 T11 T12
  float a0, b, c0;     // 2D covariance before the blur
  float a, c;          // after the +0.3 blur
  float det_orig, det_blur, dbs, ratio, comp;
  bool dbs_small;      // |det_blur| < 1e-12
  bool valid;          // det != 0
  float inv_det;
  float conic[3];
  float ph0, ph1, rw;  // homogeneous pixel projection
  float u, v;          // pixel centre
  float radius;
  int area;            // tile bbox area
  bool mask;           // projection mask (before alive)
};

// ops/projection.py::project_gaussians for one lane, glob_scale 1 and
// clip_thresh 0.01, with utils/math.py::normalize and exp of the raw
// parameters in front (models/vanilla.py).
__device__ __forceinline__ Geometry project_lane(const View& v, const Args& a,
                                                 int i) {
  Geometry g;
  const float mx = __ldg(a.means + 3 * i), my = __ldg(a.means + 3 * i + 1),
              mz = __ldg(a.means + 3 * i + 2);
  const float qw = __ldg(a.quats + 4 * i), qx = __ldg(a.quats + 4 * i + 1),
              qy = __ldg(a.quats + 4 * i + 2), qz = __ldg(a.quats + 4 * i + 3);
  // normalize: the norm's sum of squares as PyTorch's CUDA reduction over a
  // row of four adds it (two lanes, then one shuffle)
  g.qn = sqrtf((qw * qw + qy * qy) + (qx * qx + qz * qz));
  g.qd = tmax(g.qn, 1e-12f);
  const float w = qw / g.qd, x = qx / g.qd, y = qy / g.qd, z = qz / g.qd;
  g.q[0] = w; g.q[1] = x; g.q[2] = y; g.q[3] = z;
#pragma unroll
  for (int k = 0; k < 3; ++k) g.s[k] = expf(__ldg(a.scales + 3 * i + k));

  // _cov3d_components
  g.r[0] = 1.0f - 2.0f * (y * y + z * z);
  g.r[1] = 2.0f * (x * y - w * z);
  g.r[2] = 2.0f * (x * z + w * y);
  g.r[3] = 2.0f * (x * y + w * z);
  g.r[4] = 1.0f - 2.0f * (x * x + z * z);
  g.r[5] = 2.0f * (y * z - w * x);
  g.r[6] = 2.0f * (x * z - w * y);
  g.r[7] = 2.0f * (y * z + w * x);
  g.r[8] = 1.0f - 2.0f * (x * x + y * y);
  float m[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) m[k] = g.r[k] * g.s[k % 3];
  g.cov[0] = m[0] * m[0] + m[1] * m[1] + m[2] * m[2];
  g.cov[1] = m[0] * m[3] + m[1] * m[4] + m[2] * m[5];
  g.cov[2] = m[0] * m[6] + m[1] * m[7] + m[2] * m[8];
  g.cov[3] = m[3] * m[3] + m[4] * m[4] + m[5] * m[5];
  g.cov[4] = m[3] * m[6] + m[4] * m[7] + m[5] * m[8];
  g.cov[5] = m[6] * m[6] + m[7] * m[7] + m[8] * m[8];

  // _project_cov3d_ewa
  const float* W = v.w;  // row r: W[4 r .. 4 r + 2], translation W[4 r + 3]
  g.t[0] = W[0] * mx + W[1] * my + W[2] * mz + W[3];
  g.t[1] = W[4] * mx + W[5] * my + W[6] * mz + W[7];
  g.t[2] = W[8] * mx + W[9] * my + W[10] * mz + W[11];
  const float tz = g.t[2];
  g.tz_small = fabsf(tz) < 1e-6f;
  g.rz = 1.0f / (g.tz_small ? 1e-6f : tz);
  g.ux = g.t[0] * g.rz;
  g.uy = g.t[1] * g.rz;
  g.clx = tmin(tmax(g.ux, -v.lim_x), v.lim_x);
  g.cly = tmin(tmax(g.uy, -v.lim_y), v.lim_y);
  g.tx = tz * g.clx;
  g.ty = tz * g.cly;
  g.rz2 = g.rz * g.rz;
  const float fxr = v.fx * g.rz, fyr = v.fy * g.rz;
  const float gx = v.fx * g.tx * g.rz2, gy = v.fy * g.ty * g.rz2;
  g.T[0] = fxr * W[0] - gx * W[8];
  g.T[1] = fxr * W[1] - gx * W[9];
  g.T[2] = fxr * W[2] - gx * W[10];
  g.T[3] = fyr * W[4] - gy * W[8];
  g.T[4] = fyr * W[5] - gy * W[9];
  g.T[5] = fyr * W[6] - gy * W[10];
  const float* c3 = g.cov;
  auto quad = [c3](float u0, float u1, float u2, float v0, float v1,
                   float v2) {
    return c3[0] * u0 * v0 + c3[3] * u1 * v1 + c3[5] * u2 * v2 +
           c3[1] * (u0 * v1 + u1 * v0) + c3[2] * (u0 * v2 + u2 * v0) +
           c3[4] * (u1 * v2 + u2 * v1);
  };
  const float* T = g.T;
  g.a0 = quad(T[0], T[1], T[2], T[0], T[1], T[2]);
  g.b = quad(T[0], T[1], T[2], T[3], T[4], T[5]);
  g.c0 = quad(T[3], T[4], T[5], T[3], T[4], T[5]);
  g.det_orig = g.a0 * g.c0 - g.b * g.b;
  g.a = g.a0 + 0.3f;
  g.c = g.c0 + 0.3f;
  g.det_blur = g.a * g.c - g.b * g.b;
  g.dbs_small = fabsf(g.det_blur) < 1e-12f;
  g.dbs = g.dbs_small ? 1e-12f : g.det_blur;
  g.ratio = g.det_orig / g.dbs;
  g.comp = sqrtf(tmax(g.ratio, 0.0f));

  // _cov2d_bounds (its det is det_blur, recomputed the same way)
  g.valid = g.det_blur != 0.0f;
  g.inv_det = 1.0f / (g.valid ? g.det_blur : 1.0f);
  g.conic[0] = g.c * g.inv_det;
  g.conic[1] = -g.b * g.inv_det;
  g.conic[2] = g.a * g.inv_det;
  const float half_tr = 0.5f * (g.a + g.c);
  const float disc = sqrtf(clamp_min(half_tr * half_tr - g.det_blur, 0.1f));
  g.radius = ceilf(3.0f * sqrtf(clamp_min(half_tr + disc, 0.0f)));

  // project_pix
  const float* F = v.f;
  g.ph0 = F[0] * mx + F[1] * my + F[2] * mz + F[3];
  g.ph1 = F[4] * mx + F[5] * my + F[6] * mz + F[7];
  const float pw = F[12] * mx + F[13] * my + F[14] * mz + F[15];
  g.rw = 1.0f / (pw + 1e-6f);
  g.u = v.half_w * g.ph0 * g.rw - 0.5f + v.cx;
  g.v = v.half_h * g.ph1 * g.rw - 0.5f + v.cy;

  // tile_bbox: truncation, then int32 (saturating, as the cast on the card)
  const float tcx = g.u * v.inv_block, tcy = g.v * v.inv_block;
  const float tr = g.radius * v.inv_block;
  auto wrap_inc = [](int k) {  // int32 + 1 wraps, as PyTorch's does
    return static_cast<int>(static_cast<unsigned>(k) + 1u);
  };
  const int x0 = min(max(__float2int_rz(tcx - tr), 0), v.tiles_x);
  const int y0 = min(max(__float2int_rz(tcy - tr), 0), v.tiles_y);
  const int x1 = min(max(wrap_inc(__float2int_rz(tcx + tr)), 0), v.tiles_x);
  const int y1 = min(max(wrap_inc(__float2int_rz(tcy + tr)), 0), v.tiles_y);
  g.area = (x1 - x0) * (y1 - y0);
  g.mask = g.area > 0 && !(tz < 0.01f) && g.valid;
  return g;
}

// ops/sh.py::eval_sh_bases at a unit direction, term by term, the first
// kBases of them (the compiler drops the others).
template <int kBases>
__device__ __forceinline__ void sh_bases(float x, float y, float z,
                                         float* out) {
  const float c1 = 0.4886025119029199f;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  const float all[25] = {
      0.28209479177387814f,
      -c1 * y,
      c1 * z,
      -c1 * x,
      1.0925484305920792f * xy,
      -1.0925484305920792f * yz,
      0.31539156525252005f * (2.0f * zz - xx - yy),
      -1.0925484305920792f * xz,
      0.5462742152960396f * (xx - yy),
      -0.5900435899266435f * y * (3.0f * xx - yy),
      2.890611442640554f * xy * z,
      -0.4570457994644658f * y * (4.0f * zz - xx - yy),
      0.3731763325901154f * z * (2.0f * zz - 3.0f * xx - 3.0f * yy),
      -0.4570457994644658f * x * (4.0f * zz - xx - yy),
      1.445305721320277f * z * (xx - yy),
      -0.5900435899266435f * x * (xx - 3.0f * yy),
      2.5033429417967046f * xy * (xx - yy),
      -1.7701307697799304f * yz * (3.0f * xx - yy),
      0.9461746957575601f * xy * (7.0f * zz - 1.0f),
      -0.6690465435572892f * yz * (7.0f * zz - 3.0f),
      0.10578554691520431f * (zz * (35.0f * zz - 30.0f) + 3.0f),
      -0.6690465435572892f * xz * (7.0f * zz - 3.0f),
      0.47308734787878004f * (xx - yy) * (7.0f * zz - 1.0f),
      -1.7701307697799304f * xz * (xx - 3.0f * yy),
      0.6258357354491761f * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy)),
  };
#pragma unroll
  for (int k = 0; k < kBases; ++k) out[k] = all[k];
}

// The SH bases at the lane's view direction: normalize(mean - camera
// position), the norm's squares summed as PyTorch's reduction over a row of
// three adds them.
template <int kBases>
__device__ __forceinline__ void view_bases(const View& v, const Args& a, int i,
                                           float* out) {
  const float dx = __ldg(a.means + 3 * i) - v.pos[0];
  const float dy = __ldg(a.means + 3 * i + 1) - v.pos[1];
  const float dz = __ldg(a.means + 3 * i + 2) - v.pos[2];
  const float d = tmax(sqrtf((dx * dx + dz * dz) + dy * dy), 1e-12f);
  sh_bases<kBases>(dx / d, dy / d, dz / d, out);
}

// Before the colour's max(rgb + 0.5, 0): sum_k B_k coeff_k, channel ch;
// coeff_0 is features_dc, coeff_k features_rest row k - 1 (staged in
// shared memory, `rest` is the lane's first row).
template <int kBases>
__device__ __forceinline__ float sh_channel(const float* bases, float dc,
                                            const float* rest, int ch) {
  float acc = bases[0] * dc;
#pragma unroll
  for (int k = 1; k < kBases; ++k) acc = acc + bases[k] * rest[3 * (k - 1) + ch];
  return acc + 0.5f;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Copies `count` floats between global and shared memory with the whole
// CTA: 16-B accesses where the global address allows them, then the tail.
__device__ __forceinline__ void stage_in(const float* __restrict__ src,
                                         float* dst, int count) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int vecs = count >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int k = threadIdx.x; k < vecs; k += kThreads) d4[k] = __ldg(s4 + k);
    done = vecs << 2;
  }
  for (int k = done + threadIdx.x; k < count; k += kThreads) {
    dst[k] = __ldg(src + k);
  }
}

__device__ __forceinline__ void stage_out(const float* src,
                                          float* __restrict__ dst,
                                          int count) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int vecs = count >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int k = threadIdx.x; k < vecs; k += kThreads) d4[k] = s4[k];
    done = vecs << 2;
  }
  for (int k = done + threadIdx.x; k < count; k += kThreads) dst[k] = src[k];
}

}  // namespace gstk_project
