// Adam for every parameter group of one optimiser state: one launch a step.
//
// Replaces no TPU kernel: gstk_tpu's Adam (gstk_tpu/train/optim.py
// ::adam_step) is elementwise jnp that XLA fuses. In PyTorch
// (train/optim.py::adam_step_plain) it is about 18 ops a group, each a pass
// over the group, and a host-to-device copy of every learning rate, which
// PyTorch follows with a stream sync. Per element this does what
// adam_step_plain does, in its f32 order: the gradient zeroed on dead lanes;
// the gradient times its group's clip scale (1 without a norm clip);
// m <- b1 m + (1 - b1) g and v <- b2 v + (1 - b2) g^2; the update
// (lr (m / c1)) / (sqrt(v / c2) + eps), zeroed on dead lanes; p <- p - update.
// The learning rates (a constant, or gstk's exponential decay) and the bias
// corrections c1 = 1 - b1^count, c2 = 1 - b2^count are computed here, at the
// start of every CTA, from the device's step and count: the host uploads
// nothing, so the launch needs no sync. The decay's t is the step times
// 1 / max_steps rounded to f32 on the host, as PyTorch's CUDA division by a
// host scalar computes it. Built with -fmad=false (_build.py): no multiply
// and add is fused into an fma, as none is across PyTorch's separate ops.
//
// Bound: bytes. An element reads p, g, m and v and its lane's mask byte and
// writes p, m and v: 28 B. A lane has 59 floats at SH degree 3, so 2^21
// lanes move 3.46 GB, 1.03 ms at 3.35 TB/s.
// Design: the groups' elements are one range of 4-element units, which a
// grid-stride loop walks a thread a unit; a group whose four pointers are
// 16-B aligned moves its whole units with 16-B loads and stores, any other
// unit element by element. A unit reads the mask bytes of the one or two
// lanes it covers (the lane is the element over the group's row width).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxGroups = 8;
constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;
constexpr int kUnit = 4;  // elements a thread takes at once (one float4)
constexpr int kMaxDevices = 64;  // devices whose SM count is kept

struct Group {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long unit0;  // the group's first unit in the launch's range
  int numel;
  int width;  // elements a lane (a row of the update mask)
  int vec;    // p, g, m and v 16-B aligned
  int decays;  // exponential decay, else a constant rate
  float lr;  // the constant rate, or the decay's first
  float lr_final;
  float inv_steps;  // 1 / max(max_steps, 1) in f32
};

struct Table {
  Group groups[kMaxGroups];
  int n;
  long long units;
  float b1, b2;
  float one_minus_b1, one_minus_b2;  // 1 - b1 and 1 - b2 rounded once, as
                                     // PyTorch rounds a Python float
  float eps;
};

// One element's step, in adam_step_plain's order of f32 operations.
__device__ __forceinline__ void step_element(const Table& t, float lr,
                                             float scale, float c1, float c2,
                                             bool live, float& p, float g,
                                             float& m, float& v) {
  const float gl = (live ? g : 0.0f) * scale;
  m = t.b1 * m + t.one_minus_b1 * gl;
  v = t.b2 * v + t.one_minus_b2 * (gl * gl);
  const float update = lr * (m / c1) / (sqrtf(v / c2) + t.eps);
  p = p - (live ? update : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
    adam_fused_kernel(const __grid_constant__ Table t,
                      const uint8_t* __restrict__ mask,
                      const float* __restrict__ clip,
                      const int32_t* __restrict__ step,
                      const int32_t* __restrict__ count_in,
                      int32_t* __restrict__ count_out) {
  __shared__ Group s_groups[kMaxGroups];
  __shared__ float s_lr[kMaxGroups];
  __shared__ float s_scale[kMaxGroups];
  __shared__ float s_c[2];
  const int32_t count = *count_in + 1;
  if (threadIdx.x == 0) {
    const float count_f = static_cast<float>(count);
    s_c[0] = 1.0f - powf(t.b1, count_f);
    s_c[1] = 1.0f - powf(t.b2, count_f);
    if (blockIdx.x == 0) *count_out = count;
  }
#pragma unroll
  for (int k = 0; k < kMaxGroups; ++k) {
    if (k == threadIdx.x && k < t.n) {
      const Group gr = t.groups[k];
      float lr = gr.lr;
      if (gr.decays) {
        const float s = static_cast<float>(*step);
        const float x = fminf(fmaxf(s * gr.inv_steps, 0.0f), 1.0f);
        lr = expf(logf(gr.lr) * (1.0f - x) + logf(gr.lr_final) * x);
      }
      s_groups[k] = gr;
      s_lr[k] = lr;
      s_scale[k] = clip == nullptr ? 1.0f : clip[k];
    }
  }
  __syncthreads();
  const float c1 = s_c[0], c2 = s_c[1];

  for (long long u = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       u < t.units; u += static_cast<long long>(gridDim.x) * kThreads) {
    int k = 0;
    while (k + 1 < t.n && u >= s_groups[k + 1].unit0) ++k;
    const Group& gr = s_groups[k];
    const float lr = s_lr[k], scale = s_scale[k];
    const int e0 = static_cast<int>(u - gr.unit0) * kUnit;
    const int count_here = min(kUnit, gr.numel - e0);

    bool live[kUnit];
    if (mask == nullptr) {
#pragma unroll
      for (int j = 0; j < kUnit; ++j) live[j] = true;
    } else {
      int lane = e0 / gr.width;
      int col = e0 - lane * gr.width;
#pragma unroll
      for (int j = 0; j < kUnit; ++j) {
        live[j] = j < count_here && mask[lane] != 0;
        if (++col == gr.width) {
          col = 0;
          ++lane;
        }
      }
    }

    if (gr.vec && count_here == kUnit) {
      float4 p = reinterpret_cast<const float4*>(gr.p)[e0 / kUnit];
      const float4 g = __ldg(reinterpret_cast<const float4*>(gr.g) + e0 / kUnit);
      float4 m = reinterpret_cast<const float4*>(gr.m)[e0 / kUnit];
      float4 v = reinterpret_cast<const float4*>(gr.v)[e0 / kUnit];
      step_element(t, lr, scale, c1, c2, live[0], p.x, g.x, m.x, v.x);
      step_element(t, lr, scale, c1, c2, live[1], p.y, g.y, m.y, v.y);
      step_element(t, lr, scale, c1, c2, live[2], p.z, g.z, m.z, v.z);
      step_element(t, lr, scale, c1, c2, live[3], p.w, g.w, m.w, v.w);
      reinterpret_cast<float4*>(gr.p)[e0 / kUnit] = p;
      reinterpret_cast<float4*>(gr.m)[e0 / kUnit] = m;
      reinterpret_cast<float4*>(gr.v)[e0 / kUnit] = v;
    } else {
      for (int j = 0; j < count_here; ++j) {
        const int e = e0 + j;
        float p = gr.p[e], m = gr.m[e], v = gr.v[e];
        step_element(t, lr, scale, c1, c2, live[j], p, __ldg(gr.g + e), m, v);
        gr.p[e] = p;
        gr.m[e] = m;
        gr.v[e] = v;
      }
    }
  }
}

bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// The SM count of the current device, read once a device.
cudaError_t sm_count(int* sms) {
  static std::atomic<int> known[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && (*sms = known[device].load()) > 0) {
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device < kMaxDevices) known[device].store(*sms);
  return err;
}

}  // namespace

// Steps ``n`` groups: the arrays hold each group's pointers, element count,
// row width, whether it decays, its rate (or first rate), final rate and
// 1 / max_steps. ``mask`` (one byte a lane of every group, or null),
// ``clip`` (one scale a group, or null), ``step`` and ``count_in`` are
// device pointers read by the kernel; it writes count_in + 1 to
// ``count_out``.
extern "C" int gstk_adam_fused(
    int n, void* const* params, const void* const* grads, void* const* mus,
    void* const* nus, const long long* numels, const int* widths,
    const int* decays, const float* lrs, const float* lr_finals,
    const float* inv_steps, float b1, float b2, float one_minus_b1,
    float one_minus_b2, float eps, const void* mask, const void* clip,
    const void* step, const void* count_in, void* count_out, void* stream) {
  if (n < 1 || n > kMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
  Table t{};
  t.n = n;
  t.b1 = b1;
  t.b2 = b2;
  t.one_minus_b1 = one_minus_b1;
  t.one_minus_b2 = one_minus_b2;
  t.eps = eps;
  long long units = 0;
  for (int k = 0; k < n; ++k) {
    if (numels[k] < 0 || numels[k] > 0x7ffffff0LL || widths[k] < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    Group& gr = t.groups[k];
    gr.p = static_cast<float*>(params[k]);
    gr.g = static_cast<const float*>(grads[k]);
    gr.m = static_cast<float*>(mus[k]);
    gr.v = static_cast<float*>(nus[k]);
    gr.unit0 = units;
    gr.numel = static_cast<int>(numels[k]);
    gr.width = widths[k];
    gr.vec = aligned16(gr.p) && aligned16(gr.g) && aligned16(gr.m) &&
             aligned16(gr.v);
    gr.decays = decays[k];
    gr.lr = lrs[k];
    gr.lr_final = lr_finals[k];
    gr.inv_steps = inv_steps[k];
    units += (numels[k] + kUnit - 1) / kUnit;
  }
  t.units = units;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long wanted = (units + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * kCtasPerSm;
  const int blocks = static_cast<int>(wanted < 1 ? 1 : (wanted < most ? wanted : most));
  adam_fused_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const uint8_t*>(mask), static_cast<const float*>(clip),
      static_cast<const int32_t*>(step),
      static_cast<const int32_t*>(count_in), static_cast<int32_t*>(count_out));
  return static_cast<int>(cudaGetLastError());
}
