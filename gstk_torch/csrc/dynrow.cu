// Row moves at data-dependent destinations (probes P2 and P3).
//
// P2 replaces tools/bench_dynrow.py::pallas_local_perm, the TPU probe of row
// moves at dynamic VMEM sublane offsets. For a table of n rows of 128 f32,
// cut into blocks of R rows and each block into groups of `group` rows,
//
//     out[b R + perm[b, i] group + r] = in[b R + i group + r],  r < group.
//
// P3 replaces tools/bench_dynrow.py::hbm_dynwrite, the TPU probe of block
// writes to HBM at dynamic row offsets. Sub-block j of W rows goes to slot
// dst[j] of the table's n / W sub-block slots:
//
//     out[dst[j] W + r] = in[j W + r],  r < W.
//
// On the card both are scatters: every read is contiguous and each
// destination is a 512-B row run chosen by an index. A group or sub-block
// whose index lies outside its range is dropped (nothing written), so a bad
// index cannot write out of bounds; rows that no index reaches are left as
// they were (a permutation reaches every row).
//
// Bound: bytes. Each moves every row once: n * 512 B read and n * 512 B
// written, plus the indices (0.32 ms for n = 2^20 at 3.35 TB/s). What the
// design does about it: a row is 32 float4, one 16-B access a lane, so a
// warp reads and writes whole 512-B rows; each warp keeps kInFlight rows in
// registers between its loads and its stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowVecs = 32;  // float4 per 128-float row, one a lane
constexpr int kInFlight = 8;  // rows a warp loads before it stores
constexpr int kWarps = 8;     // warps per CTA
constexpr unsigned kThreads = kWarps * 32;

// Copies `rows` consecutive rows from `src` to `dst` (row indices), one
// float4 a lane, kInFlight rows loaded before any is stored.
__device__ __forceinline__ void copy_rows(const float4* __restrict__ in,
                                          float4* __restrict__ out,
                                          size_t src, size_t dst, int rows,
                                          int lane) {
  for (int r0 = 0; r0 < rows; r0 += kInFlight) {
    float4 v[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      if (r0 + j < rows) v[j] = in[(src + r0 + j) * kRowVecs + lane];
    }
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      if (r0 + j < rows) out[(dst + r0 + j) * kRowVecs + lane] = v[j];
    }
  }
}

// P2: warp w moves group w (group i = w mod g of block b = w / g, g the
// groups of a block) to its permuted place inside its block.
__global__ void __launch_bounds__(kThreads) local_perm_kernel(
    const float4* __restrict__ in, const int32_t* __restrict__ perm,
    int num_groups, int group, int groups_per_block,
    float4* __restrict__ out) {
  const int w = static_cast<int>((blockIdx.x * kThreads + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (w >= num_groups) return;
  const int to = perm[w];
  if (to < 0 || to >= groups_per_block) return;
  const size_t block_first = (size_t)(w - w % groups_per_block);
  copy_rows(in, out, (size_t)w * group, (block_first + to) * group, group,
            lane);
}

// P3: CTA b copies the sub-blocks of rows [b R, (b + 1) R); its warps take
// them in turn, each sub-block to its slot.
__global__ void __launch_bounds__(kThreads) dynwrite_kernel(
    const float4* __restrict__ in, const int32_t* __restrict__ dst,
    int rows_per_cta, int w_rows, int num_slots, float4* __restrict__ out) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int per = rows_per_cta / w_rows;
  for (int i = warp; i < per; i += kWarps) {
    const int j = blockIdx.x * per + i;
    const int slot = dst[j];
    if (slot < 0 || slot >= num_slots) continue;
    copy_rows(in, out, (size_t)j * w_rows, (size_t)slot * w_rows, w_rows,
              lane);
  }
}

}  // namespace

// table and out (n, 128) float32; perm (n / R, R / group) int32.
extern "C" int gstk_local_perm(const void* table, const void* perm, int n,
                               int R, int group, void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int num_groups = n / group;
  const unsigned ctas = (num_groups + kWarps - 1) / kWarps;
  local_perm_kernel<<<ctas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int32_t*>(perm),
      num_groups, group, R / group, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// table and out (n, 128) float32; dst (n / R, R / W) int32 slots.
extern "C" int gstk_dynwrite(const void* table, const void* dst, int n, int R,
                             int W, void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  dynwrite_kernel<<<n / R, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int32_t*>(dst), R,
      W, n / W, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
