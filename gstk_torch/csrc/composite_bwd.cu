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
// Design: one CTA of 128 threads per tile, each thread two vertically
// adjacent pixels of one column, so warp w holds rows 4w .. 4w + 3. Every
// keep / skip / stop decision comes from composite_common.cuh, taken in
// K1's order, and T is recomputed as K1 does (T *= 1 - alpha), so T_prev
// equals the forward's bit for bit. The walk is front to back, the order of
// the reference formula, so it needs nothing from the forward but acc and
// final_t. The range goes in batches of 64 entries:
//   - Staging: threads 0-63 copy the batch's 48-B packed records with three
//     16-B cp.async each into a double buffer, so batch i + 1 is in flight
//     while batch i is walked; the ids come one batch ahead in registers.
//   - Reduction over pixels: per entry, a thread adds its two pixels'
//     6 + CH values in registers, and a warp with a kept pixel sums them,
//     padded to 16, over its 32 lanes by recursive halving
//     (warp_transpose_sum): 16 shuffles a warp-entry, after which lanes 2i
//     store value i of the warp's partial row in one parallel store. A
//     warp with no kept pixel skips the entry (__any_sync), and a warp
//     whose pixels have all stopped skips the rest of the batch
//     (__all_sync); both leave the entry's bit clear in the warp's mask,
//     and the partial absent.
//   - After the batch, the CTA sums each (entry, value)'s present warp
//     partials in warp order and stores the batch's rows, coalesced.
// A warp of 64 pixels in 4 rows meets fewer (warp, entry) pairs with a kept
// pixel than two warps of 2 rows, so fewer butterflies run, and the two
// pixels share the record's loads, dx and the votes. The partials of a
// batch take 4 x 64 x (6 + CH) floats (10 KB at CH = 4), 15 KB of shared
// memory in all, and __launch_bounds__ asks the registers to fit 8 CTAs
// (32 warps) per SM. The pairing order of every sum is fixed, so the result
// is deterministic, and a tile owns its range, so no write races and no
// atomics are needed.
//
// Bound: operations. Per (pixel, entry) pair evaluated, the recompute takes
// about 15 operations (dx, dy, sigma's 9, exp, raw, min, 1 - alpha, T);
// per pair kept, the gradient takes 37 + 4 CH more: <g, c> (2 CH), w and
// the prefix (3), 1 / max(1 - alpha, 1e-3) (3), v_alpha (6), v_sigma (2),
// the x, y, a, b, c products (16), the opacity (1), the colors (CH) and the
// sum over pixels (6 + CH). Per intersection the kernel moves the id, a
// 48-B record and a 40-B row (at CH = 4), per pixel 4 (2 CH + 2) B of acc,
// final_t and cotangents: far fewer bytes than the 67 TFLOP/s f32 rate
// needs. The operations count no shuffles, but the card issues one warp
// shuffle per SM and clock, so shuffles can set the time: the butterfly
// keeps a reduction to 16 of them, and the 64-pixel warps cut the
// reductions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using gstk::kBlock;
using gstk::kPixels;

constexpr int kPerThread = 2;  // pixels per thread
constexpr int kThreads = kPixels / kPerThread;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBatch = 64;  // entries per staged batch and per partial sum
constexpr int kPad = 16;    // values per entry in the butterfly
constexpr int kMinBlocks = 8;  // resident CTAs per SM the registers must allow
// floor of 1 - alpha in the divisions: f32(1 - 0.999) as the reference has
// it, not 1.0f - 0.999f
constexpr float kOneMinusAlphaFloor = 0.001f;

// One step of the halving below: the lane keeps v[0, kHalf) or v[kHalf,
// 2 kHalf) by its lane bit kHalf * 2, sends the other half to the lane
// across that bit, and adds what it receives into v[0, kHalf). A template
// step, so that every index is a constant and v stays in registers.
template <int kHalf>
__device__ __forceinline__ void halve(float (&v)[kPad], int lane) {
  const bool upper = lane & (2 * kHalf);
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float send = upper ? v[j] : v[j + kHalf];
    const float keep = upper ? v[j + kHalf] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, send, 2 * kHalf);
  }
}

// The warp sum of each of the 16 values by recursive halving (8 + 4 + 2 + 1
// shuffles); a last shuffle adds the two halves of the lane pair that then
// hold the same value. Lanes 2i and 2i + 1 return the sum of v[i]. The
// pairing is fixed, so the sum is too.
__device__ __forceinline__ float warp_transpose_sum(float (&v)[kPad],
                                                    int lane) {
  static_assert(kPad == 16, "four halving steps");
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

template <int CH>
__global__ void __launch_bounds__(kThreads, kMinBlocks) composite_bwd_kernel(
    const float4* __restrict__ records,     // (N, 3) packed records
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
  static_assert(kOut <= kPad, "the butterfly sums 16 values");
  __shared__ float4 s_rec[2][kBatch * gstk::kRecordChunks];
  __shared__ float s_part[kWarps * kBatch * kOut];  // [warp][entry][value]
  __shared__ unsigned long long s_kept[kWarps];     // entries with a partial

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p >> 5;
  const int lane = p & 31;
  // warp w holds rows 4w .. 4w + 3 of the tile; a lane two pixels of one
  // column, rows 4w + 2 (lane / 16) and the row below
  static_assert(kPerThread == 2 && kWarps * 4 == kBlock, "4 rows a warp");
  const int col = lane & (kBlock - 1);
  const int row0 = 4 * warp + 2 * (lane >> 4);
  const float px = static_cast<float>((tile % tiles_x) * kBlock + col);
  float py[kPerThread];
  float g[kPerThread][CH];
  float g_dot_acc[kPerThread], gt_tf[kPerThread];
  float t[kPerThread], g_prefix[kPerThread];
  bool done[kPerThread];
#pragma unroll
  for (int s = 0; s < kPerThread; ++s) {
    py[s] = static_cast<float>((tile / tiles_x) * kBlock + row0 + s);
    const size_t pix = (size_t)tile * kPixels + (row0 + s) * kBlock + col;
    g_dot_acc[s] = 0.0f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      g[s][c] = g_acc[pix * CH + c];
      g_dot_acc[s] += g[s][c] * acc[pix * CH + c];
    }
    gt_tf[s] = g_final_t[pix] * final_t[pix];
    t[s] = 1.0f;
    g_prefix[s] = 0.0f;
    done[s] = false;
  }
  const int start = tile_bins[2 * tile];
  const int end = tile_bins[2 * tile + 1];

  const bool stager = p < kBatch;
  if (stager) {
    gstk::stage_record(s_rec[0], records,
                       gstk::batch_gid(gids, start, p, end, n), n, p);
  }
  gstk::cp_async_commit();
  int gid_next = stager ? gstk::batch_gid(gids, start + kBatch, p, end, n) : n;
  for (int b0 = start, i = 0; b0 < end; b0 += kBatch, ++i) {
    gstk::cp_async_wait<0>();
    // batch i has landed for every thread, and every thread is done with
    // batch i - 1 and its partials; batch i + 1 takes that buffer
    if (__syncthreads_count(done[0] && done[1]) == kThreads) break;
    if (stager && b0 + kBatch < end) {
      gstk::stage_record(s_rec[(i + 1) & 1], records, gid_next, n, p);
      gid_next = gstk::batch_gid(gids, b0 + 2 * kBatch, p, end, n);
    }
    gstk::cp_async_commit();
    const float* batch = reinterpret_cast<const float*>(s_rec[i & 1]);
    const int count = min(kBatch, end - b0);
    unsigned long long kept_entries = 0;  // warp-uniform
    for (int k = 0; k < count; ++k) {
      const float* r = batch + k * gstk::kRecordFloats;
      const float dx = r[gstk::kX] - px;
      // the decisions of composite_common.cuh in K1's order, inline
      bool kept[kPerThread];
      float dy[kPerThread], e[kPerThread], raw[kPerThread],
          alpha[kPerThread], t_prev[kPerThread];
#pragma unroll
      for (int s = 0; s < kPerThread; ++s) {
        kept[s] = false;
        if (done[s]) continue;
        dy[s] = r[gstk::kY] - py[s];
        const float sigma =
            gstk::sigma_of(r[gstk::kA], r[gstk::kB], r[gstk::kC], dx, dy[s]);
        if (sigma < 0.0f) continue;
        e[s] = expf(-sigma);
        raw[s] = r[gstk::kOp] * e[s];
        alpha[s] = gstk::clamped_alpha(raw[s]);
        if (alpha[s] < gstk::kAlphaCutoff) continue;
        float next_t;
        if (gstk::stops(t[s], alpha[s], next_t)) {
          done[s] = true;
        } else {
          kept[s] = true;
          t_prev[s] = t[s];
          t[s] = next_t;
        }
      }
      if (!__any_sync(kFull, kept[0] || kept[1])) {
        // the rest of the batch too, once the warp's pixels have all stopped
        if (__all_sync(kFull, done[0] && done[1])) break;
        continue;
      }
      const float a = r[gstk::kA], b = r[gstk::kB], c = r[gstk::kC];
      float v[kPad];
#pragma unroll
      for (int j = 0; j < kPad; ++j) v[j] = 0.0f;
#pragma unroll
      for (int s = 0; s < kPerThread; ++s) {
        if (!kept[s]) continue;
        float g_dot_col = 0.0f;
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) g_dot_col += g[s][ch] * r[gstk::kCol + ch];
        const float w = t_prev[s] * alpha[s];
        const float prefix_incl = g_prefix[s] + w * g_dot_col;
        // __frcp_rn is 1.0f / x, rounded to nearest as the division is
        const float inv_one_m =
            __frcp_rn(fmaxf(1.0f - alpha[s], kOneMinusAlphaFloor));
        const float v_alpha = t_prev[s] * g_dot_col -
                              (g_dot_acc[s] - prefix_incl) * inv_one_m -
                              gt_tf[s] * inv_one_m;
        if (!(raw[s] > gstk::kAlphaClamp)) {  // a clamped alpha passes none
          const float v_sigma = -alpha[s] * v_alpha;
          const float y = dy[s];
          v[0] += (a * dx + b * y) * v_sigma;
          v[1] += (c * y + b * dx) * v_sigma;
          v[2] += 0.5f * dx * dx * v_sigma;
          v[3] += dx * y * v_sigma;
          v[4] += 0.5f * y * y * v_sigma;
          v[5] += e[s] * v_alpha;
        }
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) v[6 + ch] += w * g[s][ch];
        g_prefix[s] = prefix_incl;
      }
      const float sum = warp_transpose_sum(v, lane);
      const int value = lane >> 1;
      if (!(lane & 1) && value < kOut) {
        s_part[(warp * kBatch + k) * kOut + value] = sum;
      }
      kept_entries |= 1ull << k;
    }
    if (lane == 0) s_kept[warp] = kept_entries;
    __syncthreads();
    // the batch's rows are count * kOut consecutive floats of gout
    float* rows = gout + (size_t)b0 * kOut;
    for (int f = p; f < count * kOut; f += kThreads) {
      const int entry = f / kOut;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if ((s_kept[w] >> entry) & 1) s += s_part[w * kBatch * kOut + f];
      }
      rows[f] = s;
    }
  }
  // an empty range never waited for its first batch's (zero-filled) copies:
  // none may land after the CTA has exited
  gstk::cp_async_wait<0>();
}

template <int CH>
cudaError_t launch(const void* records, int n, const void* gids,
                   const void* tile_bins, int num_tiles, int tiles_x,
                   const void* acc, const void* final_t, const void* g_acc,
                   const void* g_final_t, void* gout, cudaStream_t stream) {
  composite_bwd_kernel<CH><<<num_tiles, kThreads, 0, stream>>>(
      static_cast<const float4*>(records), n, static_cast<const int32_t*>(gids),
      static_cast<const int32_t*>(tile_bins), tiles_x,
      static_cast<const float*>(acc), static_cast<const float*>(final_t),
      static_cast<const float*>(g_acc), static_cast<const float*>(g_final_t),
      static_cast<float*>(gout));
  return cudaGetLastError();
}

}  // namespace

// Channel counts this kernel is instantiated for; the wrapper raises on
// any other.
extern "C" int gstk_composite_bwd(const void* records, int ch, int n,
                                  const void* gids, const void* tile_bins,
                                  int num_tiles, int tiles_x, const void* acc,
                                  const void* final_t, const void* g_acc,
                                  const void* g_final_t, void* gout,
                                  void* stream) {
  if (num_tiles <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ch) {
    case 3:
      return static_cast<int>(launch<3>(records, n, gids, tile_bins, num_tiles,
                                        tiles_x, acc, final_t, g_acc,
                                        g_final_t, gout, s));
    case 4:
      return static_cast<int>(launch<4>(records, n, gids, tile_bins, num_tiles,
                                        tiles_x, acc, final_t, g_acc,
                                        g_final_t, gout, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Resident CTAs of K2 per SM at `ch` channels, into *blocks.
extern "C" int gstk_composite_bwd_occupancy(int ch, int* blocks) {
  switch (ch) {
    case 3:
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, composite_bwd_kernel<3>, kThreads, 0));
    case 4:
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, composite_bwd_kernel<4>, kThreads, 0));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
