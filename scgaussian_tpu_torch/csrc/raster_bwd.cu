// Backward tile compositing: gradients of the packed attributes, per Gaussian
// or per tile entry, from the cotangents of the image, depth and alpha.
//
// Replaces the TPU kernel `_stream_bwd_kernel` / `_stream_bwd_block`
// (scgaussian_tpu/renderer/tile_raster.py:685-906, launched by
// `_stream_bwd_impl`) and the entry -> Gaussian routing of
// `_stream_gather_bwd` (1234-1305). It computes what that backward computes,
// with the CUDA rasterizer's conventions:
//   - the 0.99 alpha cap is ignored: d_power = d_alpha * opacity * G, with
//     G = exp(power) uncapped (tile_raster.py:816-819);
//   - dead entries (power > 0 or alpha < 1/255) get no gradient;
//   - entries after a pixel's last contributor (the forward's 1e-4 stop) get
//     none.
// The TPU kernel's carry-free chunk replay, triangular-matmul prefix sums,
// bf16 splits, pixel-basis moments and gather + cumsum routing were TPU
// workarounds and are not carried over. The kernel has two epilogues:
//   - `raster_bwd` sums into per-Gaussian rows with atomics (the route below
//     2^20 entries of budget, where JAX gathers);
//   - `raster_bwd_entries` writes each entry's 10 sums to a row of its own
//     in d_entries [E, 10] (as `_stream_bwd_kernel` writes dT [16, L_pad]):
//     row entry_dst[e]. The route by sort (`_route_by_sort`, 1169-1231)
//     passes each entry's Gaussian-major slot, so the rows land Gaussian by
//     Gaussian and csrc/segsum.cu sums contiguous runs, with no reordered
//     copy (reading entry_dst and the scattered 40-B stores add 1-4% to
//     the kernel, most of it the reads: PERF.md).
//
// Math, per pixel, over the entries i it blended (w_i = alpha_i T_i,
// T_{i+1} = T_i (1 - alpha_i), color = sum_i w_i c_i + T_final bg,
// depth = sum_i w_i d_i, alpha_out = 1 - T_final), with G_i = g_color . c_i
// + g_depth d_i:
//   d alpha_i = T_i G_i - (sum_{j>i} w_j G_j + T_final (g_color . bg - g_alpha))
//                         / (1 - alpha_i)
// Walking the entries back to front, one running scalar `tail` carries the
// bracket, and T_i is recovered from the saved final T by dividing by
// (1 - alpha_i), as the CUDA renderCUDA backward does.
//
// What bounds it on an H100. Bytes are small (~0.03 ms); the work is the
// (pixel, entry) pairs before each pixel's last contributor: ~64 fp32
// operations per live pair, the liveness test per dead one (68% of them at
// the 1080p main view, 80% at the 4K pipeline view). The first design (one
// thread per pixel, 8 warps a tile, every warp with a live lane reducing
// all 10 terms with ten 5-level shuffle trees and 10 shared atomics, every
// lane computing power, expf and alpha for every entry) took 1.18-1.28 ms at
// 1080p (atomic) and 1.53-1.72 ms at 4K (per entry) against bounds of 0.069
// and 0.099 ms. Ablations of it on the card (PERF.md) located the time: with
// the reductions replaced by a register sum it took ~37% of that, with the
// live chain never taken ~10%. So the dead pairs were cheap; the reductions,
// then the live chain, were the cost.
//
// Design (csrc/raster_common.cuh):
//  - a 128-thread block per 16x16 tile, two pixels of one column per thread,
//    walked back to front together, each with its own T, tail and last
//    contributor; a thread sums its pixels' terms before the warp reduces,
//    so a tile-entry costs at most 4 warp reductions, not 8;
//  - a warp reduces its 10 sums with one reduce-scatter butterfly (each
//    shuffle stage halves the values a lane keeps; 16 shuffles, not 50), and
//    lanes 0, 2, ..., 18 store the 10 sums into the warp's own slots;
//  - the cull: a warp skips an entry whose 1/255 ellipse cannot reach its
//    8x8 pixels (no power, no expf, no ballot), and expf waits until some
//    lane has a pixel above the entry's faint threshold;
//  - a thread's two pixels go through alpha and the gradient chain without
//    branches (a dead pixel's terms are selected away), so the two chains
//    interleave; one correctly rounded reciprocal of 1 - alpha replaces the
//    two divisions;
//  - each warp keeps one bit per entry, written every 32 entries, saying
//    whether it wrote the entry's slots: nothing is zeroed per batch, and the
//    flush adds only the slots that were written, in warp order;
//  - the flush: thread j adds entry j's sums into its Gaussian's row with
//    three float4 atomics (atomic epilogue; compute capability 9.x) or
//    stores them into the entry's row (per-entry epilogue; an entry belongs
//    to one tile, so two launches give bitwise-equal rows);
//  - the rows of the next batch are gathered with cp.async while this batch
//    composites (double-buffered shared memory, ids read a batch ahead).
// Shared memory: 6 KB of rows and 10 KB of slots, 16 KB a block; with <= 64
// registers a thread, 8 blocks (32 warps) fit on an SM (chip_smoke.py's build
// phase prints both). Per step of the design, the times are in PERF.md.
//
// Numerics: fp32, built without --use_fast_math. `power` and `alpha` are
// recomputed with the forward kernel's _rn arithmetic in the same order, so
// the dead-entry tests decide exactly as they did in the forward. T_i and the
// tail's share are T * (1 / (1 - alpha)), within an ulp of the plain
// version's division (the kernel-vs-plain limits hold unchanged). Every sum
// (a thread's pixels in order, the butterfly, the warps in order) has a
// fixed order.

#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr int kGrads = 10;  // mean x/y, conic a/b/c, opacity, rgb, depth
constexpr int kRow = 12;    // floats per d_attrs row (columns 10, 11 stay 0)
constexpr int kSpread = 16;  // kGrads padded to the butterfly's width
constexpr unsigned kFull = 0xffffffffu;
// 64-entry batches (staged by threads 0-63) and <= 64 registers a thread, so
// that 8 blocks fit on an SM (measured against 128 entries, 6 or 7 blocks).
constexpr int kBatch = 64;
constexpr int kMinBlocks = 8;
static_assert(kBatch <= kThreads && kBatch % 32 == 0, "one entry per staging thread");

// Reduce-scatter of v[0..15] over the warp: after it, lane l holds the warp's
// sum of v[(l >> 1) & 15]. The stage that exchanges with lane l ^ 2h keeps
// the upper h of its 2h values on the lanes with that bit set and sends the
// other h to the partner lane. (A template, so every index is a constant and
// v stays in registers.)
template <int kH>
__device__ __forceinline__ void reduce_scatter_stage(float (&v)[kSpread], int lane) {
  const bool upper = lane & (2 * kH);
#pragma unroll
  for (int i = 0; i < kH; ++i) {
    const float send = upper ? v[i] : v[i + kH];
    const float keep = upper ? v[i + kH] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, 2 * kH);
  }
  if constexpr (kH > 1) reduce_scatter_stage<kH / 2>(v, lane);
}

__device__ __forceinline__ float warp_reduce_scatter(float (&v)[kSpread], int lane) {
  reduce_scatter_stage<kSpread / 2>(v, lane);  // 8 + 4 + 2 + 1 shuffles
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

// attrs row g = float4 x 3 (see raster_fwd.cu):
//   a = (mean x, mean y, conic a, conic b)
//   b = (conic c, opacity, r, g)
//   c = (b, depth, 0, 0); in shared memory c.z, c.w hold the cull data
// kPerEntry: write entry e's sums to d_out[entry_dst[e]] (d_out is [E, 10]);
// otherwise add them into d_out[gauss_ids[e]] with atomics (d_out is
// [N, 12]; entry_dst unused).
template <bool kPerEntry>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
raster_bwd_kernel(const int32_t* __restrict__ tile_starts,
                  const int32_t* __restrict__ gauss_ids,
                  const float4* __restrict__ attrs,
                  const float* __restrict__ bg,
                  int width, int height, int row_lo,  // see raster_fwd.cu
                  const float* __restrict__ T_final,   // [R, W], R the slab's rows
                  const int32_t* __restrict__ last,    // [R, W]
                  const float* __restrict__ g_color,   // [3, R, W]
                  const float* __restrict__ g_depth,   // [R, W]
                  const float* __restrict__ g_alpha,   // [R, W]
                  float* __restrict__ d_out,           // zeroed, see kPerEntry
                  const int64_t* __restrict__ entry_dst)  // [E], see kPerEntry
{
  __shared__ float4 s_a[2][kBatch];
  __shared__ float4 s_b[2][kBatch];
  __shared__ float4 s_c[2][kBatch];
  __shared__ float s_grad[kWarps][kGrads][kBatch];  // each warp's own slots
  __shared__ uint32_t s_wrote[kWarps][kBatch / 32];  // which slots were written
  __shared__ int s_warp_last[kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int x0 = blockIdx.x * kTile, y0 = (row_lo + blockIdx.y) * kTile;
  const int px = x0 + local_x(t);
  const int py0 = y0 + local_y0(t);
  const float fx = static_cast<float>(px);
  const int start = tile_starts[tile];

  float T[kP], tail[kP], gr[kP], gg[kP], gb[kP], gd[kP];
  int my_last[kP];
  int thread_last = 0;
  const int slab_y0 = row_lo * kTile;
  const int hw = width * (min((row_lo + static_cast<int>(gridDim.y)) * kTile, height) - slab_y0);
#pragma unroll
  for (int k = 0; k < kP; ++k) {
    T[k] = 1.0f;
    tail[k] = gr[k] = gg[k] = gb[k] = gd[k] = 0.0f;
    my_last[k] = 0;
    const int py = py0 + k;
    if (px < width && py < height) {
      const int p = (py - slab_y0) * width + px;
      T[k] = T_final[p];
      my_last[k] = last[p];
      gr[k] = g_color[p];
      gg[k] = g_color[hw + p];
      gb[k] = g_color[2 * hw + p];
      gd[k] = g_depth[p];
      tail[k] = T[k] * (gr[k] * bg[0] + gg[k] * bg[1] + gb[k] * bg[2] - g_alpha[p]);
      thread_last = max(thread_last, my_last[k]);
    }
  }
  int warp_last = thread_last;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    warp_last = max(warp_last, __shfl_xor_sync(kFull, warp_last, off));
  }
  if (lane == 0) s_warp_last[warp] = warp_last;
  __syncthreads();
  int count = 0;  // entries [start, start + count) may get gradients
#pragma unroll
  for (int w = 0; w < kWarps; ++w) count = max(count, s_warp_last[w]);
  if (count == 0) return;

  // the last batch in flight; the ids of the one before it in a register
  const int batches = (count + kBatch - 1) / kBatch;
  const bool stager = t < kBatch;
  int id_cur = 0, id_next = 0;
  {
    const int e = (batches - 1) * kBatch + t;
    if (stager && e < count) {
      id_cur = gauss_ids[start + e];
      const int buf = (batches - 1) & 1;
      stage_row(&s_a[buf][t], &s_b[buf][t], &s_c[buf][t], attrs, id_cur);
    }
    __pipeline_commit();
    if (stager && batches >= 2) id_next = gauss_ids[start + (batches - 2) * kBatch + t];
  }

  for (int b = batches - 1; b >= 0; --b) {
    const int buf = b & 1;
    const int base = b * kBatch;
    const int n = min(kBatch, count - base);
    // batches below the last are full; their buffer was last read by batch
    // b + 1, which every thread finished before the previous flush
    int id_after = 0;
    if (stager && b >= 1) {
      stage_row(&s_a[buf ^ 1][t], &s_b[buf ^ 1][t], &s_c[buf ^ 1][t], attrs, id_next);
      if (b >= 2) id_after = gauss_ids[start + (b - 2) * kBatch + t];
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this thread's rows of batch b have landed
    if (t < n) {
      uint32_t mask;
      const float thr = cull_entry(s_a[buf][t], s_b[buf][t], x0, y0, &mask);
      s_c[buf][t].z = thr;
      s_c[buf][t].w = __uint_as_float(mask);
    }
    __syncthreads();  // rows and cull data visible; the previous flush is done

    uint32_t wrote = 0;
    for (int j = n - 1; j >= 0; --j) {
      bool stored = false;
      const float4 c = s_c[buf][j];
      // warp-uniform: past every lane's last contributor, or culled
      if (base + j < warp_last && ((__float_as_uint(c.w) >> warp) & 1u)) {
        const float4 a = s_a[buf][j];
        const float4 bb = s_b[buf][j];
        // the forward's exact arithmetic for power and alpha, both pixels
        const float dx = __fsub_rn(a.x, fx);
        const float qa = __fmul_rn(__fmul_rn(a.z, dx), dx);
        float dy[kP], power[kP];
        bool maybe[kP];
        bool any_maybe = false;
#pragma unroll
        for (int k = 0; k < kP; ++k) {
          dy[k] = __fsub_rn(a.y, static_cast<float>(py0 + k));
          const float qc = __fmul_rn(__fmul_rn(bb.x, dy[k]), dy[k]);
          const float qb = __fmul_rn(__fmul_rn(a.w, dx), dy[k]);
          power[k] = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
          // c.z: certainly faint below
          maybe[k] = base + j < my_last[k] && power[k] <= 0.0f && !(power[k] < c.z);
          any_maybe = any_maybe || maybe[k];
        }
        if (__any_sync(kFull, any_maybe)) {
          float G[kP], alpha_pre[kP], alpha[kP];
          bool live[kP];
          bool contrib = false;
#pragma unroll
          for (int k = 0; k < kP; ++k) {
            G[k] = expf(fminf(power[k], 0.0f));  // = expf(power) where it may be live
            alpha_pre[k] = __fmul_rn(bb.y, G[k]);
            alpha[k] = fminf(kAlphaMax, alpha_pre[k]);
            live[k] = maybe[k] && alpha[k] >= kAlphaMin;
            contrib = contrib || live[k];
          }
          if (__any_sync(kFull, contrib)) {
            // Both pixels' chains without branches, so they interleave; a dead
            // pixel keeps its T and tail and adds zeros (its terms are finite:
            // G <= 1, 1 - alpha >= 0.01).
            float v[kSpread];
#pragma unroll
            for (int i = 0; i < kSpread; ++i) v[i] = 0.0f;
#pragma unroll
            for (int k = 0; k < kP; ++k) {
              const float inv = __frcp_rn(__fsub_rn(1.0f, alpha[k]));  // 1 / (1 - alpha)
              const float T_before = live[k] ? T[k] * inv : T[k];
              const float w = live[k] ? alpha[k] * T_before : 0.0f;
              const float Gc = gr[k] * bb.z + gg[k] * bb.w + gb[k] * c.x + gd[k] * c.y;
              const float d_alpha = live[k] ? T_before * Gc - tail[k] * inv : 0.0f;
              tail[k] = live[k] ? tail[k] + w * Gc : tail[k];
              T[k] = T_before;
              const float d_power = d_alpha * alpha_pre[k];  // cap ignored
              v[0] += -d_power * (a.z * dx + a.w * dy[k]);
              v[1] += -d_power * (bb.x * dy[k] + a.w * dx);
              v[2] += -0.5f * dx * dx * d_power;
              v[3] += -dx * dy[k] * d_power;
              v[4] += -0.5f * dy[k] * dy[k] * d_power;
              v[5] += d_alpha * G[k];
              v[6] += w * gr[k];
              v[7] += w * gg[k];
              v[8] += w * gb[k];
              v[9] += w * gd[k];
            }
            const float s = warp_reduce_scatter(v, lane);
            if (!(lane & 1) && lane < 2 * kGrads) s_grad[warp][lane >> 1][j] = s;
            stored = true;
          }
        }
      }
      wrote |= static_cast<uint32_t>(stored) << (j & 31);
      if ((j & 31) == 0) {
        if (lane == 0) s_wrote[warp][j >> 5] = wrote;
        wrote = 0;
      }
    }
    __syncthreads();  // every warp's slots and bits of this batch are in

    if (t < n) {
      float s[kGrads];
#pragma unroll
      for (int k = 0; k < kGrads; ++k) s[k] = 0.0f;
      bool any = false;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {  // warp order
        if ((s_wrote[w][t >> 5] >> (t & 31)) & 1u) {
          any = true;
#pragma unroll
          for (int k = 0; k < kGrads; ++k) s[k] += s_grad[w][k][t];
        }
      }
      if (any) {
        if constexpr (kPerEntry) {
          float2* dst = reinterpret_cast<float2*>(
              d_out + static_cast<int64_t>(kGrads) * entry_dst[start + base + t]);
#pragma unroll
          for (int k = 0; k < kGrads / 2; ++k) dst[k] = make_float2(s[2 * k], s[2 * k + 1]);
        } else {
          float4* dst = reinterpret_cast<float4*>(d_out + static_cast<int64_t>(kRow) * id_cur);
          atomicAdd(dst + 0, make_float4(s[0], s[1], s[2], s[3]));
          atomicAdd(dst + 1, make_float4(s[4], s[5], s[6], s[7]));
          atomicAdd(dst + 2, make_float4(s[8], s[9], 0.0f, 0.0f));
        }
      }
    }
    id_cur = id_next;
    id_next = id_after;
  }
}

template <bool kPerEntry>
int launch(const void* tile_starts, const void* gauss_ids, const void* attrs,
           const void* bg, int width, int height, int row_lo, int ny_rows,
           const void* T_final, const void* last, const void* g_color,
           const void* g_depth, const void* g_alpha, void* d_out,
           const void* entry_dst, void* stream) {
  const dim3 grid((width + kTile - 1) / kTile, ny_rows);
  raster_bwd_kernel<kPerEntry><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tile_starts),
      static_cast<const int32_t*>(gauss_ids),
      static_cast<const float4*>(attrs), static_cast<const float*>(bg),
      width, height, row_lo, static_cast<const float*>(T_final),
      static_cast<const int32_t*>(last), static_cast<const float*>(g_color),
      static_cast<const float*>(g_depth), static_cast<const float*>(g_alpha),
      static_cast<float*>(d_out), static_cast<const int64_t*>(entry_dst));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each takes the tile rows
// [row_lo, row_lo + ny_rows) of its bins and the slab's per-pixel inputs, as
// raster_fwd does. The output must be zeroed by the caller: `d_attrs` [N, 12] (16-B aligned rows) for `raster_bwd`,
// `d_entries` [E, 10] for `raster_bwd_entries`, whose `entry_dst` [E] int64
// (a permutation of the rows) says where entry e's row goes. Each launches
// on `stream`, never synchronises, and returns cudaGetLastError() (0 on
// success).
extern "C" int raster_bwd(const void* tile_starts, const void* gauss_ids,
                          const void* attrs, const void* bg,
                          int width, int height, int row_lo, int ny_rows,
                          const void* T_final, const void* last,
                          const void* g_color, const void* g_depth,
                          const void* g_alpha, void* d_attrs, void* stream) {
  return launch<false>(tile_starts, gauss_ids, attrs, bg, width, height, row_lo, ny_rows,
                       T_final, last, g_color, g_depth, g_alpha, d_attrs, nullptr, stream);
}

extern "C" int raster_bwd_entries(const void* tile_starts, const void* gauss_ids,
                                  const void* attrs, const void* bg,
                                  int width, int height, int row_lo, int ny_rows,
                                  const void* T_final, const void* last,
                                  const void* g_color, const void* g_depth,
                                  const void* g_alpha, void* d_entries,
                                  const void* entry_dst, void* stream) {
  return launch<true>(tile_starts, gauss_ids, attrs, bg, width, height, row_lo, ny_rows,
                      T_final, last, g_color, g_depth, g_alpha, d_entries, entry_dst, stream);
}

// Resident blocks per SM of either epilogue's kernel, stored in `blocks`;
// returns the CUDA error code.
extern "C" int raster_bwd_occupancy(int per_entry, int* blocks) {
  const cudaError_t err =
      per_entry ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      blocks, raster_bwd_kernel<true>, kThreads, 0)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      blocks, raster_bwd_kernel<false>, kThreads, 0);
  return static_cast<int>(err);
}
