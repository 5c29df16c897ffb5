// Backward tile compositing: gradients of the packed attributes, per Gaussian
// or per tile entry, from the cotangents of the image, depth and alpha, one
// thread per pixel.
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
//   - `raster_bwd_entries` writes each entry's 10 sums to its own row of
//     d_entries [E, 10], as `_stream_bwd_kernel` writes dT [16, L_pad]. The
//     caller reorders them Gaussian-major and sums them with csrc/segsum.cu
//     (the route by sort, `_route_by_sort`, 1169-1231).
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
// Design: the forward's grid, a 256-thread block per 16x16 tile. The block
// walks its tile's range back to front, from the largest last contributor of
// its pixels, 256 entries at a time; each batch's ids and attribute rows are
// staged in shared memory. Every thread visits every entry of the batch in
// the same order (so warp collectives stay uniform) and skips the entries past
// its own last contributor. A warp whose lanes all skip an entry moves on;
// otherwise the 10 per-pixel gradient terms are summed across the warp with
// shuffles and lane 0 adds them into the batch's per-entry sums in shared
// memory. After the batch, thread j adds entry j's sums into d_attrs with one
// global atomicAdd per non-zero column, so global atomics scale with entries,
// not with pixels; atomics make the order of the sums vary from run to run.
// The per-entry epilogue is deterministic instead: lane 0 of each warp stores
// its warp's sums in a slot of its own (so a batch is 128 entries, to keep
// the 8 warps' slots in 48 KB of shared memory), and after the batch thread j
// sums the 8 slots of entry j in warp order and stores them in entry j's row
// with plain stores (an entry belongs to one tile, so no two blocks write a
// row). Two launches give bitwise-equal rows.
//
// Bound on an H100: bytes are the entry ids, the attribute rows (48 B per
// Gaussian), 28 B per pixel read (final T, last contributor, 5 cotangents)
// and 48 B per Gaussian written (40 B per entry in the per-entry epilogue);
// arithmetic is ~64 fp32 operations and one
// expf per live (pixel, entry) pair before the pixel's last contributor, and
// only the liveness test (power; then expf and alpha where power <= 0) per
// dead one. PERF.md has the measured time beside the bound.
//
// Numerics: fp32, built without --use_fast_math. `power` and `alpha` are
// recomputed with the forward kernel's _rn arithmetic in the same order, so
// the dead-entry tests decide exactly as they did in the forward.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kGrads = 10;  // mean x/y, conic a/b/c, opacity, rgb, depth
constexpr int kRow = 12;    // floats per d_attrs row (columns 10, 11 stay 0)
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// attrs row g = float4 x 3 (see raster_fwd.cu):
//   a = (mean x, mean y, conic a, conic b)
//   b = (conic c, opacity, r, g)
//   c = (b, depth, 0, 0)
// kPerEntry: write entry e's sums to d_out[e] (d_out is [E, 10]), summed
// across warps in a fixed order; otherwise add them into d_out[gauss_ids[e]]
// with atomics (d_out is [N, 12]).
template <bool kPerEntry>
__global__ void __launch_bounds__(kThreads)
raster_bwd_kernel(const int32_t* __restrict__ tile_starts,
                  const int32_t* __restrict__ gauss_ids,
                  const float4* __restrict__ attrs,
                  const float* __restrict__ bg,
                  int width, int height,
                  const float* __restrict__ T_final,   // [H, W]
                  const int32_t* __restrict__ last,    // [H, W]
                  const float* __restrict__ g_color,   // [3, H, W]
                  const float* __restrict__ g_depth,   // [H, W]
                  const float* __restrict__ g_alpha,   // [H, W]
                  float* __restrict__ d_out)           // zeroed, see kPerEntry
{
  constexpr int kBatch = kPerEntry ? kThreads / 2 : kThreads;  // entries per batch
  constexpr int kSlots = kPerEntry ? kThreads / 32 : 1;         // per-warp or shared sums
  __shared__ float4 s_a[kBatch];
  __shared__ float4 s_b[kBatch];
  __shared__ float4 s_c[kBatch];
  __shared__ int32_t s_id[kBatch];
  __shared__ float s_grad[kSlots][kGrads][kBatch];
  __shared__ int s_max_last;

  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int px = blockIdx.x * kTile + (threadIdx.x % kTile);
  const int py = blockIdx.y * kTile + (threadIdx.x / kTile);
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int start = tile_starts[tile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float T = 1.0f, tail = 0.0f;
  float gr = 0.0f, gg = 0.0f, gb = 0.0f, gd = 0.0f;
  int my_last = 0;
  if (inside) {
    const int hw = width * height;
    const int p = py * width + px;
    T = T_final[p];
    my_last = last[p];
    gr = g_color[p];
    gg = g_color[hw + p];
    gb = g_color[2 * hw + p];
    gd = g_depth[p];
    tail = T * (gr * bg[0] + gg * bg[1] + gb * bg[2] - g_alpha[p]);
  }
  if (threadIdx.x == 0) s_max_last = 0;
  __syncthreads();
  if (my_last > 0) atomicMax(&s_max_last, my_last);
  __syncthreads();
  const int count = s_max_last;  // entries [start, start + count) may get gradients

  for (int base = ((count - 1) / kBatch) * kBatch; count > 0 && base >= 0;
       base -= kBatch) {
    const int n = min(kBatch, count - base);
    __syncthreads();  // the previous batch's flush has read the shared arrays
    if (threadIdx.x < n) {
      const int g = gauss_ids[start + base + threadIdx.x];
      s_id[threadIdx.x] = g;
      s_a[threadIdx.x] = attrs[3 * g + 0];
      s_b[threadIdx.x] = attrs[3 * g + 1];
      s_c[threadIdx.x] = attrs[3 * g + 2];
    }
    if constexpr (kPerEntry) {
      for (int i = threadIdx.x; i < kSlots * kGrads * kBatch; i += kThreads) {
        (&s_grad[0][0][0])[i] = 0.0f;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kGrads; ++k) s_grad[0][k][threadIdx.x] = 0.0f;
    }
    __syncthreads();

    for (int j = n - 1; j >= 0; --j) {
      float v[kGrads];
      bool contrib = false;
      if (base + j < my_last) {
        const float4 a = s_a[j];
        const float4 b = s_b[j];
        // the forward's exact arithmetic for power and alpha
        const float dx = __fsub_rn(a.x, fx);
        const float dy = __fsub_rn(a.y, fy);
        const float qa = __fmul_rn(__fmul_rn(a.z, dx), dx);
        const float qc = __fmul_rn(__fmul_rn(b.x, dy), dy);
        const float qb = __fmul_rn(__fmul_rn(a.w, dx), dy);
        const float power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
        if (power <= 0.0f) {
          const float G = expf(power);
          const float alpha_pre = __fmul_rn(b.y, G);
          const float alpha = fminf(kAlphaMax, alpha_pre);
          if (alpha >= kAlphaMin) {
            contrib = true;
            const float4 c = s_c[j];
            const float one_m = __fsub_rn(1.0f, alpha);
            const float T_before = T / one_m;
            const float w = alpha * T_before;
            const float Gc = gr * b.z + gg * b.w + gb * c.x + gd * c.y;
            const float d_alpha = T_before * Gc - tail / one_m;
            tail = tail + w * Gc;
            T = T_before;
            const float d_power = d_alpha * alpha_pre;  // cap ignored
            v[0] = -d_power * (a.z * dx + a.w * dy);
            v[1] = -d_power * (b.x * dy + a.w * dx);
            v[2] = -0.5f * dx * dx * d_power;
            v[3] = -dx * dy * d_power;
            v[4] = -0.5f * dy * dy * d_power;
            v[5] = d_alpha * G;
            v[6] = w * gr;
            v[7] = w * gg;
            v[8] = w * gb;
            v[9] = w * gd;
          }
        }
      }
      if (!__any_sync(0xffffffffu, contrib)) continue;
#pragma unroll
      for (int k = 0; k < kGrads; ++k) {
        const float s = warp_sum(contrib ? v[k] : 0.0f);
        if (lane == 0) {
          if constexpr (kPerEntry) {
            s_grad[warp][k][j] = s;  // this warp's own slot
          } else {
            atomicAdd(&s_grad[0][k][j], s);
          }
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < n) {
      if constexpr (kPerEntry) {
        float* dst = d_out + static_cast<int64_t>(kGrads) * (start + base + threadIdx.x);
#pragma unroll
        for (int k = 0; k < kGrads; ++k) {
          float s = 0.0f;
#pragma unroll
          for (int w = 0; w < kSlots; ++w) s += s_grad[w][k][threadIdx.x];  // warp order
          dst[k] = s;
        }
      } else {
        float* dst = d_out + static_cast<int64_t>(kRow) * s_id[threadIdx.x];
#pragma unroll
        for (int k = 0; k < kGrads; ++k) {
          const float s = s_grad[0][k][threadIdx.x];
          if (s != 0.0f) atomicAdd(dst + k, s);
        }
      }
    }
  }
}

template <bool kPerEntry>
int launch(const void* tile_starts, const void* gauss_ids, const void* attrs,
           const void* bg, int width, int height, const void* T_final,
           const void* last, const void* g_color, const void* g_depth,
           const void* g_alpha, void* d_out, void* stream) {
  const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile);
  raster_bwd_kernel<kPerEntry><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tile_starts),
      static_cast<const int32_t*>(gauss_ids),
      static_cast<const float4*>(attrs), static_cast<const float*>(bg),
      width, height, static_cast<const float*>(T_final),
      static_cast<const int32_t*>(last), static_cast<const float*>(g_color),
      static_cast<const float*>(g_depth), static_cast<const float*>(g_alpha),
      static_cast<float*>(d_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). The output must be zeroed by
// the caller: `d_attrs` [N, 12] for `raster_bwd`, `d_entries` [E, 10] for
// `raster_bwd_entries`. Each launches on `stream`, never synchronises, and
// returns cudaGetLastError() (0 on success).
extern "C" int raster_bwd(const void* tile_starts, const void* gauss_ids,
                          const void* attrs, const void* bg,
                          int width, int height,
                          const void* T_final, const void* last,
                          const void* g_color, const void* g_depth,
                          const void* g_alpha, void* d_attrs, void* stream) {
  return launch<false>(tile_starts, gauss_ids, attrs, bg, width, height, T_final,
                       last, g_color, g_depth, g_alpha, d_attrs, stream);
}

extern "C" int raster_bwd_entries(const void* tile_starts, const void* gauss_ids,
                                  const void* attrs, const void* bg,
                                  int width, int height,
                                  const void* T_final, const void* last,
                                  const void* g_color, const void* g_depth,
                                  const void* g_alpha, void* d_entries, void* stream) {
  return launch<true>(tile_starts, gauss_ids, attrs, bg, width, height, T_final,
                      last, g_color, g_depth, g_alpha, d_entries, stream);
}
