// Forward tile compositing of depth-sorted Gaussians.
//
// Replaces the TPU kernel `_stream_fwd_kernel` / `_stream_fwd_block`
// (scgaussian_tpu/renderer/tile_raster.py:578-683, launched by
// `_stream_fwd_impl`) and folds in its `assemble_image` (258-293). It computes
// the oracle's semantics (scgaussian_tpu/renderer/oracle.py:3-13, 84-112), the
// CUDA renderCUDA loop, not the TPU kernel's block structure: the log-space
// triangular-matmul prefix sums, bf16 splits and chunking there were TPU
// workarounds.
//
// What bounds it on an H100. Bytes are small (entry ids, 48-B attribute rows
// mostly from L2, 28 B written per pixel); the work is the (pixel, entry)
// pairs, ~15 fp32 operations and one expf each, ~81 pairs a pixel at the
// 1080p main view because the 1e-4 stop rarely fires there. Most pairs are
// faint (alpha < 1/255). The first design (one thread per pixel,
// 256-entry batches loaded between two barriers, every pixel computing power,
// expf and alpha for every entry) took 0.32-0.38 ms at 1080p and 0.66 ms at
// 4K against bounds of 0.040 and 0.087 ms. Replacing its expf by __expf
// changed its time by < 10% (PERF.md): the instruction slots went to every pair's
// whole test and its branches, not to expf alone.
//
// Design (csrc/raster_common.cuh):
//  - a 128-thread block per 16x16 tile, two pixels of one column per thread,
//    so a pixel pair shares dx and ca*dx*dx (same _rn operations, same bits);
//  - per entry, a cull computed once by the thread that staged it: a warp
//    skips an entry whose 1/255 ellipse cannot reach its 8x8 pixels (40% of
//    the warp-entries at 1080p, 58% at 4K), and a pixel goes on to expf only
//    above the power where it is certainly faint; a skipped entry still
//    advances the contributor index (it is the entry's position), so `last`
//    is unchanged;
//  - a thread's two pixels go through alpha, T and the blend without
//    branches (selects), so the two updates interleave;
//  - the rows of the next batch are gathered with cp.async while this batch
//    composites (double-buffered shared memory, ids read a batch ahead);
//  - the block leaves once __syncthreads_count says every pixel is saturated.
// Shared memory 12 KB a block; 8 blocks fit on an SM (chip_smoke.py's build
// phase prints the registers and resident blocks). The times are in PERF.md.
//
// Numerics: fp32 throughout, built without --use_fast_math so expf is the
// accurate expf and not __expf. The threshold-deciding arithmetic (power,
// 1 - alpha, T * (1 - alpha)) is written with the _rn intrinsics, which the
// compiler may not contract into FMAs, so it rounds step by step exactly as
// the plain PyTorch version does: a flip at the 1/255 or 1e-4 threshold would
// change the image. The cull only skips pairs that arithmetic finds dead.
//
// The power test follows the oracle (power > 0 skips), not the TPU kernel's
// power <= 1e-4 (tile_raster.py:296, 573).
//
// Tile-row slices (the tile-row sharding of parallel/tiles.py, as the TPU
// kernel's `_chunk_tiles_global`, tile_raster.py:980-996): the grid covers
// the `ny_rows` tile rows from `row_lo`, whose bins hold slice-local tile ids;
// each tile works at its global pixel coordinates, so its arithmetic is the
// unsharded launch's, and the outputs are the slab of image rows
// [row_lo * 16, min((row_lo + ny_rows) * 16, height)). row_lo = 0 with every
// tile row is the whole image.

#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr float kTEps = 1e-4f;
constexpr int kBatch = kThreads;  // entries staged per batch, one per thread

// attrs row g = float4 x 3:
//   a = (mean x, mean y, conic a, conic b)
//   b = (conic c, opacity, r, g)
//   c = (b, depth, 0, 0); in shared memory c.z, c.w hold the cull data
__global__ void __launch_bounds__(kThreads)
raster_fwd_kernel(const int32_t* __restrict__ tile_starts,
                  const int32_t* __restrict__ gauss_ids,
                  const float4* __restrict__ attrs,
                  const float* __restrict__ bg,
                  int width, int height, int row_lo,
                  float* __restrict__ out_color,   // [3, R, W], R the slab's rows
                  float* __restrict__ out_depth,   // [R, W]
                  float* __restrict__ out_alpha,   // [R, W]
                  float* __restrict__ out_T,       // [R, W]
                  int32_t* __restrict__ out_last)  // [R, W]
{
  __shared__ float4 s_a[2][kBatch];
  __shared__ float4 s_b[2][kBatch];
  __shared__ float4 s_c[2][kBatch];

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int x0 = blockIdx.x * kTile, y0 = (row_lo + blockIdx.y) * kTile;
  const int px = x0 + local_x(t);
  const int py0 = y0 + local_y0(t);
  const float fx = static_cast<float>(px);

  const int start = tile_starts[tile];
  const int count = tile_starts[tile + 1] - start;
  const int batches = (count + kBatch - 1) / kBatch;

  float T[kP], C0[kP], C1[kP], C2[kP], D[kP];
  int last[kP];
  bool done[kP];
  bool all_done = true;
#pragma unroll
  for (int k = 0; k < kP; ++k) {
    T[k] = 1.0f;
    C0[k] = C1[k] = C2[k] = D[k] = 0.0f;
    last[k] = 0;
    done[k] = !(px < width && py0 + k < height);
    all_done = all_done && done[k];
  }

  // batch 0 in flight; the ids of batch 1 in a register
  if (t < count) {
    stage_row(&s_a[0][t], &s_b[0][t], &s_c[0][t], attrs, gauss_ids[start + t]);
  }
  __pipeline_commit();
  int id_next = kBatch + t < count ? gauss_ids[start + kBatch + t] : 0;

  for (int b = 0; b < batches; ++b) {
    // also the barrier after which the other buffer may be overwritten
    if (__syncthreads_count(all_done) == kThreads) break;
    const int buf = b & 1;
    const int base = b * kBatch;
    const int n = min(kBatch, count - base);
    int id_after = 0;
    if (base + kBatch + t < count) {
      stage_row(&s_a[buf ^ 1][t], &s_b[buf ^ 1][t], &s_c[buf ^ 1][t], attrs, id_next);
      if (base + 2 * kBatch + t < count) id_after = gauss_ids[start + base + 2 * kBatch + t];
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this thread's rows of batch b have landed
    if (t < n) {
      uint32_t mask;
      const float thr = cull_entry(s_a[buf][t], s_b[buf][t], x0, y0, &mask);
      s_c[buf][t].z = thr;
      s_c[buf][t].w = __uint_as_float(mask);
    }
    __syncthreads();

    for (int j = 0; j < n && !all_done; ++j) {
      const float4 c = s_c[buf][j];
      if (!((__float_as_uint(c.w) >> warp) & 1u)) continue;  // culled for this warp
      const float4 a = s_a[buf][j];
      const float4 bb = s_b[buf][j];
      const float dx = __fsub_rn(a.x, fx);
      const float qa = __fmul_rn(__fmul_rn(a.z, dx), dx);
      float power[kP];
      bool maybe[kP];
      bool any_maybe = false;
#pragma unroll
      for (int k = 0; k < kP; ++k) {
        const float dy = __fsub_rn(a.y, static_cast<float>(py0 + k));
        // power = -0.5 * (ca*dx*dx + cc*dy*dy) - cb*dx*dy, rounded per step
        const float qc = __fmul_rn(__fmul_rn(bb.x, dy), dy);
        const float qb = __fmul_rn(__fmul_rn(a.w, dx), dy);
        power[k] = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
        // c.z: certainly faint below
        maybe[k] = !done[k] && !(power[k] > 0.0f) && !(power[k] < c.z);
        any_maybe = any_maybe || maybe[k];
      }
      if (!any_maybe) continue;
      // both pixels without branches, so the two updates interleave
#pragma unroll
      for (int k = 0; k < kP; ++k) {
        const float alpha = fminf(kAlphaMax, __fmul_rn(bb.y, expf(power[k])));
        const bool live = maybe[k] && alpha >= kAlphaMin;
        const float T_new = __fmul_rn(T[k], __fsub_rn(1.0f, alpha));
        const bool stop = live && T_new < kTEps;
        const bool blend = live && !stop;
        const float w = __fmul_rn(alpha, T[k]);
        done[k] = done[k] || stop;
        C0[k] = blend ? C0[k] + w * bb.z : C0[k];
        C1[k] = blend ? C1[k] + w * bb.w : C1[k];
        C2[k] = blend ? C2[k] + w * c.x : C2[k];
        D[k] = blend ? D[k] + w * c.y : D[k];
        T[k] = blend ? T_new : T[k];
        last[k] = blend ? base + j + 1 : last[k];
      }
      all_done = true;
#pragma unroll
      for (int k = 0; k < kP; ++k) all_done = all_done && done[k];
    }
    id_next = id_after;
  }
  __pipeline_wait_prior(0);  // no copy may land after the block has left

  const int slab_y0 = row_lo * kTile;
  const int hw = width * (min((row_lo + static_cast<int>(gridDim.y)) * kTile, height) - slab_y0);
#pragma unroll
  for (int k = 0; k < kP; ++k) {
    const int py = py0 + k;
    if (px < width && py < height) {
      const int p = (py - slab_y0) * width + px;
      out_color[p] = C0[k] + T[k] * bg[0];
      out_color[hw + p] = C1[k] + T[k] * bg[1];
      out_color[2 * hw + p] = C2[k] + T[k] * bg[2];
      out_depth[p] = D[k];
      out_alpha[p] = 1.0f - T[k];
      out_T[p] = T[k];
      out_last[p] = last[k];
    }
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). `raster_fwd` composites the
// tile rows [row_lo, row_lo + ny_rows) (all of them: 0 and
// ceil(height / 16)) into the slab's outputs, launches on `stream`, never
// synchronises, and returns cudaGetLastError() (0 on success). `raster_fwd_occupancy` stores the kernel's resident blocks per
// SM in `blocks` and returns the CUDA error code.
extern "C" int raster_fwd(const void* tile_starts, const void* gauss_ids,
                          const void* attrs, const void* bg,
                          int width, int height, int row_lo, int ny_rows,
                          void* out_color, void* out_depth, void* out_alpha,
                          void* out_T, void* out_last, void* stream) {
  const dim3 grid((width + kTile - 1) / kTile, ny_rows);
  raster_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tile_starts),
      static_cast<const int32_t*>(gauss_ids),
      static_cast<const float4*>(attrs), static_cast<const float*>(bg),
      width, height, row_lo, static_cast<float*>(out_color),
      static_cast<float*>(out_depth), static_cast<float*>(out_alpha),
      static_cast<float*>(out_T), static_cast<int32_t*>(out_last));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int raster_fwd_occupancy(int* blocks) {
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, raster_fwd_kernel, kThreads, 0));
}
