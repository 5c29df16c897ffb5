// Segment sum of key-sorted rows: out[g, :] = the sum of vals[e, :] over the
// rows e whose key is g, for every g in [0, n); 0 where no row has key g.
//
// Replaces the TPU kernel `_segsum_kernel`, launched by `_segsum_sorted_mxu`
// (scgaussian_tpu/renderer/tile_raster.py:1046-1166) from `_route_by_sort`
// (1169-1231): the backward's route by sort, which the JAX package takes at
// an entry budget of 2^20 and more. The caller hands in the per-entry
// gradients of csrc/raster_bwd.cu (`raster_bwd_entries`) in Gaussian-major
// order, with their Gaussian ids as keys.
//
// Inputs: keys [E] int32, non-decreasing; vals [E, C] float32, 1 <= C <= 16.
// Rows whose key is n or more (a sentinel suffix) are never read, so NaN
// there cannot leak into a sum.
//
// The TPU design is left behind: its one-hot MXU matmuls over bf16-exact
// splits, its packed [n_pad8, 128] output window and the partial sum carried
// from one sequential grid step to the next through the aliased output. On
// Hopper blocks run in no order, so nothing rides from one block to the next:
// each warp owns 32 consecutive keys outright. Lane l finds, by binary search
// on keys, where the run of key g0 + l + 1 starts, which is where the run of
// g0 + l ends; the run's start comes from lane l - 1 by a shuffle (lane 0
// searches for its own). Most runs are short (a Gaussian covers a few
// tiles), so each lane first sums its own key's run, row by row, when it has
// at most kShortRun rows; the few longer runs are then taken one at a time
// by the whole warp: the lanes stride over the run's rows keeping C partial
// sums each, a xor-butterfly of shuffles sums them, and lane k stores column
// k. No atomics and a fixed order of the sums for each key: two launches on
// the same input give bitwise-equal results.
//
// Bound on an H100: bytes, E * (4 + 4C) read and n * 4C written over
// 3.35 TB/s; the E * C additions are negligible beside them. The binary
// searches (~log2 E dependent loads per lane, the upper levels from L2) and
// the lanes' row-by-row loads of their own runs (neighbouring lanes C * 4 B
// apart per row, not coalesced) are what this simple design pays beyond it.
//
// Numerics: fp32, built without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kKeysPerWarp = 32;
constexpr int kShortRun = 32;  // rows a lane sums alone; longer runs take the warp
constexpr int kMaxCols = 16;
constexpr unsigned kFull = 0xffffffffu;

// first index in keys[0, e) whose key is >= g (e if none)
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ keys, int e, int g) {
  int lo = 0, hi = e;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (keys[mid] < g) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
segsum_kernel(const int32_t* __restrict__ keys, const float* __restrict__ vals,
              int e, int n, int c, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int g0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kKeysPerWarp;
  if (g0 >= n) return;  // the whole warp leaves together
  const int g = g0 + lane;  // this lane's key
  const int hi = lower_bound(keys, e, g + 1);
  int lo = __shfl_up_sync(kFull, hi, 1);
  if (lane == 0) lo = lower_bound(keys, e, g0);
  const bool mine = g < n;

  // short runs (absent keys included): the lane sums its own key's rows
  if (mine && hi - lo <= kShortRun) {
    float acc[kMaxCols];
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) acc[k] = 0.0f;
    for (int r = lo; r < hi; ++r) {
      const float* row = vals + static_cast<int64_t>(r) * c;
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k) {
        if (k < c) acc[k] += row[k];
      }
    }
    float* dst = out + static_cast<int64_t>(g) * c;
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      if (k < c) dst[k] = acc[k];
    }
  }

  // long runs: one at a time, the whole warp on each
  unsigned long_runs = __ballot_sync(kFull, mine && hi - lo > kShortRun);
  while (long_runs) {
    const int j = __ffs(long_runs) - 1;
    long_runs &= long_runs - 1;
    const int run_lo = __shfl_sync(kFull, lo, j);
    const int run_hi = __shfl_sync(kFull, hi, j);
    float acc[kMaxCols];
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) acc[k] = 0.0f;
    for (int r = run_lo + lane; r < run_hi; r += 32) {
      const float* row = vals + static_cast<int64_t>(r) * c;
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k) {
        if (k < c) acc[k] += row[k];
      }
    }
    float* dst = out + static_cast<int64_t>(g0 + j) * c;
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      if (k < c) {
        const float s = warp_sum(acc[k]);  // the same bits in every lane
        if (lane == k) dst[k] = s;
      }
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Writes every row of out [n, c];
// launches on `stream`, never synchronises, and returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for c outside [1, 16].
extern "C" int segsum(const void* keys, const void* vals, int e, int n, int c,
                      void* out, void* stream) {
  if (c < 1 || c > kMaxCols || e < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int warps = (n + kKeysPerWarp - 1) / kKeysPerWarp;
  const int blocks = (warps + kWarps - 1) / kWarps;
  segsum_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const float*>(vals), e, n, c,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the kernel, stored in `blocks`; returns the CUDA
// error code.
extern "C" int segsum_occupancy(int* blocks) {
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, segsum_kernel, kThreads, 0));
}
