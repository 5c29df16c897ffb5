// Segment sum by runs: out[g, :] = the sum of rows [starts[g], starts[g + 1])
// of vals, for every g in [0, n), in row order; 0 where the run is empty.
// Columns c..ldo-1 of out are written as 0.
//
// Replaces the TPU kernel `_segsum_kernel`, launched by `_segsum_sorted_mxu`
// (scgaussian_tpu/renderer/tile_raster.py:1046-1166) from `_route_by_sort`
// (1169-1231): the backward's route by sort, which the JAX package takes at
// an entry budget of 2^20 and more. Callers (renderer/raster.py):
//   - the route (`route_by_sort`, the main path): vals are the per-entry
//     gradients [E, 10] that csrc/raster_bwd.cu (`raster_bwd_entries` with
//     `entry_dst`) stored at their entries' Gaussian-major slots, starts the
//     binning's exclusive scan of tiles per Gaussian (`TileBins.gmaj_starts`);
//     out is [n, 12], the attribute rows' width, columns 10-11 zero;
//   - the keys form (`segsum`: keys [E] int32 non-decreasing, vals [E, C],
//     1 <= C <= 16): the wrapper finds the runs with one searchsorted. Rows
//     whose key is n or more lie after starts[n] and are never read, so NaN
//     there cannot leak into a sum.
// The route's other design, in which the backward keeps its rows in the
// tiles' order and this kernel gathers each Gaussian-major slot's row through
// the inverse permutation, lost the A/B (tools/torch_kernel_ab.py
// `abl:seg_gather`, PERF.md): a gathered 40-B row costs two 32-B sectors and
// one more dependent load, more than the backward's scattered stores cost.
//
// What bounds it on an H100: bytes. The route reads each entry row once
// (E * 40 B) and the run starts ((n + 1) * 4 B), and writes the sums once
// (n * 40 B of payload): ~80 MB, ~0.024 ms at 3.35 TB/s at the 4K pipeline
// view (1.42M entries, 515,536 Gaussians); the E * 10 additions are
// nothing beside it. The first design took 0.087-0.106 ms for the
// keys form alone, after a 0.14-0.15 ms `index_copy_` had written the
// Gaussian-major copy: every lane binary-searched the 5.7 MB key array for
// its run (~21 dependent loads, 17-27% of its time), then walked its own run
// row by row with scalar loads (neighbouring lanes a run, ~110 B, apart)
// and stored its 40-B row with scalar stores.
//
// Design. A warp owns 32 consecutive keys; their runs are one contiguous
// range of rows [S0, S1), which it walks in pieces of up to kPieceRows rows:
//  1. the piece's rows are copied into shared memory with cp.async, lanes on
//     consecutive 8-B words of the piece (4-B words for other widths than
//     10): 256 contiguous bytes per copy instruction, up to 20 copies in
//     flight per lane, no registers held;
//  2. each lane adds the rows of its own key's run that fall in the piece,
//     in row order, into registers;
//  3. the 32 output rows are staged in shared memory and stored as 16-B
//     words, neighbouring lanes on neighbouring words.
// No search (a run's bounds are two coalesced loads of starts), no atomics,
// and one fixed order of the sums for each key: two launches on the same
// input give bitwise-equal rows, and each row is the sequential sum
// 0 + r0 + r1 + ... that a single-threaded `index_add_` gives. A long run is
// loaded once, piece by piece, by its warp and summed by its lane; the warp
// waits for it (at most kPieceRows rows a piece; the 4K view's longest run
// is 323 entries).
//
// Numerics: fp32, built without --use_fast_math.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kKeysPerWarp = 32;
constexpr int kPieceFloats = 1280;  // a warp's row buffer: 5 KB
constexpr int kPieceRows = 128;     // rows a piece holds at most (128 rows of 10)
constexpr int kMaxCols = 16;
constexpr int kRouteCols = 10;  // the route's width: copied as 8-B words
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPieceFloats >= kKeysPerWarp * kMaxCols, "the output rows are staged in the piece");
static_assert(kPieceFloats % 4 == 0, "16-B aligned staging");

// kC = kRouteCols: 10 columns, copied as float2; kC = 0: c columns (1..16),
// copied as floats.
template <int kC>
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const int32_t* __restrict__ starts,  // [n + 1], non-decreasing
              const float* __restrict__ vals,      // [rows, c]
              int n, int c_arg, int ldo, float* __restrict__ out) {  // out [n, ldo]
  __shared__ __align__(16) float s_rows[kWarps][kPieceFloats];
  const int c = kC ? kC : c_arg;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g0 = (blockIdx.x * kWarps + warp) * kKeysPerWarp;
  if (g0 >= n) return;  // the whole warp leaves together
  const int keys = min(kKeysPerWarp, n - g0);
  float* buf = s_rows[warp];

  // this lane's run [lo, hi); the warp's rows [S0, S1)
  int lo = 0, hi = 0;
  if (lane < keys) {
    lo = starts[g0 + lane];
    hi = starts[g0 + lane + 1];
  }
  const int S0 = __shfl_sync(kFull, lo, 0);
  const int S1 = __shfl_sync(kFull, hi, keys - 1);
  if (lane >= keys) lo = hi = S1;

  float acc[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) acc[k] = 0.0f;
  const int piece_rows = min(kPieceRows, kPieceFloats / c);

  for (int p0 = S0; p0 < S1; p0 += piece_rows) {
    const int rows = min(piece_rows, S1 - p0);
    // 1. the piece's rows, lanes on consecutive words
    if constexpr (kC == kRouteCols) {
      constexpr int kPairs = kRouteCols / 2;
      for (int f = lane; f < rows * kPairs; f += 32) {
        __pipeline_memcpy_async(buf + 2 * f, vals + static_cast<int64_t>(p0) * kRouteCols + 2 * f,
                                8);
      }
    } else {
      for (int f = lane; f < rows * c; f += 32) {
        __pipeline_memcpy_async(buf + f, vals + static_cast<int64_t>(p0) * c + f, 4);
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    // 2. this lane's rows of the piece, in row order
    const int a = max(lo, p0) - p0;
    const int b = min(hi, p0 + rows) - p0;
    for (int r = a; r < b; ++r) {
      if constexpr (kC == kRouteCols) {
        const float2* row = reinterpret_cast<const float2*>(buf + r * kRouteCols);
#pragma unroll
        for (int k = 0; k < kRouteCols / 2; ++k) {
          const float2 v = row[k];
          acc[2 * k] += v.x;
          acc[2 * k + 1] += v.y;
        }
      } else {
#pragma unroll
        for (int k = 0; k < kMaxCols; ++k) {
          if (k < c) acc[k] += buf[r * c + k];
        }
      }
    }
    __syncwarp();  // every lane is done with the piece before the next lands
  }

  // 3. stage the 32 rows (zero past column c), then 16-B stores
  if (lane < keys) {
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      if (k < ldo) buf[lane * ldo + k] = k < c ? acc[k] : 0.0f;
    }
  }
  __syncwarp();
  const int total = keys * ldo;
  float* dst = out + static_cast<int64_t>(g0) * ldo;  // 128 * ldo B from out: 16-B aligned
  for (int i = lane; i < total / 4; i += 32) {
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(buf)[i];
  }
  for (int i = (total / 4) * 4 + lane; i < total; i += 32) dst[i] = buf[i];
}

}  // namespace

// Plain C entry point (loaded with ctypes). Writes every element of out
// [n, ldo] (16-B aligned). Launches on `stream`, never
// synchronises, and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue unless 1 <= c <= ldo <= 16 and n >= 0.
extern "C" int segsum(const void* starts, const void* vals, int n, int c, int ldo, void* out,
                      void* stream) {
  if (c < 1 || ldo < c || ldo > kMaxCols || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int warps = (n + kKeysPerWarp - 1) / kKeysPerWarp;
  const int blocks = (warps + kWarps - 1) / kWarps;
  const auto* s = static_cast<const int32_t*>(starts);
  const auto* v = static_cast<const float*>(vals);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (c == kRouteCols) {
    segsum_kernel<kRouteCols><<<blocks, kThreads, 0, st>>>(s, v, n, c, ldo, o);
  } else {
    segsum_kernel<0><<<blocks, kThreads, 0, st>>>(s, v, n, c, ldo, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the kernel for c columns, stored in `blocks`;
// returns the CUDA error code.
extern "C" int segsum_occupancy(int c, int* blocks) {
  return static_cast<int>(
      c == kRouteCols
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, segsum_kernel<kRouteCols>,
                                                          kThreads, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, segsum_kernel<0>, kThreads, 0));
}
