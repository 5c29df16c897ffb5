// Shared by csrc/raster_fwd.cu and csrc/raster_bwd.cu: the tile layout, the
// staging of attribute rows with cp.async, and the per-entry cull.
//
// Layout. A 16x16 tile is one block of 256 / kP threads. Each thread owns kP
// pixels of one column (they share dx and ca*dx*dx); a warp owns an 8-pixel
// wide, 4*kP-pixel tall footprint, the warps side by side: with kP = 2, four
// warps of 8x8 pixels.
//
// Cull. When an entry is staged, the thread that staged it computes, from the
// conic and opacity in its row, which warps' footprints the entry can reach
// with alpha >= 1/255, and the power below which a pair is certainly faint.
// It stores both in the row's unused last two floats in shared memory (the
// global row keeps its zeros). A warp skips an entry whose bit it lacks, and
// a pixel skips expf below the power threshold. Both only ever skip pairs
// that the kernel's own _rn arithmetic would find dead: the bounds below are
// widened past every rounding of that arithmetic.
//
// Not `ProjectedGaussians.ext`: that rect is capped at 3 sigma, and a splat
// with opacity 0.99 keeps alpha >= 1/255 out to 3.33 sigma.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace raster {

constexpr int kTile = 16;
constexpr int kP = 2;                        // pixels per thread, one column
constexpr int kThreads = kTile * kTile / kP;  // per block
constexpr int kWarps = kThreads / 32;
constexpr int kLanesX = 8;                    // a warp's lanes: 8 across, 4 down
constexpr int kFootX = kLanesX;               // a warp's footprint in pixels
constexpr int kFootY = (32 / kLanesX) * kP;
constexpr int kWarpsX = kTile / kFootX;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;

static_assert(kWarps * kFootX * kFootY == kTile * kTile, "warps must tile the tile");
static_assert(kWarps <= 32, "one bit per warp");

// Margins of the cull (see cull_entry):
//  - kExpSlack: expf is within 2 ulp and the product op*expf rounds once, so
//    a pair with alpha >= 1/255 has power >= ln(kAlphaMin/op) - 3.1e-7;
//  - kFaintMargin: the threshold for skipping expf sits 1e-5 below
//    ln(kAlphaMin/op), far past those 3.1e-7, and is rounded down to float;
//  - kKappa: power, computed from the rounded dx, dy with six _rn products
//    and two _rn sums, is within 3u q+ of the exact -q/2 (u = 2^-24, q+ =
//    ca dx^2 + cc dy^2 + 2|cb dx dy|, first order); 3e-7 is 5u;
//  - kPixSlack: the double-precision box, in pixels.
constexpr double kExpSlack = 1e-6;
constexpr double kFaintMargin = 1e-5;
constexpr double kKappa = 3e-7;
constexpr double kPixSlack = 1e-3;

// The first pixel row (tile-local) and column of thread `t`'s pixels.
__device__ __forceinline__ int local_x(int t) {
  return ((t >> 5) % kWarpsX) * kFootX + (t & 31) % kLanesX;
}
__device__ __forceinline__ int local_y0(int t) {
  return ((t >> 5) / kWarpsX) * kFootY + ((t & 31) / kLanesX) * kP;
}

// Copy attribute row g (3 float4) into shared memory without waiting.
__device__ __forceinline__ void stage_row(float4* sa, float4* sb, float4* sc,
                                          const float4* __restrict__ attrs, int g) {
  const float4* src = attrs + 3 * static_cast<int64_t>(g);
  __pipeline_memcpy_async(sa, src + 0, sizeof(float4));
  __pipeline_memcpy_async(sb, src + 1, sizeof(float4));
  __pipeline_memcpy_async(sc, src + 2, sizeof(float4));
}

// Cull data of one entry, from its row a = (mean x, mean y, conic a, conic
// b), b = (conic c, opacity, ...), for the tile at pixel (x0, y0). Returns
// the faint threshold (power < it => alpha < 1/255) and sets `mask` to the
// warps whose footprints hold a pixel that may be live.
//
// Live means power_hat <= 0 and fl(op * expf(power_hat)) >= kAlphaMin, which
// needs -power_hat <= L' = ln(op / kAlphaMin) + kExpSlack. With |power_hat +
// q/2| <= kKappa q+ and q+ <= (ca + |cb|) dx^2 + (cc + |cb|) dy^2, a live
// pixel satisfies d^T C' d <= 2 L' with C' = C - 2 kKappa diag(ca + |cb|,
// cc + |cb|). Where C' is positive definite its ellipse's box bounds the
// live pixels: |dx| <= sqrt(2 L' C'yy / det'), |dy| <= sqrt(2 L' C'xx /
// det'). Else (det <= 0, a needle too thin for fp32, NaN) nothing is culled.
// Opacity < 1/255 is dead everywhere: alpha <= op.
__device__ __forceinline__ float cull_entry(float4 a, float4 b, int x0, int y0,
                                            uint32_t* mask) {
  const uint32_t all = (1u << kWarps) - 1u;
  const float op = b.y;
  if (op < kAlphaMin) {
    *mask = 0u;
    return INFINITY;
  }
  const double lnr = log(static_cast<double>(op) / static_cast<double>(kAlphaMin));
  const float thr = __double2float_rd(-lnr - kFaintMargin);  // NaN stays NaN
  *mask = all;
  const double ca = a.z, cb = a.w, cc = b.x;
  const double s = 2.0 * kKappa;
  const double axx = ca - s * (ca + fabs(cb));
  const double ayy = cc - s * (cc + fabs(cb));
  const double det = axx * ayy - cb * cb;
  const double r2 = 2.0 * (lnr + kExpSlack);
  if (!(axx > 0.0 && det > 0.0 && r2 < 1e30 && fabsf(a.x) < 1e30f && fabsf(a.y) < 1e30f)) {
    return thr;
  }
  const double hx = sqrt(r2 * ayy / det) + kPixSlack;
  const double hy = sqrt(r2 * axx / det) + kPixSlack;
  if (!(hx < 1e7 && hy < 1e7)) return thr;
  // tile-local pixel centres inside the box
  const double xl = ceil(a.x - hx) - x0, xh = floor(a.x + hx) - x0;
  const double yl = ceil(a.y - hy) - y0, yh = floor(a.y + hy) - y0;
  uint32_t m = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int fx = (w % kWarpsX) * kFootX, fy = (w / kWarpsX) * kFootY;
    if (xl <= fx + kFootX - 1 && xh >= fx && yl <= fy + kFootY - 1 && yh >= fy) m |= 1u << w;
  }
  *mask = m;
  return thr;
}

}  // namespace raster
