// Windowed SSIM and its gradient: the 11x11, sigma-1.5 Gaussian window of
// losses/image.py::ssim with zero padding, C1 = 0.01^2, C2 = 0.03^2, over
// [C, H, W] fp32 images, as one forward kernel (with a fixed-order mean) and
// one backward kernel.
//
// Replaces no TPU kernel: the JAX package's SSIM
// (scgaussian_tpu/losses/image.py:74-104) is plain XLA convolutions, and the
// port first ran it the same way, as five depthwise 11x11 `F.conv2d` calls
// and an elementwise chain, followed in the backward by three more
// convolutions and ~25 elementwise kernels. At 4032x3024 that was ~25 ms of
// the ~35-ms busy training iteration (PERF.md, section 5), the largest block
// of device time in the benchmark, and the match term's host sync waited for
// all of it. This kernel was added for that.
//
// What bounds it on an H100: bytes. Over N = C * H * W pixels the forward
// reads both images (8N B) and, only when a gradient is wanted, writes three
// coefficient maps (12N B); the backward reads the three maps and both images
// (20N B) and writes the gradient (4N B). At 4032x3024x3 that is 0.73 GB and
// 0.88 GB, 0.22 + 0.26 ms at 3.35 TB/s. The window is the outer product of
// two 1-D Gaussians, so the separable form takes 11 + 11 taps per moment:
// ~260 fp32 operations a pixel forward and ~140 backward (0.14 + 0.08 ms at
// 67 TFLOP/s).
//
// The math. With x = img1, y = img2, w the window and M = w * mask (1 without
// a mask): mu1 = w * x, mu2 = w * y, s1 = w * x^2 - mu1^2, s2 = w * y^2 -
// mu2^2, s12 = w * xy - mu1 mu2 (E[x^2] - mu^2, as the library route forms
// it), n1 = 2 mu1 mu2 + C1, n2 = 2 s12 + C2, d1 = mu1^2 + mu2^2 + C1, d2 = s1 +
// s2 + C2, S = n1 n2 / (d1 d2), and the loss is the mean of S M. Its
// gradient, with g the upstream gradient:
//   dL/dx = (g / N) [w * A1 + 2 x (w * B) + y (w * Cm)],
//   A1 = 2M [mu2 (n2 - n1) + mu1 S (d1 - d2)] / (d1 d2),
//   B = -M S / d2,  Cm = 2M n1 / (d1 d2),
// and dL/dy the mirror form with A2 = 2M [mu1 (n2 - n1) + mu2 S (d1 - d2)] /
// (d1 d2) and x, y swapped. w is symmetric, so the backward's correlation is
// a convolution; the maps are zero outside the image.
//
// Design:
//  - a 256-thread block per 32x32 tile of one channel (32x16 with a mask):
//    the tile and its 5-px halo of each input are staged in shared memory,
//    zero outside the image; a horizontal 11-tap pass writes each moment for
//    the halo's rows, then each thread runs the vertical 11 taps down 4 (2)
//    rows of one column, sliding over 14 (12) staged rows, so the moments take
//    no device memory;
//  - the forward writes A1 (if img1 needs a gradient), A2 (if img2 does) and
//    B, Cm (if either does), and nothing under no_grad; each block adds S M
//    over its pixels into one fp64 partial in a fixed order, and a second,
//    one-block kernel sums the partials in a fixed order: no atomics, so two
//    launches on the same inputs give the same bits;
//  - the backward stages the three maps of one gradient the same way, reads g
//    from its device pointer (no host read) and writes the gradient; for both
//    images' gradients it is launched twice, (A1, x, y) and (A2, y, x);
//  - the taps are kernel arguments (the wrapper's normalised fp32 Gaussian,
//    the same values as the library route's window), not a device tensor.
// Shared memory: 41 KB a forward block (33 KB with a mask), 37 KB a backward
// block (chip_smoke.py's build phase prints the registers and resident
// blocks). The times are in PERF.md.
//
// Numerics: fp32 throughout (the partial sums and the mean in fp64), FFMA,
// built without --use_fast_math, so the division is IEEE.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 5;  // window radius: 11 taps
constexpr int kTaps = 2 * kR + 1;
constexpr int kTW = 32;  // tile width: a warp across
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kHaloW = kTW + 2 * kR;
constexpr int kMeanThreads = 1024;
// as Python forms 0.01**2 and 0.03**2, then rounded to fp32 as PyTorch does
constexpr float kC1 = static_cast<float>(0.01 * 0.01);
constexpr float kC2 = static_cast<float>(0.03 * 0.03);

struct Taps {
  float w[kTaps];
};

// Tile height, staged inputs and moments of a forward block.
template <bool kMasked>
struct Fwd {
  static constexpr int kTH = kMasked ? 16 : 32;
  static constexpr int kIn = kMasked ? 3 : 2;  // x, y (, mask)
  static constexpr int kQ = kMasked ? 6 : 5;   // mu1, mu2, w*x^2, w*y^2, w*xy (, M)
  static constexpr int kRows = kTH + 2 * kR;
  static constexpr int kPer = kTH / kWarps;  // output rows per thread
};

constexpr int kBwdTH = 32;
constexpr int kBwdRows = kBwdTH + 2 * kR;
constexpr int kBwdPer = kBwdTH / kWarps;

// Rows [y0 - kR, y0 - kR + kRows) x columns [x0 - kR, x0 + kTW + kR) of one
// H x W plane into dst, 0 outside the image.
template <int kRows>
__device__ __forceinline__ void stage(float (*dst)[kHaloW], const float* __restrict__ src,
                                      int x0, int y0, int H, int W) {
  for (int i = threadIdx.x; i < kRows * kHaloW; i += kThreads) {
    const int r = i / kHaloW;
    const int c = i - r * kHaloW;
    const int gy = y0 - kR + r;
    const int gx = x0 - kR + c;
    dst[r][c] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                    ? __ldg(src + static_cast<int64_t>(gy) * W + gx)
                    : 0.0f;
  }
}

// acc[q][r] = sum over k = 0..10, in that order, of w[k] * h[q][row0 + r + k][lane]
template <int kQ, int kPer, int kRows>
__device__ __forceinline__ void vertical(const float (*h)[kRows][kTW], const Taps& t, int row0,
                                         int lane, float (&acc)[kQ][kPer]) {
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) acc[q][r] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kPer + 2 * kR; ++j) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float v = h[q][row0 + j][lane];
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int k = j - r;
        if (k >= 0 && k < kTaps) acc[q][r] = fmaf(t.w[k], v, acc[q][r]);
      }
    }
  }
}

// grid (tiles across, tiles down, C). partials[block] = the block's sum of
// S M; the maps (each null unless wanted) are [C, H, W].
template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
ssim_fwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ mask, int64_t mask_cstride, int H, int W, Taps t,
                float* __restrict__ a1, float* __restrict__ a2, float* __restrict__ bm,
                float* __restrict__ cm, double* __restrict__ partials) {
  using F = Fwd<kMasked>;
  __shared__ float s_in[F::kIn][F::kRows][kHaloW];
  __shared__ float s_h[F::kQ][F::kRows][kTW];
  __shared__ double s_warp[kWarps];
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * F::kTH;
  const int64_t base = static_cast<int64_t>(blockIdx.z) * H * W;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  stage<F::kRows>(s_in[0], x + base, x0, y0, H, W);
  stage<F::kRows>(s_in[1], y + base, x0, y0, H, W);
  if constexpr (kMasked) stage<F::kRows>(s_in[2], mask + blockIdx.z * mask_cstride, x0, y0, H, W);
  __syncthreads();

  // horizontal taps: a warp per staged row, a lane per column
  for (int r = warp; r < F::kRows; r += kWarps) {
    const float* xr = s_in[0][r] + lane;
    const float* yr = s_in[1][r] + lane;
    float hx = 0.0f, hy = 0.0f, hxx = 0.0f, hyy = 0.0f, hxy = 0.0f, hm = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const float w = t.w[k];
      const float xv = xr[k];
      const float yv = yr[k];
      hx = fmaf(w, xv, hx);
      hy = fmaf(w, yv, hy);
      hxx = fmaf(w, xv * xv, hxx);
      hyy = fmaf(w, yv * yv, hyy);
      hxy = fmaf(w, xv * yv, hxy);
      if constexpr (kMasked) hm = fmaf(w, s_in[2][r][lane + k], hm);
    }
    s_h[0][r][lane] = hx;
    s_h[1][r][lane] = hy;
    s_h[2][r][lane] = hxx;
    s_h[3][r][lane] = hyy;
    s_h[4][r][lane] = hxy;
    if constexpr (kMasked) s_h[5][r][lane] = hm;
  }
  __syncthreads();

  float acc[F::kQ][F::kPer];
  vertical<F::kQ, F::kPer, F::kRows>(s_h, t, warp * F::kPer, lane, acc);

  float sum = 0.0f;
  const int gx = x0 + lane;
#pragma unroll
  for (int r = 0; r < F::kPer; ++r) {
    const int gy = y0 + warp * F::kPer + r;
    if (gx >= W || gy >= H) continue;
    const float mu1 = acc[0][r];
    const float mu2 = acc[1][r];
    const float mu1_sq = mu1 * mu1;
    const float mu2_sq = mu2 * mu2;
    const float mu12 = mu1 * mu2;
    const float s1 = acc[2][r] - mu1_sq;
    const float s2 = acc[3][r] - mu2_sq;
    const float s12 = acc[4][r] - mu12;
    const float n1 = 2.0f * mu12 + kC1;
    const float n2 = 2.0f * s12 + kC2;
    const float d1 = mu1_sq + mu2_sq + kC1;
    const float d2 = s1 + s2 + kC2;
    const float dd = d1 * d2;
    const float S = (n1 * n2) / dd;
    const float M = kMasked ? acc[F::kQ - 1][r] : 1.0f;
    sum += kMasked ? S * M : S;
    if (bm != nullptr) {
      const int64_t i = base + static_cast<int64_t>(gy) * W + gx;
      const float e = 2.0f * M / dd;
      const float dn = n2 - n1;
      const float sd = S * (d1 - d2);
      if (a1 != nullptr) a1[i] = e * (mu2 * dn + mu1 * sd);
      if (a2 != nullptr) a2[i] = e * (mu1 * dn + mu2 * sd);
      bm[i] = -M * S / d2;
      cm[i] = e * n1;
    }
  }

  // the block's partial, in a fixed order: lanes by shuffles, then warps
  double v = sum;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) total += s_warp[k];
    partials[(static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x +
             blockIdx.x] = total;
  }
}

// out[0] = (sum of partials[0..n)) / total, summed in a fixed order.
__global__ void __launch_bounds__(kMeanThreads)
ssim_mean_kernel(const double* __restrict__ partials, int n, double total,
                 float* __restrict__ out) {
  __shared__ double s[kMeanThreads];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kMeanThreads) acc += partials[i];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kMeanThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) s[threadIdx.x] += s[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = static_cast<float>(s[0] / total);
}

// out = (g / n) [w * a + 2 own (w * b) + other (w * c)], grid (tiles across,
// tiles down, C), 32x32 tiles.
__global__ void __launch_bounds__(kThreads)
ssim_bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ c, const float* __restrict__ own,
                const float* __restrict__ other, const float* __restrict__ grad_out,
                int64_t n, int H, int W, Taps t, float* __restrict__ out) {
  __shared__ float s_in[3][kBwdRows][kHaloW];
  __shared__ float s_h[3][kBwdRows][kTW];
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kBwdTH;
  const int64_t base = static_cast<int64_t>(blockIdx.z) * H * W;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  stage<kBwdRows>(s_in[0], a + base, x0, y0, H, W);
  stage<kBwdRows>(s_in[1], b + base, x0, y0, H, W);
  stage<kBwdRows>(s_in[2], c + base, x0, y0, H, W);
  __syncthreads();

  for (int r = warp; r < kBwdRows; r += kWarps) {
    float h0 = 0.0f, h1 = 0.0f, h2 = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const float w = t.w[k];
      h0 = fmaf(w, s_in[0][r][lane + k], h0);
      h1 = fmaf(w, s_in[1][r][lane + k], h1);
      h2 = fmaf(w, s_in[2][r][lane + k], h2);
    }
    s_h[0][r][lane] = h0;
    s_h[1][r][lane] = h1;
    s_h[2][r][lane] = h2;
  }
  __syncthreads();

  float acc[3][kBwdPer];
  vertical<3, kBwdPer, kBwdRows>(s_h, t, warp * kBwdPer, lane, acc);

  const float scale = __ldg(grad_out) / static_cast<float>(n);
  const int gx = x0 + lane;
#pragma unroll
  for (int r = 0; r < kBwdPer; ++r) {
    const int gy = y0 + warp * kBwdPer + r;
    if (gx >= W || gy >= H) continue;
    const int64_t i = base + static_cast<int64_t>(gy) * W + gx;
    out[i] = scale * (acc[0][r] + 2.0f * __ldg(own + i) * acc[1][r] + __ldg(other + i) * acc[2][r]);
  }
}

Taps taps_of(const float* w) {
  Taps t;
  for (int k = 0; k < kTaps; ++k) t.w[k] = w[k];
  return t;
}

dim3 fwd_grid(int C, int H, int W, int masked) {
  const int th = masked ? Fwd<true>::kTH : Fwd<false>::kTH;
  return dim3((W + kTW - 1) / kTW, (H + th - 1) / th, C);
}

bool bad_shape(int C, int H, int W) {
  return C < 1 || H < 1 || W < 1 || C > 65535 || (H + kBwdTH - 1) / kBwdTH > 65535 ||
         (H + Fwd<true>::kTH - 1) / Fwd<true>::kTH > 65535;
}

}  // namespace

// The number of fp64 partials `ssim_fwd` writes for a [C, H, W] image, with
// a mask or not; 0 for a shape it refuses.
extern "C" long long ssim_fwd_blocks(int C, int H, int W, int masked) {
  if (bad_shape(C, H, W)) return 0;
  const dim3 g = fwd_grid(C, H, W, masked);
  return static_cast<long long>(g.x) * g.y * g.z;
}

// Plain C entry point (loaded with ctypes). x, y [C, H, W] fp32; mask null or
// H x W planes mask_cstride floats apart (0: one plane for every channel);
// taps the 11 host floats of the 1-D window; a1, a2, b, c null or [C, H, W]
// (b and c given whenever a1 or a2 is); partials ssim_fwd_blocks(...) doubles;
// loss one float, the mean of S M over C * H * W. Launches on `stream`, never
// synchronises, and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape the grid cannot hold.
extern "C" int ssim_fwd(const void* x, const void* y, const void* mask, long long mask_cstride,
                        int C, int H, int W, const float* taps, void* a1, void* a2, void* b,
                        void* c, void* partials, void* loss, void* stream) {
  if (bad_shape(C, H, W) || ((a1 != nullptr || a2 != nullptr) && (b == nullptr || c == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Taps t = taps_of(taps);
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid = fwd_grid(C, H, W, mask != nullptr);
  const auto* xf = static_cast<const float*>(x);
  const auto* yf = static_cast<const float*>(y);
  const auto* mf = static_cast<const float*>(mask);
  auto* a1f = static_cast<float*>(a1);
  auto* a2f = static_cast<float*>(a2);
  auto* bf = static_cast<float*>(b);
  auto* cf = static_cast<float*>(c);
  auto* p = static_cast<double*>(partials);
  if (mask != nullptr) {
    ssim_fwd_kernel<true><<<grid, kThreads, 0, st>>>(xf, yf, mf, mask_cstride, H, W, t, a1f, a2f,
                                                     bf, cf, p);
  } else {
    ssim_fwd_kernel<false><<<grid, kThreads, 0, st>>>(xf, yf, nullptr, 0, H, W, t, a1f, a2f, bf,
                                                      cf, p);
  }
  const int n = static_cast<int>(static_cast<long long>(grid.x) * grid.y * grid.z);
  ssim_mean_kernel<<<1, kMeanThreads, 0, st>>>(p, n, static_cast<double>(C) * H * W,
                                               static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}

// The gradient of the mean for one image: out = (g / (C H W)) [w * a + 2 own
// (w * b) + other (w * c)], all [C, H, W] fp32, g one float on the device.
// Returns as ssim_fwd does.
extern "C" int ssim_bwd(const void* a, const void* b, const void* c, const void* own,
                        const void* other, const void* grad_out, int C, int H, int W,
                        const float* taps, void* out, void* stream) {
  if (bad_shape(C, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kTW - 1) / kTW, (H + kBwdTH - 1) / kBwdTH, C);
  ssim_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(own), static_cast<const float*>(other),
      static_cast<const float*>(grad_out), static_cast<int64_t>(C) * H * W, H, W, taps_of(taps),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM: which = 0 the forward, 1 the forward with a mask,
// 2 the backward; stored in `blocks`; returns the CUDA error code.
extern "C" int ssim_occupancy(int which, int* blocks) {
  cudaError_t err;
  if (which == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ssim_fwd_kernel<false>, kThreads, 0);
  } else if (which == 1) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ssim_fwd_kernel<true>, kThreads, 0);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ssim_bwd_kernel, kThreads, 0);
  }
  return static_cast<int>(err);
}
