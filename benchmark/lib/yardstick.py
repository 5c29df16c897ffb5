"""The frozen yardstick: the card's peaks, the least time of each kernel's
work (its roofline bound), the operations of a whole step or view, and the
plain counter of the pairs that change a pixel.

The bounds keep the form of the bring-up smoke test's (`kernel_bound_ms`,
`kernel_bound_ms_bwd`, `route_bound_ms`): the larger of the bytes the call
must move at the HBM rate and its fp32 operations at the fp32 rate. They
price only the work that the inputs need: the forward and the backward
price the pairs that change a pixel, a (pixel, entry) pair with power <= 0
and alpha >= 1/255 that the pixel blends before its transmittance would fall
under 1e-4. Faint, far and culled pairs cost nothing, since a perfect cull
would never visit them. The count comes from the benchmark's own plain
compositing (`reference.composite_block`) on the kernel's inputs.
"""

from __future__ import annotations

import torch

from benchmark.lib import reference

H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores

# forward, per pair that changes a pixel: power (dx, dy, 3 products, 2
# adds, 4 multiplies: ~11), expf (1), alpha (2), 1 - alpha and T (2)
OPS_PER_PAIR = 16
# backward, per such pair, the whole chain: 11 for power, 1 expf, 2 alpha,
# 1 + 1 for 1 - alpha and T, 1 w, 7 colour/depth dot, 3 d_alpha, 2 tail,
# 1 d_power, 1 d_opacity, 10 mean2d, 9 conic, 4 rgb/depth, 10 adds to sum
# the terms per entry
OPS_LIVE_BWD = 64

# whole-step operations, per unit of the work named
PROJ_OPS_FWD = 400  # per alive Gaussian: transforms 66, quaternion to matrix 40,
# 3D covariance 63, Jacobian and 2D covariance 94, conic and radius 20,
# degree-3 SH (basis 30, 16 x 3 products and adds 96), direction 10
PROJ_OPS_BWD = 800  # per alive Gaussian: twice the forward
LOSS_OPS_FWD = 3700  # per pixel: SSIM's five 11 x 11 windows on 3 channels
# (5 x 3 x 121 x 2 = 3630) and ~70 elementwise for SSIM and L1
LOSS_OPS_BWD = 2300  # per pixel: the three windows of the rendered image
# (3 x 3 x 121 x 2 = 2178) and ~120 elementwise
MATCH_OPS = 150  # per match of the rendered view's pairs, forward and backward
ADAM_OPS = 13  # per parameter element: two moments (7), bias corrections,
# square root, division and update (6)
PARAMS_PER_GAUSSIAN = 59  # position 1-3, SH 48, scale 3, rotation 4, opacity 1


def bound_ms(bytes_moved: float, ops: float) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = bytes_moved / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fwd_bytes(entries: int, n: int, tiles: int, W: int, H: int) -> int:
    """The forward kernel's bytes: tile starts (tiles + 1) x 4, entry ids
    entries x 4, attribute rows n x 48, bg 12, and per pixel rgb, depth,
    alpha, T (fp32) and the last contributor (int32) written once."""
    return (tiles + 1) * 4 + entries * 4 + n * 48 + 12 + W * H * 7 * 4


def bwd_bytes(entries: int, n: int, tiles: int, W: int, H: int, per_entry: bool) -> int:
    """The backward kernel's bytes: its inputs as the forward's, per pixel
    the final T, the last contributor and 5 cotangents read once, and the
    [n, 12] gradient rows (per entry: the [entries, 10] rows) written once."""
    written = entries * 10 * 4 if per_entry else n * 48
    return (tiles + 1) * 4 + entries * 4 + n * 48 + 12 + W * H * 7 * 4 + written


def route_bound(entries: int, n: int) -> tuple:
    """The segment sum of the route by sort: the per-entry rows read once
    (entries x 40 B), the run starts read once ((n + 1) x 4 B), the [n, 10]
    sums written once (n x 40 B), or the entries x 10 additions."""
    return bound_ms(entries * 40 + (n + 1) * 4 + n * 40, entries * 10)


@torch.no_grad()
def count_pairs(attrs: torch.Tensor, W: int, H: int) -> int:
    """The pairs that change a pixel, for the kernel's packed rows [N, 12]
    (mean x, y, conic a, b, c, opacity, rgb, depth): the rows are binned by
    their 3-sigma radius (from the conic's inverse) and composited by the
    plain reference, which counts what it blends."""
    a = attrs[:, :10].detach().to(torch.float32)
    ca, cb, cc = a[:, 2], a[:, 3], a[:, 4]
    det_c = ca * cc - cb * cb
    ok = (det_c > 0) & (a[:, 9] > reference.NEAR_Z) & (a[:, 5] > 0)
    inv = torch.where(ok, 1.0 / torch.where(ok, det_c, torch.ones_like(det_c)),
                      torch.zeros_like(det_c))
    va, vc = cc * inv, ca * inv  # the 2D covariance's diagonal
    det = va * vc - (cb * inv) ** 2
    mid = 0.5 * (va + vc)
    root = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(mid + root, mid - root)))
    radius = torch.where(ok, radius, torch.zeros_like(radius)).to(torch.int64)
    bg = torch.zeros(3, device=a.device)
    return reference.render(a, radius, W, H, bg)[3]
