"""Bilinear grid sampling with torch `F.grid_sample` semantics.

Port of `scgaussian_tpu/losses/sampling.py`. The reference uses
grid_sample (mode="bilinear", align_corners=False, zero padding) to warp
colors/masks onto match pixels (`scene/gaussian_model.py:324-328`) and to
sample rendered depth at match UVs (`scene/gaussian_model.py:259`). Written
as the JAX package's explicit 4-tap gather, so that the arithmetic (and its
gradient) is the JAX code's.
"""

from __future__ import annotations

import torch


def grid_sample_2d(img: torch.Tensor, grid_xy: torch.Tensor) -> torch.Tensor:
    """Sample `img` [C, H, W] at normalized grid coords [M, 2] in [-1, 1].

    align_corners=False unnormalization: ix = ((gx + 1) * W - 1) / 2; values
    outside the image are zero (torch zero padding).

    Returns [C, M].
    """
    _, H, W = img.shape
    ix = ((grid_xy[:, 0] + 1.0) * W - 1.0) / 2.0
    iy = ((grid_xy[:, 1] + 1.0) * H - 1.0) / 2.0
    return bilinear_sample_pix(img, ix, iy)


def bilinear_sample_pix(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample [C, H, W] at float pixel coords; zeros outside.

    Returns [C, M].
    """
    _, H, W = img.shape
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    x1 = x0 + 1.0
    y1 = y0 + 1.0

    wx1 = ix - x0
    wx0 = 1.0 - wx1
    wy1 = iy - y0
    wy0 = 1.0 - wy1

    def tap(xf, yf, w):
        xi = xf.to(torch.int64)
        yi = yf.to(torch.int64)
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xi = torch.clamp(xi, 0, W - 1)
        yi = torch.clamp(yi, 0, H - 1)
        vals = img[:, yi, xi]  # [C, M]
        return vals * (w * inb)[None, :]

    return (
        tap(x0, y0, wx0 * wy0)
        + tap(x1, y0, wx1 * wy0)
        + tap(x0, y1, wx0 * wy1)
        + tap(x1, y1, wx1 * wy1)
    )
