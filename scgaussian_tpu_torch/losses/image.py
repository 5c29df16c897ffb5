"""Image losses: L1, windowed SSIM, PSNR.

Port of `scgaussian_tpu/losses/image.py`, with the reference's constants
and padding:
- `l1_loss`/`l2_loss` (`utils/loss_utils.py:40-44`)
- 11x11 sigma-1.5 Gaussian-window SSIM with zero padding
  (`utils/loss_utils.py:46-94`), used by training (`train.py:161`) and
  metrics (`metrics.py:87`)
- 5x5 AvgPool + reflection-pad SSIM error map (`utils/loss_utils.py:162-205`)
  used for render.py error visualizations
- `psnr`/`mse` (`utils/image_utils.py:15-19`)

The windows are depthwise `F.conv2d` calls (`groups=C`), a plain library
convolution as the JAX package's is plain XLA. They must run in full fp32:
the package turns TF32 off at import, since C2 = 9e-4 is below TF32's
error and SSIM would then exceed 1 on flat regions.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from scgaussian_tpu_torch.utils.profiling import count

C1 = 0.01**2
C2 = 0.03**2


def l1_loss(output: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(output - gt))


def l2_loss(output: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((output - gt) ** 2)


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image MSE over flattened pixels (`utils/image_utils.py:15-16`)."""
    b = img1.shape[0]
    return torch.mean((img1.reshape(b, -1) - img2.reshape(b, -1)) ** 2, dim=1, keepdim=True)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """`utils/image_utils.py:18-19`: 20 log10(1/sqrt(mse)) per image."""
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(img1, img2)))


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    g = np.array(
        [math.exp(-((x - window_size // 2) ** 2) / (2 * sigma**2)) for x in range(window_size)],
        dtype=np.float32,
    )
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _depthwise_conv(img: torch.Tensor, window: torch.Tensor, padding: int) -> torch.Tensor:
    """img [C, H, W], window [kh, kw] applied per channel (groups=C)."""
    c = img.shape[0]
    kernel = window[None, None].expand(c, 1, *window.shape)
    return F.conv2d(img[None], kernel, padding=padding, groups=c)[0]


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    window_size: int = 11,
    mask: torch.Tensor | None = None,
    size_average: bool = True,
) -> torch.Tensor:
    """Windowed SSIM, zero padding (matches `_ssim`, `utils/loss_utils.py:66-94`).

    Args: img1/img2 [C, H, W] in [0, 1].
    """
    window = torch.as_tensor(_gaussian_window(window_size, 1.5), device=img1.device)
    count("host_syncs")  # the copy from the host waits for the device
    pad = window_size // 2

    def conv(x):
        return _depthwise_conv(x, window, pad)

    mu1 = conv(img1)
    mu2 = conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = conv(img1 * img1) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    if mask is not None:
        mask_c = _depthwise_conv(mask[None] if mask.dim() == 2 else mask, window, pad)
        ssim_map = ssim_map * mask_c
    if size_average:
        return torch.mean(ssim_map)
    return torch.mean(ssim_map, dim=(0, 1, 2))


def avgpool_ssim_map(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """5x5 AvgPool SSIM error map with reflection padding.

    Matches the `SSIM` module (`utils/loss_utils.py:162-193`): returns
    clamp((1 - SSIM_n/SSIM_d)/2, 0, 1) as [C, H, W].
    """

    def refl(im):
        return F.pad(im[None], (2, 2, 2, 2), mode="reflect")[0]

    x, y = refl(x), refl(y)
    window = torch.full((5, 5), 1.0 / 25.0, dtype=x.dtype, device=x.device)

    def pool(im):
        return _depthwise_conv(im, window, 0)

    mu_x, mu_y = pool(x), pool(y)
    sigma_x = pool(x**2) - mu_x**2
    sigma_y = pool(y**2) - mu_y**2
    sigma_xy = pool(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)
    d = (mu_x**2 + mu_y**2 + C1) * (sigma_x + sigma_y + C2)
    return torch.clamp((1 - n / d) / 2, 0.0, 1.0)


def pixel_loss_map(image: torch.Tensor, gt_image: torch.Tensor) -> torch.Tensor:
    """0.5 L1 + 0.5 avgpool-SSIM per-pixel error map
    (`get_pixel_loss`, `utils/loss_utils.py:195-205`), used by render.py."""
    l1 = torch.mean(torch.abs(image - gt_image), dim=0)
    sl = torch.mean(avgpool_ssim_map(image, gt_image), dim=0)
    return 0.5 * l1 + 0.5 * sl
