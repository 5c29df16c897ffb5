"""Losses: image losses and bilinear sampling (port of `scgaussian_tpu/losses`).

`losses/aux.py` (smoothness, patch and ranking losses) is not ported yet.
"""

from scgaussian_tpu_torch.losses.image import (  # noqa: F401
    avgpool_ssim_map,
    l1_loss,
    l2_loss,
    mse,
    pixel_loss_map,
    psnr,
    ssim,
)
from scgaussian_tpu_torch.losses.sampling import bilinear_sample_pix, grid_sample_2d  # noqa: F401
