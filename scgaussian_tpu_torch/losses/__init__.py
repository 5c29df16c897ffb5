"""Losses: image losses, bilinear sampling and the auxiliary depth losses
(port of `scgaussian_tpu/losses`)."""

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
from scgaussian_tpu_torch.losses.aux import (  # noqa: F401
    cons_loss,
    get_smooth_loss,
    get_virtual_warp_loss,
    margin_l2_loss,
    patch_norm_mse_loss,
    patchify,
    ranking_loss,
)
