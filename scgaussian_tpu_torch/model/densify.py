"""Densification statistics.

Port of `update_stats` from `scgaussian_tpu/model/densify.py:36-63`
(`train.py:190-193`, `scene/gaussian_model.py:932-934`). `densify_and_prune`,
`reset_opacity` and the bg capacity growth are not ported yet.
"""

from __future__ import annotations

import torch

from scgaussian_tpu_torch.model.gaussians import GaussianModel


@torch.no_grad()
def update_stats(
    model: GaussianModel,
    radii: torch.Tensor,
    viewspace_grad_pix: torch.Tensor,
    width: int,
    height: int,
) -> GaussianModel:
    """Accumulate one iteration's stats into the model's buffers, in place.

    `viewspace_grad_pix` is d(loss)/d(mean2d in pixels); the reference's
    screenspace gradient is in NDC units, i.e. pixel-grad * (0.5 W, 0.5 H)
    (CUDA backward's ddelx_dx factor), so it is rescaled before the norm to
    keep the densify_grad_threshold semantics identical. Returns `model`."""
    vis = radii > 0
    model.max_radii2d.copy_(torch.where(
        vis, torch.maximum(model.max_radii2d, radii.to(torch.float32)), model.max_radii2d
    ))
    scale = torch.tensor([0.5 * width, 0.5 * height], dtype=torch.float32,
                         device=viewspace_grad_pix.device)
    norm = torch.linalg.norm(viewspace_grad_pix * scale[None, :], dim=-1, keepdim=True)
    model.xyz_gradient_accum.add_(torch.where(vis[:, None], norm, 0.0))
    model.denom.add_(vis[:, None].to(torch.float32))
    return model
