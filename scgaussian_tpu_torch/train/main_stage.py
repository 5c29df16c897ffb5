"""Main-stage training: photometric + structure-consistency optimization.

Port of `scgaussian_tpu/train/main_stage.py:39-291`: `render_model` and one
main-stage `train_step` (render -> loss -> gradients -> dual Adam update ->
densify statistics), the body of `training()`'s main loop
(`train.py:99-212`). The loop around it is `train/pipeline.py`.

Loss (matching `train.py:143-168`):
    (1 - lambda_dssim) L1 + lambda_dssim (1 - SSIM)
    + 0.3 * match-consistency on rendered depth
    + DTU only: background-alpha penalty with the dark-row mask.

Reference quirk preserved: `update_learning_rate` returns after scheduling
the fg zval group, so the bg_xyz LR is never actually scheduled and stays at
position_lr_init * spatial_lr_scale (`scene/gaussian_model.py:517-529`).

Unlike the JAX step, which returns new pytrees, `train_step` updates the
model's parameters and statistics in place (and returns the model); the
Adam state is returned anew, as in JAX.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from scgaussian_tpu_torch.config import OptimizationConfig, RasterizerConfig, TrainExtras
from scgaussian_tpu_torch.core.cameras import Camera
from scgaussian_tpu_torch.core.schedules import expon_lr
from scgaussian_tpu_torch.losses import l1_loss, ssim
from scgaussian_tpu_torch.model.densify import update_stats
from scgaussian_tpu_torch.model.gaussians import PARAM_NAMES, GaussianModel
from scgaussian_tpu_torch.model.matches import MatchBundle, matchloss_from_renderdepth
from scgaussian_tpu_torch.renderer import RenderOutput, render
from scgaussian_tpu_torch.renderer.project import sh_to_color
from scgaussian_tpu_torch.train import optim


def render_model(
    camera: Camera,
    model: GaussianModel,
    bg_color: torch.Tensor,
    mean2d_offset: Optional[torch.Tensor] = None,
    backend: str = "cuda",
    raster: RasterizerConfig = RasterizerConfig(),
    scaling_modifier: float = 1.0,
    convert_shs_python: bool = False,
    compute_cov3d_python: bool = False,
) -> RenderOutput:
    """The `render(viewpoint, gaussians, pipe, bg)` analog
    (`gaussian_renderer/__init__.py:20-118`) over a GaussianModel,
    differentiable with respect to the model's parameters and
    `mean2d_offset` on either backend. `raster` decides the tile path's
    backward route from the model's slot count (`raster.sort_route`).

    convert_shs_python / compute_cov3d_python mirror the reference's
    PipelineParams debug paths (`gaussian_renderer/__init__.py:59-96`):
    colors / 3D covariance are precomputed outside the rasterizer's own
    SH/covariance stages."""
    xyz = model.get_xyz()
    shs = None
    colors_precomp = None
    if convert_shs_python:
        colors_precomp = sh_to_color(
            model.get_features(), xyz, camera.cam_center, model.max_sh_degree
        )
    else:
        shs = model.get_features()

    scales = rotations = cov3d_precomp = None
    if compute_cov3d_python:
        cov3d_precomp = model.get_covariance(scaling_modifier)
    else:
        scales = model.get_scaling()
        rotations = model.get_rotation()

    return render(
        camera,
        xyz,
        model.get_opacity().reshape(-1),
        bg_color,
        scales=scales,
        rotations=rotations,
        shs=shs,
        colors_precomp=colors_precomp,
        cov3d_precomp=cov3d_precomp,
        active_sh_degree=model.max_sh_degree,  # bands masked by the active degree
        scaling_modifier=scaling_modifier,
        mean2d_offset=mean2d_offset,
        backend=backend,
        tile=raster.tile,
        entry_budget=raster.entry_budget,
        ptile=raster.ptile,
    )


def dtu_background_mask(gt_image: torch.Tensor, dark_threshold: float, shift_rows: int):
    """DTU dark-background mask (`train.py:149-158`): pixel is background iff
    it and the `shift_rows-1` rows above it are all darker than the threshold."""
    dark = (torch.amax(gt_image, dim=0, keepdim=True) < dark_threshold).to(torch.float32)
    padded = F.pad(dark, (0, 0, shift_rows - 1, 0), value=1.0)  # [1, H + s - 1, W]
    windowed = -F.max_pool2d(-padded[None], (shift_rows, 1), stride=1)[0]  # min over rows
    return windowed > 0.5  # [1, H, W] bool


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    match_loss: torch.Tensor
    num_visible: torch.Tensor
    overflow: torch.Tensor  # [] int32: always 0, the CUDA path never truncates


def make_camera_loss(
    model: GaussianModel,
    bundle: MatchBundle,
    camera: Camera,
    gt_image: torch.Tensor,  # [3, H, W]
    view_idx: int,
    bg_color: torch.Tensor,  # [3]
    opt_cfg: OptimizationConfig,
    raster: RasterizerConfig,
    extras: TrainExtras,
    backend: str,
    is_dtu: bool,
):
    """The per-camera training loss (`train.py:143-168`).

    Returns loss_fn(mean2d_offset) -> (loss, (out, ll1, mloss)) over the
    model's current parameters."""
    bg_mask = None
    if is_dtu:
        bg_mask = dtu_background_mask(
            gt_image, extras.dtu_dark_threshold, extras.dtu_shift_rows
        )
        gt_image = torch.where(bg_mask, 0.0, gt_image)

    def loss_fn(offset: torch.Tensor):
        out = render_model(
            camera, model, bg_color, mean2d_offset=offset, backend=backend, raster=raster,
        )
        ll1 = l1_loss(out.render, gt_image)
        loss = (1.0 - opt_cfg.lambda_dssim) * ll1 + opt_cfg.lambda_dssim * (
            1.0 - ssim(out.render, gt_image)
        )
        mloss = matchloss_from_renderdepth(bundle, view_idx, out.rendered_depth)
        loss = loss + extras.render_match_loss_weight * mloss
        if bg_mask is not None:
            # background-alpha penalty (`train.py:167-168`)
            msum = torch.clamp(bg_mask.sum(), min=1)
            loss = loss + torch.sum(out.rendered_alpha * bg_mask) / msum
        return loss, (out, ll1, mloss)

    return loss_fn


def lr_tree(
    opt_cfg: OptimizationConfig,
    spatial_lr_scale: float,
    iteration: int,
) -> Dict[str, float]:
    """Per-leaf learning rates (`scene/gaussian_model.py:486-515`)."""
    zval_sched = expon_lr(
        lr_init=opt_cfg.position_lr_init * spatial_lr_scale,
        lr_final=opt_cfg.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt_cfg.position_lr_delay_mult,
        max_steps=opt_cfg.position_lr_max_steps,
    )
    return dict(
        zval=zval_sched(iteration),
        f_dc=opt_cfg.feature_lr,
        f_rest=opt_cfg.feature_lr / 20.0,
        scaling=opt_cfg.scaling_lr,
        rotation=opt_cfg.rotation_lr,
        opacity=opt_cfg.opacity_lr,
        # bg_xyz is NOT scheduled (reference dead-code quirk, see module doc)
        bg_xyz=opt_cfg.position_lr_init * spatial_lr_scale,
        bg_f_dc=opt_cfg.feature_lr,
        bg_f_rest=opt_cfg.feature_lr / 20.0,
        bg_scaling=opt_cfg.scaling_lr,
        bg_rotation=opt_cfg.rotation_lr,
        bg_opacity=opt_cfg.opacity_lr,
    )


@torch.no_grad()
def apply_update(
    model: GaussianModel,
    opt_state: optim.AdamState,
    g_params: Dict[str, torch.Tensor],
    iteration: int,
    opt_cfg: OptimizationConfig,
) -> Tuple[GaussianModel, optim.AdamState]:
    """Scheduled dual-Adam update with the reference's skip-optimizer-on-
    final-iteration quirk (`train.py:202-208`, condition at `:203`): at
    `iteration >= opt_cfg.iterations` neither the parameters nor the Adam
    state (count included) change. Writes the parameters in place."""
    if iteration >= opt_cfg.iterations:
        return model, opt_state
    lrs = lr_tree(opt_cfg, model.spatial_lr_scale, iteration)
    params = {name: getattr(model, name) for name in PARAM_NAMES}
    new_params, opt_state = optim.apply(params, g_params, opt_state, lrs)
    for name, value in new_params.items():
        params[name].copy_(value)
    return model, opt_state


def train_step(
    model: GaussianModel,
    opt_state: optim.AdamState,
    bundle: MatchBundle,
    camera: Camera,
    gt_image: torch.Tensor,  # [3, H, W]
    view_idx: int,
    iteration: int,  # 1-based like the reference
    bg_color: torch.Tensor,  # [3]
    opt_cfg: OptimizationConfig,
    raster: RasterizerConfig = RasterizerConfig(),
    extras: TrainExtras = TrainExtras(),
    backend: str = "cuda",
    is_dtu: bool = False,
) -> Tuple[GaussianModel, optim.AdamState, StepMetrics]:
    """One main-stage iteration on one camera. The model's parameters and
    densify statistics are updated in place; returns (model, new Adam
    state, metrics), the metrics as device tensors (no host sync)."""
    offset0 = torch.zeros(model.total, 2, dtype=torch.float32, device=model.zval.device,
                          requires_grad=True)
    loss_fn = make_camera_loss(
        model, bundle, camera, gt_image, view_idx, bg_color,
        opt_cfg, raster, extras, backend, is_dtu,
    )
    loss, (out, ll1, mloss) = loss_fn(offset0)

    # one call for every leaf and the offset: nothing accumulates in .grad
    leaves = [getattr(model, name) for name in PARAM_NAMES]
    grads = torch.autograd.grad(loss, leaves + [offset0], allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves + [offset0], grads)]
    g_params = dict(zip(PARAM_NAMES, grads[:-1]))
    g_offset = grads[-1]

    # densification stats (`train.py:190-193`), only while densifying
    if iteration < opt_cfg.densify_until_iter:
        update_stats(model, out.radii, g_offset, camera.width, camera.height)

    model, opt_state = apply_update(model, opt_state, g_params, iteration, opt_cfg)

    metrics = StepMetrics(
        loss=loss.detach(),
        l1=ll1.detach(),
        match_loss=mloss.detach(),
        num_visible=torch.sum(out.radii > 0),
        overflow=out.overflow,
    )
    return model, opt_state, metrics
