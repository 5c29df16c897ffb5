"""Two-stage training: init stage -> promote -> main stage.

Port of `scgaussian_tpu/train/pipeline.py:27-329`, the functional
equivalent of `training()` (`train.py:37-212`): stage 1 optimizes the
match-prior depths, the promoted matches become the hybrid model
(`create_from_pcd` analog), stage 2 runs `train_step` with the densify /
prune / opacity-reset schedule and the background-capacity guard.

A process group (`group`) stands where the JAX pipeline takes a `mesh`
(`parallel/dp.py`). Differences from the JAX pipeline:
- no entry-budget overflow guard: the CUDA path sizes its tile entries per
  frame and never truncates, so there is nothing to regrow. The budget
  rule lives on only as the backward's route (`raster.sort_route`), decided
  per step from the current slot count, which capacity growth may change;
- random draws come from `torch.Generator`s and numpy (the camera stack),
  not `jax.random` keys: a test passes the JAX run's z0 and `stack_seed`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from scgaussian_tpu_torch.config import OptimizationConfig, RasterizerConfig, TrainExtras
from scgaussian_tpu_torch.core.cameras import Camera
from scgaussian_tpu_torch.model import matches as matches_mod
from scgaussian_tpu_torch.model.densify import densify_and_prune, grow_bg_capacity, reset_opacity
from scgaussian_tpu_torch.model.gaussians import PARAM_NAMES, GaussianModel, create_model
from scgaussian_tpu_torch.parallel import dp as dp_mod
from scgaussian_tpu_torch.train import optim
from scgaussian_tpu_torch.train.main_stage import train_step
from scgaussian_tpu_torch.utils.profiling import span


def setup_from_matches(
    bundle: matches_mod.MatchBundle,
    generator: Optional[torch.Generator],
    sh_degree: int,
    spatial_lr_scale: float,
    extras: TrainExtras = TrainExtras(),
    init_iterations: Optional[int] = None,
    z0: Optional[torch.Tensor] = None,
) -> Tuple[GaussianModel, matches_mod.InitStageResult]:
    """Init stage (`train.py:49-97`) + promotion + `create_model`, on the
    bundle's device. z0 is drawn from `generator` unless given."""
    if z0 is None:
        z0 = matches_mod.init_zvals(bundle, generator)
    result = matches_mod.run_init_stage(
        bundle,
        z0,
        iterations=init_iterations or extras.init_iterations,
        base_lr=extras.init_lr,
        loss_scale=extras.init_loss_scale,
    )
    rayo, rayd, zval, color = matches_mod.promote_matches(
        bundle, result.best_z, result.min_err, err_threshold=extras.promote_err_threshold
    )
    model = create_model(
        rayo,
        rayd,
        zval,
        color,
        max_sh_degree=sh_degree,
        spatial_lr_scale=spatial_lr_scale,
        bg_capacity=extras.bg_capacity,
        device=bundle.rays_o.device,
    )
    return model, result


@span("train.densify")
def densify_event(
    model: GaussianModel,
    opt_state: optim.AdamState,
    iteration: int,
    opt_cfg: OptimizationConfig,
    extras: TrainExtras,
    cameras_extent: float,
    generator: Optional[torch.Generator],
) -> Tuple[GaussianModel, optim.AdamState]:
    """One densify and prune event of the main stage (`train.py:195-197`)
    with the background-capacity guard: the reference grows without bound
    (`scene/gaussian_model.py:777-842`); a full fixed-capacity pool grows
    rather than silently stop densifying."""
    size_threshold = extras.size_threshold if iteration > opt_cfg.opacity_reset_interval else None
    model, opt_state, dropped = densify_and_prune(
        model, opt_state, opt_cfg.densify_grad_threshold,
        extras.prune_min_opacity, cameras_extent, size_threshold,
        opt_cfg.percent_dense, fg_split_log_quirk=extras.fg_split_log_quirk,
        generator=generator,
    )
    if dropped > 0:
        cb = model.bg_capacity
        new_cb = cb
        while new_cb < cb + dropped:
            new_cb *= 2
        msg = (f"[guard] iteration {iteration}: densify dropped {dropped} "
               f"candidates (bg capacity {cb})")
        if not extras.guard_auto_grow:
            raise RuntimeError(msg + "; set guard_auto_grow=True or raise bg_capacity")
        print(msg + f" -> growing bg capacity to {new_cb}")
        model, opt_state = grow_bg_capacity(model, opt_state, new_cb)
    return model, opt_state


@dataclasses.dataclass
class TrainState:
    model: GaussianModel
    opt_state: optim.AdamState
    iteration: int = 0


def run_main_stage(
    model: GaussianModel,
    bundle: matches_mod.MatchBundle,
    cameras: List[Camera],
    gt_images: List[torch.Tensor],
    view_ids: List[int],
    stack_seed: int,
    opt_cfg: OptimizationConfig = OptimizationConfig(),
    raster: RasterizerConfig = RasterizerConfig(),
    extras: TrainExtras = TrainExtras(),
    white_background: bool = False,
    is_dtu: bool = False,
    backend: str = "cuda",
    cameras_extent: float = 1.0,
    iterations: Optional[int] = None,
    callback: Optional[Callable[..., None]] = None,
    first_iteration: int = 0,
    opt_state: Optional[optim.AdamState] = None,
    generator: Optional[torch.Generator] = None,
    group=None,
) -> TrainState:
    """Main optimization loop (`train.py:99-212`).

    Each iteration pops a camera off a shuffled stack
    (`np.random.default_rng(stack_seed)`, as the JAX pipeline seeds it from
    its key), runs `train_step`, then the maintenance schedule: densify and
    prune (with the bg-capacity guard) and the opacity reset, and the SH
    degree bump every 1,000 iterations. `generator` draws the split noise.
    Resume by passing `first_iteration` and the restored `opt_state`.
    `callback(iteration, model, metrics, opt_state=..., raster=...)` runs
    after each iteration.

    `group` (a process group, `parallel.dp.make_group`) switches every step
    to `dp_train_step`: each iteration pops D = the group's size cameras off
    the same seeded stack on every rank, and rank r trains on the r-th;
    the cameras must share one image size. The replicas must start equal
    (`dp.broadcast_model`); the maintenance (densify and prune with the
    capacity guard, the opacity reset, the SH bump, the callback) then runs
    identically on each, with split noise from identically seeded
    generators, so they stay equal. One iteration consumes D cameras
    instead of 1; a group of one is the single-device loop."""
    iterations = iterations or opt_cfg.iterations
    dev = model.zval.device
    bg_color = torch.tensor([1.0, 1.0, 1.0] if white_background else [0.0, 0.0, 0.0],
                            device=dev)
    if opt_state is None:
        opt_state = optim.init({name: getattr(model, name) for name in PARAM_NAMES})

    n_dp = 0
    if group is not None:
        n_dp = dist.get_world_size(group)
        sizes = {(c.width, c.height) for c in cameras}
        if len(sizes) != 1:
            raise ValueError(f"data-parallel training batches cameras of one image size; "
                             f"got {sorted(sizes)}")

    # random camera stack semantics (`train.py:133-135`)
    py_rng = np.random.default_rng(stack_seed)
    stack: List[int] = []

    def pop_camera() -> int:
        nonlocal stack
        if not stack:
            stack = list(range(len(cameras)))
            py_rng.shuffle(stack)
        return stack.pop()

    for iteration in range(first_iteration + 1, iterations + 1):
        # SH degree bump every 1000 iterations (`train.py:129-130`)
        if iteration % 1000 == 0:
            model.oneup_sh_degree()

        if opt_cfg.random_background:
            bg = torch.tensor(py_rng.uniform(size=3).astype(np.float32), device=dev)
        else:
            bg = bg_color

        if n_dp:
            batch = [pop_camera() for _ in range(n_dp)]
            model, opt_state, metrics = dp_mod.dp_train_step(
                group, model, opt_state, bundle, [cameras[i] for i in batch],
                [gt_images[i] for i in batch], [view_ids[i] for i in batch],
                iteration, bg, opt_cfg, raster=raster, extras=extras, backend=backend,
                is_dtu=is_dtu,
            )
        else:
            cam_i = pop_camera()
            model, opt_state, metrics = train_step(
                model, opt_state, bundle, cameras[cam_i], gt_images[cam_i], view_ids[cam_i],
                iteration, bg, opt_cfg, raster=raster, extras=extras, backend=backend,
                is_dtu=is_dtu,
            )

        # densification + opacity reset schedule (`train.py:189-200`)
        if iteration < opt_cfg.densify_until_iter:
            if (iteration > opt_cfg.densify_from_iter
                    and iteration % opt_cfg.densification_interval == 0):
                model, opt_state = densify_event(model, opt_state, iteration, opt_cfg, extras,
                                                 cameras_extent, generator)
            if iteration < opt_cfg.opacity_reset_until_iter and (
                iteration % opt_cfg.opacity_reset_interval == 0
                or (white_background and iteration == opt_cfg.densify_from_iter)
            ):
                model, opt_state = reset_opacity(model, opt_state)

        if callback is not None:
            callback(iteration, model, metrics, opt_state=opt_state, raster=raster)

    return TrainState(model=model, opt_state=opt_state, iteration=iterations)
