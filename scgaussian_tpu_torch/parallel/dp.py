"""Camera-batch data parallelism over a process group.

Port of `scgaussian_tpu/parallel/dp.py`. One rank per device; every rank
holds the same replicated model and Adam state. One DP iteration consumes
D cameras (D = the group's size): rank r renders and differentiates item r
of the batch against the replicated parameters, the gradients are
all-reduced and divided by D (the mean, JAX's `pmean`), and every rank
applies the same Adam update. With every rank on the same camera, a DP step
equals one single-device `train_step` exactly ((g + g) / 2 = g in fp32);
with a group of one, it is `train_step`.

The per-camera loss is `main_stage.make_camera_loss`, the closure
`train_step` differentiates, and the update is `main_stage.apply_update`
(learning-rate schedule and final-iteration skip), so the two steps cannot
drift.

Densify statistics, only while densifying (`iteration <
densify_until_iter`, as `train_step`): each rank's own contribution of this
step, the norm of its screen-space gradient and its visibility, is summed
over the group and the radii are maxed; only then is the sum added to the
accumulators. Reducing the accumulators themselves would multiply every
earlier sum by D.

The JAX package stacks the D cameras into one batched pytree
(`stack_cameras`) for `shard_map`; here each rank just takes item r of a
list, so the port's `Camera` needs no stacked form.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from scgaussian_tpu_torch.config import OptimizationConfig, RasterizerConfig, TrainExtras
from scgaussian_tpu_torch.core.cameras import Camera
from scgaussian_tpu_torch.model.gaussians import PARAM_NAMES, GaussianModel
from scgaussian_tpu_torch.model.matches import MatchBundle
from scgaussian_tpu_torch.parallel import hosts
from scgaussian_tpu_torch.train import optim
from scgaussian_tpu_torch.train.main_stage import StepMetrics, apply_update, make_camera_loss


def make_group(n: Optional[int] = None, device: str | torch.device = "cuda"):
    """The counterpart of `make_mesh(n)`: the group of the D = n ranks. In a
    process group of n ranks that is the default group; a process that is
    alone joins a group of world size 1 over `tcp://127.0.0.1:<free
    port>` (NCCL for a CUDA `device`, gloo on the CPU). Raises when n
    differs from the world size: one rank per device, and every rank takes
    part."""
    if not dist.is_initialized():
        if n not in (None, 1):
            raise ValueError(f"a group of {n} needs {n} processes; this one is alone "
                             "(start them with hosts.initialize_multihost)")
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(hosts.local_device(device, 0))
        dist.init_process_group(hosts.default_backend(device),
                                init_method=f"tcp://127.0.0.1:{hosts.free_port()}",
                                world_size=1, rank=0)
    world = dist.get_world_size()
    if n not in (None, world):
        raise ValueError(f"a group of {n} ranks asked for in a world of {world}")
    return dist.group.WORLD


def broadcast_model(group, model: GaussianModel) -> GaussianModel:
    """Every rank's parameters, buffers and statistics set to the group's
    first rank's, in place, so the replicas start equal (a DP run keeps them equal from
    there: every rank applies the same reduced update)."""
    tensors = [t for _, t in sorted(model.named_parameters())] + [
        t for _, t in sorted(model.named_buffers())]
    shapes = torch.tensor([t.numel() for t in tensors], dtype=torch.int64,
                          device=tensors[0].device)
    peak = shapes.clone()
    dist.all_reduce(peak, dist.ReduceOp.MAX, group=group)
    if not torch.equal(peak, shapes):
        raise RuntimeError("the ranks' models differ in size; they cannot be replicas")
    src = 0 if group in (None, dist.group.WORLD) else dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in tensors:
            if t.dtype == torch.bool:  # not every backend sends bool
                u8 = t.to(torch.uint8)
                dist.broadcast(u8, src=src, group=group)
                t.copy_(u8.to(torch.bool))
            else:
                dist.broadcast(t.data, src=src, group=group)
    return model


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def dp_train_step(
    group,
    model: GaussianModel,
    opt_state: optim.AdamState,
    bundle: MatchBundle,
    cameras: Sequence[Camera],  # D cameras of one size; rank r takes cameras[r]
    gt_images: Sequence[torch.Tensor],  # D x [3, H, W]
    view_idx: Sequence[int],  # D
    iteration: int,  # 1-based like the reference
    bg_color: torch.Tensor,  # [3]
    opt_cfg: OptimizationConfig,
    raster: RasterizerConfig = RasterizerConfig(),
    extras: TrainExtras = TrainExtras(),
    backend: str = "cuda",
    is_dtu: bool = False,
) -> Tuple[GaussianModel, optim.AdamState, StepMetrics]:
    """One data-parallel step over `group` (the JAX `dp_train_step`): rank r
    trains on item r of the D-camera batch, the gradients are the mean over
    the ranks, and one Adam update is applied on every rank. Parameters and
    statistics are updated in place, as `train_step` does; returns (model,
    new Adam state, metrics). The metrics are the same on every rank: loss,
    l1 and match loss are means over the batch, `num_visible` and
    `overflow` maxes (overflow is always 0: nothing is truncated).

    Two collectives per step: one SUM over the gradients, the three losses
    and (while densifying) the densify contributions, one MAX over the
    radii and the visible counts."""
    d = dist.get_world_size(group)
    r = dist.get_rank(group)
    if not (len(cameras) == len(gt_images) == len(view_idx) == d):
        raise ValueError(f"{len(cameras)} cameras, {len(gt_images)} images and "
                         f"{len(view_idx)} views for a group of {d}")
    cam = cameras[r]
    dev = model.zval.device
    offset0 = torch.zeros(model.total, 2, dtype=torch.float32, device=dev, requires_grad=True)
    loss_fn = make_camera_loss(model, bundle, cam, gt_images[r], view_idx[r], bg_color,
                               opt_cfg, raster, extras, backend, is_dtu)
    loss, (out, ll1, mloss) = loss_fn(offset0)
    leaves = [getattr(model, name) for name in PARAM_NAMES]
    grads = torch.autograd.grad(loss, leaves + [offset0], allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves + [offset0], grads)]
    g_params, g_offset = grads[:-1], grads[-1]

    densifying = iteration < opt_cfg.densify_until_iter
    vis = out.radii > 0
    summed = list(g_params) + [torch.stack([loss.detach(), ll1.detach(), mloss.detach()])]
    if densifying:
        scale = torch.tensor([0.5 * cam.width, 0.5 * cam.height], dtype=torch.float32,
                             device=dev)
        norm = torch.linalg.norm(g_offset * scale[None, :], dim=-1, keepdim=True)
        summed += [torch.where(vis[:, None], norm, 0.0), vis[:, None].to(torch.float32)]
    flat = _flat(summed)
    peak = torch.cat([torch.where(vis, out.radii, 0).to(torch.float32),
                      vis.sum().to(torch.float32)[None], out.overflow.to(torch.float32)[None]])
    dist.all_reduce(flat, group=group)
    dist.all_reduce(peak, dist.ReduceOp.MAX, group=group)
    reduced = _unflat(flat, summed)
    g_mean: Dict[str, torch.Tensor] = {
        name: g / d for name, g in zip(PARAM_NAMES, reduced[:len(PARAM_NAMES)])}
    losses = reduced[len(PARAM_NAMES)] / d

    if densifying:
        d_accum, d_denom = reduced[len(PARAM_NAMES) + 1:]
        with torch.no_grad():
            model.xyz_gradient_accum.add_(d_accum)
            model.denom.add_(d_denom)
            model.max_radii2d.copy_(torch.maximum(model.max_radii2d, peak[:model.total]))

    model, opt_state = apply_update(model, opt_state, g_mean, iteration, opt_cfg)
    metrics = StepMetrics(
        loss=losses[0],
        l1=losses[1],
        match_loss=losses[2],
        num_visible=peak[model.total].to(torch.int64),
        overflow=peak[model.total + 1].to(torch.int32),
    )
    return model, opt_state, metrics
