"""Auxiliary depth-regularization losses from the reference's loss library.

Port of `scgaussian_tpu/losses/aux.py`. The reference ships (but never
wires into training) an edge-aware smoothness loss, patch-normalized depth
losses and a virtual-view warp-consistency loss
(`utils/loss_utils.py:19-38,96-159,208-246`). They keep the JAX package's
forms: masked means instead of boolean indexing, `F.unfold` with stride ==
kernel as a reshape/transpose, and `ranking_loss`'s draw from an explicit
`torch.Generator` (or injected indices) instead of `random.sample`. All
are differentiable by autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from scgaussian_tpu_torch.losses.image import avgpool_ssim_map
from scgaussian_tpu_torch.losses.sampling import grid_sample_2d


def get_smooth_loss(depth: torch.Tensor, guide: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Edge-aware first-order depth smoothness (`utils/loss_utils.py:19-38`).

    Args:
      depth: [H, W].
      guide: optional [H, W] or [C, H, W] guidance image; depth gradients are
        attenuated by exp(-|grad(guide)|).
    """
    gx = torch.abs(depth[:, :-1] - depth[:, 1:])
    gy = torch.abs(depth[:-1, :] - depth[1:, :])
    if guide is None:
        return torch.mean(gx) + torch.mean(gy)
    if guide.dim() == 3:
        ix = torch.mean(torch.abs(guide[:, :, :-1] - guide[:, :, 1:]), dim=0)
        iy = torch.mean(torch.abs(guide[:, :-1, :] - guide[:, 1:, :]), dim=0)
    else:
        ix = torch.abs(guide[:, :-1] - guide[:, 1:])
        iy = torch.abs(guide[:-1, :] - guide[1:, :])
    return torch.mean(gx * torch.exp(-ix)) + torch.mean(gy * torch.exp(-iy))


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, 1, H, W] -> [B * (H/p) * (W/p), p*p] non-overlapping patches.

    Matches `F.unfold(kernel_size=p, stride=p)` + permute/view
    (`utils/loss_utils.py:110-112`): patches enumerate row-major over the
    patch grid; elements within a patch are row-major.
    """
    b, c, h, w = x.shape
    if c != 1:
        raise ValueError("reference patchify is single-channel")
    p = patch_size
    x = x[:, 0, : h - h % p, : w - w % p]
    x = x.reshape(b, h // p, p, w // p, p)
    return x.permute(0, 1, 3, 2, 4).reshape(-1, p * p)


def _normalize_patches(x: torch.Tensor) -> torch.Tensor:
    """Per-patch standardization with a global-std floor
    (`utils/loss_utils.py:105-108`); std is the unbiased (ddof=1) torch.std."""
    mean = torch.mean(x, dim=1, keepdim=True)
    std = torch.std(x, dim=1, keepdim=True)
    return (x - mean) / (std + 1e-2 * torch.std(x.reshape(-1)))


def margin_l2_loss(
    output: torch.Tensor,
    gt: torch.Tensor,
    patch_mask: torch.Tensor,
    margin: float,
    return_mask: bool = False,
):
    """Squared error over elements of selected patches whose |error| exceeds
    `margin` (`utils/loss_utils.py:96-103`), as a masked mean."""
    err = output - gt
    sel = patch_mask[:, None] & (torch.abs(err) > margin)
    w = sel.to(err.dtype)
    loss = torch.sum(err * err * w) / torch.clamp(torch.sum(w), min=1.0)
    if return_mask:
        return loss, sel
    return loss


def patch_norm_mse_loss(
    input_depth: torch.Tensor,
    target_depth: torch.Tensor,
    fore_mask: torch.Tensor,
    patch_size: int,
    margin: float = 0.2,
    return_mask: bool = False,
):
    """Patch-normalized depth MSE on mostly-foreground patches
    (`utils/loss_utils.py:114-118`). Inputs are [B, 1, H, W]; a patch
    participates iff fewer than p*p/3 of its pixels are masked."""
    ip = _normalize_patches(patchify(input_depth, patch_size))
    tp = _normalize_patches(patchify(target_depth, patch_size))
    mask_patches = (
        torch.sum(patchify(fore_mask, patch_size), dim=1) < patch_size * patch_size / 3
    )
    return margin_l2_loss(ip, tp, mask_patches, margin, return_mask)


def ranking_loss(
    input_depth: torch.Tensor,
    target_depth: torch.Tensor,
    patch_size: int,
    margin: float = 1e-4,
    generator: Optional[torch.Generator] = None,
    sample_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Depth-ordering hinge on random pixel pairs within each patch
    (`utils/loss_utils.py:121-140`): sample 6 distinct in-patch positions
    forming 3 pairs; penalize pairs whose predicted ordering disagrees with
    the target (hinge at `margin`). The reference draws the indices with
    `random.sample`; pass a `generator` on the input's device (or explicit
    `sample_idx` [6]) instead."""
    ip = patchify(input_depth, patch_size)
    tp = patchify(target_depth, patch_size)
    if sample_idx is None:
        if generator is None:
            raise ValueError("ranking_loss needs a generator or sample_idx")
        sample_idx = torch.randperm(ip.shape[1], generator=generator,
                                    device=ip.device)[:6]
    sample_idx = torch.as_tensor(sample_idx, device=ip.device)
    ipx = ip[:, sample_idx].reshape(-1, 2)
    tpx = tp[:, sample_idx].reshape(-1, 2)
    g = tpx[:, 0] - tpx[:, 1]
    t = ipx[:, 0] - ipx[:, 1]
    t = torch.where(g < 0, t, -t) + margin
    pos = (t > 0).to(t.dtype)
    return torch.sum(t * pos) / torch.clamp(torch.sum(pos), min=1.0)


def cons_loss(
    input_depth: torch.Tensor,
    target_depth: torch.Tensor,
    patch_size: int,
    margin: float = 1e-4,
) -> torch.Tensor:
    """Local depth-consistency hinge (`utils/loss_utils.py:142-159`): for each
    pixel, its 2 nearest neighbours *in target-depth value* within the patch
    must stay within `margin` in predicted depth (only when the target gap
    itself is < 0.01).

    Reference quirk kept: the diagonal mask there is dead code
    (`tmp[tmp1>1] = 1e5` with `tmp1` a 0/1 identity — `>1` never holds), so
    each pixel's own zero distance IS eligible as a "nearest neighbour".
    The sort is stable, as JAX's `argsort` is, so ties order alike."""
    ip = patchify(input_depth, patch_size)
    tp = patchify(target_depth, patch_size)
    tmp = torch.abs(tp[:, :, None] - tp[:, None, :])
    order = torch.argsort(tmp, dim=-1, stable=True)[:, :, :2]
    tmp_t = torch.take_along_dim(tmp, order, dim=-1)
    t = torch.abs(ip[:, :, None] - ip[:, None, :])
    t = torch.take_along_dim(t, order, dim=-1) - margin
    sel = ((t > 0) & (tmp_t < 0.01)).to(t.dtype)
    return torch.sum(t * sel) / torch.clamp(torch.sum(sel), min=1.0)


def get_virtual_warp_loss(
    virtual_img: torch.Tensor,  # [3, H, W] render from the virtual pose
    virtual_depth: torch.Tensor,  # [H, W] (or [1, H, W]) rendered depth
    vir_c2w: torch.Tensor,  # [3, 4] or [4, 4] virtual camera-to-world
    intrs: torch.Tensor,  # [V, 4, 4] (or [V, 3, 3]) train intrinsics
    w2cs: torch.Tensor,  # [V, 4, 4] train world-to-camera
    img_colors: torch.Tensor,  # [V, 3, H, W] train images
    vir_mask: torch.Tensor,  # [H, W] (or [1, H, W]) validity mask
) -> torch.Tensor:
    """Virtual-view warp consistency (`utils/loss_utils.py:208-246`):
    back-project the virtual render's depth, reproject into every training
    view, warp the training images to the virtual view, and take the
    per-pixel minimum avgpool-SSIM error across views (out-of-frustum
    pixels excluded; fully-invisible or masked pixels contribute 0). The
    reference computes an L1 map too but discards it — replicated by
    omission."""
    _, h, w = virtual_img.shape
    depth = virtual_depth.reshape(-1)
    mask0 = vir_mask.reshape(h, w)
    dev, dt = depth.device, depth.dtype

    py, px = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    pix = torch.stack([px.reshape(-1).to(dt), py.reshape(-1).to(dt),
                       torch.ones(h * w, dtype=dt, device=dev)])  # [3, P]
    K0 = intrs[0][:3, :3]
    cam_pts = torch.linalg.inv(K0) @ (pix * depth[None])
    c2w = torch.eye(4, dtype=dt, device=dev)
    c2w[:3, :4] = torch.as_tensor(vir_c2w, dtype=dt, device=dev)[:3, :4]
    world = c2w @ torch.cat([cam_pts, torch.ones_like(cam_pts[:1])])  # [4, P]

    errs = []
    for w2c, K, colors in zip(w2cs, intrs, img_colors):
        cam = (w2c @ world)[:3]
        xyz = K[:3, :3] @ cam
        xy = xyz[:2] / (xyz[2:] + 1e-8)
        nx = 2.0 * xy[0] / (w - 1) - 1.0
        ny = 2.0 * xy[1] / (h - 1) - 1.0
        in_bounds = (torch.abs(nx) <= 1.0) & (torch.abs(ny) <= 1.0)
        warp = grid_sample_2d(colors, torch.stack([nx, ny], dim=-1)).reshape(3, h, w)
        err = torch.mean(avgpool_ssim_map(virtual_img, warp), dim=0)
        errs.append(torch.where(in_bounds.reshape(h, w), err, 1000.0))
    best = torch.amin(torch.stack(errs), dim=0)  # [H, W]
    best = torch.where((best >= 1000.0) | ~mask0.to(torch.bool), 0.0, best)
    return torch.mean(best)
