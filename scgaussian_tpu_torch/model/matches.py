"""Match-prior data and the structure-consistency loss on rendered depth.

Port of `scgaussian_tpu/model/matches.py`: `MatchBundle`, the padded
per-ordered-pair match data (one [P = V*(V-1), M] layout instead of the
reference's dict of per-pair tensors, `scene/gaussian_model.py:284-360`),
its host-side construction, the init stage (`init_zvals`,
`matchloss_from_base`, `run_init_stage`, `promote_matches`; `train.py:49-97`,
`scene/gaussian_model.py:175-239, 394-395`) and `matchloss_from_renderdepth`
(`scene/gaussian_model.py:241-282`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from scgaussian_tpu_torch import resolve_device
from scgaussian_tpu_torch.losses.sampling import grid_sample_2d
from scgaussian_tpu_torch.train import optim

_TENSOR_FIELDS = (
    "rays_o", "rays_d", "cam_rays_d", "uv", "color", "mask", "pad_valid", "near_far",
    "src", "dst", "partner", "pairs_of_view", "intr", "w2c",
)


@dataclasses.dataclass(frozen=True)
class MatchBundle:
    """Padded per-ordered-pair match data. Pair p = (src[p] -> dst[p]);
    `partner[p]` is the index of the reversed pair (dst -> src). Row k of
    pair p and row k of its partner are the two endpoints of one match."""

    rays_o: torch.Tensor  # [P, M, 3] world ray origins (camera centers)
    rays_d: torch.Tensor  # [P, M, 3] world unit ray directions
    cam_rays_d: torch.Tensor  # [P, M, 3] ray dirs in the source camera frame
    uv: torch.Tensor  # [P, M, 2] match pixel coords in the source view
    color: torch.Tensor  # [P, M, 3] source image bilinearly warped to uv
    mask: torch.Tensor  # [P, M] warp mask (blender mask; 0 on padding)
    pad_valid: torch.Tensor  # [P, M] bool: True for real (non-padding) matches
    near_far: torch.Tensor  # [P, 2]
    src: torch.Tensor  # [P] int64
    dst: torch.Tensor  # [P] int64
    partner: torch.Tensor  # [P] int64
    pairs_of_view: torch.Tensor  # [V, V-1] int64: ordered pairs with src == v
    intr: torch.Tensor  # [V, 3, 3]
    w2c: torch.Tensor  # [V, 4, 4]
    width: int
    height: int

    @property
    def num_pairs(self) -> int:
        return self.rays_o.shape[0]

    @property
    def matches_per_pair(self) -> int:
        return self.rays_o.shape[1]

    def to(self, device: str | torch.device) -> "MatchBundle":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _TENSOR_FIELDS}
        )


def bundle_from_numpy(
    fields: Mapping[str, np.ndarray | int],
    device: str | torch.device | None = None,
) -> MatchBundle:
    """A bundle from numpy arrays named as `MatchBundle`'s fields (plus
    `width` and `height`), e.g. a JAX bundle carried across with
    `np.asarray`. Runs on `device` (default: the GPU)."""
    dev = resolve_device(device)
    missing = [f for f in _TENSOR_FIELDS + ("width", "height") if f not in fields]
    if missing:
        raise ValueError(f"missing bundle fields: {missing}")
    tensors = {}
    for f in _TENSOR_FIELDS:
        a = np.asarray(fields[f])
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        elif a.dtype.kind == "f":
            a = a.astype(np.float32)
        tensors[f] = torch.tensor(a, device=dev)
    return MatchBundle(**tensors, width=int(fields["width"]), height=int(fields["height"]))


def build_match_bundle(
    images: List[np.ndarray],  # V x [H, W, 3] float in [0, 1]
    intrs: List[np.ndarray],  # V x [3, 3]
    w2cs: List[np.ndarray],  # V x [4, 4]
    near_fars: List[np.ndarray],  # V x [2]
    match_pixels: Dict[Tuple[int, int], np.ndarray],  # (i, j) -> [m, 2] in [0,1]
    blender_masks: List[np.ndarray] | None = None,  # V x [H, W] or None
    device: str | torch.device | None = None,
) -> MatchBundle:
    """Host-side construction, mirroring `create_from_mono`
    (`scene/gaussian_model.py:284-360`): normalized match pixels -> pixel
    rays via K^-1 then rotation by w2c^-1; colors/masks warped by bilinear
    grid_sample (on the CPU); matches padded to the per-pair maximum. The
    result is moved to `device` (default: the GPU)."""
    V = len(images)
    H, W = images[0].shape[:2]
    pairs = [(i, j) for i in range(V) for j in range(V) if j != i]
    pair_index = {p: k for k, p in enumerate(pairs)}
    M = max(1, max(m.shape[0] for m in match_pixels.values()))

    P = len(pairs)
    rays_o = np.zeros((P, M, 3), np.float32)
    rays_d = np.zeros((P, M, 3), np.float32)
    cam_rays_d = np.zeros((P, M, 3), np.float32)
    uv = np.zeros((P, M, 2), np.float32)
    color = np.zeros((P, M, 3), np.float32)
    mask = np.zeros((P, M), np.float32)
    pad_valid = np.zeros((P, M), bool)
    near_far = np.zeros((P, 2), np.float32)

    for k, (i, j) in enumerate(pairs):
        mp = match_pixels[(i, j)].astype(np.float32)  # [m, 2] normalized
        m = mp.shape[0]
        px = mp[:, 0] * W
        py = mp[:, 1] * H
        uv[k, :m] = np.stack([px, py], axis=-1)

        img = torch.tensor(np.ascontiguousarray(images[i].transpose(2, 0, 1)), dtype=torch.float32)
        grid = torch.tensor(mp * 2.0 - 1.0)
        color[k, :m] = grid_sample_2d(img, grid).numpy().T

        if blender_masks is not None and blender_masks[i] is not None:
            bm = torch.tensor(np.asarray(blender_masks[i])[None], dtype=torch.float32)
            warp_m = grid_sample_2d(bm, grid).numpy()[0]
        else:
            warp_m = np.ones((m,), np.float32)
        mask[k, :m] = warp_m
        pad_valid[k, :m] = True

        K = intrs[i]
        w2c = w2cs[i]
        c2w = np.linalg.inv(w2c)
        homo = np.stack([px, py, np.ones_like(px)], axis=-1)  # [m, 3]
        p_cam = homo @ np.linalg.inv(K).T
        d_cam = p_cam / (np.linalg.norm(p_cam, axis=-1, keepdims=True) + 1e-8)
        d_world = d_cam @ c2w[:3, :3].T
        rays_d[k, :m] = d_world
        rays_o[k, :m] = c2w[:3, 3][None, :]
        cam_rays_d[k, :m] = d_world @ w2c[:3, :3].T
        near_far[k] = near_fars[i]

    fields = dict(
        rays_o=rays_o, rays_d=rays_d, cam_rays_d=cam_rays_d, uv=uv, color=color,
        mask=mask, pad_valid=pad_valid, near_far=near_far,
        src=np.array([i for (i, j) in pairs]),
        dst=np.array([j for (i, j) in pairs]),
        partner=np.array([pair_index[(j, i)] for (i, j) in pairs]),
        pairs_of_view=np.array(
            [[pair_index[(i, j)] for j in range(V) if j != i] for i in range(V)]
        ),
        intr=np.stack(intrs), w2c=np.stack(w2cs), width=W, height=H,
    )
    return bundle_from_numpy(fields, device)


def init_zvals(bundle: MatchBundle, generator: torch.Generator) -> torch.Tensor:
    """z ~ U(near, far) per match (`scene/gaussian_model.py:339-340`), [P, M]
    on the bundle's device, drawn from `generator` (on that device)."""
    P, M = bundle.mask.shape
    u = torch.rand(P, M, generator=generator, device=bundle.mask.device)
    near = bundle.near_far[:, 0:1]
    far = bundle.near_far[:, 1:2]
    return u * (far - near) + near


def _project_to_view(bundle: MatchBundle, world_pts: torch.Tensor, view: torch.Tensor):
    """world_pts [..., M, 3] -> pixel xy + depth in `view` (w2c then K), in
    full fp32 (TF32 is off package-wide)."""
    w2c = bundle.w2c[view]  # [..., 4, 4]
    K = bundle.intr[view]
    cam = torch.einsum("...ij,...mj->...mi", w2c[..., :3, :3], world_pts) + w2c[..., None, :3, 3]
    xyz = torch.einsum("...ij,...mj->...mi", K, cam)
    xy = xyz[..., :2] / (xyz[..., 2:3] + 1e-8)
    return xy, xyz[..., 2]


def matchloss_from_renderdepth(
    bundle: MatchBundle, view: int | torch.Tensor, depth_map: torch.Tensor
) -> torch.Tensor:
    """Structure-consistency loss on rendered depth.

    Matches `get_matchloss_from_renderdepth` (`scene/gaussian_model.py:
    241-282`): bilinearly sample the rendered depth of `view` at its match
    UVs, lift to 3D along the stored rays (z = depth / cam_ray_z), reproject
    into each partner view, L1 to the partner UVs (normalized), averaged
    over in-bounds & mask-valid matches, summed over this view's pairs.

    depth_map: [1, H, W] (rasterizer depth output).
    """
    pair_ids = bundle.pairs_of_view[view]  # [V-1]
    uv = bundle.uv[pair_ids]  # [V-1, M, 2]
    wh = torch.tensor([bundle.width, bundle.height], dtype=torch.float32, device=uv.device)

    norm = uv / wh * 2.0 - 1.0
    d = grid_sample_2d(depth_map, norm.reshape(-1, 2))[0].reshape(uv.shape[:2])  # [V-1, M]

    # safe divide: padded rows have zero rays; they carry zero weight below,
    # but inf/NaN would still poison gradients through the masked product.
    czd = bundle.cam_rays_d[pair_ids][..., 2]
    z = d / torch.where(torch.abs(czd) > 1e-8, czd, torch.ones_like(czd))
    world = bundle.rays_o[pair_ids] + bundle.rays_d[pair_ids] * z[..., None]

    xy, _ = _project_to_view(bundle, world, bundle.dst[pair_ids])
    in_bounds = (
        (xy[..., 0] > 0)
        & (xy[..., 0] < bundle.width)
        & (xy[..., 1] > 0)
        & (xy[..., 1] < bundle.height)
    )
    partners = bundle.partner[pair_ids]
    err = torch.mean(torch.abs(xy - bundle.uv[partners]) / wh, dim=-1)  # [V-1, M]

    valid = (bundle.mask[pair_ids] * bundle.mask[partners]) > 0
    w = (in_bounds & valid).to(torch.float32)
    per_pair = torch.sum(err * w, dim=1) / (torch.sum(w, dim=1) + 1e-8)
    return torch.sum(per_pair)


def matchloss_from_base(
    zvals: torch.Tensor, bundle: MatchBundle
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric cross-view reprojection error of matched ray points.

    Matches `get_matchloss_from_base` (`scene/gaussian_model.py:175-239`):
    per ordered pair, lift matched rays at current z, project into the
    partner view, compare to the partner's match UVs normalized by (W, H);
    the loss sums the masked means of both directions of every unordered
    pair == the masked mean over every ordered pair.

    Returns (total_loss, per_match_error [P, M])."""
    world = bundle.rays_o + bundle.rays_d * zvals[..., None]  # [P, M, 3]
    xy, _ = _project_to_view(bundle, world, bundle.dst)
    uv_partner = bundle.uv[bundle.partner]  # [P, M, 2]
    wh = torch.tensor([bundle.width, bundle.height], dtype=torch.float32, device=xy.device)
    err = torch.mean(torch.abs(xy - uv_partner) / wh, dim=-1)  # [P, M]

    valid = (bundle.mask * bundle.mask[bundle.partner]) > 0
    num = torch.sum(torch.where(valid, err, 0.0), dim=1)
    den = torch.clamp(torch.sum(valid, dim=1), min=1)
    return torch.sum(num / den), err


@dataclasses.dataclass(frozen=True)
class InitStageResult:
    best_z: torch.Tensor  # [P, M]
    min_err: torch.Tensor  # [P, M]
    final_loss: torch.Tensor  # []


def run_init_stage(
    bundle: MatchBundle,
    z0: torch.Tensor,
    iterations: int = 2000,
    base_lr: float = 0.5,
    lr_drop_iters: Sequence[int] = (500, 1000, 1500),
    loss_scale: float = 5.0,
) -> InitStageResult:
    """The match-prior z optimization (`train.py:49-97`), a Python loop in
    place of JAX's scan: Adam with torch semantics (eps 1e-15, lr 0.5
    halved at 500/1000/1500) on loss = 5 * matchloss, with each match's best
    z tracked under the running minimum reprojection error *before* each
    step (replaced only where the error is strictly lower). `final_loss` is
    the last iteration's loss, before its step."""
    z = z0.detach().to(torch.float32)
    state = optim.init({"z": z})
    best_z = z.clone()
    min_err = torch.full_like(z, float("inf"))
    loss = torch.zeros((), dtype=torch.float32, device=z.device)
    for it in range(iterations):
        zz = z.detach().requires_grad_()
        with torch.enable_grad():
            loss, err = matchloss_from_base(zz, bundle)
            loss = loss_scale * loss
            (g,) = torch.autograd.grad(loss, zz)
        with torch.no_grad():
            err = err.detach()
            better = err < min_err
            best_z = torch.where(better, z, best_z)
            min_err = torch.where(better, err, min_err)
            lr = base_lr * 0.5 ** sum(it >= d for d in lr_drop_iters)
            new, state = optim.apply({"z": z}, {"z": g}, state, {"z": lr})
            z = new["z"]
    return InitStageResult(best_z=best_z, min_err=min_err, final_loss=loss.detach())


def promote_matches(
    bundle: MatchBundle,
    best_z: torch.Tensor | np.ndarray,
    min_err: torch.Tensor | np.ndarray,
    err_threshold: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Select converged matches as ray-Gaussian seeds (host side, once).

    Matches `create_from_pcd`'s vmask filter (`scene/gaussian_model.py:
    394-395`): keep matches whose best reprojection error < 0.1 (the warp
    mask is NOT part of the filter in the reference, only padding is
    excluded), concatenated in ordered-pair order.
    Returns (rayo, rayd, zval, color) numpy arrays."""

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    sel = ((host(min_err) < err_threshold) & host(bundle.pad_valid)).reshape(-1)
    rayo = host(bundle.rays_o).reshape(-1, 3)[sel]
    rayd = host(bundle.rays_d).reshape(-1, 3)[sel]
    z = host(best_z).reshape(-1)[sel]
    color = host(bundle.color).reshape(-1, 3)[sel]
    return rayo, rayd, z, color
