"""Match-prior data and the structure-consistency loss on rendered depth.

Port of the parts of `scgaussian_tpu/model/matches.py` that the main-stage
training step uses (26-142, 154-166, 195-236): `MatchBundle`, the padded
per-ordered-pair match data (one [P = V*(V-1), M] layout instead of the
reference's dict of per-pair tensors, `scene/gaussian_model.py:284-360`),
its host-side construction, and `matchloss_from_renderdepth`
(`scene/gaussian_model.py:241-282`). `init_zvals`, `matchloss_from_base`,
the init stage and `promote_matches` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from scgaussian_tpu_torch import resolve_device
from scgaussian_tpu_torch.losses.sampling import grid_sample_2d

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
