"""Multi-view depth reprojection consistency filter (geo_check).

Port of `scgaussian_tpu/eval/geo_check.py` (reference
`utils/geo_check.py:33-127`: dead code upstream, but part of its utility
surface and the spec of depth-consistency filtering). The JAX package
vmaps one pairwise kernel over (ref, src) pairs; here each reference view
takes one batched pass over its sources (`torch.func.vmap` over the source
axis). Bilinear sampling is the port's `bilinear_sample_pix` (zero border,
cv2.remap's INTER_LINEAR).

Reference quirks kept:
- the `extrinsics` argument is *named* c2ws upstream but used as
  world->camera maps (`xyz_src = E_src @ inv(E_ref) @ xyz_ref`);
- with fewer than `num_select+1` cameras the pair table simply truncates,
  so a view's own index can appear among its "sources" (argsort of the
  1e3-filled diagonal);
- the averaged depth divides by (#consistent + 1) counting the reference
  view itself, and the final mask needs strictly more than `view_thresh`
  consistent sources.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from scgaussian_tpu_torch import resolve_device
from scgaussian_tpu_torch.losses.sampling import bilinear_sample_pix


def get_pairs(extrinsics: np.ndarray, num_select: int = 10) -> np.ndarray:
    """Nearest cameras by translation distance (`utils/geo_check.py:25-31`);
    the diagonal is pushed to 1e3 so self sorts (almost) last."""
    t = extrinsics[:, :3, 3]
    dists = np.linalg.norm(t[:, None] - t[None, :], axis=-1)
    dists[np.eye(dists.shape[0]) > 0] = 1e3
    return np.argsort(dists, axis=1)[:, :num_select]


def _pixel_grid(h: int, w: int, like: torch.Tensor):
    yy, xx = torch.meshgrid(torch.arange(h, device=like.device),
                            torch.arange(w, device=like.device), indexing="ij")
    return yy, xx


def _inv(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a small matrix, taken in float64 and rounded once to the
    input's dtype, so that the card's and the CPU's solvers agree bitwise."""
    return torch.linalg.inv(m.to(torch.float64)).to(m.dtype)


def _mul_inv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a @ inv(b)` for 4×4 maps, in float64, rounded once (as `_inv`)."""
    return (a.to(torch.float64) @ torch.linalg.inv(b.to(torch.float64))).to(a.dtype)


def _mm(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """`m @ v` for a small matrix m [R, C] and rows v [C, P], or m [R, C + 1]
    and v taken as homogeneous (a last row of ones), as sums of products
    in a fixed order, one rounding per operation. A BLAS call orders and
    fuses its multiply-adds differently on the card and on the CPU, and
    geocheck's strict thresholds turn such last-bit differences into
    different masks."""
    rows = []
    for r in range(m.shape[0]):
        acc = m[r, 0] * v[0]
        for c in range(1, v.shape[0]):
            acc = acc + m[r, c] * v[c]
        if m.shape[1] > v.shape[0]:
            acc = acc + m[r, v.shape[0]]
        rows.append(acc)
    return torch.stack(rows)


def reproject_with_depth(
    depth_ref: torch.Tensor,  # [H, W]
    intr_ref: torch.Tensor,  # [3, 3] (or [4, 4])
    extr_ref: torch.Tensor,  # [4, 4] world->cam
    depth_src: torch.Tensor,
    intr_src: torch.Tensor,
    extr_src: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project ref pixels into src with ref depth, resample src depth there,
    and project back (`utils/geo_check.py:91-127`). Returns
    (depth_reprojected, x2d_reprojected, y2d_reprojected, x2d_src, y2d_src),
    each [H, W]. The 3×3 and 4×4 products and inverses are taken in float64;
    the per-pixel work is elementwise (`_mm`), so the card gives the CPU's
    bits."""
    h, w = depth_ref.shape
    K_ref = intr_ref[:3, :3]
    K_src = intr_src[:3, :3]

    yy, xx = _pixel_grid(h, w, depth_ref)
    pix = torch.stack(
        [xx.reshape(-1), yy.reshape(-1), torch.ones(h * w, device=depth_ref.device)],
    ).to(depth_ref.dtype)  # [3, P]

    xyz_ref = _mm(_inv(K_ref), pix * depth_ref.reshape(1, -1))
    ref_to_src = _mul_inv(extr_src, extr_ref)
    xyz_src = _mm(ref_to_src[:3], xyz_ref)
    K_xyz_src = _mm(K_src, xyz_src)
    xy_src = K_xyz_src[:2] / K_xyz_src[2:3]

    sampled = bilinear_sample_pix(depth_src[None], xy_src[0], xy_src[1])[0]

    xyz_src2 = _mm(_inv(K_src), torch.cat([xy_src, torch.ones_like(xy_src[:1])]) * sampled[None])
    src_to_ref = _mul_inv(extr_ref, extr_src)
    xyz_rep = _mm(src_to_ref[:3], xyz_src2)
    depth_rep = xyz_rep[2].reshape(h, w)
    K_xyz_rep = _mm(K_ref, xyz_rep)
    xy_rep = K_xyz_rep[:2] / K_xyz_rep[2:3]
    return (
        depth_rep,
        xy_rep[0].reshape(h, w),
        xy_rep[1].reshape(h, w),
        xy_src[0].reshape(h, w),
        xy_src[1].reshape(h, w),
    )


def _pairwise_consistency(depth_ref, intr_ref, extr_ref, depth_src, intr_src, extr_src,
                          dist_thresh: float, depth_thresh: float):
    h, w = depth_ref.shape
    yy, xx = _pixel_grid(h, w, depth_ref)
    depth_rep, x_rep, y_rep, _, _ = reproject_with_depth(
        depth_ref, intr_ref, extr_ref, depth_src, intr_src, extr_src
    )
    dx, dy = x_rep - xx, y_rep - yy
    dist = torch.sqrt(dx * dx + dy * dy)
    rel = torch.abs(depth_rep - depth_ref) / depth_ref
    mask = (dist < dist_thresh) & (rel < depth_thresh)
    return torch.where(mask, depth_rep, 0.0), mask


def geocheck(
    intrs: np.ndarray,  # [V, 3, 3] or [V, 4, 4]
    extrinsics: np.ndarray,  # [V, 4, 4] world->cam (named c2ws upstream)
    depths: np.ndarray,  # [V, H, W]
    dist_thresh: float = 1.0,
    depth_thresh: float = 0.01,
    view_thresh: int = 5,
    num_select: int = 15,
    device: str | torch.device | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Geometric consistency fusion (`utils/geo_check.py:33-88`) on `device`
    (default: the GPU): a ref pixel is kept iff > `view_thresh` source views
    agree (reprojection < 1 px and relative depth gap < 1%); kept depths
    are averaged over agreeing views plus the reference. Returns
    (filtered_depths [V,H,W], masks [V,H,W]) as numpy arrays."""
    dev = resolve_device(device)
    intrs_t = torch.as_tensor(np.asarray(intrs, np.float32), device=dev)
    extrs_t = torch.as_tensor(np.asarray(extrinsics, np.float32), device=dev)
    depths_t = torch.as_tensor(np.asarray(depths, np.float32), device=dev)
    pairs = get_pairs(np.asarray(extrinsics), num_select)

    def pair(depth_ref, intr_ref, extr_ref, depth_src, intr_src, extr_src):
        return _pairwise_consistency(depth_ref, intr_ref, extr_ref, depth_src, intr_src,
                                     extr_src, dist_thresh, depth_thresh)

    over_sources = torch.func.vmap(pair, in_dims=(None, None, None, 0, 0, 0))

    out_depths, out_masks = [], []
    for i in range(depths_t.shape[0]):
        src = torch.as_tensor(pairs[i], device=dev)
        rep, masks = over_sources(depths_t[i], intrs_t[i], extrs_t[i],
                                  depths_t[src], intrs_t[src], extrs_t[src])
        count = torch.sum(masks.to(torch.int32), dim=0)
        avg = (torch.sum(rep, dim=0) + depths_t[i]) / (count + 1)
        final_mask = count > view_thresh
        out_depths.append((avg * final_mask.to(torch.float32)).cpu().numpy())
        out_masks.append(final_mask.cpu().numpy())
    return np.stack(out_depths), np.stack(out_masks).astype(np.float32)


def visualize_depth(depth: np.ndarray, minmax=None):
    """JET-colormapped depth PIL image (`utils/geo_check.py:7-22`)."""
    import cv2
    from PIL import Image

    x = np.nan_to_num(np.asarray(depth))
    if minmax is None:
        mi = np.min(x[x > 0]) if np.any(x > 0) else 0.0
        ma = np.max(x)
    else:
        mi, ma = minmax
    x = (x - mi) / (ma - mi + 1e-8)
    x = (255 * x).astype(np.uint8)
    return Image.fromarray(cv2.applyColorMap(x, cv2.COLORMAP_JET))
