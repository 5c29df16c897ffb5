"""EWA projection of 3D Gaussians to screen space (torch ops, autograd).

Port of `scgaussian_tpu/renderer/project.py`, i.e. the semantics of the CUDA
`preprocessCUDA` stage of diff_gaussian_rasterization: near cull at view
z <= 0.2, 3D covariance from quaternion+scale, EWA 2D projection
`Sigma' = J W Sigma W^T J^T` with the 0.3-pixel low-pass dilation, conic +
3-sigma integer radius, NDC->pixel mapping and clamped SH->RGB. Culled
Gaussians are masked (radius 0), not dropped, so every field stays [N].
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from scgaussian_tpu_torch.core import sh as sh_lib
from scgaussian_tpu_torch.core.cameras import Camera
from scgaussian_tpu_torch.utils.profiling import span

NEAR_CULL_Z = 0.2  # CUDA in_frustum near cull


@dataclasses.dataclass(frozen=True)
class ProjectedGaussians:
    """Screen-space per-Gaussian attributes (all [N, ...])."""

    mean2d: torch.Tensor  # [N, 2] pixel coords (ndc2Pix convention)
    depth: torch.Tensor  # [N] view-space z
    conic: torch.Tensor  # [N, 3] inverse 2D covariance (a, b, c) packed
    color: torch.Tensor  # [N, 3] RGB from SH (or precomputed)
    opacity: torch.Tensor  # [N] activated opacity in [0, 1]
    radius: torch.Tensor  # [N] int32 pixel radius (0 => culled)
    valid: torch.Tensor  # [N] bool (radius > 0)
    ext: torch.Tensor  # [N, 2] int32 per-axis binning half-extents (<= radius)


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    """CUDA ndc2Pix: ((v + 1) * S - 1) * 0.5."""
    return ((v + 1.0) * size - 1.0) * 0.5


@span("project.cov3d")
def compute_cov3d(
    scaling: torch.Tensor, rotation: torch.Tensor, scaling_modifier: float = 1.0
) -> torch.Tensor:
    """[N,3] activated scales + [N,4] quats -> packed [N,6] 3D covariance,
    Sigma_ab = sum_j s_j^2 R_aj R_bj written out elementwise in the JAX
    package's order (`build_covariance_from_scaling_rotation`,
    `scene/gaussian_model.py:37-41`)."""
    q = rotation / torch.linalg.norm(rotation, dim=-1, keepdim=True)
    r, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - r * z)
    r02 = 2 * (x * z + r * y)
    r10 = 2 * (x * y + r * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - r * x)
    r20 = 2 * (x * z - r * y)
    r21 = 2 * (y * z + r * x)
    r22 = 1 - 2 * (x * x + y * y)
    s = scaling_modifier * scaling
    s0, s1, s2 = s[:, 0] ** 2, s[:, 1] ** 2, s[:, 2] ** 2
    xx = s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02
    xy = s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12
    xz = s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22
    yy = s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12
    yz = s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22
    zz = s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22
    return torch.stack([xx, xy, xz, yy, yz, zz], dim=-1)


def compute_cov2d(
    means3d: torch.Tensor,
    cov3d_packed: torch.Tensor,
    world_view: torch.Tensor,
    focal_x: torch.Tensor,
    focal_y: torch.Tensor,
    tanfovx: torch.Tensor,
    tanfovy: torch.Tensor,
) -> torch.Tensor:
    """EWA 2D covariance (a, b, c) with the 0.3 low-pass dilation. Mirrors
    CUDA computeCov2D: the view-space point is clamped to 1.3x the frustum
    tangent before the Jacobian is built."""
    R = world_view[:3, :3]
    t = (
        means3d[:, 0:1] * R[None, :, 0]
        + means3d[:, 1:2] * R[None, :, 1]
        + means3d[:, 2:3] * R[None, :, 2]
        + world_view[None, :3, 3]
    )
    # points at/behind the camera (e.g. dead capacity slots) are culled by
    # the near test, but 1/tz must stay finite for the backward
    tz_raw = t[:, 2]
    tz = torch.where(torch.abs(tz_raw) < 1e-6, torch.full_like(tz_raw, 1e-6), tz_raw)
    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    tx = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[:, 1] / tz, -limy, limy) * tz

    # J = [[fx/tz, 0, -fx*tx/tz^2], [0, fy/tz, -fy*ty/tz^2]]
    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    j00 = focal_x * inv_tz
    j02 = -focal_x * tx * inv_tz2
    j11 = focal_y * inv_tz
    j12 = -focal_y * ty * inv_tz2

    # M = J @ R (rows of the 2x3 screen Jacobian in world coords)
    m0 = j00[:, None] * R[0] + j02[:, None] * R[2]  # [N, 3]
    m1 = j11[:, None] * R[1] + j12[:, None] * R[2]  # [N, 3]

    vxx, vxy, vxz = cov3d_packed[:, 0], cov3d_packed[:, 1], cov3d_packed[:, 2]
    vyy, vyz, vzz = cov3d_packed[:, 3], cov3d_packed[:, 4], cov3d_packed[:, 5]

    def quad(u, w):  # u^T V w for [N, 3] vectors u, w
        return (
            vxx * u[:, 0] * w[:, 0]
            + vyy * u[:, 1] * w[:, 1]
            + vzz * u[:, 2] * w[:, 2]
            + vxy * (u[:, 0] * w[:, 1] + u[:, 1] * w[:, 0])
            + vxz * (u[:, 0] * w[:, 2] + u[:, 2] * w[:, 0])
            + vyz * (u[:, 1] * w[:, 2] + u[:, 2] * w[:, 1])
        )

    a = quad(m0, m0) + 0.3
    b = quad(m0, m1)
    c = quad(m1, m1) + 0.3
    return torch.stack([a, b, c], dim=-1)


@span("project.color")
def sh_to_color(
    shs: torch.Tensor,
    means3d: torch.Tensor,
    campos: torch.Tensor,
    active_sh_degree: int,
) -> torch.Tensor:
    """Clamped SH->RGB per Gaussian, max(eval_sh + 0.5, 0), with the view
    direction from the camera (CUDA computeColorFromSH).

    Args:
      shs: [N, K, 3] coefficient-major features (reference `get_features`
        layout, `scene/gaussian_model.py:134-142`).
    """
    dirs = means3d - campos[None, :]
    # safe normalize: a Gaussian exactly at the camera center (a dead slot
    # parked at the origin) must not produce NaNs forward or backward
    dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-12)
    k = sh_lib.num_sh_coeffs(active_sh_degree)
    basis = sh_lib.eval_sh_basis(active_sh_degree, dirs)  # [N, k]
    rgb = torch.sum(basis[:, :, None] * shs[:, :k, :], dim=1) + 0.5
    return torch.clamp(rgb, min=0.0)


@span("render.project")
def project(
    camera: Camera,
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    scales: Optional[torch.Tensor] = None,
    rotations: Optional[torch.Tensor] = None,
    shs: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    active_sh_degree: int = 0,
    scaling_modifier: float = 1.0,
) -> ProjectedGaussians:
    """Project N Gaussians into the screen space of `camera`. Culling (near
    plane, zero-det covariance) shows as `valid` False / radius 0."""
    W, H = camera.width, camera.height
    focal_x = W / (2.0 * camera.tanfovx)
    focal_y = H / (2.0 * camera.tanfovy)

    mean2d, depth, in_front = screen_means(camera, means3d)
    if cov3d_precomp is None:
        if scales is None or rotations is None:
            raise ValueError("scales and rotations are needed without cov3d_precomp")
        cov3d_packed = compute_cov3d(scales, rotations, scaling_modifier)
    else:
        cov3d_packed = cov3d_precomp
    cov2d, det, det_ok, conic = screen_conics(means3d, cov3d_packed, camera, focal_x, focal_y)
    radius, ext = screen_extents(cov2d, det, in_front & det_ok, opacities)

    if colors_precomp is None:
        if shs is None:
            raise ValueError("shs are needed without colors_precomp")
        color = sh_to_color(shs, means3d, camera.cam_center, active_sh_degree)
    else:
        color = colors_precomp

    return ProjectedGaussians(
        mean2d=mean2d,
        depth=depth,
        conic=conic,
        color=color,
        opacity=opacities.reshape(-1),
        radius=radius,
        valid=radius > 0,
        ext=ext,
    )


@span("project.mean2d")
def screen_means(camera: Camera, means3d: torch.Tensor):
    """Pixel means [N, 2] (ndc2Pix), view-space depths [N] and the near
    test [N] bool (CUDA in_frustum)."""
    W, H = camera.width, camera.height

    def xform(M):  # [N, 4] = [means3d, 1] @ M.T, column by column
        return (
            means3d[:, 0:1] * M[None, :, 0]
            + means3d[:, 1:2] * M[None, :, 1]
            + means3d[:, 2:3] * M[None, :, 2]
            + M[None, :, 3]
        )

    p_view = xform(camera.world_view)
    depth = p_view[:, 2]
    in_front = depth > NEAR_CULL_Z

    p_hom = xform(camera.full_proj)
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :3] * p_w[:, None]
    mean2d = torch.stack([ndc2pix(p_proj[:, 0], W), ndc2pix(p_proj[:, 1], H)], dim=-1)
    return mean2d, depth, in_front


@span("project.cov2d")
def screen_conics(means3d: torch.Tensor, cov3d_packed: torch.Tensor, camera: Camera,
                  focal_x: torch.Tensor, focal_y: torch.Tensor):
    """The 2D covariance (a, b, c) [N, 3] (`compute_cov2d`), its
    determinant [N], whether that is non-zero [N] and the conic [N, 3] (0
    where the determinant is)."""
    cov2d = compute_cov2d(
        means3d, cov3d_packed, camera.world_view, focal_x, focal_y,
        camera.tanfovx, camera.tanfovy,
    )
    a, b, c = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    det = a * c - b * b
    det_ok = det != 0.0
    inv_det = torch.where(
        det_ok, 1.0 / torch.where(det_ok, det, torch.ones_like(det)), torch.zeros_like(det)
    )
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    return cov2d, det, det_ok, conic


@span("project.extent")
@torch.no_grad()  # radius and extents drive binning only
def screen_extents(cov2d: torch.Tensor, det: torch.Tensor, live: torch.Tensor,
                   opacities: torch.Tensor):
    """CUDA's integer 3-sigma radius [N] int32 and the per-axis binning
    half-extents [N, 2] int32, both 0 where `live` [N] is False (culled by
    the near test or a zero determinant)."""
    a, c = cov2d[:, 0], cov2d[:, 2]
    mid = 0.5 * (a + c)
    sq = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + sq
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, mid - sq)))
    radius = torch.where(live, radius_f, torch.zeros_like(radius_f)).to(torch.int32)

    # Per-axis binning extents (JAX project.py:248-271): a pixel with
    # q = d^T conic d > q_thr = 2 ln(255 op) has alpha < 1/255 and is
    # excluded by the rasterizer, so only the axis-aligned bbox of the
    # {q <= q_thr} ellipse (half-extents sqrt(q_thr * cov2d_ii)) can
    # contribute. min() with the CUDA radius keeps the rect never larger
    # than getRect's square; +1 and the 1e-4 margin absorb rounding.
    opa = opacities.reshape(-1)
    q_thr = 2.0 * torch.log(torch.clamp(255.0 * opa, min=1e-12)) * (1.0 + 1e-4)
    q_thr = torch.clamp(q_thr, min=0.0)
    ext_x = torch.ceil(torch.sqrt(q_thr * torch.clamp(a, min=0.0))) + 1.0
    ext_y = torch.ceil(torch.sqrt(q_thr * torch.clamp(c, min=0.0))) + 1.0
    ext = torch.minimum(torch.stack([ext_x, ext_y], dim=-1), radius_f[:, None])
    ext = torch.where(live[:, None], ext, torch.zeros_like(ext)).to(torch.int32)
    return radius, ext


def tile_rect(
    mean2d: torch.Tensor,
    radius: torch.Tensor,
    width: int,
    height: int,
    tile: int,
    radius_y: torch.Tensor | None = None,
):
    """Tile-grid bounding rect [min, max) per Gaussian (CUDA getRect).

    Returns (rect_min[N,2], rect_max[N,2]) int32 tile coords; the rect is
    empty for culled Gaussians. `radius_y` makes the rect per-axis (the
    extents from `project`); by default it is the CUDA square."""
    grid_x = (width + tile - 1) // tile
    grid_y = (height + tile - 1) // tile
    with torch.no_grad():
        m = mean2d.detach()
        r = radius.to(torch.float32)
        ry = r if radius_y is None else radius_y.to(torch.float32)

        def cell(v, hi):
            # float->int truncates toward zero, as in getRect; clamping the
            # float first keeps far off-screen means inside int32
            return torch.clamp(v, -1.0, float(hi)).to(torch.int32).clamp(0, hi)

        min_x = cell((m[:, 0] - r) / tile, grid_x)
        min_y = cell((m[:, 1] - ry) / tile, grid_y)
        max_x = cell((m[:, 0] + r + tile - 1) / tile, grid_x)
        max_y = cell((m[:, 1] + ry + tile - 1) / tile, grid_y)
    return torch.stack([min_x, min_y], dim=-1), torch.stack([max_x, max_y], dim=-1)
