"""The benchmark's inputs, made from `--seed` on the device: a forward-facing
LLFF-like rig looking at a textured height field, ground-truth images
ray-cast per pixel, exact matches between every ordered pair of training
views, the served model and the served poses.

Plain PyTorch and numpy only: nothing here imports the program. Every seed
gives the same sizes (image size, views, matches per pair, Gaussians); the
seed moves the texture's phases and directions, which pixels the matches
start from, and the served model's attributes.

Camera conventions (the 3DGS / COLMAP ones): `R` is the camera-to-world
rotation, `T` the world-to-camera translation, the camera looks along +z,
x to the right and y down; pixel (i, j) of an image is centred at
K^-1 (i + 0.5, j + 0.5, 1), the principal point at (W / 2, H / 2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

SH_C0 = 0.28209479177387814


@dataclasses.dataclass(frozen=True)
class View:
    """One pinhole camera: rotation `R` (camera to world), translation `T`
    (world to camera), fields of view in radians, image size."""

    R: np.ndarray
    T: np.ndarray
    fovx: float
    fovy: float
    width: int
    height: int

    @property
    def center(self) -> np.ndarray:
        return -self.R @ self.T

    def w2c(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = self.R.T
        m[:3, 3] = self.T
        return m

    def K(self) -> np.ndarray:
        fx = self.width / (2.0 * math.tan(self.fovx / 2.0))
        fy = self.height / (2.0 * math.tan(self.fovy / 2.0))
        return np.array([[fx, 0.0, self.width / 2.0], [0.0, fy, self.height / 2.0],
                         [0.0, 0.0, 1.0]])


def look_at(position: np.ndarray, target: np.ndarray, width: int, height: int,
            focal_share: float) -> View:
    """A camera at `position` looking at `target`, y down, square pixels with
    the focal length `focal_share` x the image width."""
    fwd = target - position
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)  # y down, z forward: x = y cross z
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)
    focal = focal_share * width
    return View(R=R, T=-R.T @ position, fovx=2.0 * math.atan(width / (2.0 * focal)),
                fovy=2.0 * math.atan(height / (2.0 * focal)), width=width, height=height)


def train_views(cfg: dict) -> List[View]:
    """The training rig: `train_views` cameras on a short horizontal arc at
    the config's baseline, each looking at the focus point on the z axis."""
    rig = cfg["rig"]
    n = cfg["train_views"]
    target = np.array([0.0, 0.0, rig["focus_depth"]])
    views = []
    for i in range(n):
        s = i - (n - 1) / 2.0
        pos = np.array([rig["baseline"] * s, rig["lift"] * (s * s - 0.5), 0.0])
        views.append(look_at(pos, target, cfg["width"], cfg["height"], cfg["focal_share"]))
    return views


def spiral_views(cfg: dict, traffic: dict) -> List[View]:
    """LLFF's forward-facing spiral (`generate_spiral_path`, as the video
    renderer makes it): `frames` poses on `rotations` turns around the
    training cameras' mean position, with the radii of their spread, looking
    at the focus point."""
    rig = cfg["rig"]
    base = train_views(cfg)
    centers = np.stack([v.center for v in base])
    mean = centers.mean(0)
    radii = np.maximum(np.percentile(np.abs(centers - mean), 90, axis=0), rig["spiral_min_radius"])
    target = np.array([0.0, 0.0, rig["focus_depth"]])
    views = []
    for k in range(traffic["frames"]):
        theta = 2.0 * math.pi * traffic["rotations"] * k / traffic["frames"]
        offset = np.array([math.cos(theta), -math.sin(theta),
                           -math.sin(theta * traffic["zrate"])]) * radii
        views.append(look_at(mean + offset, target, cfg["width"], cfg["height"],
                             cfg["focal_share"]))
    return views


# ---------------- the surface and its texture ----------------

def surface_height(x: torch.Tensor, y: torch.Tensor, s: dict) -> torch.Tensor:
    """z = depth + amplitude sin(kx x + 1) cos(ky y)."""
    return s["depth"] + s["amplitude"] * torch.sin(s["kx"] * x + 1.0) * torch.cos(s["ky"] * y)


def ray_cast(o: torch.Tensor, d: torch.Tensor, s: dict, iterations: int = 16) -> torch.Tensor:
    """[R] distances t along unit rays o + t d [R, 3] to the height field, by
    Newton's method on f(t) = o_z + t d_z - h(o_xy + t d_xy). The config's
    surface keeps f' > 0 over the views' rays, so the root is unique."""
    t = (s["depth"] - o[:, 2]) / d[:, 2]
    for _ in range(iterations):
        x = o[:, 0] + t * d[:, 0]
        y = o[:, 1] + t * d[:, 1]
        sx, cx = torch.sin(s["kx"] * x + 1.0), torch.cos(s["kx"] * x + 1.0)
        sy, cy = torch.sin(s["ky"] * y), torch.cos(s["ky"] * y)
        f = o[:, 2] + t * d[:, 2] - (s["depth"] + s["amplitude"] * sx * cy)
        hx = s["amplitude"] * s["kx"] * cx * cy
        hy = -s["amplitude"] * s["ky"] * sx * sy
        t = t - f / (d[:, 2] - hx * d[:, 0] - hy * d[:, 1])
    return t


@dataclasses.dataclass(frozen=True)
class Texture:
    """A sum of plane waves per colour channel: the config's frequencies
    (`waves` of them, the same for every seed), directions and phases drawn
    from the seed."""

    omega: torch.Tensor  # [K]
    direction: torch.Tensor  # [3, K, 2]
    phase: torch.Tensor  # [3, K]
    amplitude: float

    @staticmethod
    def draw(cfg: dict, gen: torch.Generator, device) -> "Texture":
        tex = cfg["texture"]
        k = len(tex["omega"])
        ang = torch.rand(3, k, generator=gen, device=device) * (2.0 * math.pi)
        return Texture(
            omega=torch.tensor(tex["omega"], dtype=torch.float32, device=device),
            direction=torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1),
            phase=torch.rand(3, k, generator=gen, device=device) * (2.0 * math.pi),
            amplitude=float(tex["amplitude"]),
        )

    def color(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """[R, 3] in [0, 1] at surface points (x, y)."""
        out = []
        for c in range(3):
            arg = (x[:, None] * self.direction[c, :, 0] + y[:, None] * self.direction[c, :, 1])
            arg = arg * self.omega + self.phase[c]
            out.append(0.5 + self.amplitude * torch.sin(arg).sum(1))
        return torch.clamp(torch.stack(out, dim=1), 0.0, 1.0)


def pixel_rays(view: View, u: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """World rays (origins [R, 3], unit directions [R, 3]) through image
    coordinates (u, v) of `view`, in K's convention."""
    dev = u.device
    Kinv = torch.tensor(np.linalg.inv(view.K()), dtype=torch.float32, device=dev)
    R = torch.tensor(view.R, dtype=torch.float32, device=dev)
    p = torch.stack([u, v, torch.ones_like(u)], dim=1)
    d_cam = p @ Kinv.T
    d = d_cam @ R.T
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    o = torch.tensor(view.center, dtype=torch.float32, device=dev).expand_as(d)
    return o, d


def project_points(view: View, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Image coordinates (u, v) [R, 2] and camera depth [R] of world points."""
    dev = X.device
    w2c = torch.tensor(view.w2c(), dtype=torch.float32, device=dev)
    K = torch.tensor(view.K(), dtype=torch.float32, device=dev)
    cam = X @ w2c[:3, :3].T + w2c[:3, 3]
    pix = cam @ K.T
    return pix[:, :2] / pix[:, 2:3], cam[:, 2]


def render_truth(view: View, s: dict, tex: Texture, device, rows: int = 512) -> torch.Tensor:
    """The ground-truth image [3, H, W] of `view`: each pixel centre's ray
    cast to the surface and coloured by the texture, `rows` image rows at a
    time."""
    W, H = view.width, view.height
    img = torch.empty(3, H, W, dtype=torch.float32, device=device)
    xs = torch.arange(W, dtype=torch.float32, device=device) + 0.5
    for r0 in range(0, H, rows):
        r1 = min(H, r0 + rows)
        ys = torch.arange(r0, r1, dtype=torch.float32, device=device) + 0.5
        v, u = torch.meshgrid(ys, xs, indexing="ij")
        o, d = pixel_rays(view, u.reshape(-1), v.reshape(-1))
        X = o + d * ray_cast(o, d, s)[:, None]
        img[:, r0:r1] = tex.color(X[:, 0], X[:, 1]).T.reshape(3, r1 - r0, W)
    return img


def exact_matches(views: List[View], s: dict, per_pair: int, gen: torch.Generator,
                  device, margin: float = 0.02) -> Dict[Tuple[int, int], np.ndarray]:
    """`per_pair` matches for every unordered pair of views, as normalized
    image coordinates [per_pair, 2] under (i, j) and (j, i): surface points
    hit by rays through uniform random points of view i that land inside
    view j, `margin` of the image from each edge in both."""
    out = {}
    for i in range(len(views)):
        for j in range(i + 1, len(views)):
            vi, vj = views[i], views[j]
            n = 3 * per_pair
            uv = margin + (1.0 - 2.0 * margin) * torch.rand(n, 2, generator=gen, device=device)
            u, v = uv[:, 0] * vi.width, uv[:, 1] * vi.height
            o, d = pixel_rays(vi, u, v)
            X = o + d * ray_cast(o, d, s)[:, None]
            pj, z = project_points(vj, X)
            nj = pj / torch.tensor([vj.width, vj.height], dtype=torch.float32, device=device)
            ok = (z > 0) & ((nj > margin) & (nj < 1.0 - margin)).all(1)
            keep = torch.nonzero(ok).reshape(-1)[:per_pair]
            if keep.numel() < per_pair:
                raise RuntimeError(f"views {i} and {j} share only {keep.numel()} of "
                                   f"{per_pair} match points")
            out[(i, j)] = uv[keep].cpu().numpy().astype(np.float32)
            out[(j, i)] = nj[keep].cpu().numpy().astype(np.float32)
    return out


def camera_extent(views: List[View]) -> float:
    """The reference's `cameras_extent` (`getNerfppNorm`): 1.1 x the largest
    distance of a camera centre from their mean."""
    centers = np.stack([v.center for v in views])
    return 1.1 * float(np.linalg.norm(centers - centers.mean(0), axis=1).max())


# ---------------- the served model ----------------

def served_leaves(cfg: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """A trained-looking hybrid model, made on the device from the seed:
    `ray_gaussians` ray Gaussians on the surface (rays through random pixels
    of the training views, depth the surface's), `alive_bg` background
    Gaussians scattered about the surface in a `bg_capacity` buffer, SH
    degree 3 with every band non-zero, scales about the spacing of that many
    points on the visible surface, random rotations, opacities in [0.2, 0.9].
    Named as the program's model leaves (the 12 parameters and the buffers)."""
    m = cfg["serve_model"]
    s = cfg["surface"]
    views = train_views(cfg)
    nr, nb, cb = m["ray_gaussians"], m["alive_bg"], m["bg_capacity"]
    k = (cfg["sh_degree"] + 1) ** 2
    f32 = dict(dtype=torch.float32, device=device)
    tex = Texture.draw(cfg, gen, device)

    def surface_points(n):
        view_of = torch.randint(0, len(views), (n,), generator=gen, device=device)
        uv = torch.rand(n, 2, generator=gen, device=device)
        o = torch.empty(n, 3, **f32)
        d = torch.empty(n, 3, **f32)
        for i, v in enumerate(views):
            sel = view_of == i
            oi, di = pixel_rays(v, uv[sel, 0] * v.width, uv[sel, 1] * v.height)
            o[sel], d[sel] = oi, di
        return o, d, ray_cast(o, d, s)

    half_w = s["depth"] * math.tan(views[0].fovx / 2.0)
    half_h = s["depth"] * math.tan(views[0].fovy / 2.0)
    spacing = math.sqrt(4.0 * half_w * half_h / (nr + nb))

    def attributes(n, X):
        color = tex.color(X[:, 0], X[:, 1])
        return dict(
            f_dc=((color - 0.5) / SH_C0)[:, None, :],
            f_rest=torch.randn(n, k - 1, 3, generator=gen, **f32) * m["sh_rest_std"],
            scaling=torch.log(spacing * (0.5 + torch.rand(n, 3, generator=gen, **f32))),
            rotation=torch.randn(n, 4, generator=gen, **f32),
            opacity=torch.logit(0.2 + 0.7 * torch.rand(n, 1, generator=gen, **f32)),
        )

    o, d, t = surface_points(nr)
    fg = attributes(nr, o + d * t[:, None])
    ob, db, tb = surface_points(nb)
    Xb = ob + db * tb[:, None] + torch.randn(nb, 3, generator=gen, **f32) * (2.0 * spacing)
    bg = attributes(nb, Xb)

    def dead(shape, fill=0.0):
        return torch.full((cb,) + shape, fill, **f32)

    leaves = dict(zval=t[:, None], rayo=o.contiguous(), rayd=d.contiguous(), **fg)
    bg_leaves = dict(bg_xyz=dead((3,)), bg_f_dc=dead((1, 3)), bg_f_rest=dead((k - 1, 3)),
                     bg_scaling=dead((3,), -10.0), bg_rotation=dead((4,)),
                     bg_opacity=dead((1,), -10.0))
    bg_leaves["bg_rotation"][:, 0] = 1.0
    bg_leaves["bg_xyz"][:nb] = Xb
    for name in ("f_dc", "f_rest", "scaling", "rotation", "opacity"):
        bg_leaves["bg_" + name][:nb] = bg[name]
    leaves.update(bg_leaves)
    alive = torch.zeros(cb, dtype=torch.bool, device=device)
    alive[:nb] = True
    leaves["bg_alive"] = alive
    leaves["active_sh_degree"] = torch.tensor(cfg["sh_degree"], dtype=torch.int32, device=device)
    return leaves
