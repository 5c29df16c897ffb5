"""The plain reference: structure-consistent Gaussian splatting's render,
loss, Adam step and densification in plain PyTorch, written from the
published method (3D Gaussian splatting's rasterizer semantics, SCGaussian's
hybrid model and loss) and importing nothing of the program.

Precision: float32. `precision(tf32)` sets whether float32 matrix products
and convolutions may use TF32; the reference proper runs with TF32 off, the
control with it on. The parts that a lower precision would touch are
written as the library's matrix products and convolutions: the view and
projection transforms, the 3D and 2D covariances, SSIM's windows, the
rotation of the split offsets.

Rasterizer semantics (3DGS's CUDA rasterizer): near cull at view z <= 0.2,
EWA covariance with the 0.3-pixel dilation and the 1.3 x frustum clamp, a
3-sigma radius, the tile rect of that radius on 16-pixel tiles, entries
sorted by tile then depth (ties by index), a pair counted where power <= 0
and alpha = min(0.99, opacity exp(power)) >= 1/255, a pixel stopped before
the entry that would take its transmittance under 1e-4. The gradient, as
3DGS's backward has it, ignores the 0.99 cap.

Compositing runs in blocks of tiles, each tile's entries padded to the
block's longest run, so that it fits at any image size; the gradient is
taken block by block from the loss's gradient of the image (recomputing
each block's forward), then through the projection.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.lib.scene import View

TILE = 16
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
NEAR_Z = 0.2
ZNEAR, ZFAR = 0.01, 100.0
BLOCK_ELEMENTS = 1 << 24  # (tile, entry, pixel) elements of one compositing block

PARAMS = ("zval", "f_dc", "f_rest", "scaling", "rotation", "opacity",
          "bg_xyz", "bg_f_dc", "bg_f_rest", "bg_scaling", "bg_rotation", "bg_opacity")
BUFFERS = ("rayo", "rayd", "bg_alive", "active_sh_degree")
BG = ("bg_xyz", "bg_f_dc", "bg_f_rest", "bg_scaling", "bg_rotation", "bg_opacity")

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products and convolutions with TF32 on or off, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# ---------------- cameras ----------------

def camera(view: View, device) -> dict:
    """The view's transforms as float32 tensors: world to view, the full
    OpenGL-style projection (view z maps to w = z), tangents, centre."""
    w2c = view.w2c()
    tx, ty = math.tan(view.fovx / 2.0), math.tan(view.fovy / 2.0)
    P = np.zeros((4, 4))
    P[0, 0], P[1, 1] = 1.0 / tx, 1.0 / ty
    P[2, 2] = ZFAR / (ZFAR - ZNEAR)
    P[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    P[3, 2] = 1.0

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return dict(world_view=t(w2c), full_proj=t(P @ w2c), tanx=tx, tany=ty,
                center=t(view.center), width=view.width, height=view.height)


# ---------------- the model ----------------

def activations(leaves: Dict[str, torch.Tensor]) -> dict:
    """Means, scales, unit quaternions, opacities (dead background slots at
    0), SH coefficients [N, K, 3] of the hybrid model: a ray Gaussian sits
    at rayo + rayd * zval."""
    fg = torch.ones(leaves["zval"].shape[0], dtype=torch.float32, device=leaves["zval"].device)
    alive = torch.cat([fg, leaves["bg_alive"].to(torch.float32)])
    rot = torch.cat([leaves["rotation"], leaves["bg_rotation"]])
    return dict(
        xyz=torch.cat([leaves["rayo"] + leaves["rayd"] * leaves["zval"], leaves["bg_xyz"]]),
        scale=torch.exp(torch.cat([leaves["scaling"], leaves["bg_scaling"]])),
        rot=rot / (torch.linalg.norm(rot, dim=-1, keepdim=True) + 1e-12),
        opacity=torch.sigmoid(torch.cat([leaves["opacity"], leaves["bg_opacity"]]))[:, 0] * alive,
        sh=torch.cat([torch.cat([leaves["f_dc"], leaves["bg_f_dc"]]),
                      torch.cat([leaves["f_rest"], leaves["bg_f_rest"]])], dim=1),
        degree=int(leaves["active_sh_degree"]),
    )


def rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """[N, 3, 3] from quaternions (r, x, y, z), normalized first."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    r, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(q.shape[:-1] + (3, 3))


def sh_color(sh: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """max(SH(dirs) + 0.5, 0) per Gaussian, to the active degree; sh [N, K, 3]."""
    x, y, z = (dirs[:, i:i + 1] for i in range(3))
    out = SH_C0 * sh[:, 0]
    if degree > 0:
        out = out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
    if degree > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out = (out + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
               + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6] + SH_C2[3] * xz * sh[:, 7]
               + SH_C2[4] * (xx - yy) * sh[:, 8])
    if degree > 2:
        out = (out + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9] + SH_C3[1] * xy * z * sh[:, 10]
               + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
               + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
               + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
               + SH_C3[5] * z * (xx - yy) * sh[:, 14] + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return torch.clamp(out + 0.5, min=0.0)


def project(act: dict, cam: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Screen-space rows [N, 10] (mean x, mean y, conic a, b, c, opacity,
    r, g, b, view depth), differentiable, and the integer 3-sigma radius
    [N] (0 where culled)."""
    xyz = act["xyz"]
    W, H = cam["width"], cam["height"]
    homo = torch.cat([xyz, torch.ones_like(xyz[:, :1])], dim=1)
    p_view = homo @ cam["world_view"].T
    p_hom = homo @ cam["full_proj"].T
    p_proj = p_hom[:, :3] / (p_hom[:, 3:4] + 1e-7)
    mx = ((p_proj[:, 0] + 1.0) * W - 1.0) * 0.5
    my = ((p_proj[:, 1] + 1.0) * H - 1.0) * 0.5

    Rm = rotation_matrix(act["rot"])
    M = Rm * act["scale"][:, None, :]
    cov3 = M @ M.transpose(1, 2)

    fx = W / (2.0 * cam["tanx"])
    fy = H / (2.0 * cam["tany"])
    tz = p_view[:, 2]
    tz_safe = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    txz = torch.clamp(p_view[:, 0] / tz_safe, -1.3 * cam["tanx"], 1.3 * cam["tanx"])
    tyz = torch.clamp(p_view[:, 1] / tz_safe, -1.3 * cam["tany"], 1.3 * cam["tany"])
    zero = torch.zeros_like(tz)
    J = torch.stack([fx / tz_safe, zero, -fx * txz / tz_safe,
                     zero, fy / tz_safe, -fy * tyz / tz_safe], dim=-1).reshape(-1, 2, 3)
    T = J @ cam["world_view"][:3, :3]
    cov2 = T @ cov3 @ T.transpose(1, 2)
    a = cov2[:, 0, 0] + 0.3
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + 0.3
    det = a * c - b * b
    ok = (tz > NEAR_Z) & (det != 0)
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), zero)

    dirs = xyz - cam["center"]
    dirs = dirs / torch.sqrt((dirs * dirs).sum(-1, keepdim=True) + 1e-12)
    rgb = sh_color(act["sh"], dirs, act["degree"])
    rows = torch.stack([mx, my, c * inv, -b * inv, a * inv, act["opacity"],
                        rgb[:, 0], rgb[:, 1], rgb[:, 2], tz], dim=1)
    with torch.no_grad():
        mid = 0.5 * (a + c)
        root = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(mid + root, mid - root)))
        radius = torch.where(ok, radius, torch.zeros_like(radius)).to(torch.int64)
    return rows, radius


# ---------------- binning and compositing ----------------

def tile_entries(rows: torch.Tensor, radius: torch.Tensor, W: int, H: int):
    """Every (tile, Gaussian) entry of the 3-sigma rects, sorted by tile then
    depth (ties by index). Returns (Gaussian per entry [E], tile starts
    [T + 1], tiles per row)."""
    gx, gy = (W + TILE - 1) // TILE, (H + TILE - 1) // TILE
    with torch.no_grad():
        m = rows[:, :2].detach()
        r = radius.to(torch.float32)

        def cell(v, hi):
            return torch.clamp(v, -1.0, float(hi)).to(torch.int64).clamp(0, hi)

        x0, y0 = cell((m[:, 0] - r) / TILE, gx), cell((m[:, 1] - r) / TILE, gy)
        x1 = cell((m[:, 0] + r + TILE - 1) / TILE, gx)
        y1 = cell((m[:, 1] + r + TILE - 1) / TILE, gy)
        wx = x1 - x0
        count = torch.where(radius > 0, wx * (y1 - y0), torch.zeros_like(wx))
        n = rows.shape[0]
        gid = torch.repeat_interleave(torch.arange(n, device=rows.device), count)
        first = torch.cumsum(count, 0) - count
        j = torch.arange(gid.shape[0], device=rows.device) - first[gid]
        tile = (y0[gid] + j // wx[gid]) * gx + x0[gid] + j % wx[gid]
        rank = torch.empty(n, dtype=torch.int64, device=rows.device)
        rank[torch.sort(rows[:, 9].detach(), stable=True).indices] = torch.arange(
            n, device=rows.device)
        order = torch.sort(tile * n + rank[gid]).indices
        starts = torch.zeros(gx * gy + 1, dtype=torch.int64, device=rows.device)
        starts[1:] = torch.cumsum(torch.bincount(tile, minlength=gx * gy), 0)
    return gid[order], starts, gx


def blocks(starts: torch.Tensor, budget: int = BLOCK_ELEMENTS) -> List[torch.Tensor]:
    """Tiles grouped longest first so that a block's tiles x its longest
    run x 256 pixels stay within `budget` (a tile longer than that alone)."""
    counts = (starts[1:] - starts[:-1]).cpu()
    order = torch.argsort(counts, descending=True, stable=True)
    out, i, n = [], 0, order.shape[0]
    while i < n:
        longest = max(int(counts[order[i]]), 1)
        take = max(1, budget // (longest * TILE * TILE))
        out.append(order[i:i + take].to(starts.device))
        i += take
    return out


def composite_block(rows: torch.Tensor, gid: torch.Tensor, starts: torch.Tensor, gx: int,
                    tiles: torch.Tensor, W: int, H: int, bg: torch.Tensor):
    """Blend the entries of `tiles` [B] front to back. Returns colour [B,
    256, 3], depth [B, 256], final transmittance [B, 256], the flat pixel
    index [B, 256] (-1 outside the image) and the number of pairs blended."""
    dev = rows.device
    s = starts[tiles]
    n = starts[tiles + 1] - s
    L = max(int(n.max()) if tiles.numel() else 0, 1)
    k = torch.arange(L, device=dev)
    has = k[None, :] < n[:, None]  # [B, L]
    g = gid[torch.clamp(s[:, None] + k[None, :], max=max(gid.shape[0] - 1, 0))] if gid.numel() \
        else torch.zeros(tiles.shape[0], L, dtype=torch.int64, device=dev)
    a = rows[g]  # [B, L, 10]
    lidx = torch.arange(TILE * TILE, device=dev)
    px = ((tiles % gx)[:, None] * TILE + lidx % TILE)
    py = ((tiles // gx)[:, None] * TILE + lidx // TILE)
    inside = (px < W) & (py < H)  # [B, 256]
    dx = a[:, :, 0:1] - px[:, None, :].to(torch.float32)
    dy = a[:, :, 1:2] - py[:, None, :].to(torch.float32)
    power = -0.5 * (a[:, :, 2:3] * dx * dx + a[:, :, 4:5] * dy * dy) - a[:, :, 3:4] * dx * dy
    pre = a[:, :, 5:6] * torch.exp(torch.clamp(power, max=0.0))
    alpha = pre - torch.clamp(pre - ALPHA_MAX, min=0.0).detach()  # capped; gradient uncapped
    live = has[:, :, None] & inside[:, None, :] & (power <= 0.0) & (alpha >= ALPHA_MIN)
    al = torch.where(live, alpha, torch.zeros_like(alpha))
    P = torch.cumprod(1.0 - al, dim=1)
    keep = live & (P >= T_EPS)
    T_before = torch.cat([torch.ones_like(P[:, :1]), P[:, :-1]], dim=1)
    w = torch.where(keep, al * T_before, torch.zeros_like(al))
    T_final = torch.where(P >= T_EPS, P, torch.ones_like(P)).amin(dim=1)
    color = torch.stack([(w * a[:, :, 6 + c:7 + c]).sum(1) + T_final * bg[c] for c in range(3)],
                        dim=-1)
    depth = (w * a[:, :, 9:10]).sum(1)
    flat = torch.where(inside, py * W + px, torch.full_like(px, -1))
    return color, depth, T_final, flat, int(keep.sum())


def render(rows: torch.Tensor, radius: torch.Tensor, W: int, H: int, bg: torch.Tensor,
           bins=None):
    """Colour [3, H, W], depth [1, H, W], alpha [1, H, W] and the pairs
    blended, without a graph; `bins` from `tile_entries` if already made."""
    gid, starts, gx = bins or tile_entries(rows, radius, W, H)
    img = torch.empty(3, H * W, dtype=torch.float32, device=rows.device)
    dep = torch.empty(H * W, dtype=torch.float32, device=rows.device)
    alp = torch.empty(H * W, dtype=torch.float32, device=rows.device)
    pairs = 0
    with torch.no_grad():
        for tiles in blocks(starts):
            color, depth, T, flat, n = composite_block(rows.detach(), gid, starts, gx, tiles,
                                                       W, H, bg)
            m = flat >= 0
            img[:, flat[m]] = color[m].T
            dep[flat[m]] = depth[m]
            alp[flat[m]] = 1.0 - T[m]
            pairs += n
    return img.reshape(3, H, W), dep.reshape(1, H, W), alp.reshape(1, H, W), pairs


def render_backward(rows_leaf: torch.Tensor, bins, W: int, H: int, bg: torch.Tensor,
                    g_img: torch.Tensor, g_dep: torch.Tensor, g_alp: torch.Tensor) -> None:
    """Accumulate into `rows_leaf.grad` the gradient of the composited
    image, depth and alpha under the cotangents [3, H, W], [1, H, W],
    [1, H, W], block by block over the `tile_entries` bins."""
    gid, starts, gx = bins
    gi, gd, ga = g_img.reshape(3, -1), g_dep.reshape(-1), g_alp.reshape(-1)
    for tiles in blocks(starts):
        with torch.enable_grad():
            color, depth, T, flat, _ = composite_block(rows_leaf, gid, starts, gx, tiles, W, H, bg)
        m = (flat >= 0).to(torch.float32)
        f = flat.clamp(min=0)
        outs = [color, depth, T]
        cots = [gi[:, f].permute(1, 2, 0) * m[..., None], gd[f] * m, -ga[f] * m]
        torch.autograd.backward(outs, cots)


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """[3, H, W] in float -> [H, W, 3] uint8, clamped and truncated."""
    return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8).permute(1, 2, 0)


# ---------------- the loss ----------------

def gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of [3, H, W] images, 11 x 11 Gaussian window (sigma 1.5),
    zero padding, C1 = 0.01^2, C2 = 0.03^2."""
    w = torch.tensor(gaussian_window(), device=x.device)[None, None].repeat(3, 1, 1, 1)

    def conv(t):
        return F.conv2d(t[None], w, padding=5, groups=3)[0]

    mx, my = conv(x), conv(y)
    sxx = conv(x * x) - mx * mx
    syy = conv(y * y) - my * my
    sxy = conv(x * y) - mx * my
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mx * my + c1) * (2 * sxy + c2))
            / ((mx * mx + my * my + c1) * (sxx + syy + c2))).mean()


class Matches:
    """The match rays of every ordered pair, worked out from the views and
    the normalized match coordinates: pair p = (src, dst) in the order
    (i, j) for i, for j != i; row k of p and of its reverse are one match."""

    def __init__(self, views: List[View], pixels: Dict[Tuple[int, int], np.ndarray], device):
        V = len(views)
        self.pairs = [(i, j) for i in range(V) for j in range(V) if j != i]
        self.views = views
        self.device = device
        f32 = dict(dtype=torch.float32, device=device)
        self.uv, self.o, self.d, self.dz = [], [], [], []
        for i, j in self.pairs:
            v = views[i]
            uv = torch.tensor(pixels[(i, j)], **f32) * torch.tensor([v.width, v.height], **f32)
            p = torch.cat([uv, torch.ones_like(uv[:, :1])], dim=1)
            d_cam = p @ torch.tensor(np.linalg.inv(v.K()), **f32).T
            d_cam = d_cam / torch.linalg.norm(d_cam, dim=1, keepdim=True)
            self.uv.append(uv)
            self.d.append(d_cam @ torch.tensor(v.R, **f32).T)
            self.dz.append(d_cam[:, 2])
            self.o.append(torch.tensor(v.center, **f32))

    def project(self, view: int, X: torch.Tensor) -> torch.Tensor:
        """World points [M, 3] -> pixel coordinates [M, 2] in `view`."""
        dst = self.views[view]
        w2c = torch.tensor(dst.w2c(), dtype=torch.float32, device=self.device)
        K = torch.tensor(dst.K(), dtype=torch.float32, device=self.device)
        pix = (X @ w2c[:3, :3].T + w2c[:3, 3]) @ K.T
        return pix[:, :2] / (pix[:, 2:3] + 1e-8)

    def reprojection_error(self, z: torch.Tensor) -> torch.Tensor:
        """The init stage's error [P, M] at depths `z` [P, M] along the match
        rays: each match lifted at its depth, projected into the pair's
        other view, the mean normalized L1 to the partner's coordinates."""
        errs = []
        for p, (i, j) in enumerate(self.pairs):
            v = self.views[j]
            wh = torch.tensor([v.width, v.height], dtype=torch.float32, device=self.device)
            xy = self.project(j, self.o[p] + self.d[p] * z[p][:, None])
            errs.append((torch.abs(xy - self.uv[self.pairs.index((j, i))]) / wh).mean(1))
        return torch.stack(errs)

    def loss(self, view: int, depth: torch.Tensor) -> torch.Tensor:
        """The structure-consistency term on rendered depth [1, H, W]: each
        match of `view`'s pairs lifted at the sampled depth (bilinear,
        align_corners False, zeros outside) along its ray, projected into
        the pair's other view, the mean normalized L1 to the partner's
        coordinates over matches that land inside, summed over pairs."""
        total = depth.new_zeros(())
        v = self.views[view]
        wh = torch.tensor([v.width, v.height], dtype=torch.float32, device=self.device)
        for p, (i, j) in enumerate(self.pairs):
            if i != view:
                continue
            grid = (self.uv[p] / wh * 2.0 - 1.0)[None, None]
            d = F.grid_sample(depth[None], grid, mode="bilinear", padding_mode="zeros",
                              align_corners=False)[0, 0, 0]
            z = d / self.dz[p]
            xy = self.project(j, self.o[p] + self.d[p] * z[:, None])
            dst = self.views[j]
            inb = ((xy[:, 0] > 0) & (xy[:, 0] < dst.width) & (xy[:, 1] > 0)
                   & (xy[:, 1] < dst.height)).to(torch.float32)
            partner = self.pairs.index((j, i))
            err = (torch.abs(xy - self.uv[partner]) / wh).mean(1)
            total = total + (err * inb).sum() / (inb.sum() + 1e-8)
        return total


# ---------------- the start model ----------------

@torch.no_grad()
def knn_mean_sq_dist(points: torch.Tensor, k: int = 3, block: int = 512) -> torch.Tensor:
    """[N]: the mean squared distance from each point to its k nearest
    other points, from the coordinates' differences, a block of rows at a
    time (no [N, N] matrix)."""
    n = points.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    for i0 in range(0, n, block):
        rows = points[i0:i0 + block]
        d2 = ((rows[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        r = torch.arange(rows.shape[0], device=points.device)
        d2[r, r + i0] = float("inf")
        out[i0:i0 + rows.shape[0]] = torch.topk(d2, k, dim=1, largest=False).values.mean(1)
    return out


@torch.no_grad()
def start_model(matches: Matches, pixels: Dict[Tuple[int, int], np.ndarray],
                truths: List[torch.Tensor], z: torch.Tensor, err_threshold: float,
                sh_degree: int, bg_capacity: int, knn_k: int = 3):
    """SCGaussian's start model (`create_from_pcd` after the init stage)
    from the init stage's depths `z` [P, M]: the matches whose error there
    is under `err_threshold` become ray Gaussians, in pair order, at those
    depths; SH DC from the source image bilinearly sampled at the match
    (align_corners False); log-scale from the 3-NN mean squared distance
    (floored at 1e-7) among the points (`knn_k` neighbours); identity rotations;
    opacity 0.1; `bg_capacity` dead background slots. Returns (the leaves,
    the error at `z` [P, M])."""
    dev = z.device
    err = matches.reprojection_error(z)
    keep = err < err_threshold
    xyz, rayo, rayd, color = [], [], [], []
    for p, (i, j) in enumerate(matches.pairs):
        sel = keep[p]
        d = matches.d[p][sel]
        o = matches.o[p].expand_as(d)
        rayo.append(o)
        rayd.append(d)
        xyz.append(o + d * z[p][sel][:, None])
        grid = torch.tensor(pixels[(i, j)], dtype=torch.float32, device=dev)[sel] * 2.0 - 1.0
        color.append(F.grid_sample(truths[i][None], grid[None, None], mode="bilinear",
                                   padding_mode="zeros", align_corners=False)[0, :, 0].T)
    xyz, color = torch.cat(xyz), torch.cat(color)
    nr = xyz.shape[0]
    dist2 = knn_mean_sq_dist(xyz, knn_k)
    k = (sh_degree + 1) ** 2
    f32 = dict(dtype=torch.float32, device=dev)
    identity = torch.tensor([1.0, 0.0, 0.0, 0.0], **f32)
    leaves = dict(
        zval=torch.cat([z[p][keep[p]] for p in range(len(matches.pairs))])[:, None],
        f_dc=((color - 0.5) / SH_C0)[:, None, :],
        f_rest=torch.zeros(nr, k - 1, 3, **f32),
        scaling=torch.log(torch.sqrt(torch.clamp(dist2, min=1e-7)))[:, None].repeat(1, 3),
        rotation=identity.repeat(nr, 1),
        opacity=torch.full((nr, 1), math.log(0.1 / 0.9), **f32),
        bg_xyz=torch.zeros(bg_capacity, 3, **f32),
        bg_f_dc=torch.zeros(bg_capacity, 1, 3, **f32),
        bg_f_rest=torch.zeros(bg_capacity, k - 1, 3, **f32),
        bg_scaling=torch.full((bg_capacity, 3), -10.0, **f32),
        bg_rotation=identity.repeat(bg_capacity, 1),
        bg_opacity=torch.full((bg_capacity, 1), -10.0, **f32),
        rayo=torch.cat(rayo), rayd=torch.cat(rayd),
        bg_alive=torch.zeros(bg_capacity, dtype=torch.bool, device=dev),
        active_sh_degree=torch.tensor(0, dtype=torch.int32, device=dev),
    )
    return leaves, err


# ---------------- the step ----------------

def expon_lr(step: int, lr_init: float, lr_final: float, max_steps: int) -> float:
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def learning_rates(opt: dict, scale: float, iteration: int) -> Dict[str, float]:
    """Per-leaf rates: the scheduled position rate for the ray depths, the
    unscheduled one for the background means (SCGaussian's schedule returns
    after the first group), the feature rate / 20 for the SH rest."""
    pos = expon_lr(iteration, opt["position_lr_init"] * scale, opt["position_lr_final"] * scale,
                   opt["position_lr_max_steps"])
    base = dict(f_dc=opt["feature_lr"], f_rest=opt["feature_lr"] / 20.0,
                scaling=opt["scaling_lr"], rotation=opt["rotation_lr"],
                opacity=opt["opacity_lr"])
    out = dict(zval=pos, bg_xyz=opt["position_lr_init"] * scale)
    for k, v in base.items():
        out[k] = v
        out["bg_" + k] = v
    return out


class Trainer:
    """The main stage's steps: render the popped camera, L = 0.8 L1 + 0.2
    (1 - SSIM) + 0.3 match term, Adam (eps 1e-15) on every leaf. From the
    start model, or from a state `steps_done` steps in whose `leaves` hold
    the moments (`m.<leaf>`, `v.<leaf>`)."""

    def __init__(self, leaves: Dict[str, torch.Tensor], views: List[View],
                 truths: List[torch.Tensor], matches: Matches, opt: dict, scale: float,
                 stack_seed: int, tf32: bool = False, steps_done: int = 0):
        self.p = {k: leaves[k].detach().clone().requires_grad_() for k in PARAMS}
        self.buf = {k: leaves[k].detach().clone() for k in BUFFERS}
        self.m = {k: leaves[f"m.{k}"].clone() if f"m.{k}" in leaves else torch.zeros_like(v)
                  for k, v in self.p.items()}
        self.v = {k: leaves[f"v.{k}"].clone() if f"v.{k}" in leaves else torch.zeros_like(v)
                  for k, v in self.p.items()}
        self.views, self.truths, self.matches = views, truths, matches
        self.opt, self.scale, self.tf32 = opt, scale, tf32
        self.rng = np.random.default_rng(stack_seed)
        self.stack: List[int] = []
        self.count = 0
        self.bg = torch.zeros(3, device=truths[0].device)
        for _ in range(steps_done):  # the camera stack and Adam's count after those steps
            self.pop()
        self.count = steps_done

    def pop(self) -> int:
        if not self.stack:
            self.stack = list(range(len(self.views)))
            self.rng.shuffle(self.stack)
        return self.stack.pop()

    def image_loss(self, img: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        lam = self.opt["lambda_dssim"]
        return (1 - lam) * torch.abs(img - gt).mean() + lam * (1 - ssim(img, gt))

    def loss_and_grads(self, view: int) -> Tuple[float, Dict[str, torch.Tensor]]:
        v = self.views[view]
        cam = camera(v, self.truths[0].device)
        with precision(self.tf32):
            rows, radius = project(activations({**self.p, **self.buf}), cam)
            leaf = rows.detach().requires_grad_()
            bins = tile_entries(leaf, radius, v.width, v.height)
            img, dep, alp, _ = render(leaf, radius, v.width, v.height, self.bg, bins)
            img.requires_grad_()
            dep.requires_grad_()
            loss = self.image_loss(img, self.truths[view]) \
                + self.opt["match_weight"] * self.matches.loss(view, dep)
            g_img, g_dep = torch.autograd.grad(loss, [img, dep])
            render_backward(leaf, bins, v.width, v.height, self.bg, g_img, g_dep,
                            torch.zeros_like(alp))
            grads = torch.autograd.grad(rows, list(self.p.values()), leaf.grad,
                                        allow_unused=True)
        grads = {k: torch.zeros_like(self.p[k]) if g is None else g
                 for k, g in zip(self.p, grads)}
        return float(loss.detach()), grads

    @torch.no_grad()
    def adam(self, grads: Dict[str, torch.Tensor], iteration: int) -> None:
        self.count += 1
        b1, b2 = 0.9, 0.999
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        lrs = learning_rates(self.opt, self.scale, iteration)
        for k, p in self.p.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            p -= lrs[k] * (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + 1e-15)

    def step(self, iteration: int) -> Tuple[float, Dict[str, torch.Tensor]]:
        loss, grads = self.loss_and_grads(self.pop())
        self.adam(grads, iteration)
        return loss, grads


# ---------------- densification ----------------

@torch.no_grad()
def densify(state: dict, opt: dict, extent: float, iteration: int,
            generator: torch.Generator, min_opacity: float = 0.005, split_n: int = 2) -> dict:
    """One densify-and-prune event of the hybrid model (SCGaussian's
    `densify_and_prune` on a fixed-capacity background pool): Gaussians
    whose mean screen-space gradient reaches the threshold are cloned (small
    ones) or split into `split_n` children drawn N(0, scale) in their frame
    (large ones); clones and children go to free background slots in that
    order; ray parents of a split keep their slot with their log-scale
    divided by 0.8 split_n; background parents of a split, and background
    Gaussians with opacity under `min_opacity` or (after the first reset)
    wider than 0.2 x extent, die. The moments of every foreground scale and
    of every background slot that changed are zeroed. `state` holds the
    leaves, `bg_alive`, `xyz_gradient_accum`, `denom` and the moments `m.*`,
    `v.*`; returns the same keys after the event."""
    s = {k: v.clone() for k, v in state.items()}
    nr = s["zval"].shape[0]
    cb = s["bg_xyz"].shape[0]
    n = nr + cb
    grads = s["xyz_gradient_accum"] / s["denom"]
    grads = torch.where(torch.isnan(grads), torch.zeros_like(grads), grads)[:, 0]
    alive = torch.cat([torch.ones(nr, dtype=torch.bool, device=grads.device), s["bg_alive"]])
    xyz = torch.cat([s["rayo"] + s["rayd"] * s["zval"], s["bg_xyz"]])
    log_scale = torch.cat([s["scaling"], s["bg_scaling"]])
    scale = torch.exp(log_scale)
    big = scale.max(dim=1).values > opt["percent_dense"] * extent
    hot = (grads >= opt["densify_grad_threshold"]) & alive
    clone, split = hot & ~big, hot & big
    normals = torch.randn(split_n, n, 3, generator=generator, device=grads.device)
    rot = torch.cat([s["rotation"], s["bg_rotation"]])
    R = rotation_matrix(rot)
    children = [(R @ (normals[k] * scale)[:, :, None])[:, :, 0] + xyz for k in range(split_n)]
    child_scale = torch.log(scale / (0.8 * split_n))
    cat = {name: torch.cat([s[name[3:]], s[name]]) for name in
           ("bg_f_dc", "bg_f_rest", "bg_opacity")}
    cand = dict(bg_xyz=torch.cat([xyz] + children),
                bg_scaling=torch.cat([log_scale] + [child_scale] * split_n),
                bg_rotation=rot.repeat(1 + split_n, 1),
                **{k: v.repeat((1 + split_n,) + (1,) * (v.dim() - 1)) for k, v in cat.items()})
    want = torch.cat([clone] + [split] * split_n)
    free = torch.nonzero(~s["bg_alive"]).reshape(-1)
    chosen = torch.nonzero(want).reshape(-1)[:free.shape[0]]
    dest = free[:chosen.shape[0]]
    for name, values in cand.items():
        s[name][dest] = values[chosen]
    new = torch.zeros(cb, dtype=torch.bool, device=grads.device)
    new[dest] = True
    s["scaling"] = torch.where(split[:nr, None], s["scaling"] / (0.8 * split_n), s["scaling"])
    prune = torch.sigmoid(s["bg_opacity"][:, 0]) < min_opacity
    if iteration > opt["opacity_reset_interval"]:
        prune = prune | (torch.exp(s["bg_scaling"]).max(dim=1).values > 0.2 * extent)
    prune = prune | split[nr:]
    s["bg_alive"] = (s["bg_alive"] | new) & ~prune
    for mom in ("m", "v"):
        s[f"{mom}.scaling"] = torch.zeros_like(s[f"{mom}.scaling"])
        for name in BG:
            x = s[f"{mom}.{name}"]
            keep = ~(new | prune)
            s[f"{mom}.{name}"] = x * keep.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
    return s
