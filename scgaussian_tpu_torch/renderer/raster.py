"""Tile compositing: binning -> the CUDA kernels, or their plain versions.

Port of `scgaussian_tpu/renderer/tile_raster.py::rasterize` (204-293) and of
`stream_gather_composite` with its custom VJP (998-1031, 1234-1308). The
TPU's Pallas stream kernels, the untiling (`assemble_image`) and the
backward's entry -> Gaussian routing become three hand-written CUDA kernels:
`csrc/raster_fwd.cu` writes the image directly; `csrc/raster_bwd.cu` writes
gradients of the packed attribute rows, per Gaussian (atomics) or per tile
entry; `csrc/segsum.cu` sums per-entry rows per Gaussian.

The backward routes as the JAX package does (`_stream_gather_bwd`,
1254-1255): below an entry budget of `SORT_ROUTE_MIN_L` the kernel's atomic
epilogue sums per Gaussian; at or above it (`sort_route`), the kernel writes
per-entry gradients, each stored at its entry's Gaussian-major slot
(`TileBins.order`), and `route_by_sort` sums each Gaussian's run of slots
(`TileBins.gmaj_starts`) in one launch of the segment-sum kernel, with no
atomics and no reordered copy.

`raster_fwd`, `raster_bwd`, `raster_bwd_entries`, `segsum` and
`segsum_runs` (which `route_by_sort` calls) are the wrappers: on CUDA
tensors they launch their kernel (and count the launch in `LAUNCHES`; both
backward epilogues count as "raster_bwd", both segment-sum forms as
"segsum"), on CPU tensors they run the plain versions, the same arithmetic
in PyTorch ops. There is no other fallback: a CUDA tensor never reaches a
plain version through a wrapper, and a build or launch failure raises.
`rasterize` is differentiable through `RasterizeFn`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from scgaussian_tpu_torch.config import RasterizerConfig
from scgaussian_tpu_torch.renderer import _build
from scgaussian_tpu_torch.renderer.binning import TileBins, bin_gaussians, default_entry_budget
from scgaussian_tpu_torch.renderer.oracle import ALPHA_MAX, ALPHA_MIN, T_EPS
from scgaussian_tpu_torch.renderer.project import ProjectedGaussians

TILE = 16  # the kernel's tile: one 16x16 block of threads per tile
ATTR_WIDTH = 12  # packed attribute row, 3 float4 (see csrc/raster_fwd.cu)
NUM_GRADS = 10  # gradient columns: mean x/y, conic a/b/c, opacity, rgb, depth
# entry budget from which the backward routes by sort (tile_raster.py:1033)
SORT_ROUTE_MIN_L = 1 << 20
# the kernels' warp footprint (csrc/raster_common.cuh): a thread owns two
# pixels of one column, a warp 8 x 8 pixels, four warps a tile
WARP_FOOT = (8, 8)  # (x, y) pixels
# the cull's margins (csrc/raster_common.cuh, `cull_entry`)
CULL_EXP_SLACK = 1e-6
CULL_FAINT_MARGIN = 1e-5
CULL_KAPPA = 3e-7
CULL_PIX_SLACK = 1e-3
# the pair and warp-entry counts of the plain versions' `stats`, by key
WARP_STATS = ("warp_entries", "live_warp_entries", "culled_warp_entries",
              "live_warp_pairs", "dead_warp_pairs", "culled_pairs")

# Kernel launches since import, by kernel. Only the wrappers add to it.
LAUNCHES = {"raster_fwd": 0, "raster_bwd": 0, "segsum": 0}

RasterOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def pack_attrs(proj: ProjectedGaussians) -> torch.Tensor:
    """[N, 12] float32 rows (mean x, mean y, conic a, b, c, opacity, r, g,
    b, depth, 0, 0): the kernel reads each row as 3 float4."""
    zeros = torch.zeros_like(proj.depth)
    cols = [
        proj.mean2d[:, 0],
        proj.mean2d[:, 1],
        proj.conic[:, 0],
        proj.conic[:, 1],
        proj.conic[:, 2],
        proj.opacity,
        proj.color[:, 0],
        proj.color[:, 1],
        proj.color[:, 2],
        proj.depth,
        zeros,
        zeros,
    ]
    return torch.stack(cols, dim=1).to(torch.float32).contiguous()


def _check_inputs(bins: TileBins, attrs: torch.Tensor, bg: torch.Tensor,
                  width: int, height: int) -> None:
    dev = attrs.device
    for name, t, dtype in (
        ("tile_starts", bins.tile_starts, torch.int32),
        ("gauss_ids", bins.gauss_ids, torch.int32),
        ("attrs", attrs, torch.float32),
        ("bg", bg, torch.float32),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, attrs on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if attrs.dim() != 2 or attrs.shape[1] != ATTR_WIDTH:
        raise ValueError(f"attrs must be [N, {ATTR_WIDTH}], got {tuple(attrs.shape)}")
    if bg.shape != (3,):
        raise ValueError(f"bg must be [3], got {tuple(bg.shape)}")
    nx = (width + TILE - 1) // TILE
    ny = (height + TILE - 1) // TILE
    if (bins.nx, bins.ny) != (nx, ny) or bins.tile_starts.shape != (nx * ny + 1,):
        raise ValueError(f"bins are for a {bins.nx}x{bins.ny} grid, image needs {nx}x{ny}")


def raster_fwd(bins: TileBins, attrs: torch.Tensor, bg: torch.Tensor,
               width: int, height: int) -> RasterOut:
    """Composite every tile's entries front to back.

    Returns (color [3, H, W], depth [H, W], alpha [H, W], final T [H, W],
    last contributor [H, W] int32: 1-based position in the tile's range of
    the last entry that blended, 0 if none).

    The kernel's outputs carry no autograd history: to differentiate, call
    `rasterize` (or `RasterizeFn`), whose backward is `raster_bwd`. On the
    GPU, a call that would silently drop gradients raises."""
    _check_inputs(bins, attrs, bg, width, height)
    if attrs.device.type == "cpu":
        return raster_fwd_plain(bins, attrs, bg, width, height)
    if attrs.device.type != "cuda":
        raise ValueError(f"no rasterizer for device {attrs.device}")
    if attrs.requires_grad and torch.is_grad_enabled():
        raise ValueError("raster_fwd is not differentiable: use rasterize (RasterizeFn)")
    return _raster_fwd_cuda(bins, attrs, bg, width, height)


@functools.cache
def _raster_fwd_fn():
    """The kernel's C entry point with its signature set, built and loaded
    on first use."""
    fn = _build.load("raster_fwd").raster_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    return fn


def _raster_fwd_cuda(bins, attrs, bg, width, height) -> RasterOut:
    fn = _raster_fwd_fn()
    dev = attrs.device
    with torch.cuda.device(dev):
        f32 = dict(dtype=torch.float32, device=dev)
        color = torch.empty(3, height, width, **f32)
        depth = torch.empty(height, width, **f32)
        alpha = torch.empty(height, width, **f32)
        T = torch.empty(height, width, **f32)
        last = torch.empty(height, width, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            bins.tile_starts.data_ptr(), bins.gauss_ids.data_ptr(),
            attrs.data_ptr(), bg.data_ptr(), width, height,
            color.data_ptr(), depth.data_ptr(), alpha.data_ptr(),
            T.data_ptr(), last.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"raster_fwd launch failed: CUDA error {err}")
    LAUNCHES["raster_fwd"] += 1
    return color, depth, alpha, T, last


def _tile_pixels(nx: int, ny: int, dev: torch.device):
    """Pixel x, y (float32, [tiles, 256]) of every tile's threads."""
    lidx = torch.arange(TILE * TILE, device=dev)
    tid = torch.arange(nx * ny, device=dev)
    px = ((tid % nx)[:, None] * TILE + lidx % TILE).to(torch.float32)
    py = ((tid // nx)[:, None] * TILE + lidx // TILE).to(torch.float32)
    return px, py


def entry_cull_rect(attrs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' cull (`cull_entry` in csrc/raster_common.cuh) per packed
    row, in float64 as the kernels compute it.

    Returns (rect [N, 4] float64, thr [N] float32). `rect` holds x_lo, x_hi,
    y_lo, y_hi, the bounds (inclusive) of the pixel centres where the row
    can give alpha >= 1/255 by the kernels' rounded arithmetic: +-inf
    bounds where nothing is culled (a conic that is not positive definite
    with the margin, a needle too thin for fp32, NaN), an empty rect where
    opacity < 1/255. `thr`: below this power a pair is certainly faint, so
    expf is skipped (NaN for a NaN opacity: nothing skipped)."""
    a = attrs.detach().to(torch.float64)
    mx, my, ca, cb, cc = (a[:, i] for i in range(5))
    alpha_min = float(torch.tensor(ALPHA_MIN, dtype=torch.float32))
    dead = attrs[:, 5].detach() < ALPHA_MIN  # compared in float32, as the kernels do
    lnr = torch.log(a[:, 5] / alpha_min)
    t64 = -lnr - CULL_FAINT_MARGIN
    thr = t64.to(torch.float32)
    thr = torch.where(thr.to(torch.float64) > t64, torch.nextafter(thr, torch.full_like(thr, -math.inf)),
                      thr)  # rounded down
    thr = torch.where(dead, math.inf, thr)
    s = 2.0 * CULL_KAPPA
    axx = ca - s * (ca + cb.abs())
    ayy = cc - s * (cc + cb.abs())
    det = axx * ayy - cb * cb
    r2 = 2.0 * (lnr + CULL_EXP_SLACK)
    hx = torch.sqrt(r2 * ayy / det) + CULL_PIX_SLACK
    hy = torch.sqrt(r2 * axx / det) + CULL_PIX_SLACK
    ok = ((axx > 0) & (det > 0) & (r2 < 1e30) & (attrs[:, 0].abs() < 1e30)
          & (attrs[:, 1].abs() < 1e30) & (hx < 1e7) & (hy < 1e7))
    rect = torch.stack([torch.ceil(mx - hx), torch.floor(mx + hx),
                        torch.ceil(my - hy), torch.floor(my + hy)], dim=1)
    inf = math.inf
    rect = torch.where(ok[:, None], rect, rect.new_tensor([-inf, inf, -inf, inf]))
    rect = torch.where(dead[:, None], rect.new_tensor([inf, -inf, inf, -inf]), rect)
    return rect, thr


def _warps(x: torch.Tensor) -> torch.Tensor:
    """[T, 256] per-pixel values of a tile -> [T, 4, 64], by the kernels'
    warp footprints (warp w = wy * 2 + wx)."""
    fx, fy = WARP_FOOT
    t = x.shape[0]
    x = x.reshape(t, TILE // fy, fy, TILE // fx, fx).movedim(3, 2)
    return x.reshape(t, (TILE // fy) * (TILE // fx), fx * fy)


def _warp_reach(rect: torch.Tensor, nx: int) -> torch.Tensor:
    """[T, 4] rects (`entry_cull_rect`) of each tile's current entry ->
    [T, 4] bool: the warps whose footprint the cull lets the entry reach."""
    fx, fy = WARP_FOOT
    tid = torch.arange(rect.shape[0], device=rect.device)
    x0 = ((tid % nx) * TILE).to(torch.float64)
    y0 = ((tid // nx) * TILE).to(torch.float64)
    wid = torch.arange((TILE // fx) * (TILE // fy), device=rect.device)
    wx0 = ((wid % (TILE // fx)) * fx).to(torch.float64)
    wy0 = ((wid // (TILE // fx)) * fy).to(torch.float64)
    xl, xh = rect[:, 0:1] - x0[:, None], rect[:, 1:2] - x0[:, None]
    yl, yh = rect[:, 2:3] - y0[:, None], rect[:, 3:4] - y0[:, None]
    return (xl <= wx0 + fx - 1) & (xh >= wx0) & (yl <= wy0 + fy - 1) & (yh >= wy0)


def _warp_counts(needs: torch.Tensor, live: torch.Tensor, reach: torch.Tensor) -> torch.Tensor:
    """One step's `WARP_STATS` counts: `needs` [T, 256] the pairs the kernel
    must decide (a warp visits the entry if any lane has one), `live` [T,
    256] the live ones, `reach` [T, 4] the warps the cull lets through."""
    pairs = _warps(needs).sum(-1)  # [T, 4]
    visit = pairs > 0
    culled = visit & ~reach
    with_live = visit & reach & _warps(live).any(-1)
    dead = visit & reach & ~with_live
    return torch.stack([visit.sum(), with_live.sum(), culled.sum(), (pairs * with_live).sum(),
                        (pairs * dead).sum(), (pairs * culled).sum()])


def raster_fwd_plain(bins: TileBins, attrs: torch.Tensor, bg: torch.Tensor,
                     width: int, height: int, stats: dict | None = None) -> RasterOut:
    """The kernel's arithmetic in PyTorch ops, differentiable by autograd.

    All tiles advance together, one entry of each tile's range per step,
    over a [tiles, 256] pixel state; a tile whose range is exhausted sits
    still. Same operation order as the kernel, so the threshold tests round
    alike. With `stats`, stores under "pairs" the number of (pixel, entry)
    pairs to evaluate, which is the work the kernel's bound counts, and
    under `WARP_STATS` how the kernel's warps meet them: the warp-entries it
    visits (a lane has a pixel not yet saturated), those with a live pair,
    those the cull rejects, and the pairs in each kind of warp-entry (they
    add up to "pairs")."""
    dev = attrs.device
    nx, ny = bins.nx, bins.ny
    num_tiles = nx * ny
    starts = bins.tile_starts[:-1].to(torch.int64)
    counts = bins.tile_starts[1:].to(torch.int64) - starts

    px, py = _tile_pixels(nx, ny, dev)  # [T, 256]
    inside = (px < width) & (py < height)

    T = torch.ones(num_tiles, TILE * TILE, dtype=torch.float32, device=dev)
    done = ~inside
    C = torch.zeros(3, num_tiles, TILE * TILE, dtype=torch.float32, device=dev)
    D = torch.zeros_like(T)
    last = torch.zeros(num_tiles, TILE * TILE, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    warp_counts = torch.zeros(len(WARP_STATS), dtype=torch.int64, device=dev)
    rect = entry_cull_rect(attrs)[0] if stats is not None else None

    n_entries = bins.num_entries
    steps = int(counts.max()) if num_tiles and n_entries else 0
    for k in range(steps):
        active = (k < counts)[:, None]  # [T, 1]
        g = bins.gauss_ids[torch.clamp(starts + k, max=n_entries - 1)].long()
        a = attrs[g]  # [T, 12]
        dx = a[:, 0:1] - px
        dy = a[:, 1:2] - py
        power = -0.5 * (a[:, 2:3] * dx * dx + a[:, 4:5] * dy * dy) - a[:, 3:4] * dx * dy
        alpha = torch.clamp(a[:, 5:6] * torch.exp(power), max=ALPHA_MAX)
        live = active & ~done & (power <= 0.0) & (alpha >= ALPHA_MIN)
        if stats is not None:
            needs = active & ~done
            pairs += needs.sum()
            warp_counts += _warp_counts(needs, live, _warp_reach(rect[g], nx))
        T_new = T * (1.0 - alpha)
        ok = live & (T_new >= T_EPS)
        done = done | (live & (T_new < T_EPS))
        w = torch.where(ok, alpha * T, zero)
        C = C + w[None] * a[:, 6:9].T[:, :, None]
        D = D + w * a[:, 9:10]
        T = torch.where(ok, T_new, T)
        last = torch.where(ok, torch.full_like(last, k + 1), last)
        if k % 32 == 31 and bool((done | ~active).all()):
            break

    def image(x):  # [..., T, 256] -> [..., H, W], contiguous as the kernel's outputs
        lead = x.shape[:-2]
        x = x.reshape(*lead, ny, nx, TILE, TILE).movedim(-2, -3)
        return x.reshape(*lead, ny * TILE, nx * TILE)[..., :height, :width].contiguous()

    if stats is not None:
        stats["pairs"] = int(pairs)
        stats.update(zip(WARP_STATS, warp_counts.tolist()))
    color = image(C + T[None] * bg[:, None, None])
    return color, image(D), image(1.0 - T), image(T), image(last)


def _check_bwd_inputs(attrs, T_final, last, g_color, g_depth, g_alpha,
                      width: int, height: int) -> None:
    dev = attrs.device
    for name, t, dtype, shape in (
        ("T_final", T_final, torch.float32, (height, width)),
        ("last", last, torch.int32, (height, width)),
        ("g_color", g_color, torch.float32, (3, height, width)),
        ("g_depth", g_depth, torch.float32, (height, width)),
        ("g_alpha", g_alpha, torch.float32, (height, width)),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, attrs on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def raster_bwd(bins: TileBins, attrs: torch.Tensor, bg: torch.Tensor,
               T_final: torch.Tensor, last: torch.Tensor, g_color: torch.Tensor,
               g_depth: torch.Tensor, g_alpha: torch.Tensor,
               width: int, height: int) -> torch.Tensor:
    """Gradients of the packed attribute rows from the cotangents of
    `raster_fwd`'s color [3, H, W], depth [H, W] and alpha [H, W], given the
    forward's final T and last contributor.

    Returns d_attrs [N, 12] float32: columns 0-9 mean x/y, conic a/b/c,
    opacity, rgb, depth; columns 10-11 zero. CUDA's conventions: the 0.99
    alpha cap is ignored, dead entries and entries past a pixel's last
    contributor get nothing."""
    _check_inputs(bins, attrs, bg, width, height)
    _check_bwd_inputs(attrs, T_final, last, g_color, g_depth, g_alpha, width, height)
    if attrs.device.type == "cpu":
        return raster_bwd_plain(bins, attrs, bg, T_final, last, g_color, g_depth,
                                g_alpha, width, height)
    if attrs.device.type != "cuda":
        raise ValueError(f"no rasterizer for device {attrs.device}")
    return _raster_bwd_cuda(bins, attrs, bg, T_final, last, g_color, g_depth,
                            g_alpha, width, height)


@functools.cache
def _raster_bwd_fn(entry: str):
    """`raster_bwd` (atomic epilogue) or `raster_bwd_entries` (per-entry,
    with the rows' destinations)."""
    fn = getattr(_build.load("raster_bwd"), entry)
    pointers = 8 if entry == "raster_bwd_entries" else 7
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * pointers
    fn.restype = ctypes.c_int
    return fn


def _raster_bwd_cuda(bins, attrs, bg, T_final, last, g_color, g_depth, g_alpha,
                     width, height, entry_dst: torch.Tensor | None = None) -> torch.Tensor:
    """The atomic epilogue, or with `entry_dst` [E] int64 the per-entry one,
    which stores entry e's row at row entry_dst[e]."""
    per_entry = entry_dst is not None
    fn = _raster_bwd_fn("raster_bwd_entries" if per_entry else "raster_bwd")
    dev = attrs.device
    shape = (bins.num_entries, NUM_GRADS) if per_entry else (attrs.shape[0], ATTR_WIDTH)
    dst = (entry_dst.data_ptr(),) if per_entry else ()
    with torch.cuda.device(dev):
        d_out = torch.zeros(shape, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            bins.tile_starts.data_ptr(), bins.gauss_ids.data_ptr(),
            attrs.data_ptr(), bg.data_ptr(), width, height,
            T_final.data_ptr(), last.data_ptr(), g_color.data_ptr(),
            g_depth.data_ptr(), g_alpha.data_ptr(), d_out.data_ptr(), *dst, stream,
        )
    if err != 0:
        raise RuntimeError(f"raster_bwd launch failed: CUDA error {err}")
    LAUNCHES["raster_bwd"] += 1
    return d_out


# ---------------- segment sum and the route by sort ----------------

def segsum(keys: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """Per-key sums of key-sorted rows: [n, C] float32, row g the sum of
    the rows of `vals` [E, C] float32 whose key (`keys` [E] int32,
    non-decreasing) is g, 0 for absent keys. Rows with a key >= n are
    ignored, NaN included. The kernel needs 1 <= C <= 16. On CUDA one
    `searchsorted` finds the runs, then `segsum_runs` sums them."""
    if keys.device != vals.device:
        raise ValueError(f"keys are on {keys.device}, vals on {vals.device}")
    if keys.dtype != torch.int32 or vals.dtype != torch.float32:
        raise ValueError(f"keys must be int32 and vals float32, got {keys.dtype}, {vals.dtype}")
    if keys.dim() != 1 or vals.dim() != 2 or vals.shape[0] != keys.shape[0]:
        raise ValueError(f"keys [E] and vals [E, C] expected, got {tuple(keys.shape)}, "
                         f"{tuple(vals.shape)}")
    if not 1 <= vals.shape[1] <= 16:
        raise ValueError(f"vals must have 1 to 16 columns, got {vals.shape[1]}")
    if not (keys.is_contiguous() and vals.is_contiguous()):
        raise ValueError("keys and vals must be contiguous")
    if vals.device.type == "cpu":
        return segsum_plain(keys, vals, n)
    if vals.device.type != "cuda":
        raise ValueError(f"no segment sum for device {vals.device}")
    bounds = torch.arange(n + 1, dtype=torch.int32, device=keys.device)
    starts = torch.searchsorted(keys, bounds, out_int32=True)  # first row of each key's run
    return _segsum_runs_cuda(starts, vals, n, vals.shape[1])


def segsum_plain(keys: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """The segment sum in PyTorch ops: rows with a key >= n are zeroed with
    a select (they may hold NaN), then `index_add_` into [n + 1, C] with
    those keys sent to row n, which is dropped."""
    k = keys.to(torch.int64)
    sent = k >= n
    v = torch.where(sent[:, None], torch.zeros((), dtype=vals.dtype, device=vals.device), vals)
    out = torch.zeros(n + 1, vals.shape[1], dtype=vals.dtype, device=vals.device)
    out.index_add_(0, torch.where(sent, n, k), v)
    return out[:n]


def segsum_runs(starts: torch.Tensor, vals: torch.Tensor, n: int,
                width: int | None = None) -> torch.Tensor:
    """Sums by runs of rows: [n, width] float32 (width defaults to C), row g
    the sum of rows [starts[g], starts[g + 1]) of `vals` [E, C] float32, in
    row order; columns C..width-1 are 0. `starts` [n + 1] int32
    non-decreasing. The kernel needs 1 <= C <= width <= 16."""
    dev = vals.device
    for name, t, dtype in (("starts", starts, torch.int32), ("vals", vals, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, vals on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    width = vals.shape[1] if width is None else width
    if vals.dim() != 2 or not 1 <= vals.shape[1] <= width <= 16:
        raise ValueError(f"vals must be [E, C] with 1 <= C <= {width} <= 16, "
                         f"got {tuple(vals.shape)}")
    if starts.shape != (n + 1,):
        raise ValueError(f"starts must be [{n + 1}], got {tuple(starts.shape)}")
    if dev.type == "cpu":
        return segsum_runs_plain(starts, vals, n, width)
    if dev.type != "cuda":
        raise ValueError(f"no segment sum for device {dev}")
    return _segsum_runs_cuda(starts, vals, n, width)


@functools.cache
def _segsum_fn():
    fn = _build.load("segsum").segsum
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def _segsum_runs_cuda(starts, vals, n, width) -> torch.Tensor:
    dev = vals.device
    if n == 0:  # nothing to launch
        return torch.empty(0, width, dtype=torch.float32, device=dev)
    fn = _segsum_fn()
    with torch.cuda.device(dev):
        out = torch.empty(n, width, dtype=torch.float32, device=dev)  # every element written
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(starts.data_ptr(), vals.data_ptr(), n, vals.shape[1], width, out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"segsum launch failed: CUDA error {err}")
    LAUNCHES["segsum"] += 1
    return out


def segsum_runs_plain(starts: torch.Tensor, vals: torch.Tensor, n: int,
                      width: int | None = None) -> torch.Tensor:
    """`segsum_runs` in PyTorch ops: keys from the run lengths, then
    `index_add_` of the runs' rows into the first C columns of zeros."""
    width = vals.shape[1] if width is None else width
    total = int(starts[n]) if n else 0
    keys = torch.repeat_interleave(torch.arange(n, device=vals.device),
                                   (starts[1:] - starts[:-1]).to(torch.int64),
                                   output_size=total)
    out = torch.zeros(n, width, dtype=vals.dtype, device=vals.device)
    out[:, :vals.shape[1]].index_add_(0, keys, vals[:total])
    return out


def sort_route(n_slots: int, width: int, height: int, config: RasterizerConfig) -> bool:
    """Whether the backward routes by sort: the JAX package's rule
    (`tile_raster.py:1254-1255`), on the entry budget it would size for
    `n_slots` Gaussian slots at this image size, `config.entry_budget` or
    `default_entry_budget(n_slots, resolved_ptile // tile)`. With the
    default config that is the case above 262,144 slots below 4096 px."""
    budget = config.entry_budget or default_entry_budget(
        n_slots, config.resolved_ptile(width, height) // config.tile)
    return budget >= SORT_ROUTE_MIN_L


def gaussian_major(bins: TileBins, d_entries: torch.Tensor) -> torch.Tensor:
    """Per-entry rows of `bins.gauss_ids`' order put into Gaussian-major
    order, where the keys `bins.gmaj_ids` are sorted: row `order[e]` takes
    row e. The first step of the two-step route that `raster_bwd_entries`'
    stores make unnecessary; kept as its plain form."""
    return torch.empty_like(d_entries).index_copy_(0, bins.order, d_entries)


def route_by_sort(bins: TileBins, d_gmaj: torch.Tensor, n: int) -> torch.Tensor:
    """Per-entry gradients in Gaussian-major order [E, 10] (as
    `raster_bwd_entries` writes them) -> per-Gaussian rows [n, 12] (columns
    10-11 zero), the port of `_route_by_sort` (`tile_raster.py:1169-1231`):
    `segsum_runs` over the runs `bins.gmaj_starts`, one launch on CUDA. On
    the CPU, bitwise the keys form `segsum_plain(bins.gmaj_ids, d_gmaj, n)`,
    padded."""
    if d_gmaj.shape != (bins.num_entries, NUM_GRADS):
        raise ValueError(f"d_gmaj must be [{bins.num_entries}, {NUM_GRADS}], "
                         f"got {tuple(d_gmaj.shape)}")
    return segsum_runs(bins.gmaj_starts, d_gmaj, n, width=ATTR_WIDTH)


def raster_bwd_entries(bins: TileBins, attrs: torch.Tensor, bg: torch.Tensor,
                       T_final: torch.Tensor, last: torch.Tensor, g_color: torch.Tensor,
                       g_depth: torch.Tensor, g_alpha: torch.Tensor,
                       width: int, height: int) -> torch.Tensor:
    """`raster_bwd` with the per-entry epilogue: d_entries [E, 10] float32 in
    Gaussian-major order (`route_by_sort`'s input): entry e's (of
    `bins.gauss_ids`) gradient terms, summed over the pixels of its tile,
    in the columns of `raster_bwd`, at row `bins.order[e]`. Deterministic:
    each entry belongs to one tile, so no atomics are needed."""
    _check_inputs(bins, attrs, bg, width, height)
    _check_bwd_inputs(attrs, T_final, last, g_color, g_depth, g_alpha, width, height)
    if bins.order.device != attrs.device or bins.order.dtype != torch.int64:
        raise ValueError("bins.order must be int64 on the device of attrs")
    if attrs.device.type == "cpu":
        return raster_bwd_entries_plain(bins, attrs, bg, T_final, last, g_color, g_depth,
                                        g_alpha, width, height)
    if attrs.device.type != "cuda":
        raise ValueError(f"no rasterizer for device {attrs.device}")
    return _raster_bwd_cuda(bins, attrs, bg, T_final, last, g_color, g_depth, g_alpha,
                            width, height, entry_dst=bins.order)


def raster_bwd_plain(bins: TileBins, attrs: torch.Tensor, bg: torch.Tensor,
                     T_final: torch.Tensor, last: torch.Tensor, g_color: torch.Tensor,
                     g_depth: torch.Tensor, g_alpha: torch.Tensor,
                     width: int, height: int, stats: dict | None = None) -> torch.Tensor:
    """The backward kernel's arithmetic in PyTorch ops (hand-derived, no
    autograd), atomic epilogue: per-Gaussian rows [N, 12].

    All tiles step together from the back, one entry of each tile's range
    per step, over a [tiles, 256] pixel state: T is recovered from the
    final T by dividing by (1 - alpha), and `tail` carries
    sum_{j>i} w_j G_j + T_final (g_color . bg - g_alpha). Each step sums
    its per-pixel terms per tile and adds them into the Gaussian's row
    with `index_add_`.

    With `stats`, stores the (pixel, entry) pairs before each pixel's last
    contributor by how far the kernel must take them, which is the work its
    bound counts: "live_pairs" (the whole gradient chain), "faint_pairs"
    (power <= 0 but alpha < 1/255: power, exp and alpha only) and
    "far_pairs" (power > 0: power only); and under `WARP_STATS` how the
    kernel's warps meet those pairs: the warp-entries it visits (before the
    warp's largest last contributor), those with a live pair (which reduce),
    those the cull rejects, and the pairs in each kind (they add up to the
    three pair counts)."""
    d = _bwd_plain(bins, attrs, bg, T_final, last, g_color, g_depth, g_alpha,
                   width, height, False, stats)
    return torch.cat([d, torch.zeros_like(d[:, :2])], dim=1)


def raster_bwd_entries_plain(bins: TileBins, attrs: torch.Tensor, bg: torch.Tensor,
                             T_final: torch.Tensor, last: torch.Tensor,
                             g_color: torch.Tensor, g_depth: torch.Tensor,
                             g_alpha: torch.Tensor, width: int, height: int,
                             stats: dict | None = None) -> torch.Tensor:
    """`raster_bwd_plain` with the per-entry epilogue: each step's per-tile
    sums go to their entry's Gaussian-major row `bins.order[e]`
    (`index_copy_`), not into the Gaussian's row. Returns d_entries [E, 10],
    zero for entries no pixel reached."""
    return _bwd_plain(bins, attrs, bg, T_final, last, g_color, g_depth, g_alpha,
                      width, height, True, stats)


def _bwd_plain(bins, attrs, bg, T_final, last, g_color, g_depth, g_alpha,
               width, height, per_entry: bool, stats) -> torch.Tensor:
    dev = attrs.device
    nx, ny = bins.nx, bins.ny
    num_tiles = nx * ny
    starts = bins.tile_starts[:-1].to(torch.int64)
    counts_t = bins.tile_starts[1:].to(torch.int64) - starts
    px, py = _tile_pixels(nx, ny, dev)

    def tiles(x, fill):  # [..., H, W] -> [..., T, 256], padding with `fill`
        lead = x.shape[:-2]
        x = F.pad(x, (0, nx * TILE - width, 0, ny * TILE - height), value=fill)
        x = x.reshape(*lead, ny, TILE, nx, TILE).movedim(-3, -2)
        return x.reshape(*lead, num_tiles, TILE * TILE)

    T = tiles(T_final, 1.0)
    last_t = tiles(last, 0)
    gC = tiles(g_color, 0.0)  # [3, T, 256]
    gD = tiles(g_depth, 0.0)
    tail = T * (gC[0] * bg[0] + gC[1] * bg[1] + gC[2] * bg[2] - tiles(g_alpha, 0.0))
    rows = bins.num_entries if per_entry else attrs.shape[0]
    entry_row = bins.order if per_entry else None
    d = torch.zeros(rows, NUM_GRADS, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    counts = torch.zeros(3, dtype=torch.int64, device=dev)  # live, faint, far
    warp_counts = torch.zeros(len(WARP_STATS), dtype=torch.int64, device=dev)
    rect = entry_cull_rect(attrs)[0] if stats is not None else None

    n_entries = bins.num_entries
    steps = int(last_t.max()) if last_t.numel() else 0
    for k in reversed(range(steps)):
        active = k < last_t  # [T, 256]
        pos = starts + k
        g = bins.gauss_ids[torch.clamp(pos, max=n_entries - 1)].long()
        a = attrs[g]  # [T, 12]
        dx = a[:, 0:1] - px
        dy = a[:, 1:2] - py
        power = -0.5 * (a[:, 2:3] * dx * dx + a[:, 4:5] * dy * dy) - a[:, 3:4] * dx * dy
        G = torch.exp(power)
        alpha_pre = a[:, 5:6] * G
        alpha = torch.clamp(alpha_pre, max=ALPHA_MAX)
        live = active & (power <= 0.0) & (alpha >= ALPHA_MIN)
        if stats is not None:
            near = active & (power <= 0.0)
            counts += torch.stack([live.sum(), (near & ~live).sum(), (active & ~near).sum()])
            warp_counts += _warp_counts(active, live, _warp_reach(rect[g], nx))
        one_m = 1.0 - alpha
        T_before = torch.where(live, T / one_m, T)
        w = torch.where(live, alpha * T_before, zero)
        Gc = gC[0] * a[:, 6:7] + gC[1] * a[:, 7:8] + gC[2] * a[:, 8:9] + gD * a[:, 9:10]
        d_alpha = torch.where(live, T_before * Gc - tail / one_m, zero)
        tail = tail + w * Gc
        T = T_before
        d_power = d_alpha * alpha_pre  # the cap is ignored
        terms = torch.stack([
            -d_power * (a[:, 2:3] * dx + a[:, 3:4] * dy),
            -d_power * (a[:, 4:5] * dy + a[:, 3:4] * dx),
            -0.5 * dx * dx * d_power,
            -dx * dy * d_power,
            -0.5 * dy * dy * d_power,
            d_alpha * G,
            w * gC[0],
            w * gC[1],
            w * gC[2],
            w * gD,
        ], dim=-1)  # [T, 256, 10]
        # select, not multiply: G overflows to inf on dead entries with power > 0
        terms = torch.where(live[..., None], terms, zero)
        sums = terms.sum(1)  # [T, 10]
        if per_entry:
            has = k < counts_t  # tiles whose range holds an entry k
            d.index_copy_(0, entry_row[pos[has]], sums[has])
        else:
            d.index_add_(0, g, sums)
    if stats is not None:
        stats.update(zip(("live_pairs", "faint_pairs", "far_pairs"), counts.tolist()))
        stats.update(zip(WARP_STATS, warp_counts.tolist()))
    return d


class RasterizeFn(torch.autograd.Function):
    """Differentiable compositing of packed attribute rows over fixed bins:
    forward `raster_fwd` (saving the final T and last contributor), backward
    `raster_bwd` (atomic epilogue), or with `by_sort` `raster_bwd_entries`
    (rows in Gaussian-major order) then `route_by_sort`. On CPU tensors all of them run their plain
    versions, so the forward builds no graph and the hand-derived backward
    is the one used."""

    @staticmethod
    def forward(ctx, attrs: torch.Tensor, bg: torch.Tensor, bins: TileBins,
                width: int, height: int, by_sort: bool = False):
        color, depth, alpha, T, last = raster_fwd(bins, attrs, bg, width, height)
        ctx.save_for_backward(attrs, bg, T, last)
        ctx.bins = bins
        ctx.size = (width, height)
        ctx.by_sort = by_sort
        return color, depth, alpha

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_color, g_depth, g_alpha):
        attrs, bg, T, last = ctx.saved_tensors
        width, height = ctx.size

        def cot(g, *shape):
            if g is None:
                return torch.zeros(*shape, dtype=torch.float32, device=attrs.device)
            return g.to(torch.float32).contiguous()

        g_color = cot(g_color, 3, height, width)
        args = (ctx.bins, attrs, bg, T, last, g_color, cot(g_depth, height, width),
                cot(g_alpha, height, width), width, height)
        if ctx.by_sort:
            d_attrs = route_by_sort(ctx.bins, raster_bwd_entries(*args), attrs.shape[0])
        else:
            d_attrs = raster_bwd(*args)
        d_bg = (g_color * T).sum((1, 2)) if ctx.needs_input_grad[1] else None
        return d_attrs, d_bg, None, None, None, None


def rasterize(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    bg_color: torch.Tensor,
    tile: int = TILE,
    config: RasterizerConfig = RasterizerConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full tile pipeline: bin -> composite, differentiable with respect to
    the projected attributes (and the background). Returns (color [3, H, W],
    depth [1, H, W], alpha [1, H, W]). Nothing is budgeted, so nothing is
    ever dropped; `config` decides the backward's route (`sort_route`, from
    the number of projected Gaussians)."""
    if tile != TILE:
        raise ValueError(f"the tile rasterizer works on {TILE}-px tiles, got {tile}")
    bins = bin_gaussians(proj, width, height, TILE)
    attrs = pack_attrs(proj)
    bg = bg_color.to(device=attrs.device, dtype=torch.float32).contiguous()
    by_sort = sort_route(attrs.shape[0], width, height, config)
    color, depth, alpha = RasterizeFn.apply(attrs, bg, bins, width, height, by_sort)
    return color, depth[None], alpha[None]
