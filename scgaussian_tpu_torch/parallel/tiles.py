"""Tile-row sharded rendering of one view over a process group.

Port of `scgaussian_tpu/parallel/tiles.py`. The tile grid's rows are padded
to a multiple of the group's size and split into contiguous slices; every
rank holds the full projected attributes, bins and composites only its own
slice (`raster.rasterize_rows`: the compositing kernels take the slice's
tile-row offset), and the slabs are all-gathered into the image. Each
tile's entries, depth order and arithmetic are those of the unsharded
render, so the image is bitwise `raster.rasterize`'s.

The backward is the transpose that JAX's `shard_map` inserts: each rank
takes its own slab's rows of the image's cotangent (every rank computes
the same loss on the same gathered image), composites that slab's
gradients, and the attribute gradients, partial per slab, are all-reduced
(SUM) over the group, because the attributes are replicated. Both
collectives are autograd Functions of this module (gloo has no
reduce-scatter, and `torch.distributed.nn`'s all-gather is deprecated).
NCCL runs both on CUDA tensors and gloo on CPU tensors; gloo's all-gather
refuses CUDA tensors, and that raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from scgaussian_tpu_torch.config import RasterizerConfig
from scgaussian_tpu_torch.renderer import raster
from scgaussian_tpu_torch.renderer.project import ProjectedGaussians


class SumGrad(torch.autograd.Function):
    """Identity in the forward; the backward sums the cotangent over
    `group`: the transpose for an input that every rank holds whole and
    uses for a part of the output."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class GatherRows(torch.autograd.Function):
    """Each rank's slab [C, R_r, W] (rank r's rows start at r * `slab_px`,
    R_r <= `slab_px`) -> the image [C, `height`, W] on every rank: the slabs
    are padded to `slab_px` rows, all-gathered, stacked and cropped. The
    backward gives each rank its own rows of the image's cotangent."""

    @staticmethod
    def forward(ctx, slab: torch.Tensor, group, slab_px: int, height: int):
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        padded = F.pad(slab, (0, 0, 0, slab_px - slab.shape[1])).contiguous()
        parts = [torch.empty_like(padded) for _ in range(world)]
        dist.all_gather(parts, padded, group=group)
        ctx.rows = (rank * slab_px, slab.shape[1])
        return torch.cat(parts, dim=1)[:, :height].contiguous()

    @staticmethod
    def backward(ctx, g):
        y0, rows = ctx.rows
        return g[:, y0:y0 + rows].contiguous(), None, None, None


def row_slices(height: int, world: int, tile: int = raster.TILE) -> Tuple[int, int]:
    """(tile rows per rank, padded tile rows): the grid's rows padded to a
    multiple of `world`, as the JAX package pads them."""
    ny = (height + tile - 1) // tile
    rows_per = (ny + world - 1) // world
    return rows_per, rows_per * world


def rasterize_tile_sharded(
    group,
    proj: ProjectedGaussians,
    width: int,
    height: int,
    bg_color: torch.Tensor,
    tile: int = raster.TILE,
    config: RasterizerConfig = RasterizerConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`raster.rasterize` with the tile grid's rows sharded over `group`:
    rank r composites tile rows [r * rows_per, (r + 1) * rows_per)
    (`row_slices`). Differentiable with respect to the projected attributes
    (and the background); the loss must be the same on every rank.

    Returns (color [3, H, W], depth [1, H, W], alpha [1, H, W], overflow []
    int32), the same on every rank; overflow is always 0 (nothing is
    budgeted)."""
    if tile != raster.TILE:
        raise ValueError(f"the tile rasterizer works on {raster.TILE}-px tiles, got {tile}")
    rows_per, _ = row_slices(height, dist.get_world_size(group))
    row_lo = dist.get_rank(group) * rows_per
    attrs = SumGrad.apply(raster.pack_attrs(proj), group)
    bg = SumGrad.apply(bg_color, group) if bg_color.requires_grad else bg_color
    color, depth, alpha = raster.rasterize_rows(proj, width, height, bg, row_lo, rows_per,
                                                config, attrs=attrs)
    image = GatherRows.apply(torch.cat([color, depth, alpha]), group, rows_per * raster.TILE,
                             height)
    overflow = torch.zeros((), dtype=torch.int32, device=image.device)
    return image[:3], image[3:4], image[4:5], overflow
