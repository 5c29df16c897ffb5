"""Primitive + tile-row sharded rendering on a (prim, tiles) grid of ranks.

Port of `scgaussian_tpu/parallel/primitives.py`. The ranks form an n_prim x
n_tiles grid (`make_group_grid`, the counterpart of `make_mesh_2d`): rank
p * n_tiles + t is in the prim group of column t and the tiles group of
row p. Rank (p, t) projects its N / n_prim shard of the Gaussians, the
projected attributes are all-gathered over its prim group, and it then
composites tile-row slice t over its tiles group (`tiles.py`).

The backward: the tiles group's all-reduce (`tiles.SumGrad`) leaves every
rank the whole gradient of the gathered attributes, so the all-gather's
transpose keeps the rank's own shard's rows of it (JAX's reduce-scatter;
gloo has none, and the sum has been taken). Every rank passes all N inputs
and projects its shard of them (`ShardRows`), whose backward all-gathers
the shards' gradients, so each rank holds the whole gradient of every
input, as it holds the inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from scgaussian_tpu_torch.config import RasterizerConfig
from scgaussian_tpu_torch.core.cameras import Camera
from scgaussian_tpu_torch.parallel.tiles import rasterize_tile_sharded
from scgaussian_tpu_torch.renderer import project as project_mod
from scgaussian_tpu_torch.renderer.project import ProjectedGaussians


@dataclasses.dataclass(frozen=True)
class GroupGrid:
    """This rank's groups in an n_prim x n_tiles grid of ranks."""

    prim: object  # the ranks that share this rank's tile-row slice
    tiles: object  # the ranks that share this rank's primitive shard
    n_prim: int
    n_tiles: int


def make_group_grid(n_prim: int, n_tiles: int) -> GroupGrid:
    """Every rank's prim and tiles groups (`new_group`, called by every rank
    for every group in one order). The grid must hold every rank."""
    world = dist.get_world_size()
    if n_prim * n_tiles != world:
        raise ValueError(f"a {n_prim} x {n_tiles} grid in a world of {world}")
    p, t = divmod(dist.get_rank(), n_tiles)
    prim = [dist.new_group([q * n_tiles + c for q in range(n_prim)]) for c in range(n_tiles)]
    tiles = [dist.new_group([q * n_tiles + c for c in range(n_tiles)]) for q in range(n_prim)]
    return GroupGrid(prim=prim[t], tiles=tiles[p], n_prim=n_prim, n_tiles=n_tiles)


class GatherShards(torch.autograd.Function):
    """Each rank's [n / P, C] shard -> [n, C], shards in rank order, on every
    rank of `group`. The backward keeps the rank's own rows of a cotangent
    that is already the whole gradient on every rank."""

    @staticmethod
    def forward(ctx, shard: torch.Tensor, group):
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        shard = shard.contiguous()
        parts = [torch.empty_like(shard) for _ in range(world)]
        dist.all_gather(parts, shard, group=group)
        ctx.rows = (rank * shard.shape[0], shard.shape[0])
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        r0, rows = ctx.rows
        return g[r0:r0 + rows].contiguous(), None


class ShardRows(torch.autograd.Function):
    """[n, ...] -> this rank's rows [r * n / P, (r + 1) * n / P) of it, P
    the size of `group`; the backward all-gathers the shards' gradients
    into the whole [n, ...] gradient on every rank."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group):
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        per = x.shape[0] // world
        ctx.group = group
        return x[rank * per:(rank + 1) * per]

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        parts = [torch.empty_like(g) for _ in range(dist.get_world_size(ctx.group))]
        dist.all_gather(parts, g, group=ctx.group)
        return torch.cat(parts), None


def gather_projection(proj: ProjectedGaussians, group) -> ProjectedGaussians:
    """The projected attributes of every rank's shard, in rank order: the
    differentiable fields in one all-gather, the integer ones in another."""
    floats = torch.cat([proj.mean2d, proj.depth[:, None], proj.conic, proj.color,
                        proj.opacity[:, None]], dim=1)
    ints = torch.cat([proj.radius[:, None].to(torch.int32), proj.ext.to(torch.int32),
                      proj.valid[:, None].to(torch.int32)], dim=1)
    f = GatherShards.apply(floats, group)
    with torch.no_grad():
        i = GatherShards.apply(ints, group)
    return ProjectedGaussians(
        mean2d=f[:, 0:2], depth=f[:, 2], conic=f[:, 3:6], color=f[:, 6:9], opacity=f[:, 9],
        radius=i[:, 0].contiguous(), valid=i[:, 3].to(torch.bool),
        ext=i[:, 1:3].contiguous(),
    )


def render_sharded(
    grid: GroupGrid,
    camera: Camera,
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    shs: torch.Tensor,
    bg_color: torch.Tensor,
    active_sh_degree: int = 3,
    tile: int = 16,
    config: Optional[RasterizerConfig] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable render with the N Gaussians sharded over the prim
    groups and the tile rows over the tiles groups. Every rank passes all N
    inputs (N a multiple of n_prim) and projects its own shard of them.

    Returns (color [3, H, W], depth [1, H, W], alpha [1, H, W], overflow []
    int32: 0), the same on every rank; the loss must be too."""
    n = means3d.shape[0]
    if n % grid.n_prim:
        raise ValueError(f"{n} Gaussians do not split over {grid.n_prim} primitive shards")
    mine = [ShardRows.apply(x, grid.prim) for x in (means3d, opacities, scales, rotations, shs)]
    proj = project_mod.project(camera, mine[0], mine[1], scales=mine[2], rotations=mine[3],
                               shs=mine[4], active_sh_degree=active_sh_degree)
    proj = gather_projection(proj, grid.prim)
    return rasterize_tile_sharded(grid.tiles, proj, camera.width, camera.height, bg_color,
                                  tile=tile, config=config or RasterizerConfig())
