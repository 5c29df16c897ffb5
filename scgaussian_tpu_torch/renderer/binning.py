"""Tile binning: Gaussian -> depth-ordered entry ranges per 16-px tile.

The CUDA pipeline's shape (diff_gaussian_rasterization's
duplicateWithKeys + radix sort + identifyTileRanges), in torch ops; it
replaces `scgaussian_tpu/renderer/binning.py::bin_gaussians`, whose
budgets, processing tiles and segment alignment are TPU-only:

  1. tiles per Gaussian from the per-axis `ext` rect on the tile grid
     (never larger than CUDA's square getRect, same rendered output);
  2. exclusive scan of the counts, then one entry per covered tile,
     laid out in Gaussian-index order;
  3. ONE stable sort on the int64 key `tile << 32 | float_bits(depth)`.
     Depth is > 0.2 for every binned Gaussian (near cull), so its float
     bits sort like the floats; stability breaks depth ties by index, as
     `oracle.depth_order` does;
  4. per-tile [start, end) ranges from a bincount + cumsum.

Buffers are sized exactly per frame (one host sync reads the entry count),
so nothing is ever truncated. `default_entry_budget` (the JAX package's
budget rule) sizes nothing here; it decides the backward's route
(`raster.sort_route`).

The bins keep the entries' Gaussian-major order beside the sorted one:
before the sort the entries are laid out Gaussian by Gaussian, so
`gmaj_ids` is non-decreasing, Gaussian g's entries fill the Gaussian-major
slots [gmaj_starts[g], gmaj_starts[g + 1]) (the exclusive scan of step 2,
its total appended), and `order` maps each sorted slot to its
Gaussian-major slot (the sort's permutation). The sort-route backward
stores each entry's gradient row at `order[e]`
(`raster.raster_bwd_entries`) and sums the runs
of `gmaj_starts` (`raster.route_by_sort`), without a second sort and
without a reordered copy.

`row_lo`/`ny_rows` restrict the bins to tile rows [row_lo, row_lo +
ny_rows), the tile-row sharding hook of `parallel/tiles.py` (the JAX
package's `bin_gaussians(row_lo, ny_rows)`): only entries that touch those
rows are made, tile ids are local to the slice and `TileBins.row_lo`
records the offset. Each local tile's entries and their order are those of
the same tile in the unrestricted bins (the same stable sort on the same
depths, ties by Gaussian index), so each tile composites to the same bits.
The slice may run past the image's last tile row (rows padded to a
multiple of the shard count); those rows are empty.
"""

from __future__ import annotations

import dataclasses

import torch

from scgaussian_tpu_torch.renderer.project import ProjectedGaussians, tile_rect
from scgaussian_tpu_torch.utils.profiling import count, span


@dataclasses.dataclass(frozen=True)
class TileBins:
    """Tile t owns entries [tile_starts[t], tile_starts[t + 1]) of
    `gauss_ids`, front to back."""

    gauss_ids: torch.Tensor  # [L] int32 Gaussian index per entry
    tile_starts: torch.Tensor  # [T + 1] int32
    nx: int  # tiles per row
    ny: int  # tile rows of these bins (the slice's, when restricted)
    gmaj_ids: torch.Tensor  # [L] int32 Gaussian per Gaussian-major slot, non-decreasing
    gmaj_starts: torch.Tensor  # [N + 1] int32: Gaussian g's Gaussian-major slots start here
    order: torch.Tensor  # [L] int64: sorted slot -> Gaussian-major slot
    row_lo: int  # the first tile row of these bins in the image's grid
    grid_ny: int  # tile rows of the image's whole grid

    @property
    def num_entries(self) -> int:
        return self.gauss_ids.shape[0]


def default_entry_budget(n: int, ptile_factor: int = 1) -> int:
    """The JAX package's tile-entry budget for n primitives
    (`scgaussian_tpu/renderer/binning.py:83-102`): the next power of two
    >= max(4n / ptile_factor, 16384)."""
    want = max(4 * n // max(ptile_factor, 1), 1 << 14)
    return 1 << (want - 1).bit_length()


@span("render.bin")
def bin_gaussians(
    proj: ProjectedGaussians, width: int, height: int, tile: int = 16,
    row_lo: int | None = None, ny_rows: int | None = None,
) -> TileBins:
    nx = (width + tile - 1) // tile
    grid_ny = (height + tile - 1) // tile
    if row_lo is None:
        row_lo, ny = 0, grid_ny
    elif ny_rows is None or ny_rows < 1 or row_lo < 0:
        raise ValueError(f"row_lo {row_lo} needs ny_rows >= 1 and row_lo >= 0, got {ny_rows}")
    else:
        ny = ny_rows
    num_tiles = nx * ny
    dev = proj.depth.device
    with torch.no_grad():
        rect_min, rect_max = tile_rect(
            proj.mean2d, proj.ext[:, 0], width, height, tile, radius_y=proj.ext[:, 1]
        )
        if row_lo or ny != grid_ny:
            # the rect's rows clamped to the slice, relabelled locally
            lo = torch.tensor([0, row_lo], dtype=rect_min.dtype, device=dev)
            hi = torch.tensor([nx, row_lo + ny], dtype=rect_min.dtype, device=dev)
            count("host_syncs", 2)  # the copies from the host wait for the device
            rect_min = torch.minimum(torch.maximum(rect_min, lo), hi) - lo
            rect_max = torch.minimum(torch.maximum(rect_max, lo), hi) - lo
        span = rect_max - rect_min  # [N, 2] tiles covered per axis
        cov = span[:, 0] * span[:, 1]
        # CUDA duplicates only Gaussians with radius > 0
        cov = torch.where(proj.radius > 0, cov, torch.zeros_like(cov)).to(torch.int64)

        n = cov.shape[0]
        gid = torch.repeat_interleave(torch.arange(n, device=dev), cov)
        count("host_syncs", 2)  # the entry count, to size the output, and its check of the repeats
        count("bin.entries", gid.shape[0])
        if gid.shape[0] >= 2**31:
            raise ValueError(f"{gid.shape[0]} tile entries overflow the int32 ranges")
        # exclusive scan with the total appended: Gaussian g's Gaussian-major slots
        gmaj_starts = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        torch.cumsum(cov, 0, dtype=torch.int32, out=gmaj_starts[1:])
        j = torch.arange(gid.shape[0], device=dev) - gmaj_starts[gid]
        w = span[gid, 0].to(torch.int64)
        tx = rect_min[gid, 0].to(torch.int64) + j % w
        ty = rect_min[gid, 1].to(torch.int64) + j // w
        tile_id = ty * nx + tx

        depth_bits = proj.depth.detach().contiguous().view(torch.int32).to(torch.int64)
        key = (tile_id << 32) | depth_bits[gid]
        order = torch.sort(key, stable=True).indices
        counts = torch.bincount(tile_id, minlength=num_tiles)
        count("host_syncs", 2)  # the ids' least and largest value, to check and size the bins
        starts = torch.zeros(num_tiles + 1, dtype=torch.int32, device=dev)
        starts[1:] = torch.cumsum(counts, 0)
        gid = gid.to(torch.int32)
    return TileBins(
        gauss_ids=gid[order].contiguous(),
        tile_starts=starts,
        nx=nx,
        ny=ny,
        gmaj_ids=gid,
        gmaj_starts=gmaj_starts,
        order=order,
        row_lo=row_lo,
        grid_ny=grid_ny,
    )
