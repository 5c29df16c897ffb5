"""User-facing render API.

Port of `scgaussian_tpu/renderer/api.py`, the contract of the reference
`render()` (`gaussian_renderer/__init__.py:20-118`): a camera and raw
Gaussian attributes in; RGB image, rendered depth, rendered alpha, screen
radii and a visibility mask out. `mean2d_offset` ([N, 2] zeros in pixel
units) stands in for the reference's `screenspace_points` whose gradient is
read for densification.

Backends: "cuda" (binning + the CUDA compositing kernels, forward and
backward; on CPU tensors their plain PyTorch versions) and "oracle" (the
dense reference, differentiated by autograd). Both are differentiable with
respect to every Gaussian input and `mean2d_offset`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from scgaussian_tpu_torch.config import RasterizerConfig
from scgaussian_tpu_torch.core.cameras import Camera
from scgaussian_tpu_torch.renderer import oracle as oracle_mod
from scgaussian_tpu_torch.renderer import project as project_mod
from scgaussian_tpu_torch.renderer import raster


@dataclasses.dataclass(frozen=True)
class RenderOutput:
    render: torch.Tensor  # [3, H, W]
    rendered_depth: torch.Tensor  # [1, H, W]
    rendered_alpha: torch.Tensor  # [1, H, W]
    radii: torch.Tensor  # [N] int32
    visibility_filter: torch.Tensor  # [N] bool (radii > 0)
    overflow: torch.Tensor  # [] int32: always 0, nothing is budgeted here


def render(
    camera: Camera,
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    bg_color: torch.Tensor,
    scales: Optional[torch.Tensor] = None,
    rotations: Optional[torch.Tensor] = None,
    shs: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    active_sh_degree: int = 0,
    scaling_modifier: float = 1.0,
    mean2d_offset: Optional[torch.Tensor] = None,
    backend: str = "cuda",
    tile: int = oracle_mod.TILE,
    entry_budget: Optional[int] = None,
    aligned_budget: Optional[int] = None,
    ptile: Optional[int] = None,
    tile_cull: bool = True,
) -> RenderOutput:
    """Render one view. `backend` is "cuda" (tile pipeline) or "oracle".

    `entry_budget`, `aligned_budget`, `ptile` and `tile_cull` are the JAX
    package's TPU capacity and layout knobs, accepted so callers of either
    package pass the same arguments. The CUDA path sizes its buffers per
    frame and bins on the 16-px tile; `entry_budget` and `ptile` decide its
    backward's route, as in JAX (`raster.sort_route`), and the other two
    are ignored."""
    del aligned_budget, tile_cull
    proj = project_mod.project(
        camera,
        means3d,
        opacities,
        scales=scales,
        rotations=rotations,
        shs=shs,
        colors_precomp=colors_precomp,
        cov3d_precomp=cov3d_precomp,
        active_sh_degree=active_sh_degree,
        scaling_modifier=scaling_modifier,
    )
    if mean2d_offset is not None:
        proj = dataclasses.replace(proj, mean2d=proj.mean2d + mean2d_offset)

    if backend == "oracle":
        img, dep, alp = oracle_mod.composite_dense(
            proj, camera.width, camera.height, bg_color, tile=tile
        )
    elif backend == "cuda":
        config = RasterizerConfig(tile=tile, entry_budget=entry_budget, ptile=ptile or 0)
        img, dep, alp = raster.rasterize(
            proj, camera.width, camera.height, bg_color, tile=tile, config=config
        )
    else:
        raise ValueError(f"unknown backend: {backend!r}")

    return RenderOutput(
        render=img,
        rendered_depth=dep,
        rendered_alpha=alp,
        radii=proj.radius,
        visibility_filter=proj.valid,
        overflow=torch.zeros((), dtype=torch.int32, device=img.device),
    )
