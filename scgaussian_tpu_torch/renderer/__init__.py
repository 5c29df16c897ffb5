"""Tile-based Gaussian rasterizer for NVIDIA Hopper.

Port of `scgaussian_tpu/renderer`:

- `project` : EWA projection, covariance, SH->RGB (torch ops, autograd)
- `binning` : Gaussian -> per-tile depth-ordered entry ranges (torch ops)
- `raster`  : the CUDA compositing kernels' wrappers (forward, backward),
              their plain versions and the autograd Function
- `oracle`  : dense PyTorch reference renderer (the in-package spec)
- `render`  : user-facing API mirroring `gaussian_renderer.render()`
"""

from scgaussian_tpu_torch.renderer.api import RenderOutput, render  # noqa: F401
