"""Hybrid Gaussian model state: ray-based foreground + free-xyz background.

Port of `scgaussian_tpu/model/gaussians.py` (reference `GaussianModel`,
`scene/gaussian_model.py:34-934`) as an `nn.Module`, with the JAX package's
fixed capacity, alive mask and densification statistics:

- foreground (ray) Gaussians: position is `xyz = rayo + rayd * zval`
  (`scene/gaussian_model.py:127`); only `zval` is a parameter, `rayo` and
  `rayd` are fixed buffers;
- background Gaussians: ordinary 3DGS parameters in a preallocated
  capacity with a `bg_alive` mask buffer;
- densification statistics over the combined axis [Nr + Cb]
  (`xyz_gradient_accum`, `denom`, `max_radii2d`), buffers that
  `model.densify.update_stats` accumulates into in place.

`create_model` builds the model from promoted match rays
(`create_from_pcd`, `scene/gaussian_model.py:362-468`).

The 12 `GaussianParams` leaves of the JAX model are this module's
parameters under the same names. Activations follow
`scene/gaussian_model.py:36-51`: exp scaling, sigmoid opacity, normalized
quaternion. SH is evaluated at the maximum degree with the bands above
`active_sh_degree` zeroed, which equals evaluating at the active degree.
"""

from __future__ import annotations

import functools
from typing import Mapping

import numpy as np
import torch
from torch import nn

from scgaussian_tpu_torch import resolve_device
from scgaussian_tpu_torch.core import transforms
from scgaussian_tpu_torch.core.sh import rgb_to_sh
from scgaussian_tpu_torch.model.knn import knn_mean_sq_dist

# coefficient band sizes for SH degrees 1..3 within f_rest (15 coeffs at deg 3)
_SH_BANDS = [(0, 3, 1), (3, 8, 2), (8, 15, 3)]  # (start, end, required degree)


@functools.cache
def _band_degrees(num_rest: int, device: torch.device) -> torch.Tensor:
    """[num_rest] int32: the SH degree each f_rest coefficient needs, built
    once per size and device so a render copies nothing from the host."""
    band = np.zeros((num_rest,), dtype=np.int32)
    for s, e, d in _SH_BANDS:
        band[s:e] = d
    return torch.as_tensor(band, device=device)

# the JAX `GaussianParams` leaves, fg rows [Nr, ...] then bg rows [Cb, ...]
PARAM_NAMES = (
    "zval",  # [Nr, 1]
    "f_dc",  # [Nr, 1, 3]
    "f_rest",  # [Nr, K-1, 3]
    "scaling",  # [Nr, 3] (log domain)
    "rotation",  # [Nr, 4]
    "opacity",  # [Nr, 1] (logit domain)
    "bg_xyz",  # [Cb, 3]
    "bg_f_dc",  # [Cb, 1, 3]
    "bg_f_rest",  # [Cb, K-1, 3]
    "bg_scaling",  # [Cb, 3]
    "bg_rotation",  # [Cb, 4]
    "bg_opacity",  # [Cb, 1]
)
BUFFER_NAMES = (
    "rayo",  # [Nr, 3] fixed ray origins
    "rayd",  # [Nr, 3] fixed ray directions
    "bg_alive",  # [Cb] bool
    "active_sh_degree",  # [] int32, masks SH bands
)
STAT_NAMES = (
    "xyz_gradient_accum",  # [N, 1]
    "denom",  # [N, 1]
    "max_radii2d",  # [N]
)


class GaussianModel(nn.Module):
    """Parameters + fixed buffers + densification statistics of the hybrid
    model. The statistics start at zero unless `leaves` holds them."""

    def __init__(self, leaves: Mapping[str, torch.Tensor], max_sh_degree: int,
                 spatial_lr_scale: float = 1.0):
        super().__init__()
        for name in PARAM_NAMES:
            self.register_parameter(
                name, nn.Parameter(leaves[name].to(torch.float32).contiguous())
            )
        self.register_buffer("rayo", leaves["rayo"].to(torch.float32).contiguous())
        self.register_buffer("rayd", leaves["rayd"].to(torch.float32).contiguous())
        self.register_buffer("bg_alive", leaves["bg_alive"].to(torch.bool))
        self.register_buffer(
            "active_sh_degree", torch.as_tensor(leaves["active_sh_degree"]).to(torch.int32)
        )
        n = self.total
        dev = self.zval.device
        for name, shape in zip(STAT_NAMES, ((n, 1), (n, 1), (n,))):
            stat = leaves.get(name)
            if stat is None:
                stat = torch.zeros(shape, dtype=torch.float32, device=dev)
            elif tuple(stat.shape) != shape:
                raise ValueError(f"{name} must be {list(shape)}, got {list(stat.shape)}")
            self.register_buffer(name, stat.to(torch.float32).contiguous())
        self.max_sh_degree = int(max_sh_degree)
        self.spatial_lr_scale = float(spatial_lr_scale)

    # ---------------- sizes ----------------
    @property
    def num_ray(self) -> int:
        return self.zval.shape[0]

    @property
    def bg_capacity(self) -> int:
        return self.bg_xyz.shape[0]

    @property
    def total(self) -> int:
        return self.num_ray + self.bg_capacity

    # ---------------- combined getters (reference property analogs) --------
    def get_xyz(self) -> torch.Tensor:
        """`scene/gaussian_model.py:125-131`."""
        fg = self.rayo + self.rayd * self.zval
        return torch.cat([fg, self.bg_xyz], dim=0)

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(torch.cat([self.scaling, self.bg_scaling], dim=0))

    def get_rotation(self) -> torch.Tensor:
        rot = torch.cat([self.rotation, self.bg_rotation], dim=0)
        return rot / (torch.linalg.norm(rot, dim=-1, keepdim=True) + 1e-12)

    def get_opacity_raw(self) -> torch.Tensor:
        """Sigmoid opacity WITHOUT the alive mask (reference `get_opacity`)."""
        return torch.sigmoid(torch.cat([self.opacity, self.bg_opacity], dim=0))

    def alive_mask(self) -> torch.Tensor:
        fg = torch.ones(self.num_ray, dtype=torch.bool, device=self.bg_alive.device)
        return torch.cat([fg, self.bg_alive], dim=0)

    def get_opacity(self) -> torch.Tensor:
        """Activated opacity with dead bg slots forced to 0 (culled by the
        rasterizer's alpha >= 1/255 test)."""
        return self.get_opacity_raw() * self.alive_mask().to(torch.float32)[:, None]

    def get_features(self) -> torch.Tensor:
        """[N, K, 3] with the SH bands above `active_sh_degree` zeroed."""
        f_dc = torch.cat([self.f_dc, self.bg_f_dc], dim=0)
        f_rest = torch.cat([self.f_rest, self.bg_f_rest], dim=0)
        if f_rest.shape[1] > 0:
            band = _band_degrees(f_rest.shape[1], f_rest.device)
            keep = (band[None, :, None] <= self.active_sh_degree).to(f_rest.dtype)
            f_rest = f_rest * keep
        return torch.cat([f_dc, f_rest], dim=1)

    def get_covariance(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        """Packed [N, 6] covariance (`scene/gaussian_model.py:154-155`)."""
        cov = transforms.covariance_from_scaling_rotation(
            self.get_scaling(), scaling_modifier, self.get_rotation()
        )
        return transforms.strip_symmetric(cov)

    @torch.no_grad()
    def oneup_sh_degree(self) -> "GaussianModel":
        """`scene/gaussian_model.py:157-159`, in place; returns the model."""
        self.active_sh_degree.copy_(
            torch.clamp(self.active_sh_degree + 1, max=self.max_sh_degree)
        )
        return self


def model_from_numpy(
    leaves: Mapping[str, np.ndarray],
    max_sh_degree: int,
    device: str | torch.device | None = None,
    spatial_lr_scale: float = 1.0,
) -> GaussianModel:
    """A model from numpy arrays named as in `PARAM_NAMES` + `BUFFER_NAMES`
    (and optionally `STAT_NAMES`, zeros when absent), e.g. the leaves of a
    JAX `GaussianModel` carried across with `np.asarray`. Runs on `device`
    (default: the GPU)."""
    dev = resolve_device(device)
    missing = [n for n in PARAM_NAMES + BUFFER_NAMES if n not in leaves]
    if missing:
        raise ValueError(f"missing model leaves: {missing}")
    tensors = {n: torch.tensor(np.asarray(leaves[n]), device=dev) for n in leaves}
    return GaussianModel(tensors, max_sh_degree, spatial_lr_scale)


def create_model(
    rayo: np.ndarray,
    rayd: np.ndarray,
    zval: np.ndarray,
    colors: np.ndarray,
    max_sh_degree: int,
    spatial_lr_scale: float,
    bg_capacity: int = 65536,
    initial_opacity: float = 0.1,
    device: str | torch.device | None = None,
) -> GaussianModel:
    """The hybrid model from promoted match points (port of JAX
    `create_model`, `scgaussian_tpu/model/gaussians.py:158-220`; reference
    `create_from_pcd`): SH DC from the warped match colors, log-scale from
    the 3-NN mean squared distance (`knn_mean_sq_dist`, floored at 1e-7),
    identity rotations, opacity `initial_opacity`, `bg_capacity` dead
    background slots, zero densify statistics. Runs on `device` (default:
    the GPU)."""
    dev = resolve_device(device)
    nr = zval.shape[0]
    k_coeffs = (max_sh_degree + 1) ** 2
    f32 = dict(dtype=torch.float32, device=dev)

    points = torch.as_tensor(np.asarray(rayo + rayd * zval.reshape(-1, 1), np.float32),
                             device=dev)
    dist2 = torch.clamp(knn_mean_sq_dist(points, 3), min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    identity = torch.tensor([1.0, 0.0, 0.0, 0.0], **f32)
    cb = bg_capacity
    leaves = dict(
        zval=torch.as_tensor(np.asarray(zval, np.float32).reshape(-1, 1), device=dev),
        f_dc=rgb_to_sh(torch.as_tensor(np.asarray(colors, np.float32), device=dev))[:, None, :],
        f_rest=torch.zeros(nr, k_coeffs - 1, 3, **f32),
        scaling=scales,
        rotation=identity.repeat(nr, 1),
        opacity=transforms.inverse_sigmoid(torch.full((nr, 1), initial_opacity, **f32)),
        bg_xyz=torch.zeros(cb, 3, **f32),
        bg_f_dc=torch.zeros(cb, 1, 3, **f32),
        bg_f_rest=torch.zeros(cb, k_coeffs - 1, 3, **f32),
        bg_scaling=torch.full((cb, 3), -10.0, **f32),
        bg_rotation=identity.repeat(cb, 1),
        bg_opacity=torch.full((cb, 1), -10.0, **f32),
        rayo=torch.as_tensor(np.asarray(rayo, np.float32), device=dev),
        rayd=torch.as_tensor(np.asarray(rayd, np.float32), device=dev),
        bg_alive=torch.zeros(cb, dtype=torch.bool, device=dev),
        active_sh_degree=torch.tensor(0, dtype=torch.int32, device=dev),
    )
    return GaussianModel(leaves, max_sh_degree, spatial_lr_scale)
