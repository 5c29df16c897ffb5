"""Rotation / covariance / activation helpers for the Gaussian model.

Port of `scgaussian_tpu/core/transforms.py` (reference
`utils/general_utils.py:70-116`, `scene/gaussian_model.py:36-51`). All
functions take batched [N, ...] float32 tensors.
"""

from __future__ import annotations

import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """logit; matches `utils/general_utils.py:19-20`."""
    return torch.log(x / (1.0 - x))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (r, x, y, z) -> rotation matrix [..., 3, 3]; the input is
    normalized internally (`build_rotation`, `utils/general_utils.py:84-105`)."""
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], dim=-1
    )
    row1 = torch.stack(
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], dim=-1
    )
    row2 = torch.stack(
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], dim=-1
    )
    return torch.stack([row0, row1, row2], dim=-2)


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s) (`utils/general_utils.py:107-116`); `s` is activated."""
    return quat_to_rotmat(q) * s[..., None, :]


def covariance_from_scaling_rotation(
    scaling: torch.Tensor, scaling_modifier: float, rotation: torch.Tensor
) -> torch.Tensor:
    """Full symmetric [..., 3, 3] Sigma = L L^T with L = R S
    (`build_covariance_from_scaling_rotation`, `scene/gaussian_model.py:37-41`).
    A float32 matmul: TF32 is off package-wide (see the package docstring)."""
    L = build_scaling_rotation(scaling_modifier * scaling, rotation)
    return L @ L.transpose(-1, -2)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] symmetric -> packed (xx, xy, xz, yy, yz, zz)
    (`strip_lowerdiag`, `utils/general_utils.py:70-79`)."""
    return torch.stack(
        [
            cov[..., 0, 0],
            cov[..., 0, 1],
            cov[..., 0, 2],
            cov[..., 1, 1],
            cov[..., 1, 2],
            cov[..., 2, 2],
        ],
        dim=-1,
    )



def unpack_symmetric(six: torch.Tensor) -> torch.Tensor:
    """Packed 6-vector -> full symmetric [..., 3, 3] matrix."""
    xx, xy, xz, yy, yz, zz = (six[..., i] for i in range(6))
    row0 = torch.stack([xx, xy, xz], dim=-1)
    row1 = torch.stack([xy, yy, yz], dim=-1)
    row2 = torch.stack([xz, yz, zz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def normalize(v: torch.Tensor, axis: int = -1, eps: float = 0.0) -> torch.Tensor:
    n = torch.linalg.norm(v, dim=axis, keepdim=True)
    return v / (n + eps)
