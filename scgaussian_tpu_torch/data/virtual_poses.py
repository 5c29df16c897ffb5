"""Camera pose interpolation for video rendering.

A copy of the JAX package's `data/virtual_poses.py`.

Implements the live functions of the reference's `utils/virtual_poses.py`:
`interpolate_virtual_poses_sequential` (`:181-209`, used by the Tanks video
spiral at `scene/dataset_readers.py:785`) and `get_near_virtual_pose`
(`:150-178`). scipy-free quaternion slerp."""

from __future__ import annotations

import numpy as np

from scgaussian_tpu_torch.data.colmap import qvec2rotmat, rotmat2qvec
from scgaussian_tpu_torch.data.pose_utils import poses_avg, viewmatrix


def _slerp_rotmat(R0: np.ndarray, R1: np.ndarray, ratio: float) -> np.ndarray:
    """Slerp between two rotation matrices at fraction `ratio` (scipy Slerp
    equivalent)."""
    q0 = rotmat2qvec(R0)
    q1 = rotmat2qvec(R1)
    dot = float(np.dot(q0, q1))
    if dot < 0.0:
        q1, dot = -q1, -dot
    if dot > 0.9995:
        q = q0 + ratio * (q1 - q0)
    else:
        theta = np.arccos(np.clip(dot, -1.0, 1.0))
        q = (np.sin((1 - ratio) * theta) * q0 + np.sin(ratio * theta) * q1) / np.sin(theta)
    q = q / np.linalg.norm(q)
    return qvec2rotmat(q)


def interpolate_virtual_poses_sequential(base_cams: np.ndarray, n_poses: int = 30) -> np.ndarray:
    """Sine-eased w2c interpolation between consecutive c2w poses.

    Matches `interpolate_virtual_poses_sequential`
    (`utils/virtual_poses.py:181-209`): ratio = sin((k/n - 0.5) pi)/2 + 0.5,
    rotations slerped and translations lerped in *world-to-camera* space,
    result inverted back to camera-to-world.

    Args:
      base_cams: [V, 4, 4] camera-to-world matrices.
    Returns:
      [(V-1) * n_poses, 4, 4] camera-to-world matrices.
    """
    all_poses = []
    for i in range(len(base_cams) - 1):
        w2c0 = np.linalg.inv(base_cams[i])
        w2c1 = np.linalg.inv(base_cams[i + 1])
        for k in range(n_poses):
            ratio = np.sin(((k / n_poses) - 0.5) * np.pi) * 0.5 + 0.5
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = _slerp_rotmat(w2c0[:3, :3], w2c1[:3, :3], ratio)
            pose[:3, 3] = ((1.0 - ratio) * w2c0 + ratio * w2c1)[:3, 3]
            all_poses.append(np.linalg.inv(pose))
    return np.stack(all_poses, axis=0)


def get_near_virtual_pose(base_cam: np.ndarray, near_far, n_poses: int = 1) -> np.ndarray:
    """Random near-pose sampler (`utils/virtual_poses.py:150-178`)."""
    near_fars = np.array(near_far)
    poses = base_cam
    close_depth, inf_depth = near_fars.min() * 0.9, near_fars.max() * 2.0
    dt = 0.75
    focal = 1 / ((1 - dt) / close_depth + dt / inf_depth)
    positions = poses[:, :3, 3]
    radii = np.percentile(np.abs(positions), 100, 0)
    radii = np.concatenate([radii, [1.0]])
    random_poses = []
    cam2world = poses_avg(poses)
    up = poses[:, :3, 1].mean(0)
    for _ in range(n_poses):
        t = radii * np.concatenate([2 * np.random.rand(3) - 1.0, [1.0]])
        position = cam2world @ t
        lookat = cam2world @ [0, 0, -focal, 1.0]
        z_axis = position - lookat
        random_poses.append(viewmatrix(z_axis, up, position))
    return np.stack(random_poses, axis=0)[0]
