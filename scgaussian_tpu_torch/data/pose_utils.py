"""LLFF pose conventions and spiral render paths (host-side numpy).

A copy of the JAX package's `data/pose_utils.py`.

Covers the live subset of the reference's `utils/pose_utils.py`: pose
recenter/backcenter (`:442-452`), average pose / view matrices (`:465-483`),
forward-facing spiral (`generate_spiral_path`, `:486-510`), DTU spiral
(`:522-540`), and the `poses_bounds.npy` convention helpers
(`convert_poses`, `:355-370`)."""

from __future__ import annotations

import os

import numpy as np


def normalize(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x)


def pad_poses(p: np.ndarray) -> np.ndarray:
    bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def unpad_poses(p: np.ndarray) -> np.ndarray:
    return p[..., :3, :4]


def viewmatrix(lookdir, up, position, subtract_position=False) -> np.ndarray:
    """`utils/pose_utils.py:475-481`."""
    vec2 = normalize((position - lookdir) if subtract_position else lookdir)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def poses_avg(poses: np.ndarray) -> np.ndarray:
    """`utils/pose_utils.py:465-471`."""
    position = poses[:, :3, 3].mean(0)
    z_axis = poses[:, :3, 2].mean(0)
    up = poses[:, :3, 1].mean(0)
    return viewmatrix(z_axis, up, position)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """`utils/pose_utils.py:442-446`."""
    cam2world = poses_avg(poses)
    return unpad_poses(np.linalg.inv(pad_poses(cam2world)) @ pad_poses(poses))


def backcenter_poses(poses: np.ndarray, pose_ref: np.ndarray) -> np.ndarray:
    """`utils/pose_utils.py:448-452`."""
    cam2world = poses_avg(pose_ref)
    return unpad_poses(pad_poses(cam2world) @ pad_poses(poses))


def generate_spiral_path(
    poses: np.ndarray, bounds: np.ndarray, n_frames=120, n_rots=2, zrate=0.5
) -> np.ndarray:
    """Forward-facing spiral (`utils/pose_utils.py:486-510`)."""
    close_depth, inf_depth = bounds.min() * 0.9, bounds.max() * 5.0
    dt = 0.75
    focal = 1 / ((1 - dt) / close_depth + dt / inf_depth)

    positions = poses[:, :3, 3]
    radii = np.percentile(np.abs(positions), 90, 0)
    radii = np.concatenate([radii, [1.0]])

    render_poses = []
    cam2world = poses_avg(poses)
    up = poses[:, :3, 1].mean(0)
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames, endpoint=False):
        t = radii * [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]
        position = cam2world @ t
        lookat = cam2world @ [0, 0, -focal, 1.0]
        z_axis = position - lookat
        render_poses.append(viewmatrix(z_axis, up, position))
    return np.stack(render_poses, axis=0)


def focus_pt_fn(poses: np.ndarray) -> np.ndarray:
    """`utils/pose_utils.py:513-519`."""
    directions, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    return np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def generate_spiral_path_dtu(poses, n_frames=120, n_rots=2, zrate=0.5, perc=60):
    """DTU spiral (`utils/pose_utils.py:522-540`)."""
    positions = poses[:, :3, 3]
    radii = np.percentile(np.abs(positions), perc, 0)
    radii = np.concatenate([radii, [1.0]])
    render_poses = []
    cam2world = poses_avg(poses)
    up = poses[:, :3, 1].mean(0)
    z_axis = focus_pt_fn(poses)
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames, endpoint=False):
        t = radii * [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]
        position = cam2world @ t
        render_poses.append(viewmatrix(z_axis, up, position, True))
    return np.stack(render_poses, axis=0)


# LLFF poses_bounds.npy conventions -----------------------------------------

LLFF_FIX_ROTATION = np.array(
    [[0, -1, 0, 0], [1, 0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float32
)


def convert_poses(poses: np.ndarray):
    """[3, 5, N] LLFF pose blocks -> (Rs, tvecs, H, W, focal).

    Matches `convert_poses` (`utils/pose_utils.py:362-375`) exactly: the LLFF
    [-u, r, -t] axis swizzle is applied FIRST, then the camera-to-world 3x4
    (with hwf column) is inverted to world-to-camera R/t."""
    poses = np.concatenate(
        [poses[:, 1:2], poses[:, 0:1], -poses[:, 2:3], poses[:, 3:4], poses[:, 4:5]],
        axis=1,
    ).transpose(2, 0, 1)  # [N, 3, 5]
    bottom = np.tile(np.array([0, 0, 0, 1.0]).reshape(1, 1, 4), (poses.shape[0], 1, 1))
    H, W, fl = poses[0, :, -1]
    mats = np.concatenate([poses[..., :4], bottom], axis=1)
    mats = np.linalg.inv(mats)
    Rs = list(mats[:, :3, :3])
    tvecs = list(mats[:, :3, -1])
    return Rs, tvecs, int(H), int(W), fl


def load_colmap_data(realdir: str):
    """COLMAP -> LLFF pose blocks (`utils/pose_utils.py:276-322`): c2w mats
    with hwf column, axes switched to LLFF [-u, r, -t] convention; returns
    (poses [3, 5, N], pts3d rows, visibility, name-sort permutation)."""
    from scgaussian_tpu_torch.data import colmap

    camdata = colmap.read_intrinsics_binary(os.path.join(realdir, "sparse/0/cameras.bin"))
    cam = camdata[list(camdata.keys())[0]]
    hwf = np.array([cam.height, cam.width, cam.params[0]]).reshape([3, 1])

    imdata = colmap.read_extrinsics_binary(os.path.join(realdir, "sparse/0/images.bin"))
    names = [imdata[k].name for k in imdata]
    perm = np.argsort(names)
    bottom = np.array([0, 0, 0, 1.0]).reshape([1, 4])
    w2c_mats = []
    for k in imdata:
        im = imdata[k]
        R = colmap.qvec2rotmat(im.qvec)
        t = im.tvec.reshape([3, 1])
        w2c_mats.append(np.concatenate([np.concatenate([R, t], 1), bottom], 0))
    c2w_mats = np.linalg.inv(np.stack(w2c_mats, 0))
    poses = c2w_mats[:, :3, :4].transpose([1, 2, 0])
    poses = np.concatenate(
        [poses, np.tile(hwf[..., np.newaxis], [1, 1, poses.shape[-1]])], 1
    )
    # switch to [-u, r, -t] from [r, -u, t]
    poses = np.concatenate(
        [poses[:, 1:2, :], poses[:, 0:1, :], -poses[:, 2:3, :], poses[:, 3:4, :], poses[:, 4:5, :]],
        1,
    )

    xyz, _, _, point_ids = colmap.read_points3D_binary_pointid(
        os.path.join(realdir, "sparse/0/points3D.bin")
    )
    return poses, xyz, point_ids, perm, imdata


def gen_poses(basedir: str) -> None:
    """imgs2poses equivalent (`utils/pose_utils.py:410-418` gen_poses +
    save_poses `:324-358`): writes poses_bounds.npy with per-view depth
    percentile bounds from COLMAP track visibility."""
    from scgaussian_tpu_torch.data import colmap

    poses, xyz, point_ids, perm, imdata = load_colmap_data(basedir)
    n_views = poses.shape[-1]
    n_pts = xyz.shape[0]
    vis = np.zeros((n_pts, n_views), bool)
    im_keys = list(imdata.keys())
    for vi, k in enumerate(im_keys):
        for pid in imdata[k].point3D_ids:
            if pid != -1 and pid in point_ids:
                vis[point_ids[pid], vi] = True

    zvals = np.sum(
        -(xyz[:, np.newaxis, :].transpose([2, 0, 1]) - poses[:3, 3:4, :]) * poses[:3, 2:3, :],
        0,
    )
    save_arr = []
    for i in perm:
        zs = zvals[:, i][vis[:, i]]
        close_depth, inf_depth = np.percentile(zs, 0.1), np.percentile(zs, 99.9)
        save_arr.append(
            np.concatenate([poses[..., i].ravel(), np.array([close_depth, inf_depth])], 0)
        )
    np.save(os.path.join(basedir, "poses_bounds.npy"), np.array(save_arr))


def load_llff_spiral_poses(basedir: str, n_frames: int = 180):
    """The pose pipeline of `CreateLLFFSpiral`
    (`scene/dataset_readers.py:659-704`): poses_bounds.npy -> fix rotation ->
    recenter -> spiral -> backcenter -> unfix rotation -> reattach hwf."""
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses_o = poses_arr[:, :-2].reshape([-1, 3, 5])
    bounds = poses_arr[:, -2:]

    inv_rotation = np.linalg.inv(LLFF_FIX_ROTATION)
    poses = poses_o[:, :3, :4] @ LLFF_FIX_ROTATION

    render_poses = recenter_poses(poses)
    render_poses = generate_spiral_path(render_poses, bounds, n_frames=n_frames)
    render_poses = backcenter_poses(render_poses, poses)
    render_poses = render_poses @ inv_rotation
    render_poses = np.concatenate(
        [render_poses, np.tile(poses_o[:1, :3, 4:], (render_poses.shape[0], 1, 1))], -1
    )
    return render_poses.transpose([1, 2, 0])  # [3, 5, F]
