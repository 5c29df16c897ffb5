"""Synthetic COLMAP-format scene generator.

Port of the JAX package's `data/synthetic.py`. Writes a complete on-disk
dataset in the layout the reference consumes
(`sparse/0/{cameras,images,points3D}.bin`, `images/*.png`, `match_data.npy`
— `scene/dataset_readers.py:145-249`): ground-truth Gaussians rendered with
the port's renderer on a given device (the tile path by default; the JAX
package renders them with its dense oracle), COLMAP poses/tracks derived
from the true geometry, and exact
dense matches in the normalized-coordinate format of
`data_preprocess/get_match_info.py:395-421`. Used by integration tests and
as a runnable demo where no real dataset is at hand."""

from __future__ import annotations

import os

import numpy as np
import torch

from scgaussian_tpu_torch import resolve_device
from scgaussian_tpu_torch.core.cameras import Camera, fov2focal, intrinsic_matrix, world_to_view
from scgaussian_tpu_torch.data import colmap


def generate_scene(
    out_dir: str,
    n_views: int = 10,
    n_gaussians: int = 60,
    n_points: int = 120,
    width: int = 96,
    height: int = 72,
    fov: float = 0.9,
    seed: int = 0,
    name_fmt: str = "img_{:03d}",
    ring_radius: float = 0.25,
    device: str | torch.device | None = None,
    backend: str = "cuda",
) -> dict:
    """Writes the scene under `out_dir` and returns the ground truth. Poses,
    `sparse/0/*.bin` and `match_data.npy` come from numpy alone; the images
    are rendered on `device` (default: the GPU) by `backend`."""
    from PIL import Image

    from scgaussian_tpu_torch.renderer import render

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "sparse/0"), exist_ok=True)

    centers = np.stack(
        [
            rng.uniform(-0.9, 0.9, n_gaussians),
            rng.uniform(-0.7, 0.7, n_gaussians),
            rng.uniform(3.0, 5.5, n_gaussians),
        ],
        axis=-1,
    ).astype(np.float32)
    scales = np.exp(rng.uniform(-2.6, -1.9, (n_gaussians, 3))).astype(np.float32)
    quats = rng.normal(size=(n_gaussians, 4)).astype(np.float32)
    opac = rng.uniform(0.6, 0.95, n_gaussians).astype(np.float32)
    shs = np.zeros((n_gaussians, 16, 3), np.float32)
    shs[:, 0] = rng.uniform(-0.8, 0.8, (n_gaussians, 3))

    # camera ring: small lateral offsets, looking +z
    f = fov2focal(fov, width)
    K = intrinsic_matrix(fov, fov, width, height)
    Rs, Ts, names = [], [], []
    for v in range(n_views):
        t = np.array(
            [
                ring_radius * np.sin(2 * np.pi * v / n_views),
                0.72 * ring_radius * np.cos(2 * np.pi * v / n_views),
                0.0,
            ]
        )
        Rs.append(np.eye(3))
        Ts.append(t)
        names.append(name_fmt.format(v))

    # render GT images
    for v in range(n_views):
        cam = Camera.create(Rs[v], Ts[v], fov, fov, width, height, device=dev)
        with torch.no_grad():
            out = render(
                cam,
                torch.as_tensor(centers, device=dev),
                torch.as_tensor(opac, device=dev),
                torch.zeros(3, device=dev),
                scales=torch.as_tensor(scales, device=dev),
                rotations=torch.as_tensor(quats, device=dev),
                shs=torch.as_tensor(shs, device=dev),
                active_sh_degree=3,
                backend=backend,
            )
        img = torch.clamp(out.render, 0, 1).permute(1, 2, 0).cpu().numpy()
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(out_dir, "images", names[v] + ".png")
        )

    # sparse point cloud = gaussian centers (+ extras), with per-view tracks
    pts = np.concatenate(
        [
            centers,
            np.stack(
                [
                    rng.uniform(-0.9, 0.9, n_points - n_gaussians),
                    rng.uniform(-0.7, 0.7, n_points - n_gaussians),
                    rng.uniform(3.0, 5.5, n_points - n_gaussians),
                ],
                axis=-1,
            ).astype(np.float32),
        ]
    )
    rgb = rng.integers(0, 255, (n_points, 3))

    cameras = {
        1: colmap.ColmapCamera(1, "PINHOLE", width, height, np.array([f, f, width / 2, height / 2]))
    }
    colmap.write_intrinsics_binary(os.path.join(out_dir, "sparse/0/cameras.bin"), cameras)

    point_ids = np.arange(1, n_points + 1)
    images = {}
    for v in range(n_views):
        w2c = world_to_view(Rs[v], Ts[v])
        qvec = colmap.rotmat2qvec(w2c[:3, :3])
        cam_pts = pts @ w2c[:3, :3].T + w2c[:3, 3]
        uvz = cam_pts @ K.T
        uv = uvz[:, :2] / uvz[:, 2:3]
        inb = (
            (uv[:, 0] > 2) & (uv[:, 0] < width - 2) & (uv[:, 1] > 2) & (uv[:, 1] < height - 2)
        )
        xys = uv[inb]
        pids = point_ids[inb]
        images[v + 1] = colmap.ColmapImage(
            v + 1, qvec, w2c[:3, 3], 1, names[v] + ".png", xys, pids
        )
    colmap.write_extrinsics_binary(os.path.join(out_dir, "sparse/0/images.bin"), images)
    colmap.write_points3D_binary(
        os.path.join(out_dir, "sparse/0/points3D.bin"),
        pts,
        rgb,
        np.ones(n_points),
        ids=point_ids,
    )

    # exact dense matches between the 3 training views of the LLFF split:
    # train = every idx % 8 != 0, then linspace-3 -> compute for ALL pairs so
    # any split works
    match_data = {}
    for i in range(n_views):
        match_data[names[i]] = {}
    for i in range(n_views):
        for j in range(n_views):
            if i == j:
                continue
            ui = _project_norm(pts, Rs[i], Ts[i], K, width, height)
            uj = _project_norm(pts, Rs[j], Ts[j], K, width, height)
            ok = (
                (ui > 0.02).all(1) & (ui < 0.98).all(1) & (uj > 0.02).all(1) & (uj < 0.98).all(1)
            )
            match_data[names[i]][names[j]] = ui[ok].astype(np.float32)
    np.save(os.path.join(out_dir, "match_data.npy"), match_data, allow_pickle=True)

    return dict(centers=centers, scales=scales, quats=quats, opac=opac, shs=shs,
                names=names, Rs=Rs, Ts=Ts, K=K)


def _project_norm(pts, R, T, K, width, height):
    w2c = world_to_view(R, T)
    cam_pts = pts @ w2c[:3, :3].T + w2c[:3, 3]
    uvz = cam_pts @ K.T
    uv = uvz[:, :2] / uvz[:, 2:3]
    return uv / np.array([width, height])
