"""Dataset readers: LLFF/COLMAP, Tanks&Temples, DTU, Blender + video paths.

A copy of the JAX package's `data/readers.py` (numpy and PIL, host side),
with the same `CameraInfo` / `SceneInfo` records.

Re-implements the reference's `scene/dataset_readers.py` readers with the
EXACT split logic pinned by the benchmark protocol (BASELINE.md):
- LLFF/COLMAP + Tanks: every-8th test hold-out, 3 train views by linspace
  (`scene/dataset_readers.py:161-170, 267-276`)
- DTU: fixed train idx [25, 22, 28], exclude list, idr masks (`:425-433`)
- Blender: 8 fixed train views, alpha-composite onto background (`:539-547,
  566-569`)
- per-view near/far from COLMAP 3D-point track depths x [0.8, 1.2]
  (`:199-223`)
- `match_data.npy` ingestion for the train-pair matrix (`:226-240`)
- video factories: LLFF spiral (`:659-704`) and Tanks slerp path (`:752-800`)

The repeated per-reader boilerplate of the reference (near/far, match data,
point-cloud conversion) is factored into helpers; behavior is unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from scgaussian_tpu_torch.core.cameras import focal2fov, fov2focal, world_to_view
from scgaussian_tpu_torch.data import colmap, ply
from scgaussian_tpu_torch.data import pose_utils
from scgaussian_tpu_torch.data.virtual_poses import interpolate_virtual_poses_sequential


@dataclasses.dataclass
class CameraInfo:
    """`scene/dataset_readers.py:30-44` equivalent (host-side record)."""

    uid: int
    R: np.ndarray
    T: np.ndarray
    fovy: float
    fovx: float
    image: Optional[Image.Image]
    image_path: Optional[str]
    image_name: Optional[str]
    width: int
    height: int
    dtumask: Optional[np.ndarray] = None
    blendermask: Optional[np.ndarray] = None
    point3D_ids: Optional[np.ndarray] = None
    near_far: Optional[np.ndarray] = None


@dataclasses.dataclass
class SceneInfo:
    """`scene/dataset_readers.py:46-53` equivalent."""

    point_cloud: Optional[tuple]
    base_cameras: Optional[List[CameraInfo]]
    train_cameras: Optional[List[CameraInfo]]
    test_cameras: Optional[List[CameraInfo]]
    nerf_normalization: dict
    ply_path: Optional[str]
    match_data: Optional[dict]


def get_nerfpp_norm(cam_infos: List[CameraInfo]) -> dict:
    """Camera-extent normalization (`scene/dataset_readers.py:55-76`)."""
    centers = []
    for cam in cam_infos:
        w2c = world_to_view(cam.R, cam.T)
        centers.append(np.linalg.inv(w2c)[:3, 3:4])
    centers = np.hstack(centers)
    avg = np.mean(centers, axis=1, keepdims=True)
    diagonal = np.max(np.linalg.norm(centers - avg, axis=0))
    return {"translate": -avg.flatten(), "radius": diagonal * 1.1}


def _read_colmap_model(path: str):
    try:
        cam_extr = colmap.read_extrinsics_binary(os.path.join(path, "sparse/0", "images.bin"))
        cam_intr = colmap.read_intrinsics_binary(os.path.join(path, "sparse/0", "cameras.bin"))
    except Exception:
        cam_extr = colmap.read_extrinsics_text(os.path.join(path, "sparse/0", "images.txt"))
        cam_intr = colmap.read_intrinsics_text(os.path.join(path, "sparse/0", "cameras.txt"))
    return cam_extr, cam_intr


def _read_colmap_cameras(cam_extrinsics, cam_intrinsics, images_folder, dtu_masks=False):
    """`readColmapCameras` / `readColmapCamerasDTU`
    (`scene/dataset_readers.py:78-117, 358-406`)."""
    infos = []
    for key in cam_extrinsics:
        extr = cam_extrinsics[key]
        intr = cam_intrinsics[extr.camera_id]
        R = np.transpose(colmap.qvec2rotmat(extr.qvec))
        T = np.array(extr.tvec)

        if intr.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            fovy = focal2fov(intr.params[0], intr.height)
            fovx = focal2fov(intr.params[0], intr.width)
        elif intr.model == "PINHOLE":
            fovy = focal2fov(intr.params[1], intr.height)
            fovx = focal2fov(intr.params[0], intr.width)
        else:
            raise AssertionError(
                f"Colmap camera model not handled for {intr.model}: only "
                "undistorted datasets (PINHOLE or SIMPLE_PINHOLE) supported"
            )

        image_path = os.path.join(images_folder, os.path.basename(extr.name))
        image_name = os.path.basename(image_path).split(".")[0]
        image = Image.open(image_path)

        dtumask = None
        if dtu_masks:
            # idr object masks: images/../idrmask/{idx:03d}.png
            # (`scene/dataset_readers.py:393-398`)
            mask_path = os.path.join(
                images_folder.rsplit("/", 1)[0],
                "idrmask",
                "{:0>3}.png".format(int(image_name.split("_")[1]) - 1),
            )
            if os.path.exists(mask_path):
                import cv2

                m = np.array(Image.open(mask_path))
                dtumask = (np.max(m, axis=-1) > 10).astype(np.float32)
                if dtumask.shape[0] != image.size[1] and dtumask.shape[1] != image.size[0]:
                    dtumask = cv2.resize(dtumask, image.size[:2], interpolation=cv2.INTER_NEAREST)

        infos.append(
            CameraInfo(
                uid=extr.camera_id,
                R=R,
                T=T,
                fovy=fovy,
                fovx=fovx,
                image=image,
                image_path=image_path,
                image_name=image_name,
                width=image.size[0],
                height=image.size[1],
                dtumask=dtumask,
                point3D_ids=extr.point3D_ids,
            )
        )
    return sorted(infos, key=lambda c: c.image_name)


def _ensure_points_ply(path: str):
    """points3D.bin -> .ply conversion + load (`scene/dataset_readers.py:
    178-197`). Returns (pcd tuple or None, ply_path, xyz, point_ids)."""
    ply_path = os.path.join(path, "sparse/0/points3D.ply")
    bin_path = os.path.join(path, "sparse/0/points3D.bin")
    txt_path = os.path.join(path, "sparse/0/points3D.txt")
    point_ids = None
    try:
        xyz, rgb, _, point_ids = colmap.read_points3D_binary_pointid(bin_path)
    except Exception:
        xyz, rgb, _ = colmap.read_points3D_text(txt_path)
    if not os.path.exists(ply_path):
        ply.store_point_cloud(ply_path, xyz, rgb)
    try:
        pcd = ply.fetch_point_cloud(ply_path)
    except Exception:
        pcd = None
    return pcd, ply_path, xyz, point_ids


def _near_far_from_tracks(cam_infos: List[CameraInfo], xyz, point_ids):
    """Per-view near/far from COLMAP track depths x [0.8, 1.2]
    (`scene/dataset_readers.py:199-223`)."""
    for idx, c in enumerate(cam_infos):
        fx, fy = fov2focal(c.fovx, c.width), fov2focal(c.fovy, c.height)
        K = np.array([[fx, 0, c.width / 2.0], [0, fy, c.height / 2.0], [0, 0, 1]])
        w2c = np.zeros((4, 4))
        w2c[:3, :3] = c.R.transpose()
        w2c[:3, 3] = c.T
        w2c[3, 3] = 1.0
        rows = [point_ids[pid] for pid in c.point3D_ids if pid != -1]
        pts = xyz[rows].T  # [3, n]
        cam_pts = (w2c @ np.vstack([pts, np.ones_like(pts[:1])]))[:3]
        depth = (K @ cam_pts)[2]
        cam_infos[idx] = dataclasses.replace(
            c, near_far=np.array([depth.min() * 0.8, depth.max() * 1.2])
        )
    return cam_infos


def _load_match_data(path: str, train_cams: List[CameraInfo]) -> dict:
    """`match_data.npy` pair matrix for the train split
    (`scene/dataset_readers.py:226-240`)."""
    all_md = np.load(os.path.join(path, "match_data.npy"), allow_pickle=True).item()
    match_data: Dict[str, Dict[str, np.ndarray]] = {}
    for i in range(len(train_cams) - 1):
        n0 = train_cams[i].image_name
        match_data.setdefault(n0, {})
        for j in range(i + 1, len(train_cams)):
            n1 = train_cams[j].image_name
            match_data.setdefault(n1, {})
            match_data[n0][n1] = all_md[n0][n1]
            match_data[n1][n0] = all_md[n1][n0]
    return match_data


def _llff_split(cam_infos: List[CameraInfo], llffhold: int = 8, n_sparse: int = 3):
    """Every-8th hold-out + 3-view linspace subsample
    (`scene/dataset_readers.py:161-170`)."""
    train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
    test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    idx_train = [round(i) for i in np.linspace(0, len(train) - 1, n_sparse)]
    train = [c for i, c in enumerate(train) if i in idx_train]
    return train, test


def read_colmap_scene(path, images, eval, llffhold=8, dtu=False):
    """readColmapSceneInfo / readTanksSceneInfo / readDTUSceneInfo
    (`scene/dataset_readers.py:145-249, 251-355, 409-512`)."""
    cam_extr, cam_intr = _read_colmap_model(path)
    reading_dir = "images" if images is None else images
    cam_infos = _read_colmap_cameras(
        cam_extr, cam_intr, os.path.join(path, reading_dir), dtu_masks=dtu
    )

    if eval:
        if dtu:
            train_idx = [25, 22, 28, 40, 44, 48, 0, 8, 13]
            exclude_idx = [3, 4, 5, 6, 7, 16, 17, 18, 19, 20, 21, 36, 37, 38, 39]
            test_idx = [i for i in np.arange(49) if i not in train_idx + exclude_idx]
            train_cams = [c for i, c in enumerate(cam_infos) if i in train_idx[:3]]
            test_cams = [c for i, c in enumerate(cam_infos) if i in test_idx]
        else:
            train_cams, test_cams = _llff_split(cam_infos, llffhold)
    else:
        train_cams, test_cams = cam_infos, []

    norm = get_nerfpp_norm(train_cams)
    pcd, ply_path, xyz, point_ids = _ensure_points_ply(path)
    train_cams = _near_far_from_tracks(train_cams, xyz, point_ids)
    match_data = _load_match_data(path, train_cams)

    return SceneInfo(
        point_cloud=pcd,
        base_cameras=train_cams,
        train_cameras=train_cams,
        test_cameras=test_cams,
        nerf_normalization=norm,
        ply_path=ply_path,
        match_data=match_data,
    )


def read_tanks_scene(path, images, eval, llffhold=8):
    return read_colmap_scene(path, images, eval, llffhold, dtu=False)


def read_dtu_scene(path, images, eval, llffhold=8):
    return read_colmap_scene(path, images, eval, llffhold, dtu=True)


def read_blender_scene(path, white_background, eval, extension=".png"):
    """readNerfSyntheticInfo (`scene/dataset_readers.py:514-618`)."""

    def read_transforms(transformsfile):
        infos = []
        with open(os.path.join(path, transformsfile)) as f:
            contents = json.load(f)
        fovx = contents["camera_angle_x"]
        for idx, frame in enumerate(contents["frames"]):
            cam_name = os.path.join(path, frame["file_path"] + extension)
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1  # OpenGL/Blender -> COLMAP axes
            w2c = np.linalg.inv(c2w)
            R = np.transpose(w2c[:3, :3])
            T = w2c[:3, 3]

            image = Image.open(cam_name)
            im_data = np.array(image.convert("RGBA"))
            bg = np.array([1, 1, 1]) if white_background else np.array([0, 0, 0])
            norm_data = im_data / 255.0
            arr = norm_data[:, :, :3] * norm_data[:, :, 3:4] + bg * (1 - norm_data[:, :, 3:4])
            image = Image.fromarray(np.array(arr * 255.0, dtype=np.uint8), "RGB")
            img_mask = norm_data[:, :, 3] > 0

            fovy = focal2fov(fov2focal(fovx, image.size[0]), image.size[1])
            infos.append(
                CameraInfo(
                    uid=idx,
                    R=R,
                    T=T,
                    fovy=fovy,
                    fovx=fovx,
                    image=image,
                    image_path=cam_name,
                    image_name=Path(cam_name).stem,
                    width=image.size[0],
                    height=image.size[1],
                    blendermask=img_mask,
                    near_far=np.array([1.0, 6.0]),
                )
            )
        return infos

    train_cams = read_transforms("transforms_train.json")
    test_cams = read_transforms("transforms_test.json")

    if eval:
        train_cams = [c for i, c in enumerate(train_cams) if i in [2, 16, 26, 55, 73, 76, 86, 93]]
    else:
        train_cams = train_cams + test_cams
        test_cams = []

    norm = get_nerfpp_norm(train_cams)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        xyz = np.random.random((num_pts, 3)) * 2.6 - 1.3
        from scgaussian_tpu_torch.core.sh import sh_to_rgb

        shs = np.random.random((num_pts, 3)) / 255.0
        ply.store_point_cloud(ply_path, xyz, np.asarray(sh_to_rgb(shs)) * 255)
    try:
        pcd = ply.fetch_point_cloud(ply_path)
    except Exception:
        pcd = None

    match_data = _load_match_data(path, train_cams)
    return SceneInfo(
        point_cloud=pcd,
        base_cameras=train_cams,
        train_cameras=train_cams,
        test_cameras=test_cams,
        nerf_normalization=norm,
        ply_path=ply_path,
        match_data=match_data,
    )


def create_llff_spiral(basedir):
    """CreateLLFFSpiral (`scene/dataset_readers.py:659-704`)."""
    render_poses = pose_utils.load_llff_spiral_poses(basedir, n_frames=180)
    Rs, tvecs, H, W, fl = pose_utils.convert_poses(render_poses)
    fovy = focal2fov(fl, H)
    fovx = focal2fov(fl, W)
    infos = [
        CameraInfo(
            uid=i,
            R=np.transpose(Rs[i]),
            T=tvecs[i],
            fovy=fovy,
            fovx=fovx,
            image=None,
            image_path=None,
            image_name=None,
            width=W,
            height=H,
        )
        for i in range(len(Rs))
    ]
    return SceneInfo(
        point_cloud=None,
        base_cameras=None,
        train_cameras=None,
        test_cameras=infos,
        nerf_normalization=get_nerfpp_norm(infos),
        ply_path=None,
        match_data=None,
    )


def create_tanks_spiral(path):
    """CreateTanksSpiral2 (`scene/dataset_readers.py:752-800`): slerp 30
    poses between the 3 train views, there and back."""
    cam_extr, cam_intr = _read_colmap_model(path)
    cam_infos = _read_colmap_cameras(cam_extr, cam_intr, os.path.join(path, "images"))

    train_cams, _ = _llff_split(cam_infos, 8)
    train_poses = []
    for cam in train_cams:
        w2c = np.zeros((4, 4))
        w2c[:3, :3] = cam.R.transpose()
        w2c[:3, 3] = cam.T
        w2c[3, 3] = 1.0
        train_poses.append(w2c)
    train_poses = np.linalg.inv(np.stack(train_poses, axis=0))

    virtual = interpolate_virtual_poses_sequential(train_poses, 30)
    virtual = np.concatenate([virtual, virtual[::-1]], axis=0)

    infos = []
    for i, c2w in enumerate(virtual):
        w2c = np.linalg.inv(c2w)
        infos.append(
            CameraInfo(
                uid=i,
                R=w2c[:3, :3].transpose(),
                T=w2c[:3, 3],
                fovy=train_cams[0].fovy,
                fovx=train_cams[0].fovx,
                image=None,
                image_path=None,
                image_name=None,
                width=train_cams[0].width,
                height=train_cams[0].height,
            )
        )
    return SceneInfo(
        point_cloud=None,
        base_cameras=None,
        train_cameras=None,
        test_cameras=infos,
        nerf_normalization=get_nerfpp_norm(infos),
        ply_path=None,
        match_data=None,
    )


scene_load_callbacks = {
    "Colmap": read_colmap_scene,
    "Blender": read_blender_scene,
    "DTU": read_dtu_scene,
    "Tanks": read_tanks_scene,
    "LLFFVideo": create_llff_spiral,
    "TanksVideo": create_tanks_spiral,
}
