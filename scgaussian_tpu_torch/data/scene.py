"""Scene orchestration: dataset selection, camera loading, match bundles.

Port of the JAX package's `data/scene.py` (reference `scene/__init__.py:
22-185`, Scene / VideoScene): chooses the reader by source-path substring,
loads train/test cameras at the requested resolution onto a device, dumps
cameras.json, and builds the MatchBundle from the *full-resolution* base
cameras (the reference's `create_from_mono` also operates on raw CameraInfo
images — `scene/__init__.py:98`; the rendered-depth loss bridges
resolutions through normalized UVs). The cameras are shuffled with
`np.random.default_rng(seed)`, so both packages see the same order.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from scgaussian_tpu_torch import resolve_device
from scgaussian_tpu_torch.core.cameras import intrinsic_matrix
from scgaussian_tpu_torch.data.camera_utils import (
    LoadedCamera,
    camera_list_from_infos,
    camera_to_json,
)
from scgaussian_tpu_torch.data.readers import SceneInfo, scene_load_callbacks
from scgaussian_tpu_torch.model.matches import MatchBundle, build_match_bundle


def select_scene_reader(source_path: str) -> str:
    """Path-substring dispatch (`scene/__init__.py:45-63`, live branches)."""
    if "Tanks" in source_path:
        return "Tanks"
    if "dtu" in source_path:
        return "DTU"
    if os.path.exists(os.path.join(source_path, "sparse")):
        return "Colmap"
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        return "Blender"
    raise ValueError(f"Could not recognize scene type for {source_path!r}")


def build_bundle_from_scene(
    scene_info: SceneInfo, device: str | torch.device | None = None
) -> Tuple[MatchBundle, List[str]]:
    """MatchBundle from base cameras + match_data (full resolution), on
    `device` (default: the GPU), plus the view-name order defining bundle
    view indices."""
    base = scene_info.base_cameras
    names = [c.image_name for c in base]
    images, intrs, w2cs, near_fars, masks = [], [], [], [], []
    for c in base:
        img = np.array(c.image).astype(np.float32) / 255.0
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        images.append(img[..., :3])
        intrs.append(intrinsic_matrix(c.fovx, c.fovy, c.width, c.height))
        w2c = np.zeros((4, 4), np.float32)
        w2c[:3, :3] = c.R.transpose()
        w2c[:3, 3] = c.T
        w2c[3, 3] = 1.0
        w2cs.append(w2c)
        near_fars.append(np.asarray(c.near_far, np.float32))
        masks.append(
            c.blendermask.astype(np.float32) if c.blendermask is not None else None
        )

    match_pixels: Dict[Tuple[int, int], np.ndarray] = {}
    for i, ni in enumerate(names):
        for j, nj in enumerate(names):
            if i != j:
                match_pixels[(i, j)] = np.asarray(
                    scene_info.match_data[ni][nj], np.float32
                )

    any_mask = any(m is not None for m in masks)
    bundle = build_match_bundle(
        images, intrs, w2cs, near_fars, match_pixels,
        blender_masks=masks if any_mask else None, device=device,
    )
    return bundle, names


class Scene:
    """Training/eval scene (`scene/__init__.py:22-112`) on `device`
    (default: the GPU)."""

    def __init__(
        self,
        source_path: str,
        model_path: str,
        images: str = "images",
        resolution: int = -1,
        white_background: bool = False,
        eval: bool = True,
        shuffle: bool = True,
        load_iteration: Optional[int] = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.source_path = source_path
        self.model_path = model_path
        self.loaded_iter = None
        if load_iteration is not None:
            if load_iteration == -1:
                self.loaded_iter = search_max_iteration(
                    os.path.join(model_path, "point_cloud")
                )
            else:
                self.loaded_iter = load_iteration

        kind = select_scene_reader(source_path)
        self.kind = kind
        if kind == "Blender":
            scene_info = scene_load_callbacks[kind](source_path, white_background, eval)
        else:
            scene_info = scene_load_callbacks[kind](source_path, images, eval)
        self.scene_info = scene_info
        self.is_dtu = kind == "DTU"

        os.makedirs(model_path, exist_ok=True)

        if shuffle:
            rng = np.random.default_rng(seed)
            rng.shuffle(scene_info.train_cameras)
            rng.shuffle(scene_info.test_cameras)

        self.cameras_extent = scene_info.nerf_normalization["radius"]
        self.train_cameras: List[LoadedCamera] = camera_list_from_infos(
            scene_info.train_cameras, resolution, device=self.device
        )
        self.test_cameras: List[LoadedCamera] = camera_list_from_infos(
            scene_info.test_cameras, resolution, device=self.device
        )

        if not self.loaded_iter:
            cams_json = [
                camera_to_json(i, c)
                for i, c in enumerate(self.test_cameras + self.train_cameras)
            ]
            with open(os.path.join(model_path, "cameras.json"), "w") as f:
                json.dump(cams_json, f)

        # match bundle over full-resolution base cameras
        if scene_info.match_data is not None:
            self.bundle, self.base_names = build_bundle_from_scene(scene_info, self.device)
        else:
            self.bundle, self.base_names = None, []

    def view_id(self, camera: LoadedCamera) -> int:
        """Bundle view index for a (shuffled) train camera."""
        return self.base_names.index(camera.image_name)

    def point_cloud_dir(self, iteration: int) -> str:
        return os.path.join(self.model_path, f"point_cloud/iteration_{iteration}")

    def init_point_cloud_dir(self, iteration: int) -> str:
        return os.path.join(self.model_path, f"init_point_cloud/iteration_{iteration}")


class VideoScene:
    """Render-path scene (`scene/__init__.py:115-185`) on `device`."""

    def __init__(self, source_path: str, model_path: str, resolution: int = -1,
                 load_iteration: Optional[int] = -1,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model_path = model_path
        kind = "TanksVideo" if "Tanks" in source_path else "LLFFVideo"
        scene_info = scene_load_callbacks[kind](source_path)
        self.scene_info = scene_info
        self.cameras_extent = scene_info.nerf_normalization["radius"]
        self.test_cameras = camera_list_from_infos(scene_info.test_cameras, resolution,
                                                   device=self.device)
        self.loaded_iter = None
        if load_iteration is not None:
            if load_iteration == -1:
                self.loaded_iter = search_max_iteration(
                    os.path.join(model_path, "point_cloud")
                )
            else:
                self.loaded_iter = load_iteration


def search_max_iteration(folder: str) -> int:
    """`searchForMaxIteration` (`utils/system_utils.py`)."""
    saved = [int(f.split("_")[-1]) for f in os.listdir(folder)]
    return max(saved)
