"""CameraInfo -> device-ready training camera, with resolution logic.

Port of the JAX package's `data/camera_utils.py` (reference
`utils/camera_utils.py:20-102` + `scene/cameras.py:19-72`): a host record
(`LoadedCamera`) holding the numpy image and masks, the port's `Camera` on
a given device, and the full-resolution pose and fields of view the match
machinery uses. Images are resized with PIL (bicubic, as the reference's
`PILtoTorch`), masks with OpenCV's bilinear `resize`; `cv2` is imported
only where a mask is resized.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
from PIL import Image

from scgaussian_tpu_torch import resolve_device
from scgaussian_tpu_torch.core.cameras import Camera, fov2focal

_WARNED = False


@dataclasses.dataclass
class LoadedCamera:
    camera: Camera  # the renderer's camera (at the loaded resolution)
    uid: int
    colmap_id: int
    image_name: Optional[str]
    R: np.ndarray
    T: np.ndarray
    fovx: float
    fovy: float
    image: Optional[np.ndarray]  # [3, H, W] float32 in [0, 1], clamped
    dtumask: Optional[np.ndarray]  # [H, W] float32
    blendermask: Optional[np.ndarray]  # [H, W] float32
    near_far: Optional[np.ndarray]

    @property
    def width(self) -> int:
        return self.camera.width

    @property
    def height(self) -> int:
        return self.camera.height

    def gt_image(self) -> torch.Tensor:
        """The ground truth [3, H, W] on the camera's device."""
        return torch.as_tensor(self.image, device=self.camera.device)


def _pil_to_np(pil_image: Image.Image, resolution) -> np.ndarray:
    """PILtoTorch equivalent (`utils/general_utils.py:22-28`): resize then
    [C, H, W] float in [0, 1]."""
    resized = pil_image.resize(resolution)
    arr = np.array(resized).astype(np.float32) / 255.0
    if arr.ndim == 3:
        return arr.transpose(2, 0, 1)
    return arr[None]


def _resize_mask(mask: np.ndarray, resolution) -> np.ndarray:
    import cv2

    return cv2.resize(mask.astype(np.float32), resolution)


def load_cam(resolution_arg: int, uid: int, info, resolution_scale: float = 1.0,
             device: str | torch.device | None = None) -> LoadedCamera:
    """`loadCam` (`utils/camera_utils.py:20-72`): divisor resolutions
    {1,2,4,8} or width-based downscale with the >1600px auto clamp. The
    camera lives on `device` (default: the GPU)."""
    global _WARNED
    dev = resolve_device(device)

    if info.image is not None:
        orig_w, orig_h = info.image.size
        if resolution_arg in (1, 2, 4, 8):
            resolution = (
                round(orig_w / (resolution_scale * resolution_arg)),
                round(orig_h / (resolution_scale * resolution_arg)),
            )
        else:
            if resolution_arg == -1:
                if orig_w > 1600:
                    if not _WARNED:
                        print(
                            "[ INFO ] Encountered quite large input images "
                            "(>1.6K pixels width), rescaling to 1.6K."
                        )
                        _WARNED = True
                    global_down = orig_w / 1600
                else:
                    global_down = 1
            else:
                global_down = orig_w / resolution_arg
            scale = float(global_down) * float(resolution_scale)
            resolution = (int(orig_w / scale), int(orig_h / scale))

        rgb = _pil_to_np(info.image, resolution)
        gt = np.clip(rgb[:3], 0.0, 1.0)
        if rgb.shape[0] == 4:
            gt = gt * rgb[3:4]
        blendermask = info.blendermask
        if blendermask is not None:
            blendermask = _resize_mask(blendermask, resolution)
        dtumask = info.dtumask
        if dtumask is not None:
            dtumask = _resize_mask(dtumask, resolution)
        width, height = resolution
    else:
        gt = None
        blendermask = None
        dtumask = None
        width, height = info.width, info.height
        if resolution_arg in (1, 2, 4, 8):
            width = int(width / resolution_arg)
            height = int(height / resolution_arg)

    cam = Camera.create(info.R, info.T, info.fovx, info.fovy, width, height, device=dev)
    return LoadedCamera(
        camera=cam,
        uid=uid,
        colmap_id=info.uid,
        image_name=info.image_name,
        R=info.R,
        T=info.T,
        fovx=info.fovx,
        fovy=info.fovy,
        image=gt,
        dtumask=dtumask,
        blendermask=blendermask,
        near_far=info.near_far,
    )


def camera_list_from_infos(infos: List, resolution_arg: int, resolution_scale: float = 1.0,
                           device: str | torch.device | None = None) -> List[LoadedCamera]:
    return [load_cam(resolution_arg, i, c, resolution_scale, device)
            for i, c in enumerate(infos)]


def camera_to_json(id: int, cam: LoadedCamera) -> dict:
    """`camera_to_JSON` (`utils/camera_utils.py:82-102`)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = cam.R.transpose()
    Rt[:3, 3] = cam.T
    Rt[3, 3] = 1.0
    w2c = np.linalg.inv(Rt)
    return {
        "id": id,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": w2c[:3, 3].tolist(),
        "rotation": [r.tolist() for r in w2c[:3, :3]],
        "fy": fov2focal(cam.fovy, cam.height),
        "fx": fov2focal(cam.fovx, cam.width),
    }
