"""SIBR remote-viewer socket protocol.

Port of `scgaussian_tpu/viewer/network_gui.py` (reference
`gaussian_renderer/network_gui.py:26-86`): a non-blocking TCP listener
speaking the SIBR viewer protocol — length-prefixed JSON request (camera
pose + training toggles) in, raw RGB bytes + verify string out. The train
CLI attaches it with --port and polls it every iteration.

The viewer sends matrices in the reference's transposed (row-vector)
convention with flipped y/z columns; `receive()` converts them to the
column-vector `Camera`.

One difference from the JAX package: its `poll` drops the connection on
any exception. Here only socket and protocol errors drop it (`OSError`,
and `ValueError` from JSON or UTF-8 decoding); an error from the render,
such as a failed kernel launch, propagates to the caller.
"""

from __future__ import annotations

import json
import socket
from typing import Optional

import numpy as np
import torch


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None

    def try_connect(self) -> None:
        try:
            self.conn, addr = self.listener.accept()
        except OSError:  # no viewer waiting (BlockingIOError), or it left already
            return
        print(f"\nViewer connected by {addr}")
        self.conn.settimeout(None)

    def _read(self) -> dict:
        n = int.from_bytes(self.conn.recv(4), "little")
        return json.loads(self.conn.recv(n).decode("utf-8"))

    def send(self, image_bytes: Optional[bytes], verify: str) -> None:
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def receive(self):
        """Returns (camera_dict | None, do_training, shs_python,
        rot_scale_python, keep_alive, scaling_modifier)."""
        message = self._read()
        width = message["resolution_x"]
        height = message["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None, None, None

        view_t = np.array(message["view_matrix"], np.float32).reshape(4, 4)
        view_t[:, 1] = -view_t[:, 1]
        view_t[:, 2] = -view_t[:, 2]
        proj_t = np.array(message["view_projection_matrix"], np.float32).reshape(4, 4)
        proj_t[:, 1] = -proj_t[:, 1]

        cam = {
            "width": width,
            "height": height,
            "fovy": message["fov_y"],
            "fovx": message["fov_x"],
            "znear": message["z_near"],
            "zfar": message["z_far"],
            # reference stores transposed (row-vector) matrices; convert
            "world_view": view_t.T,
            "full_proj": proj_t.T,
        }
        return (
            cam,
            bool(message["train"]),
            bool(message["shs_python"]),
            bool(message["rot_scale_python"]),
            bool(message["keep_alive"]),
            message["scaling_modifier"],
        )

    def _drop(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass
        self.conn = None

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()
        self.listener.close()

    def poll(
        self,
        model,
        source_path: str,
        iteration: int,
        max_iterations: int,
        backend: str = "cuda",
        raster=None,
    ) -> None:
        """Per-training-iteration viewer poll — mirrors `train.py:109-122`:
        accept a pending connection, then serve render requests until the
        viewer either releases training (`do_training` with the budget not
        exhausted) or disconnects. A socket or protocol error drops the
        connection and training continues; a render error propagates."""
        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                cam_dict, do_training, _shs_py, _cov_py, keep_alive, scaling = (
                    self.receive()
                )
            except (OSError, ValueError):
                self._drop()
                return
            image_bytes = None
            if cam_dict is not None:
                image_bytes = render_for_viewer(
                    cam_dict, model, backend=backend,
                    scaling_modifier=float(scaling), raster=raster,
                )
            try:
                self.send(image_bytes, source_path)
            except OSError:
                self._drop()
                return
            if do_training and (iteration < max_iterations or not keep_alive):
                return


@torch.no_grad()
def render_for_viewer(
    cam_dict, model, backend="cuda", scaling_modifier: float = 1.0, raster=None
) -> bytes:
    """Render for the viewer on the model's device: returns H*W*3 uint8
    bytes (train.py:116-117)."""
    from scgaussian_tpu_torch.core.cameras import Camera
    from scgaussian_tpu_torch.train.main_stage import render_model

    dev = model.zval.device

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    w2c = cam_dict["world_view"]
    cam = Camera(
        width=int(cam_dict["width"]),
        height=int(cam_dict["height"]),
        world_view=t(w2c),
        full_proj=t(cam_dict["full_proj"]),
        cam_center=t(np.linalg.inv(w2c)[:3, 3]),
        K=t(np.eye(3)),
        tanfovx=t(np.tan(cam_dict["fovx"] / 2)),
        tanfovy=t(np.tan(cam_dict["fovy"] / 2)),
        znear=t(cam_dict["znear"]),
        zfar=t(cam_dict["zfar"]),
    )
    kwargs = {} if raster is None else {"raster": raster}
    out = render_model(
        cam, model, torch.zeros(3, device=dev), backend=backend,
        scaling_modifier=scaling_modifier, **kwargs,
    )
    img = (torch.clamp(out.render, 0, 1) * 255).cpu().numpy().astype(np.uint8)
    return np.ascontiguousarray(img.transpose(1, 2, 0)).tobytes()
