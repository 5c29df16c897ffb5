"""Video rendering CLI — interpolated-camera fly-through.

Port of the JAX package's `apps/render_video.py` (reference
`render_video.py:115-165`): renders the spiral/slerp camera path from
`VideoScene` (LLFF spiral, which needs `poses_bounds.npy` from
`data/pose_utils.py::gen_poses`, or Tanks sequential slerp) and writes
per-frame PNGs plus RGB and turbo-depth XVID videos.

    python -m scgaussian_tpu_torch.apps.render_video -m <model dir> [--device cpu]

Renders run under `torch.no_grad()` on `--device` (default `cuda`; without
a GPU the CLI raises unless `--device cpu` is given). There is no
truncation warning: the CUDA path never drops tile entries. A video writer
that OpenCV cannot open (no XVID encoder) raises rather than writing
nothing.
"""

from __future__ import annotations

import json
import os
import time
from argparse import ArgumentParser

import numpy as np
import torch


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Video rendering parameters")
    parser.add_argument("--source_path", "-s", type=str, default=None)
    parser.add_argument("--model_path", "-m", type=str, required=True)
    parser.add_argument("--resolution", "-r", type=int, default=None)
    parser.add_argument("--white_background", "-w", action="store_true", default=None)
    parser.add_argument("--sh_degree", type=int, default=None)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--backend", type=str, default="cuda", choices=["cuda", "oracle"])
    parser.add_argument("--bg_capacity", type=int, default=65536)
    parser.add_argument("--fps", type=int, default=30)
    parser.add_argument("--max_frames", type=int, default=None,
                        help="render only the first N path frames")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on; 'cpu' runs the kernels' "
                             "plain versions")
    return parser


def _writer(cv2, path: str, fps: int, size):
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"XVID"), fps, size)
    if not writer.isOpened():
        raise RuntimeError(f"OpenCV cannot open an XVID writer for {path}")
    return writer


@torch.no_grad()
def main(argv=None) -> dict:
    """Renders the path; returns its host seconds per frame: `render`
    (render and the copies to the host) and `write` (frame PNGs and the
    two videos' frames)."""
    import cv2

    from scgaussian_tpu_torch import resolve_device
    from scgaussian_tpu_torch.apps.render import save_image, save_turbo_depth
    from scgaussian_tpu_torch.data.scene import VideoScene
    from scgaussian_tpu_torch.model import io as model_io
    from scgaussian_tpu_torch.train.main_stage import render_model

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    cfg_path = os.path.join(args.model_path, "cfg_args.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = json.load(f)
        for key in ("source_path", "resolution", "white_background", "sh_degree"):
            if getattr(args, key) is None and key in cfg:
                setattr(args, key, cfg[key])

    scene = VideoScene(
        source_path=args.source_path,
        model_path=args.model_path,
        resolution=args.resolution if args.resolution is not None else -1,
        load_iteration=args.iteration,
        device=dev,
    )
    model = model_io.load_ply(
        os.path.join(
            args.model_path, "point_cloud", f"iteration_{scene.loaded_iter}",
            "point_cloud.ply",
        ),
        max_sh_degree=args.sh_degree or 3,
        bg_capacity=args.bg_capacity,
        device=dev,
    )
    bg = torch.tensor([1.0, 1.0, 1.0] if args.white_background else [0.0, 0.0, 0.0],
                      device=dev)

    base = os.path.join(args.model_path, "video", f"ours_{scene.loaded_iter}")
    frames_dir = os.path.join(base, "frames")
    os.makedirs(frames_dir, exist_ok=True)

    cams = scene.test_cameras
    if args.max_frames is not None:
        cams = cams[: args.max_frames]
    size = (cams[0].width, cams[0].height)
    vid_rgb = _writer(cv2, os.path.join(base, "video_rgb.avi"), args.fps, size)
    vid_depth = _writer(cv2, os.path.join(base, "video_depth.avi"), args.fps, size)

    seconds = {"render": [], "write": []}
    try:
        for idx, cam in enumerate(cams):
            t0 = time.perf_counter()
            out = render_model(cam.camera, model, bg, backend=args.backend)
            rgb = torch.clamp(out.render, 0, 1).cpu().numpy()
            depth = out.rendered_depth[0].cpu().numpy()
            seconds["render"].append(time.perf_counter() - t0)

            t0 = time.perf_counter()
            rng = depth.max() - depth.min()
            depth_norm = (depth - depth.min()) / (rng if rng > 0 else 1.0)
            save_image(rgb, os.path.join(frames_dir, f"{idx:05d}.png"))
            save_turbo_depth(depth_norm, os.path.join(frames_dir, f"depth_{idx:05d}.png"))
            frame = (rgb.transpose(1, 2, 0)[..., ::-1] * 255).astype(np.uint8)
            vid_rgb.write(np.ascontiguousarray(frame))
            vid_depth.write(cv2.imread(os.path.join(frames_dir, f"depth_{idx:05d}.png")))
            seconds["write"].append(time.perf_counter() - t0)
    finally:
        vid_rgb.release()
        vid_depth.release()
    print(f"Wrote {len(cams)} frames to {base}")
    return seconds


if __name__ == "__main__":
    main()
