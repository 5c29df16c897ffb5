"""Render CLI — train/test set rendering with depth + error-map outputs.

Port of the JAX package's `apps/render.py` (reference `render.py:119-195`):
writes `<model>/{train,test}/ours_<it>/{renders,gt,depth,error_map,dtumask}`
PNGs, min-max-normalized depth plus a turbo-colormapped depth, the
0.5*L1+0.5*SSIM error map, and the colored point cloud on the first train
view. Loads the model from the saved PLY (`scene/__init__.py:91-95`).

    python -m scgaussian_tpu_torch.apps.render -m <model dir> [--device cpu]

Renders run under `torch.no_grad()` on `--device` (default `cuda`; without
a GPU the CLI raises unless `--device cpu` is given). Images are written
with PIL and the turbo colormap is the port's own table
(`utils/colormap.py`). There is no truncation warning: the CUDA path sizes
its tile entries per frame and never drops any.
"""

from __future__ import annotations

import json
import os
import time
from argparse import ArgumentParser

import numpy as np
import torch
from PIL import Image

from scgaussian_tpu_torch.utils.colormap import turbo_rgb


def save_image(arr: np.ndarray, path: str) -> None:
    """[C, H, W] or [H, W] float in [0, 1] -> PNG."""
    if arr.ndim == 3:
        arr = arr.transpose(1, 2, 0)
        if arr.shape[-1] == 1:
            arr = arr[..., 0]
    Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)).save(path)


def save_turbo_depth(depth: np.ndarray, path: str) -> None:
    """Turbo-colormapped depth (`render.py:97-110`): vmax at the 98th
    percentile."""
    vmax = np.percentile(depth, 98)
    Image.fromarray(turbo_rgb(depth, depth.min(), vmax)).save(path)


@torch.no_grad()
def render_set(model_path, name, iteration, cameras, model, bg_color, backend="cuda",
               save_color_pcd=False) -> dict:
    """Renders and writes one set. Returns its host seconds: `render`
    (render, error map and the copies to the host, per view), `png`,
    `turbo` and `ply` (file writing, summed over the views)."""
    from scgaussian_tpu_torch.data.ply import store_point_cloud
    from scgaussian_tpu_torch.losses import pixel_loss_map
    from scgaussian_tpu_torch.renderer.project import sh_to_color
    from scgaussian_tpu_torch.train.main_stage import render_model

    base = os.path.join(model_path, name, f"ours_{iteration}")
    dirs = {k: os.path.join(base, k) for k in ("renders", "gt", "depth", "error_map", "dtumask")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    dev = model.zval.device
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    seconds = {"render": [], "png": 0.0, "turbo": 0.0, "ply": 0.0}
    for idx, cam in enumerate(cameras):
        t0 = time.perf_counter()
        out = render_model(cam.camera, model, bg, backend=backend)
        rendering_t = torch.clamp(out.render, 0, 1)
        rendering = rendering_t.cpu().numpy()
        depth = out.rendered_depth[0].cpu().numpy()
        rng = depth.max() - depth.min()
        depth_norm = (depth - depth.min()) / (rng if rng > 0 else 1.0)
        err = None
        if cam.image is not None:
            gt = np.clip(cam.image, 0, 1)
            err = pixel_loss_map(rendering_t, torch.as_tensor(gt, device=dev)).cpu().numpy()
        seconds["render"].append(time.perf_counter() - t0)

        if name == "train" and idx == 0 and save_color_pcd:
            # colored point cloud (`gaussian_renderer/__init__.py:90-96`)
            t0 = time.perf_counter()
            xyz = model.get_xyz()
            alive = model.alive_mask().cpu().numpy()
            colors = sh_to_color(
                model.get_features(), xyz, cam.camera.cam_center, model.max_sh_degree,
            ).cpu().numpy()
            store_point_cloud(
                os.path.join(model_path, name, "point_cloud_color.ply"),
                xyz.cpu().numpy()[alive],
                np.clip(colors[alive], 0, 1) * 255,
            )
            seconds["ply"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        save_image(rendering, os.path.join(dirs["renders"], f"{idx:05d}.png"))
        if err is not None:
            save_image(gt, os.path.join(dirs["gt"], f"{idx:05d}.png"))
            save_image(err, os.path.join(dirs["error_map"], f"{idx:05d}.png"))
        save_image(depth_norm, os.path.join(dirs["depth"], f"{idx:05d}.png"))
        if cam.dtumask is not None:
            save_image(cam.dtumask, os.path.join(dirs["dtumask"], f"{idx:05d}.png"))
        seconds["png"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        save_turbo_depth(depth_norm, os.path.join(dirs["depth"], f"color_{idx:05d}.png"))
        seconds["turbo"] += time.perf_counter() - t0
    return seconds


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Testing script parameters")
    parser.add_argument("--source_path", "-s", type=str, default=None)
    parser.add_argument("--model_path", "-m", type=str, required=True)
    parser.add_argument("--images", "-i", type=str, default=None)
    parser.add_argument("--resolution", "-r", type=int, default=None)
    parser.add_argument("--white_background", "-w", action="store_true", default=None)
    parser.add_argument("--eval", action="store_true", default=None)
    parser.add_argument("--sh_degree", type=int, default=None)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--backend", type=str, default="cuda", choices=["cuda", "oracle"])
    parser.add_argument("--bg_capacity", type=int, default=65536)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on; 'cpu' runs the kernels' "
                             "plain versions")
    return parser


def main(argv=None) -> dict:
    """Renders the sets; returns {set name: `render_set`'s seconds}."""
    from scgaussian_tpu_torch import resolve_device
    from scgaussian_tpu_torch.data.scene import Scene
    from scgaussian_tpu_torch.model import io as model_io

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    # cfg_args.json overlay (reference get_combined_args, arguments/__init__.py:93-113)
    cfg_path = os.path.join(args.model_path, "cfg_args.json")
    cfg = {}
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = json.load(f)
    for key in ("source_path", "images", "resolution", "white_background", "eval", "sh_degree"):
        if getattr(args, key) is None and key in cfg:
            setattr(args, key, cfg[key])
    print("Rendering " + args.model_path)

    scene = Scene(
        source_path=args.source_path,
        model_path=args.model_path,
        images=args.images or "images",
        resolution=args.resolution if args.resolution is not None else -1,
        white_background=bool(args.white_background),
        eval=bool(args.eval),
        shuffle=False,
        load_iteration=args.iteration,
        device=dev,
    )
    model = model_io.load_ply(
        os.path.join(scene.point_cloud_dir(scene.loaded_iter), "point_cloud.ply"),
        max_sh_degree=args.sh_degree or 3,
        bg_capacity=args.bg_capacity,
        device=dev,
    )
    bg = [1.0, 1.0, 1.0] if args.white_background else [0.0, 0.0, 0.0]

    seconds = {}
    if not args.skip_train:
        seconds["train"] = render_set(args.model_path, "train", scene.loaded_iter,
                                      scene.train_cameras, model, bg, args.backend,
                                      save_color_pcd=True)
    if not args.skip_test:
        seconds["test"] = render_set(args.model_path, "test", scene.loaded_iter,
                                     scene.test_cameras, model, bg, args.backend)
    return seconds


if __name__ == "__main__":
    main()
