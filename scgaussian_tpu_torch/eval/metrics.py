"""Evaluation metrics pipeline (PSNR / SSIM / LPIPS / AVG).

Port of `scgaussian_tpu/eval/metrics.py` (reference `metrics.py:26-118`):
walks `<model>/test/ours_<it>/{renders,gt,dtumask}`, white-composites DTU
masks (`render*mask + (1-mask)`, `metrics.py:43-44`), computes SSIM (full
image, on the device), PSNR (mask-selected pixels, in numpy as the JAX
package does), LPIPS-VGG (when weights are available, see `eval/lpips.py`)
and AVG = geometric mean of (10^(-PSNR/10), sqrt(1-SSIM), LPIPS)
(`metrics.py:91`), writing results.json / per_view.json with the reference
schema, including its quirk of storing the LPIPS mean under "AVG" in
results.json (`metrics.py:107`).
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from PIL import Image

from scgaussian_tpu_torch import resolve_device
from scgaussian_tpu_torch.eval import lpips as lpips_mod
from scgaussian_tpu_torch.losses import ssim

METRICS = ("SSIM", "PSNR", "LPIPS", "AVG")


def _to_tensor(img: Image.Image) -> np.ndarray:
    arr = np.asarray(img).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, axis=-1)
    return arr[..., :3].transpose(2, 0, 1)  # [3, H, W]


def read_images(renders_dir: Path, gt_dir: Path, mask_dir: Path):
    """`readImages` (`metrics.py:26-47`)."""
    renders, gts, masks, names = [], [], [], []
    for fname in sorted(os.listdir(renders_dir)):
        render = _to_tensor(Image.open(renders_dir / fname))
        gt = _to_tensor(Image.open(gt_dir / fname))
        if os.path.exists(mask_dir / fname):
            m_img = Image.open(mask_dir / fname).resize((gt.shape[2], gt.shape[1]))
            mask = _to_tensor(m_img)
        else:
            mask = np.ones_like(gt)
        mask_bin = mask == 1.0
        renders.append(render * mask + (1 - mask))
        gts.append(gt * mask + (1 - mask))
        masks.append(mask_bin)
        names.append(fname)
    return renders, gts, names, masks


def compute_image_metrics(render: np.ndarray, gt: np.ndarray, mask_bin: np.ndarray,
                          lpips_model: Optional[lpips_mod.LPIPS] = None,
                          device: str | torch.device | None = None
                          ) -> Dict[str, Optional[float]]:
    """Per-image metrics (`metrics.py:86-95`); SSIM and LPIPS on `device`
    (default: the GPU)."""
    dev = resolve_device(device)
    r = torch.as_tensor(render, device=dev)
    g = torch.as_tensor(gt, device=dev)
    with torch.no_grad():
        o_ssim = float(ssim(r, g))
        o_lpips = None
        if lpips_model is not None:
            o_lpips = float(lpips_model(r[None], g[None])[0])
    # PSNR over mask-selected pixels, in numpy as the JAX package computes it
    # (exactly 20*log10(1/sqrt(mse)), image_utils.py:18)
    diff = render[mask_bin] - gt[mask_bin]
    o_psnr = float(20.0 * np.log10(1.0 / np.sqrt(np.mean(diff * diff))))
    terms = [10 ** (-o_psnr / 10), math.sqrt(max(1 - o_ssim, 1e-12))]
    if o_lpips is not None:
        terms.append(max(o_lpips, 1e-12))
    o_avg = float(np.exp(np.mean(np.log(terms))))
    return {"SSIM": o_ssim, "PSNR": o_psnr, "LPIPS": o_lpips, "AVG": o_avg}


def evaluate(model_paths: List[str], use_lpips: bool = True,
             device: str | torch.device | None = None) -> Dict:
    """`evaluate` (`metrics.py:49-118`) on `device` (default: the GPU)."""
    dev = resolve_device(device)
    lpips_model = None
    if use_lpips and lpips_mod.lpips_available("vgg"):
        lpips_model = lpips_mod.LPIPS("vgg", device=dev)
    elif use_lpips:
        print("[metrics] LPIPS weights unavailable; reporting LPIPS as null "
              "(set $SCGAUSSIAN_LPIPS_WEIGHTS)")

    full_dict = {}
    per_view_dict = {}
    for scene_dir in model_paths:
        print("Scene:", scene_dir)
        full_dict[scene_dir] = {}
        per_view_dict[scene_dir] = {}
        test_dir = Path(scene_dir) / "test"
        for method in os.listdir(test_dir):
            print("Method:", method)
            method_dir = test_dir / method
            renders, gts, names, masks = read_images(
                method_dir / "renders", method_dir / "gt", method_dir / "dtumask"
            )
            per_image = [
                compute_image_metrics(r, g, m, lpips_model, dev)
                for r, g, m in zip(renders, gts, masks)
            ]
            means = {
                k: (
                    float(np.mean([pi[k] for pi in per_image]))
                    if all(pi[k] is not None for pi in per_image)
                    else None
                )
                for k in METRICS
            }
            for k in METRICS:
                v = means[k]
                print(f"  {k} : {v:.7f}" if v is not None else f"  {k} : n/a")
            full_dict[scene_dir][method] = {
                "SSIM": means["SSIM"],
                "PSNR": means["PSNR"],
                "LPIPS": means["LPIPS"],
                # reference quirk: results.json "AVG" stores the LPIPS mean
                # (`metrics.py:107`); the true AVG lives in per_view.json
                "AVG": means["LPIPS"] if means["LPIPS"] is not None else means["AVG"],
            }
            if means["LPIPS"] is None:
                # explicit schema marker: without LPIPS weights the AVG
                # geo-mean is over (PSNR, SSIM) terms only
                full_dict[scene_dir][method]["AVG_definition"] = (
                    "geomean(10^(-PSNR/10), sqrt(1-SSIM)) — LPIPS term "
                    "omitted (weights unavailable)"
                )
                print("  [metrics] WARNING: AVG computed WITHOUT the LPIPS "
                      "term (weights unavailable)")
            per_view_dict[scene_dir][method] = {
                k: {n: pi[k] for pi, n in zip(per_image, names)} for k in METRICS
            }
        with open(os.path.join(scene_dir, "results.json"), "w") as f:
            json.dump(full_dict[scene_dir], f, indent=True)
        with open(os.path.join(scene_dir, "per_view.json"), "w") as f:
            json.dump(per_view_dict[scene_dir], f, indent=True)
    return full_dict
