"""Configuration dataclasses mirroring the reference flag system.

A copy of `scgaussian_tpu/config.py`: knob names and defaults are identical
to `arguments/__init__.py:47-91` (ModelParams / PipelineParams /
OptimizationParams) so configs written by either package load in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """`ModelParams` (`arguments/__init__.py:47-62`)."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = False


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """`PipelineParams` (`arguments/__init__.py:64-69`)."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    """`OptimizationParams` (`arguments/__init__.py:71-91`)."""

    iterations: int = 2_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 2_000
    feature_lr: float = 0.002
    opacity_lr: float = 0.055
    scaling_lr: float = 0.0055
    rotation_lr: float = 0.0015
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 200
    opacity_reset_until_iter: int = 2_000
    densify_from_iter: int = 500
    densify_until_iter: int = 2_000
    densify_grad_threshold: float = 0.0004
    random_background: bool = False


@dataclasses.dataclass(frozen=True)
class RasterizerConfig:
    """Rasterizer knobs: `tile` is the 16-px CUDA tile.

    `entry_budget` and `ptile` are the JAX package's TPU capacities. Here
    they size nothing (the GPU path sizes its entry buffers per frame and
    never truncates); they decide the backward's route, as in JAX: with an
    entry budget (`entry_budget`, or `binning.default_entry_budget` of the
    slot count at the resolved processing tile) of at least
    `raster.SORT_ROUTE_MIN_L`, per-entry gradients are sorted by Gaussian
    and summed by the segment-sum kernel (`raster.sort_route`)."""

    tile: int = 16
    entry_budget: Optional[int] = None
    ptile: int = 0

    def resolved_ptile(self, width: int, height: int) -> int:
        """The JAX package's processing tile (`scgaussian_tpu/config.py:
        80-86`): `ptile` if set, else 2 * tile when the tile grid is at most
        256 tiles each way, else `tile`."""
        if self.ptile:
            return self.ptile
        fits = (width + self.tile - 1) // self.tile <= 256 and (
            height + self.tile - 1
        ) // self.tile <= 256
        return 2 * self.tile if fits else self.tile


@dataclasses.dataclass(frozen=True)
class TrainExtras:
    """Hardcoded reference constants surfaced as config."""

    init_iterations: int = 2_000  # train.py:57
    init_lr: float = 0.5  # scene/gaussian_model.py:475
    init_loss_scale: float = 5.0  # train.py:66
    render_match_loss_weight: float = 0.3  # train.py:165
    promote_err_threshold: float = 0.1  # scene/gaussian_model.py:395
    prune_min_opacity: float = 0.005  # train.py:197
    size_threshold: int = 20  # train.py:196
    bg_capacity: int = 65536
    dtu_dark_threshold: float = 30.0 / 255.0  # train.py:152 (15/255 for scan110)
    dtu_shift_rows: int = 50  # train.py:156-157
    # Reference quirk: on split, ray-Gaussian parents divide their LOG-domain
    # scaling by 0.8*N (scene/gaussian_model.py:889-890). True replicates it.
    fg_split_log_quirk: bool = True
    # True: auto-grow bg capacity when densify drops candidates. False: raise.
    guard_auto_grow: bool = True


def save_config(path: str, **groups) -> None:
    payload = {k: dataclasses.asdict(v) for k, v in groups.items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)


def load_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
