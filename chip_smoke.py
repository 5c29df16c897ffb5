#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of `scgaussian_tpu_torch` from the sources in this
checkout (one nvcc per source, started together) and reports each one's
resident blocks per SM, holds each against its plain PyTorch version on the
card (also on a scene built to press on the compositing kernels' cull),
then drives the port's three paths:

- serving: model saved to PLY -> `load_ply` -> `render_model` for 5 views
  at 1920x1080, 100k Gaussians, SH degree 3, under `torch.no_grad()`;
- one training step: 6 main-stage `train_step`s at 1920x1080 on the same
  hybrid model (106,384 slots, so the backward sums with atomics),
  cycling through 3 views with a `MatchBundle` of 6 ordered pairs x 15,000
  matches, against ground truth rendered from the model with its depths
  perturbed;
- two-stage training at 3840x2160: `setup_from_matches` (init stage,
  promotion, `create_model`) on 6 ordered pairs x 75,000 exact matches of a
  300,000-ray ground-truth model, then 12 iterations of `run_main_stage`
  with one densify event and one opacity reset, on 450,000 ray Gaussians +
  65,536 background slots, where the backward routes by sort through the
  segment-sum kernel;
- the command line: a synthetic COLMAP scene of 20 views at 1008x756
  written to disk, the train CLI on it at `-r 2` (504x378, the size of
  LLFF at `-r 8`) under the LLFF few-shot protocol (3 training views, every
  8th view held out, >= 2,000 matches a pair, 2,000 init + 2,000 main
  iterations), a run resumed from its checkpoint at 1,000, and the render
  CLI; then the kernels against their plain versions at that size.

It times the kernels, the stages and whole renders and steps with CUDA
events, the host clock and the profiler.

Output: one JSON line per phase; then the card's `nvidia-smi` name and
power limit, the kernel table as one JSON line, and last
`{"ok": true, "device": {...}}`. Any failed check raises (exit code != 0,
no last line). Without a CUDA device, or without the package beside it,
the script fails before printing a result.
"""

from __future__ import annotations

import copy
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from scgaussian_tpu_torch.apps import render as render_cli
from scgaussian_tpu_torch.apps import train as train_cli
from scgaussian_tpu_torch import native
from scgaussian_tpu_torch.config import OptimizationConfig, RasterizerConfig, TrainExtras
from scgaussian_tpu_torch.core.cameras import Camera
from scgaussian_tpu_torch.data.camera_utils import camera_list_from_infos
from scgaussian_tpu_torch.data.readers import read_colmap_scene
from scgaussian_tpu_torch.data.scene import build_bundle_from_scene
from scgaussian_tpu_torch.data.synthetic import generate_scene
from scgaussian_tpu_torch.losses import l1_loss, ssim
from scgaussian_tpu_torch.model.densify import densify_and_prune, reset_opacity, update_stats
from scgaussian_tpu_torch.model.gaussians import PARAM_NAMES, create_model, model_from_numpy
from scgaussian_tpu_torch.model.io import load_ply, save_ply
from scgaussian_tpu_torch.model.knn import knn_mean_sq_dist
from scgaussian_tpu_torch.model.matches import (
    build_match_bundle, init_zvals, matchloss_from_base, matchloss_from_renderdepth,
    promote_matches, run_init_stage,
)
from scgaussian_tpu_torch.renderer import _build, raster
from scgaussian_tpu_torch.renderer.api import render
from scgaussian_tpu_torch.renderer.binning import bin_gaussians
from scgaussian_tpu_torch.renderer.oracle import composite_dense
from scgaussian_tpu_torch.renderer.project import ProjectedGaussians, project
from scgaussian_tpu_torch.train import optim
from scgaussian_tpu_torch.train.main_stage import (
    apply_update, make_camera_loss, render_model, train_step,
)
from scgaussian_tpu_torch.train import pipeline as pipeline_mod
from scgaussian_tpu_torch.train.pipeline import run_main_stage, setup_from_matches
from scgaussian_tpu_torch.utils import profiling
from scgaussian_tpu_torch.utils.logging import TrainLogger

REPS = 5  # timed repeats after one warm-up
H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
OPS_PER_PAIR = 16  # ~15 fp32 operations + 1 expf per (pixel, entry) pair evaluated
# backward, per (pixel, entry) pair before the pixel's last contributor, counted
# from csrc/raster_bwd.cu. A live pair takes the whole chain: 11 for power,
# 1 expf, 2 alpha, 1 + 1 for 1 - alpha and T, 1 w, 7 color/depth dot,
# 3 d_alpha, 2 tail, 1 d_power, 1 d_opacity, 10 mean2d, 9 conic, 4 rgb/depth,
# plus 10 adds to sum the terms per entry. A dead pair takes only the liveness
# test: power (11), and where power <= 0 also expf and alpha (3 more). Both
# bounds keep pricing the dead pairs that the kernels' cull now skips, so
# that times stay comparable with the first kernel designs' bounds.
OPS_LIVE_BWD = 64
OPS_FAINT_BWD = 14  # power <= 0, alpha < 1/255
OPS_FAR_BWD = 11  # power > 0
ALPHA_T_MAX = 1e-5  # kernel vs plain: alpha and final T (they agree bitwise when right)
# backward kernel vs plain: max abs error per column group <= this * max|g|.
# The per-pixel arithmetic is the same; atomics change the order of the sums
# from run to run (measured: <= 4e-7 * max|g| at 1080p).
BWD_REL_MAX = 1e-5
AUTOGRAD_REL_MAX = 5e-4  # plain backward vs autograd (tests/test_tile_raster.py:81-109)
PAIR_KINDS = ("live_pairs", "faint_pairs", "far_pairs")  # the backward's pairs, by cost
GRAD_GROUPS = {"mean2d": (0, 2), "conic": (2, 5), "opacity": (5, 6), "rgb": (6, 9),
               "depth": (9, 10)}

# (width, height, Gaussians) of the JAX package's bench scenes (bench.py)
PARITY = (256, 160, 1500)  # bench.py:55, the parity-gate scene
FULL = (1920, 1080, 100_000)  # bench.py:170-171
DENSE = (3840, 2160, 500_000)  # bench.py:167-168
HYBRID = (90_000, 10_000, 16_384)  # main path: ray, alive bg, bg capacity
VIEWS = 5
TRAIN_VIEWS = 3  # the LLFF few-shot protocol: 3 views, 6 ordered pairs
MATCHES = 15_000  # per ordered pair
TRAIN_STEPS = 6
# the two-stage 4K training path (the JAX bench's dense 4K regime, bench.py:165-168)
PIPE_SIZE = (3840, 2160)
PIPE_GT = (300_000, 20_000, 32_768)  # ground truth: ray Gaussians, alive bg, bg slots
PIPE_MATCHES = 75_000  # per ordered pair: 6 pairs, 450,000 matches
PIPE_BG_CAPACITY = 65_536
PIPE_INIT_ITERS = 2_000  # the reference's init stage (train.py:57)
PIPE_STEPS = 12
PIPE_MIN_SLOTS = 262_144  # above it, the default config routes the backward by sort
# cut: the reference densifies from 500 every 100 and resets every 200 (of
# 2,000); here one densify/prune event and one opacity reset, both at 10
PIPE_OPT = dict(densify_from_iter=5, densification_interval=5, opacity_reset_interval=10)
EVENT = 10  # the iteration of that event
MIN_PROMOTED = 0.9  # share of the (exact) matches the init stage must promote
SEGSUM_REL_MAX = 1e-5  # kernel vs plain, per column: index_add_ sums in another order
# sort route vs atomic route, per column group: atomics reorder the latter's sums
ROUTE_REL_MAX = 1e-5
# the command-line path: the LLFF few-shot protocol (BASELINE.md:24-30) on the
# synthetic COLMAP scene, whose views are 1008x756 on disk and 504x378 at -r 2,
# the size LLFF's -r 8 gives; the default schedule (2,000 init and 2,000 main
# iterations, densify from 500 every 100, opacity reset every 200)
CLI_VIEWS = 20  # test = every 8th (3 views), train = 3 of the other 17
CLI_SIZE = (1008, 756)
CLI_RESOLUTION = 2
CLI_GAUSSIANS = 1_000  # ground truth
CLI_POINTS = 2_030  # the sparse cloud: >= 2,000 matches for every ordered training pair
CLI_RING = 1.2  # camera ring radius: a real baseline between the training views
CLI_MIN_MATCHES = 2_000  # per ordered pair (BASELINE.md:29)
CLI_INIT_ITERATIONS = 2_000
CLI_ITERATIONS = 2_000
CLI_TEST_ITERATIONS = (500, 1000, 1500, 2000)
CLI_CHECKPOINT = 1_000
CLI_RESUME_TO = 1_040  # resumed from CLI_CHECKPOINT
CLI_PROFILE = (1_005, 25)  # profile the resumed run's iterations 1,006-1,030
# The init stage's health: the JAX recipe's line is a final loss below 0.1.
# On this scene the loss cannot fall that far: the generator (a copy of the
# JAX package's, file for file) renders with a vertical field of view of
# 0.9 rad but writes cameras.bin with fy = fx, so where two training views
# differ in both x and y no depth fits a match in both axes. So the line is
# held above the floor the scene's geometry leaves: the final loss must be
# below that floor + 0.1, the floor being the loss with every match at its
# best depth on a grid of CLI_FLOOR_SAMPLES depths (`init_loss_floor`); and
# the stage must promote at least 90% of the matches.
CLI_INIT_LOSS_MARGIN = 0.1
CLI_FLOOR_SAMPLES = 2_048
CLI_MIN_PROMOTED = 0.9
DEVICE = "cuda"
KERNELS = ("raster_fwd", "raster_bwd", "segsum")
REPLACES = {"raster_fwd": "scgaussian_tpu/renderer/tile_raster.py:578",
            "raster_bwd": "scgaussian_tpu/renderer/tile_raster.py:685",
            "segsum": "scgaussian_tpu/renderer/tile_raster.py:1052"}
# per library: (kernel, exported occupancy query, its leading arguments)
OCCUPANCY = {"raster_fwd": [("raster_fwd", "raster_fwd_occupancy", ())],
             "raster_bwd": [("raster_bwd", "raster_bwd_occupancy", (0,)),
                            ("raster_bwd_entries", "raster_bwd_occupancy", (1,))],
             "segsum": [("segsum@c=10", "segsum_occupancy", (10,)),
                        ("segsum@c=other", "segsum_occupancy", (0,))]}
# the adversarial cull scene: opacities near 1/255, needle conics up to 1:1000
CULL = (256, 160, 1500)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi(query: str) -> str:
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def cuda_times(fn, reps: int = REPS, setup=None) -> dict:
    """Median/min/max milliseconds of `fn(setup())` (or `fn()` without a
    setup) over `reps` runs after one warm-up, each between two CUDA events;
    the setup runs outside them."""
    def once():
        arg = setup() if setup is not None else None
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg) if setup is not None else fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    once()
    ms = [once() for _ in range(reps)]
    return {"median_ms": statistics.median(ms), "min_ms": min(ms), "max_ms": max(ms),
            "reps": reps}


def host_times(fn, reps: int = REPS) -> dict:
    """Host-clock milliseconds of `fn()` ending in a synchronize."""
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": statistics.median(ms), "min_ms": min(ms), "max_ms": max(ms),
            "reps": reps}


def device_busy(fn, reps: int = REPS, require: bool = True) -> dict:
    """Device busy time and kernel count per call of `fn()`, from
    torch.profiler's kernel events over `reps` calls after one warm-up
    (one stream, so the kernels' times add up to the busy time). Raises if
    the profiler saw no device time, unless `require` is off."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels) / reps
    check(busy_us > 0 or not require, "the profiler saw no device time")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {
        "busy_ms": busy_us / 1e3,
        "kernels_per_call": sum(e.count for e in kernels) / reps,
        "top": [{"kernel": e.key[:80], "ms_per_call": e.self_device_time_total / reps / 1e3,
                 "launches_per_call": e.count / reps} for e in top],
    }


def kernel_device_ms(fn, reps: int = REPS):
    """Device time per call of `fn()` (`device_busy`), or None when the
    profiler saw none in three sessions: it has dropped a whole session's
    events after many sessions in one process."""
    for _ in range(3):
        busy = device_busy(fn, reps, require=False)["busy_ms"]
        if busy > 0:
            return busy
    return None


# ---------------- scenes ----------------

def bench_scene(W: int, H: int, N: int, seed: int, log_scale: tuple):
    """The JAX package's bench scenes (bench.py:55-65, 164-185): Gaussians
    uniform in a box in front of an identity camera, SH degree 3 with
    only the DC band set."""
    rng = np.random.default_rng(seed)
    means = np.stack(
        [rng.uniform(-3, 3, N), rng.uniform(-2, 2, N), rng.uniform(2, 10, N)], -1
    ).astype(np.float32)
    scales = np.exp(rng.uniform(*log_scale, (N, 3))).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    opac = rng.uniform(0.2, 0.9, N).astype(np.float32)
    shs = np.zeros((N, 16, 3), np.float32)
    shs[:, 0] = rng.uniform(-1, 1, (N, 3))
    return dict(means=means, scales=scales, quats=quats, opac=opac, shs=shs)


def cull_scene(W: int, H: int, N: int, seed: int, device) -> ProjectedGaussians:
    """Projected splats that press on the kernels' cull: a third with
    opacity within 1e-6 to 1e-2 above 1/255 (and some just below), the
    rest 0.02-0.99 (a tenth at 0.99); conics with axis ratios up to 1:1000
    at every angle (b of both signs); 2% not positive definite (det <= 0).
    Radii reach 3.4 sigma, past the 1/255 ellipse (3.33 sigma at 0.99), and
    the binning rect is the radius' square, so the cull, not the binning,
    rejects the pixels beyond the ellipse."""
    rng = np.random.default_rng(seed)
    alpha_min = float(np.float32(1.0 / 255.0))
    op = rng.uniform(0.02, 0.99, N)
    edge = rng.random(N) < 1 / 3
    op[edge] = alpha_min * (1 + 10.0 ** rng.uniform(-6, -2, edge.sum()))
    op[rng.random(N) < 0.03] = alpha_min * (1 - 1e-6)
    op[rng.random(N) < 0.1] = 0.99
    s1 = np.exp(rng.uniform(0.5, 3.5, N))  # sigma along the long axis, px
    s2 = s1 / 10.0 ** rng.uniform(0, 3, N)
    th = rng.uniform(-math.pi, math.pi, N)
    c, s = np.cos(th), np.sin(th)
    i1, i2 = 1 / s1**2, 1 / s2**2
    conic = np.stack([c * c * i1 + s * s * i2, c * s * (i1 - i2), s * s * i1 + c * c * i2], -1)
    bad = rng.random(N) < 0.02
    conic[bad, 1] = np.sign(conic[bad, 1] + 1e-30) * np.sqrt(conic[bad, 0] * conic[bad, 2]) * (
        1 + rng.uniform(0, 0.5, bad.sum()))
    radius = np.ceil(3.4 * s1) + 1
    f32 = dict(dtype=torch.float32, device=device)
    mean2d = np.stack([rng.uniform(-20, W + 20, N), rng.uniform(-20, H + 20, N)], -1)
    return ProjectedGaussians(
        mean2d=torch.tensor(mean2d, **f32),
        depth=torch.tensor(rng.uniform(2, 10, N), **f32),
        conic=torch.tensor(conic, **f32),
        color=torch.tensor(rng.uniform(0, 1, (N, 3)), **f32),
        opacity=torch.tensor(op, **f32),
        radius=torch.tensor(radius, dtype=torch.int32, device=device),
        valid=torch.ones(N, dtype=torch.bool, device=device),
        ext=torch.tensor(np.stack([radius, radius], -1), dtype=torch.int32, device=device),
    )


def bench_camera(W, H, device):
    return Camera.create(np.eye(3), np.zeros(3), 0.9, 0.6, W, H, device=device)


def logit(p: np.ndarray) -> np.ndarray:
    return np.log(p / (1.0 - p))


def hybrid_leaves(num_ray: int, num_bg: int, capacity: int, seed: int,
                  surface: bool = False) -> dict:
    """Leaves of a hybrid model: `num_ray` ray Gaussians (origins near the
    world origin, directions inside a 0.9 x 0.6 rad view, depths 2-10, or
    with `surface` on the smooth surface 6 + 1.5 sin(4 ax + 1) cos(5 ay) of
    the ray's angles) and `num_bg` alive background Gaussians in a
    `capacity`-slot buffer, SH degree 3 with every band non-zero. Random,
    from `seed`."""
    rng = np.random.default_rng(seed)
    k = 16
    ang_x = rng.uniform(-0.42, 0.42, num_ray)
    ang_y = rng.uniform(-0.28, 0.28, num_ray)
    rayd = np.stack([np.tan(ang_x), np.tan(ang_y), np.ones(num_ray)], -1)
    rayd /= np.linalg.norm(rayd, axis=-1, keepdims=True)

    def block(n):
        f_dc = rng.uniform(-1.5, 1.5, (n, 1, 3))
        f_rest = rng.normal(size=(n, k - 1, 3)) * 0.1
        return dict(
            f_dc=f_dc, f_rest=f_rest,
            scaling=rng.uniform(-5.5, -4.0, (n, 3)),
            rotation=rng.normal(size=(n, 4)),
            opacity=logit(rng.uniform(0.2, 0.9, (n, 1))),
        )

    fg = block(num_ray)
    bg = block(num_bg)
    if surface:
        zval = (6.0 + 1.5 * np.sin(4.0 * ang_x + 1.0) * np.cos(5.0 * ang_y))[:, None]
    else:
        zval = rng.uniform(2.0, 10.0, (num_ray, 1))
    leaves = dict(
        zval=zval,
        rayo=rng.normal(size=(num_ray, 3)) * 0.01,
        rayd=rayd,
        **fg,
        bg_xyz=np.zeros((capacity, 3)),
        bg_f_dc=np.zeros((capacity, 1, 3)),
        bg_f_rest=np.zeros((capacity, k - 1, 3)),
        bg_scaling=np.full((capacity, 3), -10.0),
        bg_rotation=np.tile([1.0, 0.0, 0.0, 0.0], (capacity, 1)),
        bg_opacity=np.full((capacity, 1), -10.0),
    )
    leaves["bg_xyz"][:num_bg] = np.stack(
        [rng.uniform(-6, 6, num_bg), rng.uniform(-4, 4, num_bg), rng.uniform(8, 20, num_bg)], -1
    )
    for name in ("f_dc", "f_rest", "scaling", "rotation", "opacity"):
        leaves["bg_" + name][:num_bg] = bg[name]
    leaves = {n: np.asarray(v, np.float32) for n, v in leaves.items()}
    alive = np.zeros(capacity, bool)
    alive[:num_bg] = True
    leaves["bg_alive"] = alive
    leaves["active_sh_degree"] = np.int32(3)
    return leaves


def bench_model_leaves(scene: dict) -> dict:
    """A bench scene as a model: no ray Gaussians, every Gaussian an alive
    background slot."""
    n = scene["means"].shape[0]
    leaves = dict(
        zval=np.zeros((0, 1)), f_dc=np.zeros((0, 1, 3)), f_rest=np.zeros((0, 15, 3)),
        scaling=np.zeros((0, 3)), rotation=np.zeros((0, 4)), opacity=np.zeros((0, 1)),
        rayo=np.zeros((0, 3)), rayd=np.zeros((0, 3)),
        bg_xyz=scene["means"], bg_f_dc=scene["shs"][:, :1], bg_f_rest=scene["shs"][:, 1:],
        bg_scaling=np.log(scene["scales"]), bg_rotation=scene["quats"],
        bg_opacity=logit(scene["opac"].astype(np.float64))[:, None],
    )
    leaves = {k: np.asarray(v, np.float32) for k, v in leaves.items()}
    leaves["bg_alive"] = np.ones(n, bool)
    leaves["active_sh_degree"] = np.int32(3)
    return leaves


def view_cameras(W: int, H: int, count: int, device):
    """`count` views around the identity pose: small yaw and sideways steps."""
    cams = []
    for i in range(count):
        yaw = 0.04 * (i - (count - 1) / 2)
        c, s = math.cos(yaw), math.sin(yaw)
        R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        T = np.array([0.05 * i, -0.02 * i, 0.0])
        cams.append(Camera.create(R, T, 0.9, 0.6, W, H, device=device))
    return cams


# ---------------- kernel vs plain ----------------

def project_scene(cam, scene, device):
    t = {k: torch.tensor(v, device=device) for k, v in scene.items()}
    return project(cam, t["means"], t["opac"], scales=t["scales"],
                   rotations=t["quats"], shs=t["shs"], active_sh_degree=3)


def project_model(cam, model):
    return project(cam, model.get_xyz(), model.get_opacity().reshape(-1),
                   scales=model.get_scaling(), rotations=model.get_rotation(),
                   shs=model.get_features(), active_sh_degree=model.max_sh_degree)


def compare_kernel(name, proj, W, H, img_max, depth_max, img_mean=None) -> dict:
    """Kernel vs plain version on the same bins; raises past the limits.
    Image and depth get the stated tolerances; alpha, final T and the last
    contributor must agree to ALPHA_T_MAX and exactly, since the kernel
    rounds the threshold-deciding arithmetic step by step as the plain
    version does. Returns the errors, the evaluated pair count and the
    plain version's other work counts, the bound inputs and the kernel's
    final T and last contributor."""
    bins = bin_gaussians(proj, W, H)
    attrs = raster.pack_attrs(proj)
    bg = torch.tensor([0.1, 0.2, 0.3], device=attrs.device)
    before = raster.LAUNCHES["raster_fwd"]
    k_out = raster.raster_fwd(bins, attrs, bg, W, H)
    stats = {}
    p_out = raster.raster_fwd_plain(bins, attrs, bg, W, H, stats=stats)
    torch.cuda.synchronize()
    raster.LAUNCHES["raster_fwd"] = before  # comparison launches do not count
    err = {}
    for key, a, b in zip(("image", "depth", "alpha", "T"), k_out[:4], p_out[:4]):
        d = (a - b).abs()
        check(bool(torch.isfinite(a).all()), f"{name}: kernel {key} not finite")
        err[f"{key}_max_abs_err"] = float(d.max())
        err[f"{key}_mean_abs_err"] = float(d.mean())
    err["image_pixels_err_gt_1e-4"] = int(((k_out[0] - p_out[0]).abs() > 1e-4).any(0).sum())
    err["last_contributor_mismatches"] = int((k_out[4] != p_out[4]).sum())
    emit("kernel_vs_plain", scene=name, width=W, height=H, gaussians=proj.depth.shape[0],
         entries=bins.num_entries, **stats, **err)
    check(err["image_max_abs_err"] < img_max,
          f"{name}: image max err {err['image_max_abs_err']} >= {img_max}")
    check(err["depth_max_abs_err"] < depth_max,
          f"{name}: depth max err {err['depth_max_abs_err']} >= {depth_max}")
    if img_mean is not None:
        check(err["image_mean_abs_err"] < img_mean,
              f"{name}: image mean err {err['image_mean_abs_err']} >= {img_mean}")
    for key in ("alpha", "T"):
        check(err[f"{key}_max_abs_err"] < ALPHA_T_MAX,
              f"{name}: {key} max err {err[f'{key}_max_abs_err']} >= {ALPHA_T_MAX}")
    check(err["last_contributor_mismatches"] == 0,
          f"{name}: last contributor differs at {err['last_contributor_mismatches']} pixels")
    return dict(err=err, bins=bins, attrs=attrs, bg=bg, pairs=stats["pairs"], stats=stats,
                T=k_out[3], last=k_out[4])


def kernel_bound_ms(bins, attrs, W, H, pairs) -> tuple:
    """Least time for the kernel's work on an H100 SXM: every input read
    once (tile starts, entry ids, attribute rows, bg) and every output
    written once (rgb, depth, alpha, T: fp32; last contributor: int32), or
    the fp32 operations of the pairs evaluated, whichever is longer."""
    bytes_moved = (
        bins.tile_starts.numel() * 4 + bins.gauss_ids.numel() * 4
        + attrs.numel() * 4 + 3 * 4 + W * H * 7 * 4
    )
    t_bytes = bytes_moved / H100_HBM_BYTES_PER_S * 1e3
    t_ops = pairs * OPS_PER_PAIR / H100_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_cotangents(W: int, H: int, seed: int, device) -> list:
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=shape).astype(np.float32), device=device)
            for shape in ((3, H, W), (H, W), (H, W))]


def group_errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Per column group of d_attrs: max abs error and max |want|."""
    return {name: {"max_abs_err": float((got[:, lo:hi] - want[:, lo:hi]).abs().max()),
                   "max_abs_g": float(want[:, lo:hi].abs().max())}
            for name, (lo, hi) in GRAD_GROUPS.items()}


def check_groups(name: str, errs: dict, rel: float) -> None:
    for group, e in errs.items():
        check(e["max_abs_err"] <= rel * e["max_abs_g"],
              f"{name} {group}: max err {e['max_abs_err']} > {rel} * {e['max_abs_g']}")


def compare_backward(name, cmp: dict, W, H, autograd: bool = False,
                     per_entry: bool = False) -> dict:
    """Backward kernel vs plain version on the forward comparison's bins,
    final T and last contributor, with random cotangents: the atomic
    epilogue (`raster_bwd`), or with `per_entry` the per-entry one
    (`raster_bwd_entries`, rows in Gaussian-major order, launched twice: the
    two must be bitwise equal);
    with `autograd`, also the plain version vs autograd of
    raster_fwd_plain. Raises past the limits. Returns the inputs, the pair
    counts the bound prices (and the warp-entry counts) and the largest
    error."""
    bins, attrs, bg, T, last = cmp["bins"], cmp["attrs"], cmp["bg"], cmp["T"], cmp["last"]
    before = dict(raster.LAUNCHES)
    cots = random_cotangents(W, H, 1, attrs.device)
    kernel, plain = ((raster.raster_bwd_entries, raster.raster_bwd_entries_plain) if per_entry
                     else (raster.raster_bwd, raster.raster_bwd_plain))
    k = kernel(bins, attrs, bg, T, last, *cots, W, H)
    again = kernel(bins, attrs, bg, T, last, *cots, W, H) if per_entry else k
    counts = {}
    p = plain(bins, attrs, bg, T, last, *cots, W, H, stats=counts)
    torch.cuda.synchronize()
    raster.LAUNCHES.update(before)  # comparison launches do not count
    check(bool(torch.isfinite(k).all()), f"{name}: backward kernel gradients not finite")
    check(per_entry or float(k[:, 10:].abs().max()) == 0.0, f"{name}: padding columns not zero")
    errs = group_errors(k, p)
    out = {"kernel_vs_plain": errs}
    if autograd:
        a = attrs.detach().requires_grad_()
        with torch.enable_grad():
            color, depth, alpha, _, _ = raster.raster_fwd_plain(bins, a, bg, W, H)
            loss = (color * cots[0]).sum() + (depth * cots[1]).sum() + (alpha * cots[2]).sum()
            (want,) = torch.autograd.grad(loss, a)
        out["plain_vs_autograd"] = group_errors(p, want)
    check(sum(counts[k] for k in PAIR_KINDS) == int(last.sum()), f"{name}: pair counts {counts}")
    emit("backward_vs_plain", scene=name, width=W, height=H, entries=bins.num_entries,
         epilogue="per_entry" if per_entry else "atomic", bitwise_repeat=bool(torch.equal(k, again)),
         **counts, **out)
    check(torch.equal(k, again), f"{name}: two per-entry launches differ")
    check_groups(f"{name} kernel vs plain", errs, BWD_REL_MAX)
    if autograd:
        check_groups(f"{name} plain vs autograd", out["plain_vs_autograd"], AUTOGRAD_REL_MAX)
    return dict(T=T, last=last, cots=cots, counts=counts,
                max_abs_err=max(e["max_abs_err"] for e in errs.values()))


def kernel_bound_ms_bwd(bins, attrs, W, H, counts, per_entry: bool = False) -> tuple:
    """Least time for the backward kernel's work on an H100 SXM: every input
    read once (tile starts, entry ids, attribute rows, bg; per pixel final
    T, last contributor and 5 cotangents), the [N, 12] gradient rows (with
    `per_entry`, the [E, 10] entry rows) written once, or the fp32
    operations of the pairs before each pixel's last contributor (live
    pairs the whole chain, dead ones the liveness test), whichever is
    longer."""
    written = bins.num_entries * 10 * 4 if per_entry else attrs.numel() * 4
    bytes_moved = (
        bins.tile_starts.numel() * 4 + bins.gauss_ids.numel() * 4
        + attrs.numel() * 4 + 3 * 4 + W * H * 7 * 4 + written
    )
    t_bytes = bytes_moved / H100_HBM_BYTES_PER_S * 1e3
    ops = (counts["live_pairs"] * OPS_LIVE_BWD + counts["faint_pairs"] * OPS_FAINT_BWD
           + counts["far_pairs"] * OPS_FAR_BWD)
    t_ops = ops / H100_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------- segment sum and the route by sort ----------------

def segsum_layouts(seed: int = 3, cols: int = 10) -> dict:
    """The four adversarial key layouts of tests/test_tile_raster.py:497-552
    over 4 x 1,024 rows, keys below 2,200 and the sentinel 2,200: a run over
    three whole blocks; dense runs crossing blocks with a sentinel suffix;
    sparse keys with jumps; one key per block. Values are normal, NaN on the
    sentinel rows. Returns name -> (keys int32 [E], vals float32 [E, cols], n)."""
    rng = np.random.default_rng(seed)
    n, B = 2200, 1024
    L = 4 * B
    k = np.sort(rng.integers(0, 900, 3 * B + 17))
    base = np.sort(rng.choice(np.arange(0, B + 192 - 8, 13), 40, replace=False))
    layouts = {
        "deep_run": np.sort(np.concatenate([np.full(B // 2, 7), np.full(2 * B + B // 2, 8),
                                            np.full(B, n)])),
        "dense_suffix": np.concatenate([k, np.full(L - k.size, n)]),
        "sparse_jumps": np.sort(np.concatenate([rng.choice(base, 2 * B), base + 960,
                                                np.full(L - 2 * B - base.size, n)])),
        "one_key_per_block": np.repeat(np.asarray([3, 3, 1700, n]), B),
    }
    out = {}
    for name, keys in layouts.items():
        vals = rng.normal(size=(L, cols)).astype(np.float32)
        vals[keys == n] = np.nan
        out[name] = (keys.astype(np.int32), vals, n)
    return out


def compare_segsum(name: str, keys: torch.Tensor, vals: torch.Tensor, n: int) -> dict:
    """segsum kernel's keys form vs segsum_plain on the same input: per
    column, max abs error <= SEGSUM_REL_MAX * (max |plain| + 1); two
    launches bitwise equal. Raises otherwise. Comparison launches do not
    count."""
    before = dict(raster.LAUNCHES)
    a = raster.segsum(keys, vals, n)
    b = raster.segsum(keys, vals, n)
    p = raster.segsum_plain(keys, vals, n)
    torch.cuda.synchronize()
    raster.LAUNCHES.update(before)
    check(bool(torch.isfinite(a).all()), f"segsum {name}: not finite")
    col_err = (a - p).abs().amax(0)
    col_max = p.abs().amax(0)
    out = {"max_abs_err": float(col_err.max()),
           "max_rel_err": float((col_err / (col_max + 1)).max()),
           "bitwise_repeat": bool(torch.equal(a, b))}
    emit("segsum_vs_plain", case=name, rows=int(keys.shape[0]), keys=n, **out)
    check(bool((col_err <= SEGSUM_REL_MAX * (col_max + 1)).all()),
          f"segsum {name}: errors {col_err.tolist()} vs max {col_max.tolist()}")
    check(out["bitwise_repeat"], f"segsum {name}: two launches differ")
    return out


def compare_route(name: str, bins, d_gmaj: torch.Tensor, n: int) -> dict:
    """The segment-sum kernel's route form (`route_by_sort`: the runs
    `gmaj_starts` of the per-entry rows in Gaussian-major order) vs its plain
    version `segsum_runs_plain`: per column, max abs error <= SEGSUM_REL_MAX
    * (max |plain| + 1); padding columns zero; two launches bitwise equal,
    one launch each. Raises otherwise. Comparison launches do not count."""
    before = dict(raster.LAUNCHES)
    a = raster.route_by_sort(bins, d_gmaj, n)
    b = raster.route_by_sort(bins, d_gmaj, n)
    torch.cuda.synchronize()
    launched = raster.LAUNCHES["segsum"] - before["segsum"]
    raster.LAUNCHES.update(before)
    p = raster.segsum_runs_plain(bins.gmaj_starts, d_gmaj, n, raster.ATTR_WIDTH)
    check(launched == 2, f"route {name}: {launched} segsum launches for 2 routes")
    check(bool(torch.isfinite(a).all()), f"route {name}: not finite")
    col_err = (a - p).abs().amax(0)
    col_max = p.abs().amax(0)
    runs = bins.gmaj_starts[1:] - bins.gmaj_starts[:-1]
    out = {"max_abs_err": float(col_err.max()),
           "max_rel_err": float((col_err / (col_max + 1)).max()),
           "bitwise_repeat": bool(torch.equal(a, b)),
           "pad_max_abs": float(a[:, raster.NUM_GRADS:].abs().max())}
    emit("route_vs_plain", case=name, entries=bins.num_entries, keys=n,
         longest_run=int(runs.max()), keys_with_entries=int((runs > 0).sum()), **out)
    check(bool((col_err <= SEGSUM_REL_MAX * (col_max + 1)).all()),
          f"route {name}: errors {col_err.tolist()} vs max {col_max.tolist()}")
    check(out["pad_max_abs"] == 0.0, f"route {name}: padding columns not zero")
    check(out["bitwise_repeat"], f"route {name}: two launches differ")
    return out


def segsum_bound_ms(rows: int, cols: int, n: int) -> tuple:
    """Least time for the segment sum's keys form on an H100 SXM: keys and
    rows read once, the [n, cols] sums written once, or its rows * cols
    additions."""
    t_bytes = (rows * (4 + 4 * cols) + n * 4 * cols) / H100_HBM_BYTES_PER_S * 1e3
    t_ops = rows * cols / H100_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def route_bound_ms(entries: int, n: int) -> tuple:
    """Least time for the route by sort's reduction on an H100 SXM: the
    per-entry rows, which the backward stored Gaussian-major, read once
    (entries x 40 B), the run starts read once ((n + 1) x 4 B), the [n, 10]
    sums written once (n x 40 B), or the entries x 10 additions. The
    backward, not the reduction, reads the entry -> slot map."""
    cols = raster.NUM_GRADS
    t_bytes = (entries * 4 * cols + (n + 1) * 4 + n * 4 * cols) / H100_HBM_BYTES_PER_S * 1e3
    t_ops = entries * cols / H100_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def route_grads(bins, attrs, bg, W, H, cots, by_sort: bool) -> torch.Tensor:
    """d_attrs through RasterizeFn (forward, then the backward by the route
    asked for) for the loss sum(color * g_color + depth * g_depth + alpha *
    g_alpha)."""
    a = attrs.detach().clone().requires_grad_()
    with torch.enable_grad():
        color, depth, alpha = raster.RasterizeFn.apply(a, bg, bins, W, H, by_sort)
        loss = (color * cots[0]).sum() + (depth * cots[1]).sum() + (alpha * cots[2]).sum()
        return torch.autograd.grad(loss, a)[0]


def compare_routes(name: str, bins, attrs, bg, W, H, cots) -> dict:
    """RasterizeFn's sort route (per-entry kernel, then the segment-sum
    kernel's route form) vs raster_bwd's atomic route on the same bins and
    cotangents: per column group within ROUTE_REL_MAX * max|g| (atomics
    reorder the latter's sums); two sort-route runs bitwise equal (no
    atomics anywhere on it). Raises otherwise; comparison launches do not
    count."""
    before = dict(raster.LAUNCHES)
    by_sort = route_grads(bins, attrs, bg, W, H, cots, True)
    again = route_grads(bins, attrs, bg, W, H, cots, True)
    with torch.no_grad():
        _, _, _, T, last = raster.raster_fwd(bins, attrs, bg, W, H)
        atomic = raster.raster_bwd(bins, attrs, bg, T, last, *cots, W, H)
    torch.cuda.synchronize()
    launched = {k: raster.LAUNCHES[k] - before[k] for k in raster.LAUNCHES}
    raster.LAUNCHES.update(before)
    check(launched == {"raster_fwd": 3, "raster_bwd": 3, "segsum": 2},
          f"{name}: route comparison launched {launched}")
    check(bool(torch.isfinite(by_sort).all()), f"{name}: sort-route gradients not finite")
    errs = group_errors(by_sort, atomic)
    emit("sort_route_vs_atomic", scene=name, width=W, height=H, gaussians=attrs.shape[0],
         entries=bins.num_entries, bitwise_repeat=bool(torch.equal(by_sort, again)), **errs)
    check_groups(f"{name} sort route vs atomic route", errs, ROUTE_REL_MAX)
    check(bool(torch.equal(by_sort, again)), f"{name}: two sort-route backwards differ")
    return errs


# ---------------- training scene ----------------

def match_bundle_for(gt_model, cams, seed: int, matches: int):
    """Ground truth images (renders of `gt_model`, clipped to [0, 1]) and a
    MatchBundle over every ordered pair of `cams`: `matches` matches per
    pair, placed where ray Gaussians of `gt_model` project inside both
    views. Returns (bundle, gt images [3, H, W] each)."""
    rng = np.random.default_rng(seed)
    W, H = cams[0].width, cams[0].height
    with torch.no_grad():
        gts = [torch.clamp(render_model(c, gt_model, torch.zeros(3, device=c.device)).render,
                           0.0, 1.0) for c in cams]
        norm = []
        for c in cams:
            proj = project_model(c, gt_model)
            uv = (proj.mean2d[: gt_model.num_ray] / torch.tensor([W, H], device=c.device))
            ok = proj.valid[: gt_model.num_ray] & ((uv > 0.02) & (uv < 0.98)).all(1)
            norm.append((uv.cpu().numpy(), ok.cpu().numpy()))
    pixels = {}
    for i in range(len(cams)):
        for j in range(i + 1, len(cams)):
            both = np.flatnonzero(norm[i][1] & norm[j][1])
            check(both.size >= matches, f"only {both.size} ray Gaussians seen by views {i}, {j}")
            pick = rng.choice(both, matches, replace=False)
            pixels[(i, j)] = norm[i][0][pick].astype(np.float32)
            pixels[(j, i)] = norm[j][0][pick].astype(np.float32)
    images = [g.permute(1, 2, 0).cpu().numpy() for g in gts]
    bundle = build_match_bundle(
        images, [c.K.cpu().numpy() for c in cams], [c.world_view.cpu().numpy() for c in cams],
        [np.array([1.0, 25.0], np.float32)] * len(cams), pixels, device=cams[0].device,
    )
    return bundle, gts


# ---------------- phases ----------------

def build_kernels(root: str) -> None:
    """One nvcc per source, all started together; then each kernel's
    resident blocks per SM, from the occupancy query its source exports."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    seconds = time.perf_counter() - t0
    for name, lib_path in libs.items():
        ptxas = lib_path.with_suffix(".log").read_text().strip().splitlines()
        blocks = {}
        for entry, query, args in OCCUPANCY[name]:
            fn = getattr(_build.load(name), query)
            fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
            n = ctypes.c_int(0)
            err = fn(*args, ctypes.byref(n))
            check(err == 0, f"{query}{args}: CUDA error {err}")
            blocks[entry] = n.value
        emit("build", kernel=name, seconds=seconds, library=os.path.relpath(lib_path, root),
             ptxas=[ln for ln in ptxas if "registers" in ln or "spill" in ln or "smem" in ln],
             resident_blocks_per_sm=blocks)


def serving_phases(dev, root) -> dict:
    """Kernel-vs-plain checks of both kernels, the tile path vs the dense
    oracle, and the serving main path (5 views from a PLY-loaded model)."""
    W, H, _ = PARITY
    parity = bench_scene(*PARITY, 42, (-5.0, -3.5))
    cam_p = bench_camera(W, H, dev)
    proj_p = project_scene(cam_p, parity, dev)
    parity_cmp = compare_kernel("parity", proj_p, W, H, img_max=1e-3, depth_max=1e-2)
    compare_backward("parity", parity_cmp, W, H, autograd=True)
    Wc, Hc, Nc = CULL
    cull_cmp = compare_kernel("cull_adversarial", cull_scene(Wc, Hc, Nc, 5, dev), Wc, Hc,
                              img_max=1e-3, depth_max=1e-2)
    for per_entry in (False, True):
        compare_backward("cull_adversarial", cull_cmp, Wc, Hc, per_entry=per_entry)
    bg0 = torch.zeros(3, device=dev)
    t = {k: torch.tensor(v, device=dev) for k, v in parity.items()}
    tile_out = render(cam_p, t["means"], t["opac"], bg0, scales=t["scales"],
                      rotations=t["quats"], shs=t["shs"], active_sh_degree=3)
    o_img, o_dep, o_alp = composite_dense(proj_p, W, H, bg0)
    errs = {
        "image_max_abs_err": float((tile_out.render - o_img).abs().max()),
        "depth_max_abs_err": float((tile_out.rendered_depth - o_dep).abs().max()),
        "alpha_max_abs_err": float((tile_out.rendered_alpha - o_alp).abs().max()),
    }
    emit("tile_path_vs_oracle", scene="parity", **errs)
    check(errs["image_max_abs_err"] < 1e-3, f"tile path vs oracle image: {errs}")
    check(errs["depth_max_abs_err"] < 1e-2, f"tile path vs oracle depth: {errs}")
    check(errs["alpha_max_abs_err"] < 1e-3, f"tile path vs oracle alpha: {errs}")

    W1, H1, _ = FULL
    scene_1080 = bench_scene(*FULL, 0, (-5.5, -4.0))
    cam_1080 = bench_camera(W1, H1, dev)
    proj_1080 = project_scene(cam_1080, scene_1080, dev)
    bench_cmp = compare_kernel("bench_full", proj_1080, W1, H1,
                               img_max=1e-2, depth_max=1e-1, img_mean=1e-6)

    # main path: hybrid model -> PLY -> load_ply -> render_model x 5 views
    num_ray, num_bg, capacity = HYBRID
    leaves = hybrid_leaves(num_ray, num_bg, capacity, seed=7)
    src_model = model_from_numpy(leaves, 3, device=dev)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        ply_path = os.path.join(tmp, "point_cloud", "point_cloud.ply")
        save_ply(src_model, ply_path)
        model = load_ply(ply_path, 3, bg_capacity=capacity, device=dev)
    check(model.num_ray == num_ray and int(model.bg_alive.sum()) == num_bg,
          "PLY round trip changed the model's size")
    for name in ("zval", "f_rest", "bg_xyz", "bg_f_rest", "bg_opacity"):
        check(torch.equal(getattr(model, name), getattr(src_model, name)),
              f"PLY round trip changed {name}")
    cams = view_cameras(W1, H1, VIEWS, dev)
    bg = torch.tensor([0.0, 0.0, 0.0], device=dev)
    raster.LAUNCHES.update(dict.fromkeys(raster.LAUNCHES, 0))
    outs = [render_model(cam, model, bg, raster=RasterizerConfig()) for cam in cams]
    torch.cuda.synchronize()
    launches = dict(raster.LAUNCHES)
    for i, out in enumerate(outs):
        check(tuple(out.render.shape) == (3, H1, W1), f"view {i}: image shape")
        check(tuple(out.rendered_depth.shape) == (1, H1, W1), f"view {i}: depth shape")
        for key in ("render", "rendered_depth", "rendered_alpha"):
            check(bool(torch.isfinite(getattr(out, key)).all()), f"view {i}: {key} not finite")
        alpha = out.rendered_alpha
        check(bool((alpha >= 0).all() and (alpha <= 1).all()), f"view {i}: alpha outside [0, 1]")
        check(float(alpha.mean()) > 0.05, f"view {i}: almost nothing rendered")
    check(launches == {"raster_fwd": VIEWS, "raster_bwd": 0, "segsum": 0},
          f"serving launched {launches} for {VIEWS} views")
    emit("main_path", views=len(outs), width=W1, height=H1, gaussians=model.total,
         alive=model.num_ray + int(model.bg_alive.sum()), launches=launches,
         mean_alpha=[float(o.rendered_alpha.mean()) for o in outs],
         visible=[int(o.visibility_filter.sum()) for o in outs])

    # both kernels at the main path's shapes (view 0), against their plain versions
    proj_main = project_model(cams[0], model)
    main_cmp = compare_kernel("main_path_view0", proj_main, W1, H1,
                              img_max=1e-2, depth_max=1e-1, img_mean=1e-6)
    main_bwd = compare_backward("main_path_view0", main_cmp, W1, H1)
    compare_routes("main_path_view0", main_cmp["bins"], main_cmp["attrs"], main_cmp["bg"],
                   W1, H1, main_bwd["cots"])

    # forward kernel timing (CUDA events, median of REPS after a warm-up)
    bins, attrs, kbg = main_cmp["bins"], main_cmp["attrs"], main_cmp["bg"]
    kernel_t = cuda_times(lambda: raster.raster_fwd(bins, attrs, kbg, W1, H1))
    plain_t = cuda_times(lambda: raster.raster_fwd_plain(bins, attrs, kbg, W1, H1))
    bbins, battrs, bbg = bench_cmp["bins"], bench_cmp["attrs"], bench_cmp["bg"]
    bench_kernel_t = cuda_times(lambda: raster.raster_fwd(bbins, battrs, bbg, W1, H1))
    bench_plain_t = cuda_times(lambda: raster.raster_fwd_plain(bbins, battrs, bbg, W1, H1))
    bound, bound_by = kernel_bound_ms(bins, attrs, W1, H1, main_cmp["pairs"])
    bench_bound, bench_bound_by = kernel_bound_ms(bbins, battrs, W1, H1, bench_cmp["pairs"])
    emit("kernel_time", kernel="raster_fwd", scene="main_path_view0", kernel_ms=kernel_t,
         plain=plain_t, bound_ms=bound, bound_by=bound_by, entries=bins.num_entries,
         **main_cmp["stats"])
    emit("kernel_time", kernel="raster_fwd", scene="bench_full", kernel_ms=bench_kernel_t,
         plain=bench_plain_t, bound_ms=bench_bound, bound_by=bench_bound_by,
         entries=bbins.num_entries, **bench_cmp["stats"])

    # backward kernel timing on the same bins with the comparison's cotangents
    T, last, cots = main_bwd["T"], main_bwd["last"], main_bwd["cots"]
    bwd_t = cuda_times(lambda: raster.raster_bwd(bins, attrs, kbg, T, last, *cots, W1, H1))
    bwd_plain_t = cuda_times(
        lambda: raster.raster_bwd_plain(bins, attrs, kbg, T, last, *cots, W1, H1))
    bwd_bound, bwd_bound_by = kernel_bound_ms_bwd(bins, attrs, W1, H1, main_bwd["counts"])
    emit("kernel_time", kernel="raster_bwd", scene="main_path_view0", kernel_ms=bwd_t,
         plain=bwd_plain_t, bound_ms=bwd_bound, bound_by=bwd_bound_by,
         entries=bins.num_entries, **main_bwd["counts"])
    raster.LAUNCHES.update(launches)  # timing launches do not count

    render_breakdown("main_path_hybrid", cams[0], model, bg)
    return {
        "serving_launches": launches,
        "raster_fwd": dict(max_abs_err=max(main_cmp["err"][f"{k}_max_abs_err"]
                                           for k in ("image", "depth", "alpha", "T")),
                           ms=kernel_t["median_ms"], plain_ms=plain_t["median_ms"],
                           bound_ms=bound, bound_by=bound_by),
        "raster_bwd": dict(max_abs_err=main_bwd["max_abs_err"], ms=bwd_t["median_ms"],
                           plain_ms=bwd_plain_t["median_ms"], bound_ms=bwd_bound,
                           bound_by=bwd_bound_by),
        "raster_bwd_times": bwd_t,
    }


def render_breakdown(name, cam, mdl, bg) -> None:
    W_, H_ = cam.width, cam.height
    before = dict(raster.LAUNCHES)
    proj = project_model(cam, mdl)
    b = bin_gaussians(proj, W_, H_)
    a = raster.pack_attrs(proj)
    stages = {
        "project": cuda_times(lambda: project_model(cam, mdl)),
        "bin": cuda_times(lambda: bin_gaussians(proj, W_, H_)),
        "pack_attrs": cuda_times(lambda: raster.pack_attrs(proj)),
        "kernel": cuda_times(lambda: raster.raster_fwd(b, a, bg, W_, H_)),
        "render_model": cuda_times(lambda: render_model(cam, mdl, bg)),
    }
    host = host_times(lambda: render_model(cam, mdl, bg))
    busy = device_busy(lambda: render_model(cam, mdl, bg))
    raster.LAUNCHES.update(before)  # timing launches do not count
    emit("render_time", scene=name, width=W_, height=H_, gaussians=mdl.total,
         entries=b.num_entries, stages=stages, render_model_host_ms=host,
         device=busy, device_idle_share=max(0.0, 1.0 - busy["busy_ms"] / host["median_ms"]),
         peak_mem_bytes=torch.cuda.max_memory_allocated())


def training_phase(dev, bwd_kernel_t: dict) -> dict:
    """The training main path: TRAIN_STEPS train_steps at 1080p on the
    hybrid model, cycling through TRAIN_VIEWS views, then the step's stage
    times (`bwd_kernel_t`: the backward kernel's, timed in serving_phases).
    Raises on any failed check; returns the launches of the counted run."""
    W1, H1, _ = FULL
    num_ray, num_bg, capacity = HYBRID
    leaves = hybrid_leaves(num_ray, num_bg, capacity, seed=7)
    rng = np.random.default_rng(8)
    gt_leaves = dict(leaves, zval=(leaves["zval"] * (1.0 + 0.05 * rng.uniform(
        -1.0, 1.0, leaves["zval"].shape))).astype(np.float32))
    model = model_from_numpy(leaves, 3, device=dev)
    gt_model = model_from_numpy(gt_leaves, 3, device=dev)
    cams = view_cameras(W1, H1, TRAIN_VIEWS, dev)
    bundle, gts = match_bundle_for(gt_model, cams, seed=9, matches=MATCHES)
    del gt_model
    check(bundle.num_pairs == TRAIN_VIEWS * (TRAIN_VIEWS - 1)
          and bundle.matches_per_pair == MATCHES, "match bundle shape")
    bg = torch.zeros(3, device=dev)
    cfg, extras = OptimizationConfig(), TrainExtras()

    def view_loss(v):
        fn = make_camera_loss(model, bundle, cams[v], gts[v], v, bg, cfg, RasterizerConfig(),
                              extras, "cuda", False)
        with torch.no_grad():
            return float(fn(torch.zeros(model.total, 2, device=dev))[0])

    loss_before = view_loss(0)
    params_before = {n: getattr(model, n).detach().clone() for n in PARAM_NAMES}
    state = optim.init({n: getattr(model, n) for n in PARAM_NAMES})
    raster.LAUNCHES.update(dict.fromkeys(raster.LAUNCHES, 0))
    metrics = []
    for it in range(1, TRAIN_STEPS + 1):
        v = (it - 1) % TRAIN_VIEWS
        model, state, m = train_step(model, state, bundle, cams[v], gts[v], v, it, bg, cfg)
        metrics.append(m)
    torch.cuda.synchronize()
    launches = dict(raster.LAUNCHES)
    loss_after = view_loss(0)

    check(launches == {"raster_fwd": TRAIN_STEPS, "raster_bwd": TRAIN_STEPS, "segsum": 0},
          f"training launched {launches} in {TRAIN_STEPS} steps")
    for it, m in enumerate(metrics, 1):
        for key in ("loss", "l1", "match_loss"):
            check(bool(torch.isfinite(getattr(m, key))), f"step {it}: {key} not finite")
    check(state.count == TRAIN_STEPS, f"Adam count {state.count}")
    changed = {}
    for n in PARAM_NAMES:
        check(bool(torch.isfinite(state.m[n]).all() and torch.isfinite(state.v[n]).all()),
              f"{n}: a gradient was not finite")
        moved = not torch.equal(getattr(model, n).detach(), params_before[n])
        has_grad = float(state.m[n].abs().max()) > 0
        changed[n] = moved
        check(moved or not has_grad, f"{n} has a gradient and did not change")
    visible = sum(int(m.num_visible) for m in metrics)
    check(float(model.denom.sum()) == visible and visible > 0,
          f"denom grew by {float(model.denom.sum())}, {visible} visible")
    check(loss_after < loss_before, f"view-0 loss {loss_before} -> {loss_after}")
    emit("train_path", steps=TRAIN_STEPS, width=W1, height=H1, gaussians=model.total,
         views=TRAIN_VIEWS, pairs=bundle.num_pairs, matches_per_pair=MATCHES,
         launches=launches, adam_count=state.count,
         loss=[float(m.loss) for m in metrics], l1=[float(m.l1) for m in metrics],
         match_loss=[float(m.match_loss) for m in metrics],
         num_visible=[int(m.num_visible) for m in metrics],
         view0_loss_before=loss_before, view0_loss_after=loss_after,
         leaves_changed=changed, xyz_gradient_accum_sum=float(model.xyz_gradient_accum.sum()))

    # timed once, in the kernel_time phase at the serving path's view 0
    train_breakdown("main_path_hybrid", model, state, bundle, cams[0], gts[0], bg, cfg, extras,
                    {"backward_kernel": dict(bwd_kernel_t, scene="main_path_view0")})
    raster.LAUNCHES.update(launches)  # timing launches do not count
    return launches


def train_breakdown(name, model, state, bundle, cam, gt, bg, cfg, extras, kernel_rows) -> None:
    """Stage times of one training step on view 0 (CUDA events; the
    backward's kernel rows `kernel_rows` are timed by the caller), the
    whole step by events and host clock, the device's busy time per step
    from the profiler, and peak memory. Keeps stepping the model
    (iterations from 100 on)."""
    W, H = cam.width, cam.height
    torch.cuda.reset_peak_memory_stats()
    dev = bg.device
    leaves = [getattr(model, n) for n in PARAM_NAMES]
    loss_fn = make_camera_loss(model, bundle, cam, gt, 0, bg, cfg, RasterizerConfig(),
                               extras, "cuda", False)

    def offset():
        return torch.zeros(model.total, 2, device=dev, requires_grad=True)

    with torch.no_grad():
        proj = project_model(cam, model)
        bins = bin_gaussians(proj, W, H)
        attrs = raster.pack_attrs(proj)
        out = render_model(cam, model, bg)
    render_img = out.render.detach().requires_grad_()
    depth_img = out.rendered_depth.detach().requires_grad_()

    def loss_only(img, dep):
        ll1 = l1_loss(img, gt)
        loss = (1.0 - cfg.lambda_dssim) * ll1 + cfg.lambda_dssim * (1.0 - ssim(img, gt))
        return loss + extras.render_match_loss_weight * matchloss_from_renderdepth(bundle, 0, dep)

    def graph():
        off = offset()
        return loss_fn(off)[0], off

    def backward(arg):
        loss, off = arg
        return torch.autograd.grad(loss, leaves + [off], allow_unused=True)

    g_all = backward(graph())
    grads = dict(zip(PARAM_NAMES, g_all[:-1]))
    it = iter(range(100, 10_000))
    stages = {
        "project": cuda_times(lambda: project_model(cam, model)),
        "bin": cuda_times(lambda: bin_gaussians(proj, W, H)),
        "forward_kernel": cuda_times(lambda: raster.raster_fwd(bins, attrs, bg, W, H)),
        "loss": cuda_times(lambda: loss_only(render_img, depth_img)),
        "forward_whole": cuda_times(lambda: loss_fn(offset())),
        "backward_autograd": cuda_times(backward, setup=graph),
        **kernel_rows,
        "adam": cuda_times(lambda: apply_update(model, state, grads, next(it), cfg)),
        "stats": cuda_times(lambda: update_stats(model, out.radii, g_all[-1], W, H)),
    }

    def step():
        train_step(model, state, bundle, cam, gt, 0, next(it), bg, cfg)

    whole = cuda_times(step)
    host = host_times(step)
    busy = device_busy(step)
    emit("train_time", scene=name, width=W, height=H, gaussians=model.total,
         entries=bins.num_entries, stages=stages, train_step=whole, train_step_host_ms=host,
         device=busy, device_idle_share=max(0.0, 1.0 - busy["busy_ms"] / host["median_ms"]),
         peak_mem_bytes=torch.cuda.max_memory_allocated())


def nerfpp_radius(cams) -> float:
    """The reference's cameras_extent (`getNerfppNorm`): 1.1 x the largest
    distance of a camera centre from their mean."""
    centers = np.stack([c.cam_center.cpu().numpy() for c in cams])
    return 1.1 * float(np.linalg.norm(centers - centers.mean(0), axis=1).max())


def pipeline_phase(dev) -> dict:
    """Two-stage training at 3840x2160: the ground-truth scene and exact
    matches, `setup_from_matches`, then PIPE_STEPS iterations of
    `run_main_stage` with its launch counts checked; then, outside the
    counted run, the sort route against the atomic one and the segment-sum
    kernel against its plain version at view 0, the kernel and stage times
    of one step, and the pipeline's one-off costs. Raises on any failed
    check; returns the counted launches and the segment sum's numbers."""
    W, H = PIPE_SIZE
    num_ray, num_bg, capacity = PIPE_GT
    # matches lie on the scene's surfaces, as in a capture
    gt_model = model_from_numpy(hybrid_leaves(num_ray, num_bg, capacity, seed=11, surface=True),
                                3, device=dev)
    cams = view_cameras(W, H, TRAIN_VIEWS, dev)
    bundle, gts = match_bundle_for(gt_model, cams, seed=12, matches=PIPE_MATCHES)
    del gt_model
    num_matches = int(bundle.pad_valid.sum())
    check(num_matches == bundle.num_pairs * PIPE_MATCHES, f"{num_matches} matches")
    extras = TrainExtras(bg_capacity=PIPE_BG_CAPACITY)
    cfg = OptimizationConfig(**PIPE_OPT)
    extent = nerfpp_radius(cams)
    bg = torch.zeros(3, device=dev)

    # stage 1: init stage -> promote -> create_model
    z0 = init_zvals(bundle, torch.Generator(device=dev).manual_seed(13))
    with torch.no_grad():
        init_first = float(extras.init_loss_scale * matchloss_from_base(z0, bundle)[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, init = setup_from_matches(bundle, None, 3, extent, extras=extras,
                                     init_iterations=PIPE_INIT_ITERS, z0=z0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    promoted = model.num_ray / num_matches
    emit("pipeline_setup", width=W, height=H, matches=num_matches,
         init_iterations=PIPE_INIT_ITERS, init_loss_first=init_first,
         init_loss_final=float(init.final_loss), promoted=model.num_ray,
         promoted_share=promoted, slots=model.total, bg_capacity=model.bg_capacity,
         cameras_extent=extent, setup_host_s=setup_s,
         sort_route=raster.sort_route(model.total, W, H, RasterizerConfig()))
    check(init.final_loss < init_first, f"init loss {init_first} -> {float(init.final_loss)}")
    check(promoted >= MIN_PROMOTED, f"only {model.num_ray} of {num_matches} matches promoted")
    check(model.total > PIPE_MIN_SLOTS and raster.sort_route(model.total, W, H, RasterizerConfig()),
          f"{model.total} slots do not take the sort route")

    def view_loss(mdl, v):
        fn = make_camera_loss(mdl, bundle, cams[v], gts[v], v, bg, cfg, RasterizerConfig(),
                              extras, "cuda", False)
        with torch.no_grad():
            return float(fn(torch.zeros(mdl.total, 2, device=dev))[0])

    loss_before = view_loss(model, 0)

    # stage 2: the counted main-stage run
    log = []

    @torch.no_grad()
    def record(iteration, mdl, metrics, **_):
        log.append(dict(
            iteration=iteration, loss=float(metrics.loss), l1=float(metrics.l1),
            match_loss=float(metrics.match_loss), visible=int(metrics.num_visible),
            slots=mdl.total, bg_alive=int(mdl.bg_alive.sum()),
            max_alive_opacity=float(mdl.get_opacity_raw()[mdl.alive_mask()].max()),
            sort_route=raster.sort_route(mdl.total, W, H, RasterizerConfig())))
        if iteration in (EVENT - 1, EVENT):  # just before and just after the event
            counted = dict(raster.LAUNCHES)
            log[-1]["view0_loss"] = view_loss(mdl, 0)
            raster.LAUNCHES.update(counted)  # measurement launches do not count

    torch.cuda.synchronize()
    raster.LAUNCHES.update(dict.fromkeys(raster.LAUNCHES, 0))
    t0 = time.perf_counter()
    state = run_main_stage(model, bundle, cams, gts, list(range(TRAIN_VIEWS)), stack_seed=14,
                           opt_cfg=cfg, extras=extras, cameras_extent=extent,
                           iterations=PIPE_STEPS, callback=record,
                           generator=torch.Generator(device=dev).manual_seed(15))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(raster.LAUNCHES)
    model = state.model
    loss_after = view_loss(model, 0)
    event, pre = log[EVENT - 1], log[EVENT - 2]
    emit("pipeline_main_stage", steps=PIPE_STEPS, launches=launches, run_host_s=run_s,
         view0_loss_before=loss_before, view0_loss_after=loss_after, log=log,
         adam_count=state.opt_state.count, optimization=PIPE_OPT)
    check(launches == dict.fromkeys(KERNELS, PIPE_STEPS),
          f"the 4K main stage launched {launches} in {PIPE_STEPS} iterations")
    check(all(math.isfinite(r[k]) for r in log for k in ("loss", "l1", "match_loss")),
          "a main-stage loss is not finite")
    check(all(r["sort_route"] for r in log), "an iteration left the sort route")
    check(event["bg_alive"] != pre["bg_alive"] or event["slots"] > pre["slots"],
          f"the densify event changed nothing: {pre} -> {event}")
    check(event["max_alive_opacity"] <= 0.01 + 1e-6,
          f"opacity {event['max_alive_opacity']} after the reset")
    # the opacity reset raises the loss by design (every opacity to <= 0.01),
    # so training is held on each side of it
    check(pre["view0_loss"] < loss_before,
          f"view-0 loss {loss_before} before the run, {pre['view0_loss']} before the event")
    check(loss_after < event["view0_loss"],
          f"view-0 loss {event['view0_loss']} after the reset, {loss_after} after the run")

    # outside the counted run, at view 0: the forward and the per-entry
    # backward against their plain versions (which count the work the bounds
    # price), the sort route against the atomic one, the segment sum's route
    # form and keys form against their plain versions
    before = dict(raster.LAUNCHES)
    cam = cams[0]
    with torch.no_grad():
        proj = project_model(cam, model)
        cmp4 = compare_kernel("pipeline_4k_view0", proj, W, H,
                              img_max=1e-2, depth_max=1e-1, img_mean=1e-6)
        bwd4 = compare_backward("pipeline_4k_view0", cmp4, W, H, per_entry=True)
        bins, attrs, kbg, T, last = (cmp4[k] for k in ("bins", "attrs", "bg", "T", "last"))
        cots = bwd4["cots"]
        compare_routes("pipeline_4k_view0", bins, attrs, kbg, W, H, cots)
        bwd_args = (bins, attrs, kbg, T, last, *cots, W, H)
        d_gmaj = raster.raster_bwd_entries(*bwd_args)  # Gaussian-major, as the main path's
        entries = d_gmaj[bins.order]  # the same rows in the tiles' order
        keys, n = bins.gmaj_ids, attrs.shape[0]
        route = compare_route("pipeline_4k_view0", bins, d_gmaj, n)
        seg = compare_segsum("pipeline_4k_view0", keys, d_gmaj, n)

        # kernel and stage times at view 0: CUDA events around one call (host
        # enqueue included), and for the route's parts the profiler's device
        # time of the kernels each call launches
        t_fwd = cuda_times(lambda: raster.raster_fwd(bins, attrs, kbg, W, H))
        t_entries = cuda_times(lambda: raster.raster_bwd_entries(*bwd_args))
        t_route = cuda_times(lambda: raster.route_by_sort(bins, d_gmaj, n))
        t_route_plain = cuda_times(lambda: raster.segsum_runs_plain(
            bins.gmaj_starts, d_gmaj, n, raster.ATTR_WIDTH))
        t_seg = cuda_times(lambda: raster.segsum(keys, d_gmaj, n))
        t_seg_plain = cuda_times(lambda: raster.segsum_plain(keys, d_gmaj, n))
        t_atomic = cuda_times(lambda: raster.raster_bwd(*bwd_args))
        route_parts = {
            "route": lambda: raster.route_by_sort(bins, d_gmaj, n),
            "reorder": lambda: raster.gaussian_major(bins, entries),
            "keys_form": lambda: raster.segsum(keys, d_gmaj, n),
            "two_step_route": lambda: raster.segsum(keys, raster.gaussian_major(bins, entries), n),
            "index_add_gauss_ids": lambda: torch.zeros(n, raster.NUM_GRADS, device=dev)
            .index_add_(0, bins.gauss_ids, entries),
            "index_add_sorted_keys": lambda: torch.zeros(n, raster.NUM_GRADS, device=dev)
            .index_add_(0, keys, d_gmaj),
            "backward_per_entry": lambda: raster.raster_bwd_entries(*bwd_args),
        }
        parts = {k: dict(events=cuda_times(fn), device_ms=kernel_device_ms(fn))
                 for k, fn in route_parts.items()}
    t_route_lib = parts["index_add_gauss_ids"]["events"]
    t_seg_lib = parts["index_add_sorted_keys"]["events"]
    bounds = {
        "raster_fwd": kernel_bound_ms(bins, attrs, W, H, cmp4["pairs"]),
        "raster_bwd_entries": kernel_bound_ms_bwd(bins, attrs, W, H, bwd4["counts"],
                                                  per_entry=True),
        "raster_bwd": kernel_bound_ms_bwd(bins, attrs, W, H, bwd4["counts"]),
        "segsum": route_bound_ms(bins.num_entries, n),
        "segsum_keys": segsum_bound_ms(keys.shape[0], d_gmaj.shape[1], n),
    }
    times = {"raster_fwd": t_fwd, "raster_bwd_entries": t_entries, "raster_bwd": t_atomic,
             "segsum": t_route, "segsum_keys": t_seg}
    work = {"raster_fwd": cmp4["stats"],
            "raster_bwd_entries": bwd4["counts"],
            "raster_bwd": bwd4["counts"],
            "segsum": dict(form="route", plain=t_route_plain, library_index_add_gauss=t_route_lib),
            "segsum_keys": dict(form="keys", plain=t_seg_plain, library_index_add_sorted=t_seg_lib)}
    for kernel, t in times.items():
        emit("kernel_time", kernel=kernel, scene="pipeline_4k_view0", kernel_ms=t,
             bound_ms=bounds[kernel][0], bound_by=bounds[kernel][1], entries=bins.num_entries,
             gaussians=n, **work[kernel])
    # the route by sort: one launch over the rows the backward stored
    # Gaussian-major, beside the two-step form (reorder, then the keys form)
    # and the library calls
    emit("route_time", scene="pipeline_4k_view0", entries=bins.num_entries, gaussians=n,
         parts=parts, route_bound_ms=bounds["segsum"][0],
         keys_form_bound_ms=bounds["segsum_keys"][0], route=route, keys_form=seg)
    raster.LAUNCHES.update(before)  # comparison and timing launches do not count
    train_breakdown("pipeline_4k", model, state.opt_state, bundle, cam, gts[0], bg, cfg, extras,
                    {"backward_kernel_per_entry": t_entries, "route_by_sort": t_route,
                     "backward_kernel_atomic_same_view": t_atomic})

    # the pipeline's one-off costs
    iters = 50
    init_part = cuda_times(lambda: run_init_stage(bundle, z0, iterations=iters), reps=1)
    rayo, rayd, zval, color = promote_matches(bundle, init.best_z, init.min_err)
    points = torch.as_tensor(rayo + rayd * zval[:, None], device=dev)
    state_opt = state.opt_state

    def clone_model():
        return copy.deepcopy(model)

    one_off = {
        "setup_from_matches_host_s": setup_s,
        "init_stage_ms_per_iteration": {k: v / iters if k != "reps" else v
                                        for k, v in init_part.items()},
        "knn_mean_sq_dist": cuda_times(lambda: knn_mean_sq_dist(points), reps=1),
        "create_model": cuda_times(lambda: create_model(
            rayo, rayd, zval, color, 3, extent, bg_capacity=PIPE_BG_CAPACITY, device=dev), reps=1),
        "densify_and_prune": cuda_times(
            lambda m: densify_and_prune(m, state_opt, cfg.densify_grad_threshold,
                                        extras.prune_min_opacity, extent, None, cfg.percent_dense,
                                        generator=torch.Generator(device=dev).manual_seed(16)),
            reps=3, setup=clone_model),
        "reset_opacity": cuda_times(lambda m: reset_opacity(m, state_opt), reps=3,
                                    setup=clone_model),
        "main_stage_host_s": run_s,
    }
    emit("pipeline_one_off", points=int(points.shape[0]), **one_off)
    raster.LAUNCHES.update(before)
    seg_bound, seg_bound_by = bounds["segsum"]
    return {"launches": launches,
            "per_launch": {k: (times[k]["median_ms"], bounds[k][0]) for k in times},
            "segsum": dict(max_abs_err=max(route["max_abs_err"], seg["max_abs_err"]),
                           ms=t_route["median_ms"], plain_ms=t_route_plain["median_ms"],
                           bound_ms=seg_bound, bound_by=seg_bound_by,
                           library_ms=t_route_lib["median_ms"])}


class CliRecorder:
    """Reads the train CLI's run through its seams, for the time of a
    `with` block: how long the scene load (from `main`'s start to the init
    stage), the init stage (`setup_from_matches`) and the main stage
    (`run_main_stage`) take, the init stage's result, each iteration's
    loss and host time (what `TrainLogger.step` is handed: `StepTimer`
    synchronises the device before it reads the clock) and each
    evaluation, and how long each of `StepTimer`'s device syncs waits (the
    first sync after a step waits for the step's device work to end, where
    the JAX CLI's `float(metrics.loss)` waits). With `profile_from`, it runs the profiler over the
    `profile_iters` iterations after that one and keeps their device busy
    time and host time."""

    def __init__(self, profile_from: int | None = None, profile_iters: int = 0):
        self.profile_from, self.profile_iters = profile_from, profile_iters
        self.steps, self.evals, self.seconds, self.sync_waits = [], [], {}, []
        self.init = self.promoted = None
        self.window = {}

    def __enter__(self):
        self._saved = (pipeline_mod.setup_from_matches, pipeline_mod.run_main_stage,
                       TrainLogger.step, TrainLogger.eval, profiling._sync)
        setup, run, step, evaluate, sync = self._saved
        rec = self
        self.t_main = time.perf_counter()

        def timed_setup(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec.seconds["scene_load"] = t0 - rec.t_main
            model, rec.init = setup(*args, **kwargs)
            rec.promoted = model.num_ray
            torch.cuda.synchronize()
            rec.seconds["init_stage"] = time.perf_counter() - t0
            return model, rec.init

        def timed_run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec.seconds.setdefault("scene_load", t0 - rec.t_main)
            state = run(*args, **kwargs)
            torch.cuda.synchronize()
            rec.seconds["main_stage"] = time.perf_counter() - t0
            return state

        def recorded_step(logger, iteration, l1, total, iter_time):
            rec.steps.append((iteration, total, iter_time))
            if rec.profile_from is not None:
                if iteration == rec.profile_from:
                    rec.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    torch.cuda.synchronize()
                    rec.prof.start()
                    rec.window["t0"] = time.perf_counter()
                elif iteration == rec.profile_from + rec.profile_iters:
                    torch.cuda.synchronize()
                    rec.window["host_s"] = time.perf_counter() - rec.window["t0"]
                    rec.prof.stop()
                    kernels = [e for e in rec.prof.key_averages()
                               if e.device_type == DeviceType.CUDA]
                    rec.window["busy_s"] = sum(e.self_device_time_total for e in kernels) / 1e6
                    rec.window["kernels"] = sum(e.count for e in kernels)
            return step(logger, iteration, l1, total, iter_time)

        def timed_sync():
            t0 = time.perf_counter()
            sync()
            rec.sync_waits.append(time.perf_counter() - t0)

        def recorded_eval(logger, name, l1, psnr, iteration):
            rec.evals.append((name, iteration, l1, psnr))
            return evaluate(logger, name, l1, psnr, iteration)

        pipeline_mod.setup_from_matches, pipeline_mod.run_main_stage = timed_setup, timed_run
        TrainLogger.step, TrainLogger.eval = recorded_step, recorded_eval
        profiling._sync = timed_sync
        return self

    def __exit__(self, *exc):
        (pipeline_mod.setup_from_matches, pipeline_mod.run_main_stage,
         TrainLogger.step, TrainLogger.eval, profiling._sync) = self._saved
        return False


def init_loss_floor(bundle, samples: int) -> float:
    """The init stage's loss with every match at the best of `samples`
    depths, even in inverse depth from half its pair's near to twice its
    far: each match's reprojection error depends on its own depth alone,
    so this is the lowest loss the scene's geometry allows, up to the
    grid's spacing."""
    lo, hi = 1.0 / (2.0 * bundle.near_far[:, 1:2]), 1.0 / (0.5 * bundle.near_far[:, 0:1])
    best = torch.full_like(bundle.mask, float("inf"))
    with torch.no_grad():
        for k in range(samples):
            z = (1.0 / (lo + (hi - lo) * ((k + 0.5) / samples))).expand_as(best)
            best = torch.minimum(best, matchloss_from_base(z, bundle)[1])
        valid = (bundle.mask * bundle.mask[bundle.partner]) > 0
        per_pair = (torch.where(valid, best, 0.0).sum(1)
                    / torch.clamp(valid.sum(1), min=1))
        return float(TrainExtras().init_loss_scale * per_pair.sum())


def ms_summary(seconds: list) -> dict:
    ms = [s * 1e3 for s in seconds]
    return {"median_ms": statistics.median(ms), "min_ms": min(ms), "max_ms": max(ms),
            "n": len(ms)}


def cli_phase(dev, card: str) -> dict:
    """The command-line path, as a user runs it: the synthetic COLMAP scene
    written to disk (`generate_scene`, ground truth rendered on the card),
    the train CLI on it (`-r 2 --eval`, the default 2,000 + 2,000
    iterations, evaluations at 500/1,000/1,500/2,000, a checkpoint at
    1,000), a resumed run from that checkpoint, and the render CLI on the
    trained model; then, outside the counted run, the render CLI's test
    renders against `render_model` on the model `main` returned, and both
    compositing kernels against their plain versions at test view 0
    (504x378, ragged in both axes). Raises on any failed check; returns the
    counted launches and the kernels' per-launch times at that view."""
    W, H = CLI_SIZE[0] // CLI_RESOLUTION, CLI_SIZE[1] // CLI_RESOLUTION
    with tempfile.TemporaryDirectory(prefix="cli_") as tmp:
        scene_dir = os.path.join(tmp, "scene")
        model_dir = os.path.join(tmp, "model")
        resume_dir = os.path.join(tmp, "model_resume")

        # the scene: 20 views, ground truth rendered by the forward kernel
        before = raster.LAUNCHES["raster_fwd"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate_scene(scene_dir, n_views=CLI_VIEWS, n_gaussians=CLI_GAUSSIANS,
                       n_points=CLI_POINTS, width=CLI_SIZE[0], height=CLI_SIZE[1],
                       ring_radius=CLI_RING, device=dev)
        write_s = time.perf_counter() - t0
        check(raster.LAUNCHES["raster_fwd"] - before == CLI_VIEWS,
              f"scene writing: {raster.LAUNCHES['raster_fwd'] - before} forward launches")
        info = read_colmap_scene(scene_dir, "images", True)
        pair_matches = [len(info.match_data[a.image_name][b.image_name])
                        for a in info.train_cameras for b in info.train_cameras if a is not b]
        check(len(info.train_cameras) == 3 and len(info.test_cameras) == 3,
              f"split: {len(info.train_cameras)} train, {len(info.test_cameras)} test")
        check(min(pair_matches) >= CLI_MIN_MATCHES, f"matches per ordered pair {pair_matches}")
        # the init stage's loss at z0, on the bundle the train CLI builds
        # (cameras in the order `Scene` shuffles them to, z0 from --seed 0)
        np.random.default_rng(0).shuffle(info.train_cameras)
        bundle, _ = build_bundle_from_scene(info, dev)
        z0 = init_zvals(bundle, torch.Generator(device=dev).manual_seed(0))
        with torch.no_grad():
            init_first = float(TrainExtras().init_loss_scale * matchloss_from_base(z0, bundle)[0])
        init_floor = init_loss_floor(bundle, CLI_FLOOR_SAMPLES)
        num_matches = int(bundle.pad_valid.sum())
        del bundle, z0

        # the counted run: train, resume, render
        for name in KERNELS:
            raster.LAUNCHES[name] = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        train_args = ["-s", scene_dir, "-r", str(CLI_RESOLUTION), "--eval", "--no_tensorboard",
                      "--device", DEVICE]
        with CliRecorder() as rec:
            state = train_cli.main(train_args + [
                "-m", model_dir, "--init_iterations", str(CLI_INIT_ITERATIONS),
                "--iterations", str(CLI_ITERATIONS),
                "--test_iterations", *map(str, CLI_TEST_ITERATIONS),
                "--checkpoint_iterations", str(CLI_CHECKPOINT)])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # the train CLI's scene load takes the native points3D walker when it builds
        reader = "native" if native.load_library("colmap_fast") is not None else "python"
        with CliRecorder(*CLI_PROFILE) as resumed:
            resumed_state = train_cli.main(train_args + [
                "-m", resume_dir, "--iterations", str(CLI_RESUME_TO),
                "--test_iterations", "-1", "--save_iterations", "-1",
                "--start_checkpoint", os.path.join(model_dir, f"chkpnt{CLI_CHECKPOINT}.npz")])
        render_s = render_cli.main(["-m", model_dir, "--device", DEVICE])
        torch.cuda.synchronize()
        launches = dict(raster.LAUNCHES)

        # the train CLI's artifacts (tests/test_cli_end_to_end.py:46-57), its health
        for rel in (f"point_cloud/iteration_{CLI_ITERATIONS}/point_cloud.ply", "cfg_args.json",
                    f"chkpnt{CLI_CHECKPOINT}.npz", f"chkpnt{CLI_ITERATIONS}.npz",
                    f"init_point_cloud/iteration_{CLI_INIT_ITERATIONS}/point_cloud_matchpoint.ply",
                    "train_log.jsonl", "cameras.json"):
            check(os.path.exists(os.path.join(model_dir, rel)), f"train CLI wrote no {rel}")
        init_loss = float(rec.init.final_loss)
        promoted = rec.promoted / num_matches
        check(promoted >= CLI_MIN_PROMOTED, f"init stage promoted {promoted:.3f} of the matches")
        check(math.isfinite(init_loss) and init_loss < init_floor + CLI_INIT_LOSS_MARGIN,
              f"init stage final loss {init_loss} (must be finite and < the scene's floor "
              f"{init_floor} + {CLI_INIT_LOSS_MARGIN})")
        check(state.iteration == CLI_ITERATIONS, f"train CLI ended at {state.iteration}")
        check([it for it, _, _ in rec.steps] == list(range(1, CLI_ITERATIONS + 1)),
              "train CLI: iterations logged out of order")
        with open(os.path.join(model_dir, "train_log.jsonl")) as f:
            records = [json.loads(line) for line in f]
        logged = [t for _, t, _ in rec.steps] + [r["loss"] for r in records]
        check(all(math.isfinite(x) for x in logged), "train CLI: a logged loss is not finite")
        test_psnr = [(it, p) for name, it, _, p in rec.evals if name == "test"]
        check([it for it, _ in test_psnr] == list(CLI_TEST_ITERATIONS),
              f"test evaluations at {[it for it, _ in test_psnr]}")
        check(test_psnr[-1][1] > test_psnr[0][1], f"test PSNR did not rise: {test_psnr}")
        # the resumed run
        check(resumed_state.iteration == CLI_RESUME_TO,
              f"resumed run ended at {resumed_state.iteration}")
        check([it for it, _, _ in resumed.steps]
              == list(range(CLI_CHECKPOINT + 1, CLI_RESUME_TO + 1)), "resumed iterations")
        check(os.path.exists(os.path.join(resume_dir, f"chkpnt{CLI_RESUME_TO}.npz")),
              "resumed run wrote no final checkpoint")
        # the render CLI's artifacts
        test_dir = os.path.join(model_dir, "test", f"ours_{CLI_ITERATIONS}")
        renders = sorted(os.listdir(os.path.join(test_dir, "renders")))
        check(len(renders) == 3, f"render CLI: {len(renders)} test renders")
        for rel in ("depth/color_00000.png", "depth/00000.png", "error_map/00000.png",
                    "gt/00000.png"):
            check(os.path.exists(os.path.join(test_dir, rel)), f"render CLI wrote no {rel}")
        check(os.path.exists(os.path.join(model_dir, "train", "point_cloud_color.ply")),
              "render CLI wrote no point_cloud_color.ply")

        # launches over the counted run: a forward and a backward per training
        # iteration, a forward per evaluated view (3 test + 3 train views at each
        # evaluation) and per rendered view; the atomic route, so no segment sum
        iters = CLI_ITERATIONS + (CLI_RESUME_TO - CLI_CHECKPOINT)
        rendered = len(CLI_TEST_ITERATIONS) * 6 + 6
        want = {"raster_fwd": iters + rendered, "raster_bwd": iters, "segsum": 0}
        check(launches == want, f"CLI launches {launches}, expected {want}")

        # the render CLI's test renders == 8-bit render_model on main's model
        test_cams = camera_list_from_infos(info.test_cameras, CLI_RESOLUTION, device=dev)
        model = state.model
        zero = torch.zeros(3, device=dev)
        lsb = []
        with torch.no_grad():
            for idx, cam in enumerate(test_cams):
                out = render_model(cam.camera, model, zero)
                want_png = (torch.clamp(out.render, 0, 1).permute(1, 2, 0).cpu().numpy()
                            * 255).astype(np.uint8)
                got = np.asarray(Image.open(os.path.join(test_dir, "renders", f"{idx:05d}.png")))
                check(got.shape == want_png.shape, f"render CLI view {idx}: {got.shape}")
                lsb.append(int(np.abs(got.astype(np.int32) - want_png).max()))
        check(max(lsb) <= 1, f"render CLI renders vs render_model: {lsb} LSB")

        # both kernels at test view 0 with the trained model, against their
        # plain versions, and their times there
        before = dict(raster.LAUNCHES)
        with torch.no_grad():
            proj = project_model(test_cams[0].camera, model)
            cmp = compare_kernel("cli_test_view0", proj, W, H,
                                 img_max=1e-2, depth_max=1e-1, img_mean=1e-6)
            bwd = compare_backward("cli_test_view0", cmp, W, H)
            bins, attrs, kbg, T, last = (cmp[k] for k in ("bins", "attrs", "bg", "T", "last"))
            cots = bwd["cots"]
            def fwd():
                raster.raster_fwd(bins, attrs, kbg, W, H)

            def bwd_atomic():
                raster.raster_bwd(bins, attrs, kbg, T, last, *cots, W, H)

            # device time, or events when the profiler drops its sessions
            fwd_ms = kernel_device_ms(fwd) or cuda_times(fwd)["median_ms"]
            bwd_ms = kernel_device_ms(bwd_atomic) or cuda_times(bwd_atomic)["median_ms"]
        raster.LAUNCHES.update(before)
        fwd_bound = kernel_bound_ms(bins, attrs, W, H, cmp["pairs"])
        bwd_bound = kernel_bound_ms_bwd(bins, attrs, W, H, bwd["counts"])

    host = [dt for _, _, dt in rec.steps]
    window = resumed.window
    check(window.get("busy_s", 0.0) > 0, "the profiler saw no device time in the resumed run")
    busy_ms = window["busy_s"] * 1e3 / CLI_PROFILE[1]
    host_ms = window["host_s"] * 1e3 / CLI_PROFILE[1]
    views = {k: len(v["render"]) for k, v in render_s.items()}
    n_views = sum(views.values())
    evals = {f"{name}@{it}": {"l1": l1, "psnr": p} for name, it, l1, p in rec.evals}
    emit("cli", card=card, width=W, height=H, views_on_disk=list(CLI_SIZE),
         train_views=3, test_views=3, matches_per_pair=pair_matches,
         points3d_reader=reader, scene_write_s=write_s,
         scene_load_s=rec.seconds["scene_load"], init_stage_s=rec.seconds["init_stage"],
         init_loss_first=init_first, init_final_loss=init_loss, init_loss_floor=init_floor, matches=num_matches,
         promoted=rec.promoted, promoted_share=promoted, main_stage_s=rec.seconds["main_stage"], iteration_host=ms_summary(host),
         iteration_host_last_1000=ms_summary(host[-1000:]),
         # StepTimer syncs twice an iteration: at its stop (after the step) and start
         sync_wait_per_iteration=ms_summary([a + b for a, b in zip(rec.sync_waits[1::2],
                                                                   rec.sync_waits[2::2])]),
         slots=state.model.total, alive=state.model.num_ray + int(state.model.bg_alive.sum()),
         ray_gaussians=state.model.num_ray, bg_capacity=state.model.bg_capacity,
         peak_memory_gb=peak_gb, evaluations=evals, launches=launches)
    emit("cli_device", card=card, iterations=CLI_PROFILE[1],
         first_iteration=CLI_PROFILE[0] + 1, busy_ms_per_iteration=busy_ms,
         host_ms_per_iteration_profiled=host_ms, idle_share=1.0 - busy_ms / host_ms,
         kernels_per_iteration=window["kernels"] / CLI_PROFILE[1],
         idle_share_vs_unprofiled_median=1.0 - busy_ms / ms_summary(host)["median_ms"],
         resume_scene_load_s=resumed.seconds["scene_load"],
         resume_main_stage_s=resumed.seconds["main_stage"])
    emit("cli_render", card=card, views=views,
         render_s_per_view={k: v["render"] for k, v in render_s.items()},
         png_s_per_view=sum(v["png"] for v in render_s.values()) / n_views,
         turbo_s_per_view=sum(v["turbo"] for v in render_s.values()) / n_views,
         ply_s=sum(v["ply"] for v in render_s.values()), max_lsb_vs_render_model=lsb)
    for kernel, ms, (bound, by), work in (("raster_fwd", fwd_ms, fwd_bound, cmp["stats"]),
                                          ("raster_bwd", bwd_ms, bwd_bound, bwd["counts"])):
        emit("kernel_time", kernel=kernel, scene="cli_test_view0", kernel_device_ms=ms,
             bound_ms=bound, bound_by=by, entries=bins.num_entries, gaussians=proj.depth.shape[0],
             **work)
    return {"launches": launches,
            "per_launch": {"raster_fwd": (fwd_ms, fwd_bound[0]),
                           "raster_bwd": (bwd_ms, bwd_bound[0])}}


def rank_kernels(serving: dict, train_launches: dict, pipe: dict, cli: dict) -> None:
    """The order in which the kernels lose the most time on the main paths:
    first any kernel slower than its library call (by that factor), then by
    the sum over the paths of launches x (kernel ms - bound ms), each path
    priced at its own shapes: the 1080p main view for serving and the 1080p
    steps, view 0 of the 4K pipeline (per-entry backward, the segment sum's
    route form against `index_add_` by `gauss_ids`) for its 12, test view 0
    of the command-line path (504x378) for its launches."""
    lost = {
        "raster_fwd": (serving["serving_launches"]["raster_fwd"] + train_launches["raster_fwd"])
        * (serving["raster_fwd"]["ms"] - serving["raster_fwd"]["bound_ms"]),
        "raster_bwd": train_launches["raster_bwd"]
        * (serving["raster_bwd"]["ms"] - serving["raster_bwd"]["bound_ms"]),
        "segsum": 0.0,
    }
    for name, per_launch in (("raster_fwd", "raster_fwd"), ("raster_bwd", "raster_bwd_entries"),
                             ("segsum", "segsum")):
        ms, bound = pipe["per_launch"][per_launch]
        lost[name] += pipe["launches"][name] * (ms - bound)
    for name, (ms, bound) in cli["per_launch"].items():
        lost[name] += cli["launches"][name] * (ms - bound)
    seg = pipe["segsum"]
    library_factor = {"segsum": seg["ms"] / seg["library_ms"]}
    def rank(k):
        factor = library_factor.get(k, 0.0)
        return (0, -factor) if factor > 1.0 else (1, -lost[k])

    order = sorted(KERNELS, key=rank)
    emit("rule2_ranking", order=order, lost_ms=lost, library_factor=library_factor)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    dev = torch.device(DEVICE)

    # 1. device
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    emit("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build every kernel from the checkout's sources
    build_kernels(root)

    # 3. the segment-sum kernel on the adversarial key layouts at the route's
    # width (10 columns), and on two of them at the narrowest and the widest
    # width of the kernel's instance for other widths (3 and 16 columns)
    cases = list(segsum_layouts().items())
    for cols in (3, 16):
        layouts = segsum_layouts(cols=cols)
        cases += [(f"{name}@c={cols}", layouts[name]) for name in ("deep_run", "sparse_jumps")]
    for name, (keys, vals, n) in cases:
        compare_segsum(name, torch.tensor(keys, device=dev), torch.tensor(vals, device=dev), n)

    # 4. serving: kernels vs plain, routes, tile path vs oracle, 5 views, timings
    with torch.no_grad():
        serving = serving_phases(dev, root)

    # 5. one training step: 6 steps at 1080p (atomic route), stage times
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train_launches = training_phase(dev, serving["raster_bwd_times"])

    # 6. the dense 4K serving regime
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    W4, H4, _ = DENSE
    with torch.no_grad():
        scene_4k = bench_scene(*DENSE, 0, (-5.5, -4.0))
        model_4k = model_from_numpy(bench_model_leaves(scene_4k), 3, device=dev)
        render_breakdown("bench_dense", bench_camera(W4, H4, dev), model_4k,
                         torch.zeros(3, device=dev))
    del scene_4k, model_4k

    # 7. two-stage training at 4K (sort route), stage and one-off times
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pipe = pipeline_phase(dev)

    # 8. the command-line path: scene on disk -> train CLI -> resume -> render CLI
    torch.cuda.empty_cache()
    cli = cli_phase(dev, card)
    emit("card_state", nvidia_smi=nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))

    rows = {name: dict(serving[name], library_ms=None) for name in ("raster_fwd", "raster_bwd")}
    rows["segsum"] = pipe["segsum"]
    # launches over the four main paths: 5 views, 6 steps at 1080p, 12 at 4K,
    # and the command-line run (2,040 iterations, 30 rendered views)
    launches = {name: serving["serving_launches"][name] + train_launches[name]
                + pipe["launches"][name] + cli["launches"][name] for name in KERNELS}
    rank_kernels(serving, train_launches, pipe, cli)

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"scgaussian_tpu_torch/csrc/{name}.cu",
        "replaces": REPLACES[name],
        "launches": launches[name],
        **{k: rows[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")},
    } for name in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
