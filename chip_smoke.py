#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of `scgaussian_tpu_torch` from the sources in this
checkout (one nvcc per source, started together) and reports each one's
resident blocks per SM, holds each against its plain PyTorch version on the
card (also on a scene built to press on the compositing kernels' cull; the
SSIM kernels at LLFF's 4032x3024, timed beside their plain versions and the
`F.conv2d` route they replaced), then drives the port's paths:

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
- parallelism (`scgaussian_tpu_torch/parallel/`) on the one card: 3
  data-parallel steps over an NCCL group of world size 1 against 3
  `train_step`s on the 1080p model; two processes sharing the card in a
  gloo group (a step of two cameras against the mean of their gradients,
  then 12 `run_main_stage` iterations over the group, replicas bitwise
  equal); 4 tile-row slices at 1920x1080/100k and 3840x2160/500k, one
  after another, against the whole image (the compositing kernels at a
  nonzero tile-row offset against their plain versions); the sharded
  renders over the world-1 group; the train CLI refusing `--data_parallel
  2` on one card;
- the command line: a synthetic COLMAP scene of 20 views at 1008x756
  written to disk, the train CLI on it at `-r 2` (504x378, the size of
  LLFF at `-r 8`) under the LLFF few-shot protocol (3 training views, every
  8th view held out, >= 2,000 matches a pair, 2,000 init + 2,000 main
  iterations), a run resumed from its checkpoint at 1,000, and the render
  CLI; then the kernels against their plain versions at that size;
- evaluation and the remaining tools on that scene and model: the metrics
  CLI (without LPIPS weights, then with seeded random VGG weights; SSIM
  and LPIPS on the card against the CPU), the 180-frame LLFF spiral video,
  the acceptance harness (`--skip_train` on the model, then `--synthetic`
  end to end), the geo check on depths rendered at all 20 views, every
  auxiliary loss on the CLI's renders (values and gradients against the
  CPU), the viewer over a local socket, and the model's health.

It times the kernels, the stages and whole renders and steps with CUDA
events, the host clock and the profiler.

Output: one JSON line per phase; then the card's `nvidia-smi` name and
power limit, the kernel table as one JSON line, and last
`{"ok": true, "device": {...}}`. Any failed check raises (exit code != 0,
no last line). Without a CUDA device, or without the package beside it,
the script fails before printing a result.
"""

from __future__ import annotations

import collections.abc
import contextlib
import copy
import ctypes
import dataclasses
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from PIL import Image
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from scgaussian_tpu_torch import _build
from scgaussian_tpu_torch.apps import acceptance
from scgaussian_tpu_torch.apps import metrics as metrics_cli
from scgaussian_tpu_torch.apps import render as render_cli
from scgaussian_tpu_torch.apps import render_video as video_cli
from scgaussian_tpu_torch.apps import train as train_cli
from scgaussian_tpu_torch import native
from scgaussian_tpu_torch.config import OptimizationConfig, RasterizerConfig, TrainExtras
from scgaussian_tpu_torch.core.cameras import Camera
from scgaussian_tpu_torch.data import readers
from scgaussian_tpu_torch.data.camera_utils import camera_list_from_infos
from scgaussian_tpu_torch.data.pose_utils import gen_poses
from scgaussian_tpu_torch.data.readers import read_colmap_scene
from scgaussian_tpu_torch.data.scene import VideoScene, build_bundle_from_scene
from scgaussian_tpu_torch.data.synthetic import generate_scene
from scgaussian_tpu_torch.data.virtual_poses import get_near_virtual_pose
from scgaussian_tpu_torch.eval import geo_check
from scgaussian_tpu_torch.eval import lpips as lpips_mod
from scgaussian_tpu_torch.eval import metrics as metrics_mod
from scgaussian_tpu_torch.losses import aux, image as image_losses, l1_loss, ssim
from scgaussian_tpu_torch.model.densify import densify_and_prune, reset_opacity, update_stats
from scgaussian_tpu_torch.model.gaussians import PARAM_NAMES, create_model, model_from_numpy
from scgaussian_tpu_torch.model.io import load_ply, save_ply
from scgaussian_tpu_torch.parallel import dp, hosts, primitives, tiles
from scgaussian_tpu_torch.model.knn import knn_mean_sq_dist
from scgaussian_tpu_torch.model.matches import (
    build_match_bundle, bundle_from_numpy, init_zvals, matchloss_from_base, matchloss_from_renderdepth,
    promote_matches, run_init_stage,
)
from scgaussian_tpu_torch.renderer import raster
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
from scgaussian_tpu_torch.utils import debug, profiling
from scgaussian_tpu_torch.utils.logging import TrainLogger
from scgaussian_tpu_torch.viewer import network_gui

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
# SSIM (csrc/ssim.cu) at the size the llff_r1.train cell takes it: LLFF at -r 1
SSIM_SIZE = (4032, 3024)
SSIM_LOSS_REL = 1e-6  # kernel vs plain: fp64 partial sums against torch.mean's fp32 sum
SSIM_GRAD_REL = 1e-5  # of max|g|: separable taps against the 2-D window, another order
# fp32 operations a pixel of the separable form (an FMA two): forward, 5 moments
# x 22 taps x 2, 3 products and ~37 for S and the three maps; backward, 3 maps x
# 22 taps x 2 and ~8 to combine them
SSIM_OPS_FWD = 260
SSIM_OPS_BWD = 140
SSIM_BYTES_FWD = 20  # a pixel: both images read (8), three maps written (12)
SSIM_BYTES_BWD = 24  # a pixel: three maps and both images read (20), the gradient written (4)
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
# the eval phase, on the command-line path's scene and model
EVAL_LPIPS_SEED = 7
EVAL_VIDEO_FRAMES = 180  # the LLFF spiral (data/readers.py:346-348)
# metrics CLI (8-bit PNGs) vs the train CLI's own evaluation at 2,000 (floats)
EVAL_PSNR_MAX_GAP = 0.1  # dB
EVAL_SSIM_MAX = 1e-5  # card vs CPU, absolute
EVAL_LPIPS_REL = 1e-4  # card vs CPU, of max(|cpu|, 1e-3) (tests/test_lpips.py:175)
ACCEPT_MIN_PSNR = 10.0  # acceptance --synthetic, dB
GEO_MASK_AGREE = 0.9999  # share of pixels whose geo_check mask is the same on card and CPU
GEO_DEPTH_REL = 1e-5  # card vs CPU where both keep a pixel
AUX_PATCH = 16  # 504x378 is not whole patches: patchify crops
AUX_CONS_PATCH = 8
AUX_VALUE_REL = 1e-5  # card vs CPU, of max(|cpu|, 1)
AUX_GRAD_REL = 1e-4  # card vs CPU, of max|g| on the CPU
PAR_STEPS = 3  # data-parallel steps over the world-1 group, and train_steps beside them
PAR_LOSS_REL = 1e-6  # DP vs train_step: loss, relative
PAR_LEAF_REL = 1e-5  # DP vs train_step: parameters and Adam moments, of each leaf's max
PAR_FIRM = 1e-3  # parameters are compared where |m| > this share of the leaf's max |m|
PAR_RUN_STEPS = 12  # run_main_stage iterations over the two-process gloo group
PAR_SLICES = 4  # tile-row slices, rendered one after another
PAR_JOIN_S = 240  # the two processes must end within this
DEVICE = "cuda"
KERNELS = ("raster_fwd", "raster_bwd", "segsum")
SSIM_KERNELS = ("ssim_fwd", "ssim_bwd")  # csrc/ssim.cu
COUNTED = KERNELS + SSIM_KERNELS  # every kernel whose launches the script counts
REPLACES = {"raster_fwd": "scgaussian_tpu/renderer/tile_raster.py:578",
            "raster_bwd": "scgaussian_tpu/renderer/tile_raster.py:685",
            "segsum": "scgaussian_tpu/renderer/tile_raster.py:1052"}


class KernelLaunches(collections.abc.MutableMapping):
    """The kernels' launch counters (`profiling.TOTALS["kernel.<name>"]`,
    counted since import by the wrappers in `renderer/raster.py` and
    `losses/image.py`) as a dict by kernel name over `COUNTED`, which this
    script reads, zeroes, saves and restores around every phase."""

    def __getitem__(self, name: str) -> int:
        if name not in COUNTED:
            raise KeyError(name)
        return profiling.TOTALS.get("kernel." + name, 0)

    def __setitem__(self, name: str, value: int) -> None:
        if name not in COUNTED:
            raise KeyError(name)
        profiling.TOTALS["kernel." + name] = value

    def __delitem__(self, name: str) -> None:
        raise TypeError("the kernel counters cannot be removed")

    def __iter__(self):
        return iter(COUNTED)

    def __len__(self) -> int:
        return len(COUNTED)


LAUNCHES = KernelLaunches()


def launches_of(**n: int) -> dict:
    """A launch count over every kernel in `COUNTED`: `n` where given, else 0."""
    return {k: n.get(k, 0) for k in COUNTED}


# per library: (kernel, exported occupancy query, its leading arguments)
OCCUPANCY = {"raster_fwd": [("raster_fwd", "raster_fwd_occupancy", ())],
             "raster_bwd": [("raster_bwd", "raster_bwd_occupancy", (0,)),
                            ("raster_bwd_entries", "raster_bwd_occupancy", (1,))],
             "segsum": [("segsum@c=10", "segsum_occupancy", (10,)),
                        ("segsum@c=other", "segsum_occupancy", (0,))],
             "ssim": [("ssim_fwd", "ssim_occupancy", (0,)),
                      ("ssim_fwd@mask", "ssim_occupancy", (1,)),
                      ("ssim_bwd", "ssim_occupancy", (2,))]}
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


def compare_kernel(name, proj, W, H, img_max, depth_max, img_mean=None, rows=None) -> dict:
    """Kernel vs plain version on the same bins (with `rows` = (row_lo,
    ny_rows), the bins of that tile-row slice); raises past the limits.
    Image and depth get the stated tolerances; alpha, final T and the last
    contributor must agree to ALPHA_T_MAX and exactly, since the kernel
    rounds the threshold-deciding arithmetic step by step as the plain
    version does. Returns the errors, the evaluated pair count and the
    plain version's other work counts, the bound inputs and the kernel's
    final T and last contributor."""
    bins = bin_gaussians(proj, W, H, **({} if rows is None else dict(row_lo=rows[0],
                                                                       ny_rows=rows[1])))
    attrs = raster.pack_attrs(proj)
    bg = torch.tensor([0.1, 0.2, 0.3], device=attrs.device)
    before = LAUNCHES["raster_fwd"]
    k_out = raster.raster_fwd(bins, attrs, bg, W, H)
    stats = {}
    p_out = raster.raster_fwd_plain(bins, attrs, bg, W, H, stats=stats)
    torch.cuda.synchronize()
    LAUNCHES["raster_fwd"] = before  # comparison launches do not count
    err = {}
    for key, a, b in zip(("image", "depth", "alpha", "T"), k_out[:4], p_out[:4]):
        d = (a - b).abs()
        check(bool(torch.isfinite(a).all()), f"{name}: kernel {key} not finite")
        err[f"{key}_max_abs_err"] = float(d.max())
        err[f"{key}_mean_abs_err"] = float(d.mean())
    err["image_pixels_err_gt_1e-4"] = int(((k_out[0] - p_out[0]).abs() > 1e-4).any(0).sum())
    err["last_contributor_mismatches"] = int((k_out[4] != p_out[4]).sum())
    emit("kernel_vs_plain", scene=name, width=W, height=H, gaussians=proj.depth.shape[0],
         entries=bins.num_entries, row_lo=bins.row_lo, ny_rows=bins.ny, **stats, **err)
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
    before = dict(LAUNCHES)
    cots = random_cotangents(W, T.shape[0], 1, attrs.device)  # the bins' slab of rows
    kernel, plain = ((raster.raster_bwd_entries, raster.raster_bwd_entries_plain) if per_entry
                     else (raster.raster_bwd, raster.raster_bwd_plain))
    k = kernel(bins, attrs, bg, T, last, *cots, W, H)
    again = kernel(bins, attrs, bg, T, last, *cots, W, H) if per_entry else k
    counts = {}
    p = plain(bins, attrs, bg, T, last, *cots, W, H, stats=counts)
    torch.cuda.synchronize()
    LAUNCHES.update(before)  # comparison launches do not count
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
         row_lo=bins.row_lo, ny_rows=bins.ny,
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
    before = dict(LAUNCHES)
    a = raster.segsum(keys, vals, n)
    b = raster.segsum(keys, vals, n)
    p = raster.segsum_plain(keys, vals, n)
    torch.cuda.synchronize()
    LAUNCHES.update(before)
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
    before = dict(LAUNCHES)
    a = raster.route_by_sort(bins, d_gmaj, n)
    b = raster.route_by_sort(bins, d_gmaj, n)
    torch.cuda.synchronize()
    launched = LAUNCHES["segsum"] - before["segsum"]
    LAUNCHES.update(before)
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
    before = dict(LAUNCHES)
    by_sort = route_grads(bins, attrs, bg, W, H, cots, True)
    again = route_grads(bins, attrs, bg, W, H, cots, True)
    with torch.no_grad():
        _, _, _, T, last = raster.raster_fwd(bins, attrs, bg, W, H)
        atomic = raster.raster_bwd(bins, attrs, bg, T, last, *cots, W, H)
    torch.cuda.synchronize()
    launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    LAUNCHES.update(before)
    check(launched == launches_of(raster_fwd=3, raster_bwd=3, segsum=2),
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
    sources = (*KERNELS, "ssim")
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(_build.build, sources)))
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


def library_ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """SSIM as the port took it before csrc/ssim.cu: five depthwise 11x11
    `F.conv2d` calls and an elementwise chain, differentiated by autograd
    (three more convolutions in the backward). The yardstick `library_ms`;
    the port never calls it."""
    window = torch.as_tensor(image_losses._gaussian_window(11, 1.5), device=img1.device)

    def conv(x):
        return image_losses._depthwise_conv(x, window, 5)

    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = conv(img1 * img1) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu1_mu2
    c1, c2 = image_losses.C1, image_losses.C2
    return torch.mean(((2 * mu1_mu2 + c1) * (2 * sigma12 + c2))
                      / ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)))


def ssim_phase(dev) -> dict:
    """The SSIM kernels at 4032x3024x3, as the training loss takes them (only
    the render's gradient): the loss and the gradient against the plain
    versions on the card, with a mask too, a bitwise repeat, the launches of
    one loss and its gradient; then the times of the forward (with the maps,
    and under no_grad without them) and the backward by CUDA events and by
    the profiler's device time, beside their byte bounds, the plain
    versions' and the library route's (`library_ssim`). Returns each
    kernel's row of the kernel table."""
    W, H = SSIM_SIZE
    rng = np.random.default_rng(21)
    y_np = rng.uniform(size=(3, H, W)).astype(np.float32)
    x_np = np.clip(y_np + rng.normal(scale=0.1, size=y_np.shape), 0, 1).astype(np.float32)
    x, y = torch.tensor(x_np, device=dev), torch.tensor(y_np, device=dev)
    mask = torch.tensor((rng.uniform(size=(H, W)) > 0.3).astype(np.float32), device=dev)
    n = x.numel()
    one = torch.ones((), device=dev)
    counted = dict(LAUNCHES)

    def kernel(m=None):
        xg = x.clone().requires_grad_(True)
        loss = ssim(xg, y, mask=m)
        (g,) = torch.autograd.grad(loss, xg)
        return loss.detach(), g

    def plain(m=None):
        loss, (a1, _, b, c) = image_losses.ssim_fwd_plain(x, y, m, 11, (True, False))
        return loss, image_losses.ssim_bwd_plain(a1, b, c, x, y, one)

    errs = {}
    for name, m in (("unmasked", None), ("masked", mask)):
        before = dict(LAUNCHES)
        got = kernel(m)
        torch.cuda.synchronize()
        launched = {k: LAUNCHES[k] - before[k] for k in COUNTED}
        check(launched == launches_of(ssim_fwd=1, ssim_bwd=1), f"SSIM launches {launched}")
        want = plain(m)
        loss_rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
        grad_rel = float((got[1] - want[1]).abs().max()) / float(want[1].abs().max())
        check(loss_rel <= SSIM_LOSS_REL, f"SSIM {name} loss vs plain: {loss_rel}")
        check(grad_rel <= SSIM_GRAD_REL, f"SSIM {name} gradient vs plain: {grad_rel} of max|g|")
        again = kernel(m)
        check(all(torch.equal(a, b) for a, b in zip(got, again)), f"SSIM {name}: repeat differs")
        errs[name] = {"loss_rel": loss_rel, "grad_rel_of_max": grad_rel,
                      "loss_abs_err": abs(float(got[0]) - float(want[0])),
                      "grad_max_abs_err": float((got[1] - want[1]).abs().max())}
    del got, want, again

    grads = (True, False)
    _, (a1, _, b, c) = image_losses.ssim_fwd(x, y, None, 11, grads)

    def fwd():
        image_losses.ssim_fwd(x, y, None, 11, grads)

    def fwd_nograd():
        image_losses.ssim_fwd(x, y, None, 11, (False, False))

    def bwd():
        image_losses.ssim_bwd(a1, b, c, x, y, one)

    xl = x.clone().requires_grad_(True)
    lib_loss = library_ssim(xl, y)
    times = {
        "fwd": cuda_times(fwd), "fwd_nograd": cuda_times(fwd_nograd), "bwd": cuda_times(bwd),
        "plain_fwd": cuda_times(lambda: image_losses.ssim_fwd_plain(x, y, None, 11, grads)),
        "plain_bwd": cuda_times(lambda: image_losses.ssim_bwd_plain(a1, b, c, x, y, one)),
        "library_fwd": cuda_times(lambda: library_ssim(xl, y)),
        "library_bwd": cuda_times(lambda: torch.autograd.grad(lib_loss, xl, retain_graph=True)),
    }
    device_ms = {"fwd": kernel_device_ms(fwd), "fwd_nograd": kernel_device_ms(fwd_nograd),
                 "bwd": kernel_device_ms(bwd)}
    del lib_loss

    def peak_mb(loss_fn) -> float:
        """Device memory a loss and its gradient take at their peak, over
        what the inputs hold."""
        xg = x.clone().requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.autograd.grad(loss_fn(xg, y), xg)
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated(dev) - base) / 2**20

    peak = {"kernel_mb": peak_mb(ssim), "library_mb": peak_mb(library_ssim)}
    LAUNCHES.update(counted)  # comparison and timing launches do not count
    bounds = {"ssim_fwd": bound_ms(SSIM_BYTES_FWD * n, SSIM_OPS_FWD * n),
              "ssim_bwd": bound_ms(SSIM_BYTES_BWD * n, SSIM_OPS_BWD * n)}
    rows = {}
    for name, key in (("ssim_fwd", "fwd"), ("ssim_bwd", "bwd")):
        (bound, by) = bounds[name]
        err = "grad_max_abs_err" if key == "bwd" else "loss_abs_err"
        rows[name] = {"max_abs_err": errs["unmasked"][err],
                      "ms": times[key]["median_ms"], "device_ms": device_ms[key],
                      "plain_ms": times[f"plain_{key}"]["median_ms"], "bound_ms": bound,
                      "bound_by": by, "library_ms": times[f"library_{key}"]["median_ms"]}
    emit("ssim", size=[3, H, W], errors=errs, times=times, device_ms=device_ms, rows=rows,
         peak_memory=peak, image_mb=n * 4 / 2**20,
         bound_ms_total=bounds["ssim_fwd"][0] + bounds["ssim_bwd"][0])
    return rows


def bound_ms(bytes_moved: float, ops: float) -> tuple:
    """The least time the card could take: (ms, "bytes" or "operations")."""
    by_bytes = bytes_moved / H100_HBM_BYTES_PER_S * 1e3
    by_ops = ops / H100_FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


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
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    outs = [render_model(cam, model, bg, raster=RasterizerConfig()) for cam in cams]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    for i, out in enumerate(outs):
        check(tuple(out.render.shape) == (3, H1, W1), f"view {i}: image shape")
        check(tuple(out.rendered_depth.shape) == (1, H1, W1), f"view {i}: depth shape")
        for key in ("render", "rendered_depth", "rendered_alpha"):
            check(bool(torch.isfinite(getattr(out, key)).all()), f"view {i}: {key} not finite")
        alpha = out.rendered_alpha
        check(bool((alpha >= 0).all() and (alpha <= 1).all()), f"view {i}: alpha outside [0, 1]")
        check(float(alpha.mean()) > 0.05, f"view {i}: almost nothing rendered")
    check(launches == launches_of(raster_fwd=VIEWS),
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
    LAUNCHES.update(launches)  # timing launches do not count

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
    before = dict(LAUNCHES)
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
    LAUNCHES.update(before)  # timing launches do not count
    emit("render_time", scene=name, width=W_, height=H_, gaussians=mdl.total,
         entries=b.num_entries, stages=stages, render_model_host_ms=host,
         device=busy, device_idle_share=max(0.0, 1.0 - busy["busy_ms"] / host["median_ms"]),
         peak_mem_bytes=torch.cuda.max_memory_allocated())


def training_phase(dev, bwd_kernel_t: dict) -> dict:
    """The training main path: TRAIN_STEPS train_steps at 1080p on the
    hybrid model, cycling through TRAIN_VIEWS views, then the step's stage
    times (`bwd_kernel_t`: the backward kernel's, timed in serving_phases).
    Raises on any failed check; returns the launches of the counted run and
    the views, their ground truth and the match bundle."""
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
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    metrics = []
    for it in range(1, TRAIN_STEPS + 1):
        v = (it - 1) % TRAIN_VIEWS
        model, state, m = train_step(model, state, bundle, cams[v], gts[v], v, it, bg, cfg)
        metrics.append(m)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    loss_after = view_loss(0)

    check(launches == launches_of(raster_fwd=TRAIN_STEPS, raster_bwd=TRAIN_STEPS,
                                  ssim_fwd=TRAIN_STEPS, ssim_bwd=TRAIN_STEPS),
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
    LAUNCHES.update(launches)  # timing launches do not count
    return dict(launches=launches, bundle=bundle, gts=gts, cams=cams)


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
            counted = dict(LAUNCHES)
            log[-1]["view0_loss"] = view_loss(mdl, 0)
            LAUNCHES.update(counted)  # measurement launches do not count

    torch.cuda.synchronize()
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    t0 = time.perf_counter()
    state = run_main_stage(model, bundle, cams, gts, list(range(TRAIN_VIEWS)), stack_seed=14,
                           opt_cfg=cfg, extras=extras, cameras_extent=extent,
                           iterations=PIPE_STEPS, callback=record,
                           generator=torch.Generator(device=dev).manual_seed(15))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    model = state.model
    loss_after = view_loss(model, 0)
    event, pre = log[EVENT - 1], log[EVENT - 2]
    emit("pipeline_main_stage", steps=PIPE_STEPS, launches=launches, run_host_s=run_s,
         view0_loss_before=loss_before, view0_loss_after=loss_after, log=log,
         adam_count=state.opt_state.count, optimization=PIPE_OPT)
    check(launches == dict.fromkeys(COUNTED, PIPE_STEPS),
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
    before = dict(LAUNCHES)
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
    LAUNCHES.update(before)  # comparison and timing launches do not count
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
    LAUNCHES.update(before)
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
    loss and host time (what `TrainLogger.step` is handed: from the end of
    the last callback to the loss read, which waits for the step's device
    work, as the JAX CLI's `float(metrics.loss)` does) and each
    evaluation. With `profile_from`, it runs the profiler over the
    `profile_iters` iterations after that one and keeps their device busy
    time and host time."""

    def __init__(self, profile_from: int | None = None, profile_iters: int = 0):
        self.profile_from, self.profile_iters = profile_from, profile_iters
        self.steps, self.evals, self.seconds = [], [], {}
        self.init = self.promoted = None
        self.window = {}

    def __enter__(self):
        self._saved = (pipeline_mod.setup_from_matches, pipeline_mod.run_main_stage,
                       TrainLogger.step, TrainLogger.eval)
        setup, run, step, evaluate = self._saved
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

        def recorded_eval(logger, name, l1, psnr, iteration):
            rec.evals.append((name, iteration, l1, psnr))
            return evaluate(logger, name, l1, psnr, iteration)

        pipeline_mod.setup_from_matches, pipeline_mod.run_main_stage = timed_setup, timed_run
        TrainLogger.step, TrainLogger.eval = recorded_step, recorded_eval
        return self

    def __exit__(self, *exc):
        (pipeline_mod.setup_from_matches, pipeline_mod.run_main_stage,
         TrainLogger.step, TrainLogger.eval) = self._saved
        return False


# ---------------- parallelism ----------------

def leaves_close(name: str, got: dict, want: dict, rel: float, where: dict = None) -> float:
    """Max over the leaves of max|got - want| / max|want|, taken over the
    elements `where[key]` (a bool mask) where given; raises past `rel`."""
    worst = 0.0
    for key, w in want.items():
        diff = (got[key] - w).abs()
        if where and key in where:
            diff = diff[where[key]]
        err = float(diff.max()) if diff.numel() else 0.0
        scale = float(w.abs().max())
        check(err <= rel * scale or err == 0.0,
              f"{name} {key}: max err {err} > {rel} * {scale}")
        worst = max(worst, err / scale if scale > 0 else 0.0)
    return worst


def state_of(model, state) -> dict:
    """Copies of the parameters and Adam moments, by name."""
    out = {n: getattr(model, n).detach().clone() for n in PARAM_NAMES}
    out.update({f"m.{n}": state.m[n].clone() for n in PARAM_NAMES})
    out.update({f"v.{n}": state.v[n].clone() for n in PARAM_NAMES})
    return out


def dp_against_train_step(dev, group, leaves, bundle, cams, gts, bg, cfg, rcfg) -> dict:
    """PAR_STEPS `dp_train_step`s over `group` and PAR_STEPS `train_step`s,
    each from a model made from `leaves`, cycling through the views, with
    the rasterizer config `rcfg`: per kind, the losses, the launches, and the
    parameters, Adam moments and densify statistics after step 1 and after
    the last step, and the last model and state."""
    out = {}
    for kind in ("dp", "single"):
        model = model_from_numpy(leaves, 3, device=dev)
        state = optim.init({n: getattr(model, n) for n in PARAM_NAMES})
        LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
        losses, first = [], None
        for it in range(1, PAR_STEPS + 1):
            v = (it - 1) % TRAIN_VIEWS
            if kind == "dp":
                model, state, m = dp.dp_train_step(group, model, state, bundle, [cams[v]],
                                                   [gts[v]], [v], it, bg, cfg, raster=rcfg)
            else:
                model, state, m = train_step(model, state, bundle, cams[v], gts[v], v, it, bg,
                                             cfg, raster=rcfg)
            losses.append(float(m.loss))
            if it == 1:
                first = state_of(model, state)
        torch.cuda.synchronize()
        final = state_of(model, state)
        final.update({n: getattr(model, n).clone() for n in ("xyz_gradient_accum", "denom",
                                                             "max_radii2d")})
        out[kind] = dict(model=model, state=state, losses=losses, first=first, final=final,
                         launches=dict(LAUNCHES))
    return out


def grad_elements(model) -> int:
    """Floats in one DP step's SUM all-reduce while densifying: every
    parameter's gradient, the three losses and two densify columns."""
    return sum(getattr(model, n).numel() for n in PARAM_NAMES) + 3 + 2 * model.total


def par_rank(rank: int, port: int, tmp: str, device_type: str) -> None:
    """One of the two processes that share the card over gloo (CUDA tensors):
    one data-parallel step on views 0 and 1, the gloo all-reduce's time at
    the step's size, then PAR_RUN_STEPS iterations of `run_main_stage` over
    the group (one densify event and one opacity reset). Writes its states,
    losses, launch counts and times into `tmp`."""
    hosts.initialize_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo", device=device_type)
    try:
        dev = hosts.local_device(device_type)
        group = dp.make_group(2, device=dev)
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        bundle = bundle_from_numpy(inputs["bundle"], device=dev)
        gts = [g.to(dev) for g in inputs["gts"]]
        W1, H1, _ = FULL
        cams = view_cameras(W1, H1, TRAIN_VIEWS, dev)
        model = model_from_numpy(hybrid_leaves(*HYBRID, seed=7), 3, device=dev)
        dp.broadcast_model(group, model)
        bg = torch.zeros(3, device=dev)
        cfg = OptimizationConfig(**PIPE_OPT)
        state = optim.init({n: getattr(model, n) for n in PARAM_NAMES})
        LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
        model, state, m1 = dp.dp_train_step(group, model, state, bundle, cams[:2], gts[:2],
                                            [0, 1], 1, bg, cfg)
        torch.cuda.synchronize()
        step1 = {k: v.cpu() for k, v in state_of(model, state).items()}
        buf = torch.ones(grad_elements(model), device=dev)
        reduce_t = cuda_times(lambda: dist.all_reduce(buf, group=group))
        losses, slots = [], [model.total, model.total]

        def record(it, m, met, **_):
            losses.append(float(met.loss))
            slots.append(m.total)  # the next step's slots: densify may grow them

        t0 = time.perf_counter()
        out = run_main_stage(
            model, bundle, cams, gts, list(range(TRAIN_VIEWS)), stack_seed=21, opt_cfg=cfg,
            iterations=1 + PAR_RUN_STEPS, first_iteration=1, opt_state=state, group=group,
            generator=torch.Generator(device=dev).manual_seed(22), callback=record)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        by_sort = sum(raster.sort_route(n, W1, H1, RasterizerConfig())
                      for n in slots[:1 + PAR_RUN_STEPS])
        final = {k: v.cpu() for k, v in state_of(out.model, out.opt_state).items()}
        torch.save(dict(step1=step1, final=final, loss1=float(m1.loss), losses=losses,
                        bg_alive=int(out.model.bg_alive.sum()), slots=out.model.total,
                        launches=dict(LAUNCHES), steps_by_sort=by_sort,
                        all_reduce=reduce_t, run_s=run_s,
                        elements=buf.numel()),
                   os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        hosts.shutdown()


def two_process_gloo(dev, bundle, gts, cams, card: str) -> dict:
    """Phase (b): the two processes over gloo; the parent holds step 1
    against its own mean of the two cameras' gradients and one
    `apply_update`, and both ranks bitwise equal after step 1 and after the
    run. Returns the processes' launches."""
    cfg, extras = OptimizationConfig(**PIPE_OPT), TrainExtras()
    bg = torch.zeros(3, device=dev)
    with tempfile.TemporaryDirectory(prefix="par_") as tmp:
        fields = {f.name: getattr(bundle, f.name) for f in dataclasses.fields(bundle)}
        torch.save(dict(bundle={k: v.cpu().numpy() if torch.is_tensor(v) else v
                                for k, v in fields.items()},
                        gts=[g.cpu() for g in gts]), os.path.join(tmp, "inputs.pt"))
        t0 = time.perf_counter()
        ctx = mp.start_processes(par_rank, args=(hosts.free_port(), tmp, dev.type), nprocs=2,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + PAR_JOIN_S
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                check(time.monotonic() < deadline, f"two gloo processes ran past {PAR_JOIN_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)
        wall_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in (0, 1)]

    # the reference: the mean of the two cameras' gradients, one update
    before = dict(LAUNCHES)
    model = model_from_numpy(hybrid_leaves(*HYBRID, seed=7), 3, device=dev)
    leaves = [getattr(model, n) for n in PARAM_NAMES]
    grads = []
    for v in (0, 1):
        fn = make_camera_loss(model, bundle, cams[v], gts[v], v, bg, cfg, RasterizerConfig(),
                              extras, "cuda", False)
        loss, _ = fn(torch.zeros(model.total, 2, device=dev, requires_grad=True))
        grads.append(torch.autograd.grad(loss, leaves, allow_unused=True))
    mean = {n: ((a if a is not None else torch.zeros_like(x))
                + (b if b is not None else torch.zeros_like(x))) / 2
            for n, x, a, b in zip(PARAM_NAMES, leaves, *grads)}
    state = optim.init({n: getattr(model, n) for n in PARAM_NAMES})
    model, state = apply_update(model, state, mean, 1, cfg)
    torch.cuda.synchronize()
    LAUNCHES.update(before)  # reference launches do not count
    ref = {k: v.cpu() for k, v in state_of(model, state).items()}
    firm = {n: ref[f"m.{n}"].abs() > PAR_FIRM * ref[f"m.{n}"].abs().max() for n in PARAM_NAMES}
    step1_err = leaves_close("gloo step 1 vs the mean of two gradients",
                             {k: ranks[0]["step1"][k] for k in ref}, ref, PAR_LEAF_REL,
                             where=firm)  # parameters where the gradient is firm (phase a)
    for key in ("step1", "final"):
        for name, t in ranks[0][key].items():
            check(torch.equal(t, ranks[1][key][name]), f"gloo ranks differ in {key} {name}")
    a, b = ranks
    check(a["losses"] == b["losses"] and len(a["losses"]) == PAR_RUN_STEPS,
          f"gloo ranks' losses {a['losses']} / {b['losses']}")
    check(all(math.isfinite(x) for x in a["losses"]), f"gloo losses {a['losses']}")
    check(a["bg_alive"] > 0 and a["bg_alive"] == b["bg_alive"], f"bg alive {a['bg_alive']}")
    for r in ranks:
        steps = 1 + PAR_RUN_STEPS
        want = launches_of(raster_fwd=steps, raster_bwd=steps, ssim_fwd=steps, ssim_bwd=steps,
                           segsum=r["steps_by_sort"])  # capacity growth may switch the route
        check(r["launches"] == want, f"a gloo rank launched {r['launches']}, not {want}")
    emit("parallel_gloo", card=card, ranks=2, backend="gloo", tensors="cuda", views=[0, 1],
         step1_max_rel_err=step1_err, bitwise_equal_ranks=True, losses=a["losses"],
         loss_step1=a["loss1"], bg_alive=a["bg_alive"], slots=a["slots"],
         steps_by_sort=a["steps_by_sort"],
         all_reduce_elements=a["elements"], all_reduce_ms=[r["all_reduce"] for r in ranks],
         run_s=[r["run_s"] for r in ranks], run_ms_per_iteration=[
             r["run_s"] * 1e3 / PAR_RUN_STEPS for r in ranks],
         wall_s=wall_s, launches=[r["launches"] for r in ranks])
    return {k: a["launches"][k] + b["launches"][k] for k in COUNTED}


def slice_grads(proj, attrs, bg, W, H, cots, by_sort, slices=None):
    """Colour/depth/alpha and d_attrs of sum(out * cots): the whole image
    through RasterizeFn, or with `slices` (rows per slice) the slices one
    after another through `rasterize_rows`, their gradients summed."""
    a = attrs.detach().clone().requires_grad_()
    with torch.enable_grad():
        if slices is None:
            color, depth, alpha = raster.RasterizeFn.apply(a, bg, bin_gaussians(proj, W, H),
                                                           W, H, by_sort)
            outs = [color, depth[None], alpha[None]]
        else:
            parts = [raster.rasterize_rows(proj, W, H, bg, r * slices, slices, attrs=a)
                     for r in range(PAR_SLICES)]
            outs = [torch.cat([p[i] for p in parts], dim=1) for i in range(3)]
        loss = sum((o * c).sum() for o, c in zip(outs, cots))
        (g,) = torch.autograd.grad(loss, a)
    return [o.detach() for o in outs], g


def row_slices_phase(dev, card: str, name: str, scene: dict, W: int, H: int) -> dict:
    """Phase (c) at one bench scene: PAR_SLICES row slices, one after
    another, bitwise the whole image, their summed attribute gradients
    within BWD_REL_MAX of scale of the whole image's; the last slice's
    kernels (a nonzero tile-row offset, ragged) against their plain
    versions, with their times beside the whole image's. Returns the
    counted launches of the slices' run."""
    cam = bench_camera(W, H, dev)
    proj = project_scene(cam, scene, dev)
    attrs = raster.pack_attrs(proj)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    by_sort = raster.sort_route(attrs.shape[0], W, H, RasterizerConfig())
    rows_per, padded = tiles.row_slices(H, PAR_SLICES)
    rng = np.random.default_rng(31)
    cots = [torch.tensor(rng.normal(size=sh).astype(np.float32), device=dev)
            for sh in ((3, H, W), (1, H, W), (1, H, W))]
    before = dict(LAUNCHES)
    whole, g_whole = slice_grads(proj, attrs, bg, W, H, cots, by_sort)
    torch.cuda.synchronize()
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    sliced, g_sliced = slice_grads(proj, attrs, bg, W, H, cots, by_sort, slices=rows_per)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    LAUNCHES.update(before)
    check(launches == launches_of(raster_fwd=PAR_SLICES, raster_bwd=PAR_SLICES,
                                  segsum=PAR_SLICES if by_sort else 0),
          f"{name}: {PAR_SLICES} slices launched {launches}")
    for key, a, b in zip(("color", "depth", "alpha"), sliced, whole):
        check(torch.equal(a, b), f"{name}: the slices' {key} differs from the whole image's")
    errs = group_errors(g_sliced, g_whole)
    check_groups(f"{name} slices' gradients vs the whole image's", errs, BWD_REL_MAX)

    # the kernels of the slice that holds the last tile row (a nonzero offset,
    # ragged) against their plain versions, and times
    index = ((H + raster.TILE - 1) // raster.TILE - 1) // rows_per
    last = index * rows_per
    rows = H - last * raster.TILE
    cmp = compare_kernel(f"{name}_slice{index}", proj, W, H, img_max=1e-2,
                         depth_max=1e-1, img_mean=1e-6, rows=(last, rows_per))
    bwd = compare_backward(f"{name}_slice{index}", cmp, W, H, per_entry=by_sort)
    sb, sa, sbg = cmp["bins"], cmp["attrs"], cmp["bg"]
    whole_bins = bin_gaussians(proj, W, H)
    with torch.no_grad():
        _, _, _, Tw, lw = raster.raster_fwd(whole_bins, sa, sbg, W, H)
    cw = random_cotangents(W, H, 1, dev)
    bwd_fn = raster.raster_bwd_entries if by_sort else raster.raster_bwd
    before = dict(LAUNCHES)
    times = {
        "fwd_whole": cuda_times(lambda: raster.raster_fwd(whole_bins, sa, sbg, W, H)),
        "fwd_slice": cuda_times(lambda: raster.raster_fwd(sb, sa, sbg, W, H)),
        "bwd_whole": cuda_times(lambda: bwd_fn(whole_bins, sa, sbg, Tw, lw, *cw, W, H)),
        "bwd_slice": cuda_times(lambda: bwd_fn(sb, sa, sbg, bwd["T"], bwd["last"], *bwd["cots"],
                                               W, H)),
    }
    LAUNCHES.update(before)  # timing launches do not count
    f_bound = kernel_bound_ms(sb, sa, W, rows, cmp["pairs"])
    b_bound = kernel_bound_ms_bwd(sb, sa, W, rows, bwd["counts"], per_entry=by_sort)
    emit("parallel_row_slices", card=card, scene=name, width=W, height=H,
         gaussians=attrs.shape[0], slices=PAR_SLICES, rows_per_slice=rows_per,
         padded_rows=padded, tile_rows=(H + raster.TILE - 1) // raster.TILE,
         route="sort" if by_sort else "atomic", launches=launches, bitwise_equal=True,
         grad_errors=errs, offset_slice=dict(row_lo=last, pixel_rows=rows,
                                             entries=sb.num_entries),
         kernel_ms=times, fwd_slice_bound_ms=f_bound, bwd_slice_bound_ms=b_bound)
    return dict(launches=launches, times=times, fwd_err=max(
        cmp["err"][f"{k}_max_abs_err"] for k in ("image", "depth", "alpha", "T")),
        bwd_err=bwd["max_abs_err"], f_bound=f_bound, b_bound=b_bound, proj=proj)


def parallel_phase(dev, card: str, train_ctx: dict) -> dict:
    """Parallelism on one card: (a) PAR_STEPS `dp_train_step`s over an NCCL
    group of world size 1 against PAR_STEPS `train_step`s from the same
    state on the 1080p hybrid model; (b) two processes sharing the card over
    gloo; (c) PAR_SLICES tile-row slices at bench_full and bench_dense, and
    the sharded renders over group (a); (d) the train CLI's `--data_parallel
    2` exit. Raises on any failed check; returns the counted launches (the
    DP steps, both gloo processes' runs, the slices and the sharded
    renders) and the kernels' times at a nonzero offset."""
    t_phase = time.perf_counter()
    bundle, gts, cams = train_ctx["bundle"], train_ctx["gts"], train_ctx["cams"]
    group = dp.make_group(1, device=dev)
    check(dist.get_backend(group) == hosts.default_backend(dev)
          and dist.get_world_size(group) == 1,
          f"group (a): {dist.get_backend(group)}, world {dist.get_world_size(group)}")
    bg = torch.zeros(3, device=dev)
    cfg = OptimizationConfig()
    leaves = hybrid_leaves(*HYBRID, seed=7)
    counted = launches_of()

    # (a) DP at world size 1 against train_step: by the route by sort (no
    # atomics) every bit must agree; by the main path's atomic route the
    # backward sums in another order each run
    runs = {route: dp_against_train_step(dev, group, leaves, bundle, cams, gts, bg, cfg, rcfg)
            for route, rcfg in (("sort", RasterizerConfig(entry_budget=raster.SORT_ROUTE_MIN_L)),
                                ("atomic", RasterizerConfig()))}
    sort_dp, sort_one = runs["sort"]["dp"], runs["sort"]["single"]
    check(sort_dp["launches"] == sort_one["launches"] == dict.fromkeys(COUNTED, PAR_STEPS),
          f"by sort: DP launched {sort_dp['launches']}, train_step {sort_one['launches']}")
    check(sort_dp["losses"] == sort_one["losses"],
          f"by sort: DP losses {sort_dp['losses']}, train_step {sort_one['losses']}")
    for key, t in sort_one["final"].items():
        check(torch.equal(sort_dp["final"][key], t), f"by sort: DP and train_step differ in {key}")
    dp_run, one = runs["atomic"]["dp"], runs["atomic"]["single"]
    check(dp_run["launches"] == one["launches"] == launches_of(
              raster_fwd=PAR_STEPS, raster_bwd=PAR_STEPS, ssim_fwd=PAR_STEPS, ssim_bwd=PAR_STEPS),
          f"DP launched {dp_run['launches']}, train_step {one['launches']}")
    for k in COUNTED:
        counted[k] += dp_run["launches"][k]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(dp_run["losses"], one["losses"]))
    check(loss_rel <= PAR_LOSS_REL, f"DP vs train_step loss: {loss_rel} relative")
    # after the first step from one state the two differ by the atomic order
    # alone: moments within PAR_LEAF_REL everywhere; Adam moves a parameter by
    # about lr where its gradient sits at that noise floor, so parameters are
    # held where the gradient is firm (|m| > PAR_FIRM of the leaf's max), as
    # the CPU tests hold the port's step against JAX's; later steps start from
    # states that differ, and are reported
    got, want = dp_run["first"], one["first"]
    moments = [k for k in want if "." in k]
    leaf_rel = leaves_close("DP vs train_step, Adam moments after step 1",
                            {k: got[k] for k in moments}, {k: want[k] for k in moments},
                            PAR_LEAF_REL)
    firm = {n: want[f"m.{n}"].abs() > PAR_FIRM * want[f"m.{n}"].abs().max() for n in PARAM_NAMES}
    param_rel = leaves_close("DP vs train_step, parameters after step 1",
                             {n: got[n] for n in PARAM_NAMES}, {n: want[n] for n in PARAM_NAMES},
                             PAR_LEAF_REL, where=firm)
    firm_share = (sum(int(f.sum()) for f in firm.values())
                  / sum(int((want[f"m.{n}"] != 0).sum()) for n in PARAM_NAMES))
    last_rel = {k: float((dp_run["final"][k] - t).abs().max() / t.abs().max())
                for k, t in one["final"].items() if float(t.abs().max()) > 0}
    model, state = dp_run["model"], dp_run["state"]
    it = iter(range(100, 10_000))
    before = dict(LAUNCHES)
    step_t = {
        "dp_train_step": cuda_times(lambda: dp.dp_train_step(
            group, model, state, bundle, [cams[0]], [gts[0]], [0], next(it), bg, cfg)),
        "train_step": cuda_times(lambda: train_step(model, state, bundle, cams[0], gts[0], 0,
                                                    next(it), bg, cfg)),
    }
    buf = torch.ones(grad_elements(model), device=dev)
    step_t["nccl_all_reduce_world1"] = cuda_times(lambda: dist.all_reduce(buf, group=group))
    LAUNCHES.update(before)  # timing launches do not count
    emit("parallel_dp_world1", card=card, backend=dist.get_backend(group), world=1,
         steps=PAR_STEPS,
         width=cams[0].width, height=cams[0].height, gaussians=model.total,
         losses_dp=dp_run["losses"], losses_train_step=one["losses"], loss_max_rel_err=loss_rel,
         sort_route_bitwise_equal=True, step1_moment_max_rel_err=leaf_rel,
         step1_param_max_rel_err_firm=param_rel, firm_share_of_moved=firm_share,
         after_steps_max_rel_err=last_rel,
         launches=dp_run["launches"], times=step_t,
         all_reduce_elements=buf.numel(),
         dp_overhead_ms=step_t["dp_train_step"]["median_ms"] - step_t["train_step"]["median_ms"])
    del runs, dp_run, one, sort_dp, sort_one, model, state, buf, got, want
    torch.cuda.empty_cache()

    # (b) two processes sharing the card over gloo
    for k, n in two_process_gloo(dev, bundle, gts, cams, card).items():
        counted[k] += n

    # (c) row slices at the bench scenes, then the sharded renders over group (a)
    slices = {}
    for name, (W, H, N), log_scale in (("bench_full", FULL, (-5.5, -4.0)),
                                       ("bench_dense", DENSE, (-5.5, -4.0))):
        scene = bench_scene(W, H, N, 0, log_scale)
        slices[name] = row_slices_phase(dev, card, name, scene, W, H)
        for k in COUNTED:
            counted[k] += slices[name]["launches"][k]
        del scene
    W, H, _ = FULL
    proj = slices["bench_full"].pop("proj")
    slices["bench_dense"].pop("proj")
    bg0 = torch.zeros(3, device=dev)
    scene = bench_scene(*FULL, 0, (-5.5, -4.0))
    t = {k: torch.tensor(v, device=dev) for k, v in scene.items()}
    cam = bench_camera(W, H, dev)
    grid = primitives.make_group_grid(1, 1)
    with torch.no_grad():
        before = dict(LAUNCHES)
        want = raster.rasterize(proj, W, H, bg0)
        LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
        got_tiles = tiles.rasterize_tile_sharded(group, proj, W, H, bg0)
        got_prim = primitives.render_sharded(grid, cam, t["means"], t["opac"], t["scales"],
                                             t["quats"], t["shs"], bg0)
        torch.cuda.synchronize()
        sharded_launches = dict(LAUNCHES)
        LAUNCHES.update(before)
    check(sharded_launches == launches_of(raster_fwd=2),
          f"the sharded renders launched {sharded_launches}")
    for label, got in (("rasterize_tile_sharded", got_tiles), ("render_sharded", got_prim)):
        for key, a, b in zip(("color", "depth", "alpha"), got[:3], want):
            check(torch.equal(a, b), f"{label} {key} differs from rasterize")
        check(int(got[3]) == 0, f"{label} overflow {int(got[3])}")
    for k in COUNTED:
        counted[k] += sharded_launches[k]
    emit("parallel_sharded_renders", card=card, group=f"{dist.get_backend(group)}, world 1",
         width=W, height=H,
         gaussians=proj.depth.shape[0], bitwise_equal=True, launches=sharded_launches)
    del proj, scene, t, got_tiles, got_prim, want

    # (d) the train CLI refuses what one card cannot run
    cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="dp_cli_") as tmp:
        out_dir = os.path.join(tmp, "model")
        before = dict(LAUNCHES)
        try:
            train_cli.main(["-s", os.path.join(tmp, "no_scene"), "-m", out_dir,
                            "--data_parallel", str(cards + 1)])
            exited = None
        except SystemExit as e:
            exited = str(e)
        check(exited is not None and "available devices" in exited,
              f"--data_parallel {cards + 1} on {cards} card(s): {exited!r}")
        check(not os.path.exists(out_dir) and LAUNCHES == before,
              "the refused CLI wrote or launched something")
    emit("parallel_cli_refuses", card=card, cards=cards, data_parallel=cards + 1, message=exited)
    hosts.shutdown()
    seconds = time.perf_counter() - t_phase
    emit("parallel", card=card, launches=counted, seconds=seconds)
    return dict(launches=counted, slices=slices, seconds=seconds)


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


def cli_phase(dev, card: str, tmp: str) -> dict:
    """The command-line path, as a user runs it: the synthetic COLMAP scene
    written to disk (`generate_scene`, ground truth rendered on the card),
    the train CLI on it (`-r 2 --eval`, the default 2,000 + 2,000
    iterations, evaluations at 500/1,000/1,500/2,000, a checkpoint at
    1,000), a resumed run from that checkpoint, and the render CLI on the
    trained model; then, outside the counted run, the render CLI's test
    renders against `render_model` on the model `main` returned, and both
    compositing kernels against their plain versions at test view 0
    (504x378, ragged in both axes). Writes into `tmp`. Raises on any failed
    check; returns the counted launches, the kernels' per-launch times at
    that view, and what the eval phase takes over: the scene and model
    directories, the trained model, the train and test cameras (in the
    order the train CLI shuffled them to) and the last test PSNR."""
    W, H = CLI_SIZE[0] // CLI_RESOLUTION, CLI_SIZE[1] // CLI_RESOLUTION
    scene_dir = os.path.join(tmp, "scene")
    model_dir = os.path.join(tmp, "model")
    resume_dir = os.path.join(tmp, "model_resume")

    # the scene: 20 views, ground truth rendered by the forward kernel
    before = LAUNCHES["raster_fwd"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate_scene(scene_dir, n_views=CLI_VIEWS, n_gaussians=CLI_GAUSSIANS,
                   n_points=CLI_POINTS, width=CLI_SIZE[0], height=CLI_SIZE[1],
                   ring_radius=CLI_RING, device=dev)
    write_s = time.perf_counter() - t0
    check(LAUNCHES["raster_fwd"] - before == CLI_VIEWS,
          f"scene writing: {LAUNCHES['raster_fwd'] - before} forward launches")
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
    LAUNCHES.update(launches_of())
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
    launches = dict(LAUNCHES)

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

    # launches over the counted run: a forward and a backward of the
    # compositing and of SSIM per training iteration, a forward per evaluated
    # view (3 test + 3 train views at each evaluation, which takes no SSIM)
    # and per rendered view; the atomic route, so no segment sum
    iters = CLI_ITERATIONS + (CLI_RESUME_TO - CLI_CHECKPOINT)
    rendered = len(CLI_TEST_ITERATIONS) * 6 + 6
    want = launches_of(raster_fwd=iters + rendered, raster_bwd=iters, ssim_fwd=iters,
                       ssim_bwd=iters)
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
    before = dict(LAUNCHES)
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
    LAUNCHES.update(before)
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
                           "raster_bwd": (bwd_ms, bwd_bound[0])},
            # for the eval phase, which works on this phase's scene and model
            "scene_dir": scene_dir, "model_dir": model_dir, "model": model,
            "train_cams": camera_list_from_infos(info.train_cameras, CLI_RESOLUTION, device=dev),
            "test_cams": test_cams, "test_psnr": test_psnr[-1][1]}


def lpips_vgg_weights(path: str, seed: int) -> None:
    """Random LPIPS-VGG weights in the `.npz` layout `eval/lpips.py` reads
    (the repo ships no VGG weights), He-scaled so every tap stays well
    conditioned, with lin heads as the JAX suite draws them."""
    rng = np.random.default_rng(seed)
    params, cin, ci = {}, 3, 0
    for cout in (c for c in lpips_mod._VGG_CFG if c != "M"):
        params[f"conv{ci}_w"] = rng.normal(size=(cout, cin, 3, 3),
                                           scale=math.sqrt(2.0 / (cin * 9))).astype(np.float32)
        params[f"conv{ci}_b"] = rng.normal(size=(cout,), scale=0.05).astype(np.float32)
        cin, ci = cout, ci + 1
    for i, c in enumerate((64, 128, 256, 512, 512)):
        params[f"lin{i}_w"] = np.abs(rng.normal(size=(1, c, 1, 1), scale=0.05)).astype(np.float32)
    np.savez(path, **params)


class Launches:
    """Reads the kernels' launch counts step by step: `step(name, want)`
    checks the launches since the last step against `want` (a dict of the
    kernels that launched; the others must not have), and `aside()` is a
    block whose launches (comparisons) are taken back out."""

    def __init__(self):
        LAUNCHES.update(launches_of())
        self.mark = dict(LAUNCHES)

    def step(self, label: str, want: dict) -> None:
        torch.cuda.synchronize()
        got = {k: LAUNCHES[k] - self.mark[k] for k in COUNTED}
        full = launches_of(**want)
        check(got == full, f"eval {label}: launches {got}, expected {full}")
        self.mark = dict(LAUNCHES)

    @contextlib.contextmanager
    def aside(self):
        saved = dict(LAUNCHES)
        yield
        LAUNCHES.update(saved)

    def total(self) -> dict:
        return dict(LAUNCHES)


def u8_image(render: torch.Tensor) -> np.ndarray:
    """[3, H, W] -> H x W x 3 uint8, as `apps/render.py::save_image` and the
    viewer (`render_for_viewer`) quantise a render."""
    return (torch.clamp(render, 0, 1).permute(1, 2, 0).cpu().numpy() * 255).astype(np.uint8)


def read_results(model_dir: str) -> tuple:
    out = []
    for name in ("results.json", "per_view.json"):
        with open(os.path.join(model_dir, name)) as f:
            out.append(json.load(f))
    return tuple(out)


def check_results_schema(results: dict, per_view: dict, views: int, lpips: bool) -> None:
    method = f"ours_{CLI_ITERATIONS}"
    check(list(results) == [method] and list(per_view) == [method],
          f"metrics: methods {list(results)}, {list(per_view)}")
    keys = {"SSIM", "PSNR", "LPIPS", "AVG"} | (set() if lpips else {"AVG_definition"})
    check(set(results[method]) == keys, f"results.json keys {sorted(results[method])}")
    check(set(per_view[method]) == set(metrics_mod.METRICS)
          and all(len(v) == views for v in per_view[method].values()),
          f"per_view.json: {[(k, len(v)) for k, v in per_view[method].items()]}")
    values = [results[method][k] for k in ("SSIM", "PSNR", "AVG")]
    values += [v for k, d in per_view[method].items() for v in d.values()
               if k != "LPIPS" or lpips]
    check(all(isinstance(v, float) and math.isfinite(v) for v in values),
          "metrics: a value is missing or not finite")
    if lpips:
        check(results[method]["AVG"] == results[method]["LPIPS"],
              "results.json AVG must hold the LPIPS mean (the reference quirk)")
    else:
        check(results[method]["LPIPS"] is None
              and all(v is None for v in per_view[method]["LPIPS"].values()),
              "metrics without weights must report LPIPS as null")


def viewer_request(cam, fovx: float, fovy: float) -> dict:
    """The SIBR request for `cam`: matrices transposed (row-vector) with
    the y/z flips the viewer applies (`NetworkGUI.receive` undoes them)."""
    view_t = cam.world_view.cpu().numpy().T.copy()
    proj_t = cam.full_proj.cpu().numpy().T.copy()
    view_t[:, 1:3] *= -1
    proj_t[:, 1] *= -1
    return {"resolution_x": cam.width, "resolution_y": cam.height, "train": True,
            "fov_y": fovy, "fov_x": fovx, "z_near": float(cam.znear), "z_far": float(cam.zfar),
            "shs_python": False, "rot_scale_python": False, "keep_alive": True,
            "scaling_modifier": 1.0, "view_matrix": [float(v) for v in view_t.flatten()],
            "view_projection_matrix": [float(v) for v in proj_t.flatten()]}


def recv_exact(sock, n: int) -> bytes:
    """`n` bytes from `sock` (a socket with a timeout returns what has
    arrived, MSG_WAITALL or not)."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        check(len(chunk) > 0, f"the viewer connection closed after {len(buf)} of {n} bytes")
        buf += chunk
    return bytes(buf)


def viewer_client(port: int, request: dict, n_bytes: int, out: dict) -> None:
    """A viewer: connects, sends `request`, reads the reply into `out`."""
    with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
        payload = json.dumps(request).encode()
        sock.sendall(len(payload).to_bytes(4, "little") + payload)
        out["image"] = recv_exact(sock, n_bytes)
        n = int.from_bytes(recv_exact(sock, 4), "little")
        out["verify"] = recv_exact(sock, n).decode()


def margin_on(a: torch.Tensor, b: torch.Tensor, patch_mask: torch.Tensor, margin: float,
              selection=None) -> tuple:
    """`aux.margin_l2_loss(a, b, patch_mask, margin)` and the elements it
    selects; where `selection` is given, the loss over that selection
    instead (the same masked mean of the squared error). An element within
    rounding of the margin may fall on either side of it on each device, so
    the card and the CPU are compared over one selection: the card's."""
    loss, sel = aux.margin_l2_loss(a, b, patch_mask, margin, return_mask=True)
    if selection is not None:
        w = selection.to(a.device, a.dtype)
        err = a - b
        loss = torch.sum(err * err * w) / torch.clamp(torch.sum(w), min=1.0)
    return loss, sel


def aux_losses_on(dev, inputs: dict, sample_idx: torch.Tensor, dtype=torch.float32,
                  selections=None) -> tuple:
    """{name: (value, {input: gradient})} of every `losses/aux.py` function
    on `inputs` (copied to `dev` in `dtype` as leaves that require grad),
    and {name: selection} of the two margin losses (`margin_l2_loss` and
    `patch_norm_mse_loss`, which is `margin_l2_loss` over normalized
    patches); where `selections` is given, the margin losses are taken over
    those selections (`margin_on`)."""
    x = {k: v.detach().to(dev, dtype).requires_grad_() for k, v in inputs.items()}
    fore = (x["alpha0"] < 0.5).to(dtype)
    fore_patches = aux.patchify(fore, AUX_PATCH).sum(1) < AUX_PATCH ** 2 / 3
    shared = selections or {}

    def norm(depth):
        return aux._normalize_patches(aux.patchify(depth, AUX_PATCH))

    calls = {
        "get_smooth_loss": (lambda: aux.get_smooth_loss(x["depth0"][0, 0], x["img0"]),
                            ("depth0", "img0")),
        "patchify": (lambda: aux.patchify(x["depth0"], AUX_PATCH).square().mean(), ("depth0",)),
        "margin_l2_loss": (lambda: margin_on(
            aux.patchify(x["depth0"], AUX_PATCH), aux.patchify(x["depth1"], AUX_PATCH),
            fore_patches, 0.05, shared.get("margin_l2_loss")), ("depth0", "depth1")),
        # composed from its parts, as the card's selection needs; held below
        # against `aux.patch_norm_mse_loss` itself
        "patch_norm_mse_loss": (lambda: margin_on(
            norm(x["depth0"]), norm(x["depth1"]), fore_patches, 0.2,
            shared.get("patch_norm_mse_loss")), ("depth0", "depth1")),
        "ranking_loss": (lambda: aux.ranking_loss(
            x["depth0"], x["depth1"], AUX_PATCH, sample_idx=sample_idx.to(dev)), ("depth0",)),
        "cons_loss": (lambda: aux.cons_loss(x["depth0"], x["depth1"], AUX_CONS_PATCH, 1e-3),
                      ("depth0",)),
        "get_virtual_warp_loss": (lambda: aux.get_virtual_warp_loss(
            x["img_v"], x["depth_v"], x["c2w_v"], x["intrs"], x["w2cs"], x["colors"],
            x["alpha_v"][0] > 0.5), ("img_v", "depth_v", "colors")),
    }
    out, sels = {}, {}
    for name, (fn, wrt) in calls.items():
        value = fn()
        if isinstance(value, tuple):
            value, sels[name] = value[0], value[1].cpu()
        grads = torch.autograd.grad(value, [x[k] for k in wrt])
        out[name] = (float(value.detach()), {k: g.cpu() for k, g in zip(wrt, grads)})
    if selections is None:
        own = float(aux.patch_norm_mse_loss(x["depth0"], x["depth1"], fore, AUX_PATCH).detach())
        check(own == out["patch_norm_mse_loss"][0], f"patch_norm_mse_loss {own} vs its "
              f"composition {out['patch_norm_mse_loss'][0]} on {dev}")
    return out, sels


def eval_phase(dev, card: str, tmp: str, cli: dict) -> dict:
    """Evaluation and the remaining tools on the command-line path's scene
    and trained model (`cli_phase`), as a user runs them, each step
    checked: the metrics CLI (without and with LPIPS-VGG from seeded random
    weights; SSIM and LPIPS of each view on the card against the CPU), the
    LLFF spiral video (180 frames), the acceptance harness (`--skip_train`
    on the model, then `--synthetic` end to end), the geo check on depths
    rendered at all 20 views (card against CPU), every auxiliary loss on
    the CLI's renders (values and gradients, card against CPU), the viewer
    over a socket, and the model's health. Launches are counted per step;
    renders that only compare are taken back out. Raises on any failed
    check; returns the counted launches."""
    scene_dir, model_dir, model = cli["scene_dir"], cli["model_dir"], cli["model"]
    test_cams, train_cams = cli["test_cams"], cli["train_cams"]
    method = f"ours_{CLI_ITERATIONS}"
    W, H = test_cams[0].width, test_cams[0].height
    zero = torch.zeros(3, device=dev)
    counts = Launches()

    # 1. the metrics CLI on test/ours_2000: without LPIPS weights, then with
    # seeded random VGG weights
    os.environ.pop(lpips_mod._ENV_VAR, None)
    t0 = time.perf_counter()
    metrics_cli.main(["-m", model_dir, "--no_lpips", "--device", DEVICE])
    metrics_s = time.perf_counter() - t0
    no_lpips = read_results(model_dir)
    check_results_schema(*no_lpips, views=len(test_cams), lpips=False)
    psnr = no_lpips[0][method]["PSNR"]
    check(abs(psnr - cli["test_psnr"]) <= EVAL_PSNR_MAX_GAP,
          f"metrics CLI PSNR {psnr} vs the train CLI's {cli['test_psnr']} at {CLI_ITERATIONS}")
    weights = os.path.join(tmp, "lpips_vgg.npz")
    lpips_vgg_weights(weights, EVAL_LPIPS_SEED)
    os.environ[lpips_mod._ENV_VAR] = weights
    t0 = time.perf_counter()
    metrics_cli.main(["-m", model_dir, "--device", DEVICE])
    metrics_lpips_s = time.perf_counter() - t0
    with_lpips = read_results(model_dir)
    check_results_schema(*with_lpips, views=len(test_cams), lpips=True)
    counts.step("metrics", {"ssim_fwd": 2 * len(test_cams)})  # two runs, SSIM per test view
    # each view's SSIM and LPIPS on the card against the CPU, and their times
    test_dir = os.path.join(model_dir, "test", method)
    t0 = time.perf_counter()
    renders, gts, names, _ = metrics_mod.read_images(
        *(Path(test_dir) / k for k in ("renders", "gt", "dtumask")))
    decode_s = (time.perf_counter() - t0) / len(names)
    nets = {"card": lpips_mod.LPIPS("vgg", device=dev), "cpu": lpips_mod.LPIPS("vgg", device="cpu")}
    ssim_err, lpips_err, ssim_s, lpips_s = [], [], [], []
    for name, r, g in zip(names, renders, gts):
        pair = {d: (torch.tensor(r, device=d), torch.tensor(g, device=d)) for d in (dev, "cpu")}
        with counts.aside(), torch.no_grad():  # comparison launches do not count
            t0 = time.perf_counter()
            card_ssim = float(ssim(*pair[dev]))
            ssim_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            card_lpips = float(nets["card"](pair[dev][0][None], pair[dev][1][None])[0])
            lpips_s.append(time.perf_counter() - t0)
            cpu_ssim = float(ssim(*pair["cpu"]))
            cpu_lpips = float(nets["cpu"](pair["cpu"][0][None], pair["cpu"][1][None])[0])
        cli_view = (with_lpips[1][method]["SSIM"][name], with_lpips[1][method]["LPIPS"][name])
        check(all(abs(a - b) <= 1e-6 * max(1.0, abs(b))
                  for a, b in zip(cli_view, (card_ssim, card_lpips))),
              f"metrics CLI view {name} {cli_view} vs the same calls on the card "
              f"{(card_ssim, card_lpips)}")
        ssim_err.append(abs(card_ssim - cpu_ssim))
        lpips_err.append(abs(card_lpips - cpu_lpips) / max(abs(cpu_lpips), 1e-3))
    check(max(ssim_err) <= EVAL_SSIM_MAX, f"SSIM card vs CPU {ssim_err}")
    check(max(lpips_err) <= EVAL_LPIPS_REL, f"LPIPS card vs CPU (relative) {lpips_err}")
    x0, y0 = (torch.tensor(a, device=dev)[None] for a in (renders[0], gts[0]))
    with torch.no_grad():
        lpips_pair = cuda_times(lambda: nets["card"](x0, y0))
    del nets
    emit("eval_metrics", card=card, width=W, height=H, views=len(names),
         psnr=psnr, train_cli_psnr=cli["test_psnr"], ssim=no_lpips[0][method]["SSIM"],
         lpips_random_vgg=with_lpips[0][method]["LPIPS"],
         cli_s_per_view=metrics_s / len(names), cli_lpips_s_per_view=metrics_lpips_s / len(names),
         png_decode_s_per_view=decode_s, ssim_s_per_view=ssim_s, lpips_s_per_view=lpips_s,
         lpips_vgg_ms_per_pair=lpips_pair, ssim_max_abs_err=max(ssim_err),
         lpips_max_rel_err=max(lpips_err))

    # 2. the fly-through video: the LLFF spiral from poses_bounds.npy
    gen_poses(scene_dir)
    t0 = time.perf_counter()
    video_s = video_cli.main(["-m", model_dir, "--device", DEVICE])
    video_total_s = time.perf_counter() - t0
    counts.step("video", {"raster_fwd": EVAL_VIDEO_FRAMES})
    base = os.path.join(model_dir, "video", method)
    for kind in ("rgb", "depth"):
        cap = cv2.VideoCapture(os.path.join(base, f"video_{kind}.avi"))
        check(cap.isOpened(), f"cannot read video_{kind}.avi back")
        frames = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            check(frame.shape == (H, W, 3), f"video_{kind}.avi frame {frame.shape}")
            frames += 1
        cap.release()
        check(frames == EVAL_VIDEO_FRAMES, f"video_{kind}.avi holds {frames} frames")
    with counts.aside(), torch.no_grad():
        video = VideoScene(scene_dir, model_dir, resolution=CLI_RESOLUTION, device=dev)
        check(len(video.test_cameras) == EVAL_VIDEO_FRAMES,
              f"{len(video.test_cameras)} spiral cameras")
        ply = load_ply(os.path.join(model_dir, "point_cloud", f"iteration_{CLI_ITERATIONS}",
                                    "point_cloud.ply"), max_sh_degree=3, device=dev)
        want = u8_image(render_model(video.test_cameras[0].camera, ply, zero).render)
        del ply
    got = np.asarray(Image.open(os.path.join(base, "frames", "00000.png")))
    frame_lsb = int(np.abs(got.astype(np.int32) - want).max())
    check(got.shape == want.shape and frame_lsb == 0,
          f"video frame 0 vs render_model: {frame_lsb} LSB")
    emit("eval_video", card=card, frames=EVAL_VIDEO_FRAMES, width=W, height=H,
         total_s=video_total_s, render_ms_per_frame=ms_summary(video_s["render"]),
         write_ms_per_frame=ms_summary(video_s["write"]), frame0_lsb=frame_lsb)

    # 3. the acceptance harness: on the trained model, then end to end on
    # its synthetic scene
    t0 = time.perf_counter()
    skip = acceptance.main(["-s", scene_dir, "-m", model_dir, "--skip_train", "--no_lpips",
                            "--iterations", str(CLI_ITERATIONS), "--device", DEVICE])
    skip_s = time.perf_counter() - t0
    check(skip == no_lpips[0], f"acceptance --skip_train {skip} vs the metrics CLI {no_lpips[0]}")
    counts.step("acceptance --skip_train", {"raster_fwd": 2 * len(test_cams),
                                            "ssim_fwd": len(test_cams)})
    t0 = time.perf_counter()
    synthetic = acceptance.main(["--synthetic", "--device", DEVICE])
    synthetic_s = time.perf_counter() - t0
    (syn_method, syn), = synthetic.items()
    check(math.isfinite(syn["PSNR"]) and syn["PSNR"] > ACCEPT_MIN_PSNR,
          f"acceptance --synthetic PSNR {syn['PSNR']}")
    # 10 views written, 60 iterations, an evaluation (2 test + 3 train views), 5
    # renders, SSIM in each iteration and in the metrics of the 2 test renders
    counts.step("acceptance --synthetic", {"raster_fwd": 10 + 60 + 5 + 5, "raster_bwd": 60,
                                           "ssim_fwd": 60 + 2, "ssim_bwd": 60})
    emit("eval_acceptance", card=card, skip_train_s=skip_s, synthetic_s=synthetic_s,
         synthetic=syn, synthetic_method=syn_method)

    # 4. the geo check on the model's depths at all 20 views
    infos = sorted(readers._read_colmap_cameras(*readers._read_colmap_model(scene_dir),
                                                os.path.join(scene_dir, "images")),
                   key=lambda c: c.image_name)
    check(len(infos) == CLI_VIEWS, f"geo_check: {len(infos)} views")
    views = camera_list_from_infos(infos, CLI_RESOLUTION, device=dev)
    with torch.no_grad():
        depths = np.stack([render_model(v.camera, model, zero).rendered_depth[0].cpu().numpy()
                           for v in views])
    counts.step("geo_check depths", {"raster_fwd": len(views)})
    intrs = np.stack([v.camera.K.cpu().numpy() for v in views])
    extrs = np.stack([v.camera.world_view.cpu().numpy() for v in views])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_d, card_m = geo_check.geocheck(intrs, extrs, depths, device=dev)
    geo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_d, cpu_m = geo_check.geocheck(intrs, extrs, depths, device="cpu")
    geo_cpu_s = time.perf_counter() - t0
    # the reprojection is elementwise in a fixed order: the card gives the CPU's
    # values, and NaN where the CPU has NaN (0/0 where a zero depth meets a
    # camera offset with no z)
    src0 = int(geo_check.get_pairs(extrs, 15)[0, 0])
    pair = [torch.as_tensor(x[k], dtype=torch.float32) for k in (0, src0)
            for x in (depths, intrs, extrs)]
    rep_cpu = geo_check.reproject_with_depth(*pair)
    rep_card = [a.cpu() for a in geo_check.reproject_with_depth(*(x.to(dev) for x in pair))]
    rep_bits = sum(int((~((a == b) | (a.isnan() & b.isnan()))).sum())
                   for a, b in zip(rep_card, rep_cpu))
    rep_nan = sum(int(b.isnan().sum()) for b in rep_cpu)
    check(rep_bits == 0, f"geo_check reprojection card vs CPU: {rep_bits} elements differ")
    disagree = int((card_m != cpu_m).sum())
    check(1.0 - disagree / card_m.size >= GEO_MASK_AGREE,
          f"geo_check masks differ at {disagree} of {card_m.size} pixels")
    both = (card_m > 0) & (cpu_m > 0)
    depth_rel = float((np.abs(card_d - cpu_d)[both] / np.abs(cpu_d[both])).max()) \
        if both.any() else 0.0
    check(both.any(), "geo_check kept no pixel")
    check(depth_rel <= GEO_DEPTH_REL, f"geo_check depths card vs CPU: {depth_rel} relative")
    emit("eval_geo_check", card=card, views=len(views), width=W, height=H,
         kept_share=[float(m.mean()) for m in card_m], mask_disagreements=disagree,
         reprojection_elements_differing=rep_bits, reprojection_nan=rep_nan,
         depth_max_rel_err=depth_rel, card_s=geo_s, cpu_s=geo_cpu_s)

    # 5. the auxiliary losses on the CLI's renders, card against CPU
    np.random.seed(EVAL_LPIPS_SEED)
    base_c2w = np.stack([np.linalg.inv(c.camera.world_view.cpu().numpy()) for c in train_cams])
    near_far = np.concatenate([np.ravel(c.near_far) for c in train_cams])
    c2w_v = get_near_virtual_pose(base_c2w, near_far)
    R_v = c2w_v[:3, :3]
    cam_v = Camera.create(R_v, -R_v.T @ c2w_v[:3, 3], test_cams[0].fovx, test_cams[0].fovy,
                          W, H, device=dev)
    with torch.no_grad():
        outs = [render_model(c, model, zero) for c in (test_cams[0].camera,
                                                      test_cams[1].camera, cam_v)]
    counts.step("aux renders", {"raster_fwd": 3})
    inputs = {
        "img0": outs[0].render, "depth0": outs[0].rendered_depth[None],
        "alpha0": outs[0].rendered_alpha[None], "depth1": outs[1].rendered_depth[None],
        "img_v": outs[2].render, "depth_v": outs[2].rendered_depth[0],
        "alpha_v": outs[2].rendered_alpha, "c2w_v": torch.tensor(c2w_v, dtype=torch.float32),
        "intrs": torch.stack([torch.eye(4)] * len(train_cams)),
        "w2cs": torch.stack([c.camera.world_view.cpu() for c in train_cams]),
        "colors": torch.stack([c.gt_image().cpu() for c in train_cams]),
    }
    for i, c in enumerate(train_cams):
        inputs["intrs"][i, :3, :3] = c.camera.K.cpu()
    sample_idx = torch.randperm(AUX_PATCH ** 2, generator=torch.Generator().manual_seed(0))[:6]
    # in float32, and in float64: the warp loss samples the training views at
    # projected coordinates, and in float32 the card's and the CPU's
    # projections part in the last bit, which puts a few of its 190k pixels
    # on the other side of a texel edge, the frustum's edge or a tie between
    # views, where its gradient jumps; its gradients are held in float64 only
    aux_errs = {}
    for dtype in (torch.float32, torch.float64):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_aux, card_sel = aux_losses_on(dev, inputs, sample_idx, dtype)
        torch.cuda.synchronize()
        aux_s = time.perf_counter() - t0
        # the margin losses over the card's selection on both sides
        cpu_aux, cpu_sel = aux_losses_on("cpu", inputs, sample_idx, dtype, card_sel)
        errs = {"card_s": aux_s, "selected": {k: int(v.sum()) for k, v in card_sel.items()},
                "selection_differs": {k: int((v != cpu_sel[k]).sum())
                                      for k, v in card_sel.items()}}
        for name, (value, grads) in card_aux.items():
            want_v, want_g = cpu_aux[name]
            check(math.isfinite(value) and value != 0.0, f"aux {name}: value {value}")
            value_err = abs(value - want_v) / max(abs(want_v), 1.0)
            grad_err = max(float((g - want_g[k]).abs().max() / want_g[k].abs().max())
                           for k, g in grads.items())
            errs[name] = {"value": value, "value_rel_err": value_err, "grad_rel_err": grad_err}
            check(value_err <= AUX_VALUE_REL, f"aux {name} ({dtype}): value {value} vs CPU {want_v}")
            if dtype == torch.float64 or name != "get_virtual_warp_loss":
                check(grad_err <= AUX_GRAD_REL,
                      f"aux {name} ({dtype}): gradient error {grad_err} of max|g|")
        aux_errs[str(dtype).removeprefix("torch.")] = errs
    counts.step("aux losses", {})
    emit("eval_aux", card=card, width=W, height=H, losses=aux_errs)

    # 6. the viewer: a client on a thread sends one request at the CLI's
    # size; the reply and a direct `render_for_viewer` equal render_model's
    # 8-bit image
    gui = network_gui.NetworkGUI(port=0)
    reply = {}
    request = viewer_request(test_cams[0].camera, test_cams[0].fovx, test_cams[0].fovy)
    client = threading.Thread(target=viewer_client,
                              args=(gui.listener.getsockname()[1], request, W * H * 3, reply))
    client.start()
    try:
        deadline = time.perf_counter() + 60
        while gui.conn is None and time.perf_counter() < deadline:
            gui.try_connect()
            time.sleep(0.01)
        check(gui.conn is not None, "the viewer client never connected")
        t0 = time.perf_counter()
        gui.poll(model, scene_dir, 1, CLI_ITERATIONS)
        poll_s = time.perf_counter() - t0
        client.join(timeout=60)
        check(not client.is_alive(), "the viewer client did not finish")
        # the request as `receive` decodes it, rendered directly
        decoded = type("Request", (), {"_read": lambda self: request})()
        direct = network_gui.render_for_viewer(network_gui.NetworkGUI.receive(decoded)[0], model)
    finally:
        gui.close()
        client.join(timeout=60)
    counts.step("viewer", {"raster_fwd": 2})
    with counts.aside(), torch.no_grad():
        want = u8_image(render_model(test_cams[0].camera, model, zero).render).tobytes()
    check(reply.get("verify") == scene_dir, f"viewer verify string {reply.get('verify')!r}")
    check(reply.get("image") == want, "viewer reply differs from render_model's 8-bit image")
    check(direct == want, "render_for_viewer differs from render_model's 8-bit image")
    emit("eval_viewer", card=card, width=W, height=H, bytes=len(want), poll_ms=poll_s * 1e3)

    # 7. the model's health
    debug.assert_model_finite(model)
    launches = counts.total()
    emit("eval", card=card, launches=launches)
    return {"launches": launches}


def rank_kernels(serving: dict, train_launches: dict, pipe: dict, cli: dict,
                 ev: dict) -> None:
    """The order in which the kernels lose the most time on the main paths:
    first any kernel slower than its library call (by that factor), then by
    the sum over the paths of launches x (kernel ms - bound ms), each path
    priced at its own shapes: the 1080p main view for serving and the 1080p
    steps, view 0 of the 4K pipeline (per-entry backward, the segment sum's
    route form against `index_add_` by `gauss_ids`) for its 12, test view 0
    of the command-line path (504x378) for its launches and the eval
    phase's."""
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
        lost[name] += (cli["launches"][name] + ev["launches"][name]) * (ms - bound)
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

    # 2. build every kernel from the checkout's sources; the SSIM kernels at 4032x3024
    build_kernels(root)
    ssim_rows = ssim_phase(dev)

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
    train_ctx = training_phase(dev, serving["raster_bwd_times"])
    train_launches = train_ctx.pop("launches")

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

    # 8. parallelism on one card: DP over a world-1 NCCL group, two processes over
    # gloo, tile-row slices and the sharded renders, the CLI's refusal
    torch.cuda.empty_cache()
    par = parallel_phase(dev, card, train_ctx)
    del train_ctx

    # 9. the command-line path: scene on disk -> train CLI -> resume -> render CLI;
    # 10. then evaluation and the remaining tools on that scene and model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="cli_") as tmp:
        cli = cli_phase(dev, card, tmp)
        ev = eval_phase(dev, card, tmp, cli)
        del cli["model"], cli["train_cams"], cli["test_cams"]
    emit("card_state", nvidia_smi=nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))

    rows = {name: dict(serving[name], library_ms=None) for name in ("raster_fwd", "raster_bwd")}
    rows["segsum"] = pipe["segsum"]
    # launches over the six main paths: 5 views, 6 steps at 1080p, 12 at 4K,
    # the parallel phase (3 DP steps, two gloo processes' 13 steps each, 2 x 4
    # row slices, 2 sharded renders), the command-line run (2,040 iterations,
    # 30 rendered views) and the eval phase (a 180-frame video, a 60-iteration
    # acceptance run, 20 depths, ...)
    launches = {name: serving["serving_launches"][name] + train_launches[name]
                + pipe["launches"][name] + par["launches"][name] + cli["launches"][name]
                + ev["launches"][name] for name in COUNTED}
    rank_kernels(serving, train_launches, pipe, cli, ev)

    print(card, flush=True)
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    table = [{
        "name": name,
        "route": "cuda",
        "source": f"scgaussian_tpu_torch/csrc/{name}.cu",
        "replaces": REPLACES[name],
        "launches": launches[name],
        **{k: rows[name][k] for k in fields},
    } for name in KERNELS]
    # SSIM's kernels, timed at 4032x3024; launched on the training and evaluation paths
    table += [{
        "name": name,
        "route": "cuda",
        "source": "scgaussian_tpu_torch/csrc/ssim.cu",
        "replaces": "none (XLA convolutions, scgaussian_tpu/losses/image.py:74-104)",
        "launches": launches[name],
        **{k: ssim_rows[name][k] for k in fields},
    } for name in SSIM_KERNELS]
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
