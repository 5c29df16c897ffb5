"""The `serve_closed_loop` traffic: one client asks for views along LLFF's
spiral path, one after the other. A request is `main_stage.render_model` at
the pose, then the frame clamped to [0, 1], scaled to 8 bits and copied to
the client's page-locked [H, W, 3] uint8 buffer on the host: what the video
renderer and the viewer hand on. Its latency is from the request to the
frame on the host.

Set-up makes the served model on the device from the seed, builds the
poses and serves `warmup_views` views. The window starts at a pose drawn
from the seed and walks the path in order. The check keeps the first frame
served at each of `check_frames` poses drawn from the seed, and compares
them, once the window has closed, with the reference's render of the same
pose and model.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.lib import reference, scene
from benchmark.lib import trace as tr
from benchmark.lib import yardstick
from benchmark.lib.train import sync


def frame_of(render: torch.Tensor, host: torch.Tensor) -> torch.Tensor:
    """The served frame: [3, H, W] float -> [H, W, 3] uint8, copied into
    the client's `host` buffer (page-locked on a GPU machine), which it
    returns once the copy has landed."""
    frame = (torch.clamp(render, 0.0, 1.0) * 255.0).to(torch.uint8)
    return host.copy_(frame.permute(1, 2, 0))


class Run:
    def __init__(self, spec: dict, seed: int, seconds: float, trace: bool, t0: float,
                 device: torch.device, stop_when_sampled: bool = False):
        self.stop_when_sampled = stop_when_sampled
        self.cfg, self.traffic = spec["config"], spec["traffic"]
        self.seed, self.seconds, self.trace, self.t0 = seed, seconds, trace, t0
        self.device = device
        self.latencies: List[float] = []
        self.frames: Dict[int, torch.Tensor] = {}
        self.sub = tr.SubWindow(device) if trace else None
        self.launches = tr.Launches()

    def run(self) -> None:
        from scgaussian_tpu_torch.core.cameras import Camera
        from scgaussian_tpu_torch.model.gaussians import GaussianModel
        from scgaussian_tpu_torch.renderer import project as project_mod
        from scgaussian_tpu_torch.renderer import raster
        from scgaussian_tpu_torch.train import main_stage

        cfg, traffic, dev = self.cfg, self.traffic, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        self.leaves = scene.served_leaves(cfg, gen, dev)
        model = GaussianModel({k: v.clone() for k, v in self.leaves.items()}, cfg["sh_degree"])
        self.poses = scene.spiral_views(cfg, traffic)
        cams = [Camera.create(v.R, v.T, v.fovx, v.fovy, v.width, v.height, device=dev)
                for v in self.poses]
        rng = np.random.default_rng(self.seed)
        frames = len(cams)
        self.sample = sorted(rng.choice(frames, traffic["check_frames"], replace=False).tolist())
        first = int(rng.integers(frames))
        bg = torch.zeros(3, device=dev)

        v0 = self.poses[0]
        host = torch.empty(v0.height, v0.width, 3, dtype=torch.uint8,
                           pin_memory=dev.type == "cuda")

        def request(cam):
            return frame_of(main_stage.render_model(cam, model, bg).render, host)

        for i in range(traffic["warmup_views"]):
            request(cams[(first + i) % frames])
        if self.sub is not None:
            self.sub.warm()
        sync(dev)
        self.t_window = time.perf_counter()
        self.setup_s = self.t_window - self.t0

        targets = []
        if self.trace:
            targets = self.launches.targets(raster) + [
                (main_stage, "render_model", tr.spanned("render")),
                (project_mod, "project", tr.spanned("project")),
                (raster, "bin_gaussians", tr.spanned("bin")),
                (raster, "raster_fwd", tr.spanned("raster_fwd"))]
        sub_first = None
        i = 0
        with tr.patched(targets):
            while True:
                pose = (first + i) % frames
                t = time.perf_counter()
                if self.trace:
                    with torch.profiler.record_function("bench:frame"):
                        frame = request(cams[pose])
                else:
                    frame = request(cams[pose])
                now = time.perf_counter()
                self.latencies.append(now - t)
                if pose in self.sample and pose not in self.frames:
                    self.frames[pose] = frame.clone()  # the buffer takes the next frame
                i += 1
                if self.sub is not None:
                    due = now - self.t_window >= traffic["trace_after"] * self.seconds
                    if sub_first is None and due:
                        sub_first = i
                        self.sub.start()
                        self.launches.on = True
                    elif self.launches.on and i - sub_first >= traffic["trace_views"]:
                        self.launches.on = False
                        self.sub.stop()
                        self.sub.units = i - sub_first
                if now - self.t_window >= self.seconds and not self.launches.on:
                    break
                if self.stop_when_sampled and len(self.frames) == len(self.sample):
                    break
        if self.launches.on:
            self.launches.on = False
            self.sub.stop()
            self.sub.units = i - sub_first
        sync(dev)
        self.t_end = time.perf_counter()
        self.window_s = self.t_end - self.t_window
        self.memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        del model, cams

    def metrics_context(self) -> dict:
        ctx = dict(kind="serve", setup_s=self.setup_s, views=len(self.latencies),
                   window_s=self.window_s, latencies=self.latencies)
        if self.trace and self.sub is not None and self.sub.units:
            ctx["trace"] = tr.reduce(self.sub.prof)
            ctx["units"] = self.sub.units
            fwd, flops = [], 0.0
            for bins, attrs, W, H in self.launches.fwd:
                pairs = yardstick.count_pairs(attrs, W, H)
                tiles = bins.tile_starts.numel() - 1
                fwd.append(yardstick.bound_ms(
                    yardstick.fwd_bytes(bins.num_entries, attrs.shape[0], tiles, W, H),
                    pairs * yardstick.OPS_PER_PAIR)[0] * 1e-3)
                alive = int((attrs[:, 5] > 0).sum())
                flops += pairs * yardstick.OPS_PER_PAIR + alive * yardstick.PROJ_OPS_FWD
            ctx["launches"] = dict(fwd=fwd, flops=flops)
            self.launches = tr.Launches()
        return ctx

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_frames(self, tf32: bool = False) -> Dict[int, torch.Tensor]:
        """The reference's frames at the sampled poses."""
        out = {}
        bg = torch.zeros(3, device=self.device)
        with reference.precision(tf32), torch.no_grad():
            act = reference.activations(self.leaves)
            for pose in self.sample:
                v = self.poses[pose]
                rows, radius = reference.project(act, reference.camera(v, self.device))
                img = reference.render(rows, radius, v.width, v.height, bg)[0]
                out[pose] = reference.to_uint8(img).cpu()
        return out

    def numbers(self, ref=None, prog=None) -> Dict[str, float]:
        """frame_max_lsb and frame_mean_lsb: the largest and the mean
        absolute difference, in 8-bit steps, between each sampled served
        frame and the reference's (an unserved pose reads NaN)."""
        ref = ref or self.reference_frames()
        prog = prog if prog is not None else self.frames
        worst, mean = 0.0, 0.0
        for pose in self.sample:
            if pose not in prog:
                return dict(frame_max_lsb=None, frame_mean_lsb=None)
            d = (prog[pose].to(torch.int16) - ref[pose].to(torch.int16)).abs()
            worst = max(worst, float(d.max()))
            mean = max(mean, float(d.to(torch.float64).mean()))
        return dict(frame_max_lsb=worst, frame_mean_lsb=mean)
