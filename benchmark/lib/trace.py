"""The traced run's instruments, all from the benchmark's side: spans around
the calls into the program's layers (its module attributes, wrapped for the
traced run only), the capture of each compositing kernel's inputs, and the
reduction of a `torch.profiler` sub-window to busy time, kernel counts,
kernel time by name and the breakdown.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

WINDOW = "bench.window"
SPAN = "bench:"
KERNELS = {"raster_fwd": "raster_fwd_kernel", "raster_bwd": "raster_bwd_kernel",
           "segsum": "segsum_kernel"}


@contextlib.contextmanager
def patched(targets: List[Tuple[object, str, Callable]]):
    """Replace `module.attr` by `make(original)` for each target, restored
    on exit."""
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
    try:
        for mod, attr, make in targets:
            setattr(mod, attr, make(getattr(mod, attr)))
        yield
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


def spanned(name: str) -> Callable:
    """A wrapper maker: the call runs inside a profiler span `bench:<name>`."""
    def make(fn):
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(SPAN + name):
                return fn(*args, **kwargs)
        return wrapper
    return make


class Launches:
    """The inputs of each compositing launch while `on`: forward (bins,
    attrs, W, H), backward (bins, attrs, W, H, per_entry) and the route's
    segment sums (rows, n)."""

    def __init__(self):
        self.on = False
        self.fwd: List[tuple] = []
        self.bwd: List[tuple] = []
        self.seg: List[tuple] = []

    def targets(self, raster) -> List[Tuple[object, str, Callable]]:
        def fwd(fn):
            def wrapper(bins, attrs, bg, width, height):
                if self.on:
                    self.fwd.append((bins, attrs, width, height))
                return fn(bins, attrs, bg, width, height)
            return wrapper

        def bwd(per_entry):
            def make(fn):
                def wrapper(bins, attrs, *args):
                    if self.on:
                        self.bwd.append((bins, attrs, args[-2], args[-1], per_entry))
                    return fn(bins, attrs, *args)
                return wrapper
            return make

        def seg(fn):
            def wrapper(starts, vals, n, width=None):
                if self.on:
                    self.seg.append((vals.shape[0], n))
                return fn(starts, vals, n, width)
            return wrapper

        return [(raster, "raster_fwd", fwd), (raster, "raster_bwd", bwd(False)),
                (raster, "raster_bwd_entries", bwd(True)), (raster, "segsum_runs", seg)]


class SubWindow:
    """A profiled stretch of the run: `start()` synchronises and opens the
    profiler and the `bench.window` span, `stop()` closes them. `warm()`,
    called in set-up, starts and stops the profiler once, so that its
    one-off start (some seconds on the card) falls outside the window."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.prof = None
        self.span = None
        self.units = 0

    def warm(self) -> None:
        self.start()
        torch.ones(8, device="cuda" if self.cuda else "cpu").sum().item()
        self.stop()
        self.prof = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        if self.cuda:
            torch.cuda.synchronize()
        self.span = torch.profiler.record_function(WINDOW)
        self.span.__enter__()

    def stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.stop()


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def reduce(prof) -> Dict:
    """Busy and window seconds, kernel launches, device seconds and
    launches by kernel name, and the breakdown (the ten device operations
    that took most time; the idle time summed by the innermost benchmark
    span the host was in, the ten largest), over the `bench.window` span."""
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    win = [e for e in events if e.name() == WINDOW and e.device_type() == cpu]
    if not win:
        raise RuntimeError("the profiler's trace has no bench.window span")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    dev, host = [], []
    for e in events:
        if e.is_user_annotation() and e.device_type() != cpu:
            continue
        s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if t <= s:
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((e.name(), s, t))
        elif e.is_user_annotation() and e.name().startswith(SPAN):
            host.append((e.name(), e.start_ns(), e.end_ns()))
    busy = _merge([(s, t) for _, s, t in dev])
    busy_ns = sum(t - s for s, t in busy)
    by_name: Dict[str, List[float]] = {}
    launches = 0
    for name, s, t in dev:
        if name.startswith("Memcpy") or name.startswith("Memset"):
            key = name.split(" ")[0]
        else:
            launches += 1
            key = name
        rec = by_name.setdefault(key, [0.0, 0])
        rec[0] += (t - s) * 1e-9
        rec[1] += 1
    # each idle gap is named by the innermost benchmark span running at its middle
    edges = np.array([w0] + [x for iv in busy for x in iv] + [w1], dtype=np.int64)
    lo, hi = edges[0::2], edges[1::2]
    keep = hi > lo
    lo, hi = lo[keep], hi[keep]
    mid = (lo + hi) // 2
    spans = sorted(host, key=lambda h: h[2] - h[1])
    label = np.full(mid.shape, -1)
    for i, (_, s, t) in enumerate(spans):
        hit = (label < 0) & (mid >= s) & (mid <= t)
        label[hit] = i
    gaps: Dict[str, float] = {}
    for i, secs in zip(label.tolist(), ((hi - lo) * 1e-9).tolist()):
        name = spans[i][0] if i >= 0 else "host, outside the benchmark's spans"
        gaps[name] = gaps.get(name, 0.0) + secs
    device_ops = sorted(([k, v[0]] for k, v in by_name.items()), key=lambda x: -x[1])[:10]
    idle = sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:10]
    return dict(busy_s=busy_ns * 1e-9, window_s=(w1 - w0) * 1e-9, launches=launches,
                by_name=by_name, kernel_s=kernel_times(events, w0, w1),
                breakdown=dict(device_ops=device_ops, idle_gaps=idle))


def kernel_times(events, w0: int, w1: int) -> Dict[str, List[Optional[float]]]:
    """For each program kernel, one entry per `bench:<kernel>` span in the
    window, in call order: the device seconds of the kernel that the span's
    launch call started (paired by the launch's correlation id), or None
    where the trace holds no record of it."""
    cpu = torch.autograd.DeviceType.CPU
    kernels, calls, spans = {}, [], {name: [] for name in KERNELS}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            kernels[e.correlation_id()] = (e.name(), e.duration_ns() * 1e-9)
        elif e.device_type() == cpu and "LaunchKernel" in e.name():
            calls.append((e.start_ns(), e.correlation_id()))
        elif e.device_type() == cpu and e.is_user_annotation() and e.name().startswith(SPAN):
            name = e.name()[len(SPAN):]
            if name in spans and w0 <= e.start_ns() <= w1:
                spans[name].append((e.start_ns(), e.end_ns()))
    out = {}
    for name, found in spans.items():
        times = []
        for s, t in sorted(found):
            secs = [kernels[c][1] for at, c in calls
                    if s <= at <= t and c in kernels and KERNELS[name] in kernels[c][0]]
            times.append(sum(secs) if secs else None)
        out[name] = times
    return out


def roofline(ctx: Dict, kind: str, name: str, key: str) -> Optional[float]:
    """100 x the summed least times of the captured `key` launches over the
    summed device times of the same launches; in a trace that holds device
    kernels, a launch without a kernel record fails the run."""
    t, w = ctx.get("trace"), ctx.get("launches")
    if ctx["kind"] != kind or not t or not t["launches"] or not w or not w[key]:
        return None  # not this cell's, or no device kernel in the trace (a CPU run)
    times = t["kernel_s"][name]
    if len(times) != len(w[key]):
        raise RuntimeError(f"{name}: {len(times)} spans in the trace, {len(w[key])} captured")
    missing = sum(x is None for x in times)
    if missing:
        raise RuntimeError(f"{name}: {missing} of {len(times)} launches have no kernel record "
                           "paired by correlation id in the trace")
    return 100.0 * sum(w[key]) / sum(times)
