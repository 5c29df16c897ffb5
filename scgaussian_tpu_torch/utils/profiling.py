"""Tracing / profiling utilities.

Port of the JAX package's `utils/profiling.py`. The reference only logs
per-iteration wall time via paired CUDA events (`train.py:46-47,124,172`).
Here:

- `trace(logdir)` — context manager around `torch.profiler` that writes a
  TensorBoard / Perfetto trace of the host and the CUDA device under
  `logdir`;
- `StepTimer` — EMA wall-clock step timing + the throughput counter rays/s
  (H*W*batch / step time); it synchronises the CUDA device before it reads
  the clock, so a step's time includes its queued device work;
- `annotate` — a `record_function` range, so train phases show up in traces.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Capture a host + device trace under `logdir` (no-op if logdir is None)."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    return torch.profiler.record_function(name)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """EMA step timing + rays/s counter."""

    def __init__(self, pixels_per_step: int, ema: float = 0.9):
        self.pixels = pixels_per_step
        self.ema_alpha = ema
        self.ema_dt: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self) -> None:
        _sync()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        _sync()
        dt = time.perf_counter() - self._t0
        self.ema_dt = dt if self.ema_dt is None else (
            self.ema_alpha * self.ema_dt + (1 - self.ema_alpha) * dt
        )
        return dt

    @property
    def rays_per_s(self) -> float:
        return self.pixels / self.ema_dt if self.ema_dt else 0.0

    @property
    def steps_per_s(self) -> float:
        return 1.0 / self.ema_dt if self.ema_dt else 0.0
