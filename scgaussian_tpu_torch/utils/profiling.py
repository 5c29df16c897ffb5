"""Tracing: the profiler trace, and the spans and counters of the port's layers.

Port of the JAX package's `utils/profiling.py`; the reference only logs
per-iteration wall time via paired CUDA events (`train.py:46-47,124,172`).
Here:

- `trace(logdir)` — context manager around `torch.profiler` that writes a
  TensorBoard / Perfetto trace of the host and the CUDA device under
  `logdir` (the train command line's `--profile_dir`);
- `span(name)` — a named stretch of host work in one of the port's layers,
  as a context manager or a decorator. While a `torch.profiler` records, it
  opens a `record_function` range of that name (so it lands in the trace, on
  the profiler's clock) and appends a `Span` to `WINDOW`; otherwise it costs
  one check of the profiler's flag;
- `count(name, n)` — a counter: always added to `TOTALS` (since import),
  and while a profiler records, to `WINDOW.counts` too;
- `WINDOW` — the store of one profiled window: every span and count made
  while the last profiler session recorded. It starts afresh at the first
  span or count made under a profiler after one made with none, so each
  session that follows unprofiled work has a window of its own.

Spans are named for the layers they time (`train.step`, `step.backward`,
`render.project`, `project.cov2d`, ...). Each `Span` names its cause, the
span open on its thread when it opened; a span opened on a thread with no
open span (autograd's device thread, for the backward's kernels) takes as
its cause the open `ADOPTERS` span that waits for it (`step.backward`). A
`UNITS` span opened outside any unit starts one (`train.step`, a top-level
`render.view`): every span inside it carries the unit's sequence number in
the window.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Dict, List, Optional

import torch

_enabled = torch._C._autograd._profiler_enabled

UNITS = ("train.step", "render.view")  # spans that start a unit where none is open
ADOPTERS = ("step.backward",)  # spans that other threads' top-level spans name as cause


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


class Span:
    """One recorded span: `start_ns` and `end_ns` on `time.time_ns()` (the
    scale of the profiler's own event times; `end_ns` None while open), the
    causing `Span` (None at the top), the unit's sequence number (None
    outside a unit) and whether this span started its unit."""

    __slots__ = ("name", "start_ns", "end_ns", "cause", "unit", "opens_unit")

    def __init__(self, name, start_ns, cause, unit, opens_unit):
        self.name = name
        self.start_ns = start_ns
        self.end_ns = None
        self.cause = cause
        self.unit = unit
        self.opens_unit = opens_unit

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6 if self.end_ns is not None else 0.0


class Window:
    """The spans and counts of one profiled window."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}
        self.next_unit = 0
        self.adopter = None  # (Span, thread id) of the open `ADOPTERS` span

    def reset(self) -> None:
        self.__init__()

    def units(self, name: str) -> int:
        """How many `name` spans started a unit."""
        return sum(1 for s in self.spans if s.opens_unit and s.name == name)

    def total_ms(self, *names: str) -> float:
        """The summed duration of every closed span named in `names`."""
        return sum(s.ms for s in self.spans if s.name in names)


WINDOW = Window()
TOTALS: Dict[str, int] = {}  # every counter since import, profiled or not
_fresh = True  # a span or count ran with no profiler: the next profiled one resets WINDOW
_local = threading.local()


def _window() -> Window:
    global _fresh
    if _fresh:
        _fresh = False
        WINDOW.reset()
    return WINDOW


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Named:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __call__(self, fn):
        """As a decorator: each call of `fn` runs inside the span."""
        name = self.name

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            global _fresh
            if not _enabled():
                _fresh = True
                return fn(*args, **kwargs)
            with _Live(name):
                return fn(*args, **kwargs)

        return wrapper


class _Noop(_Named):
    """A span while no profiler records: enters and exits doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


class _Live(_Named):
    """A span while a profiler records: a `record_function` range and a `Span`."""

    __slots__ = ("rec", "range", "adopt", "prev_adopter")

    def __enter__(self):
        window = _window()
        stack = _stack()
        if stack:
            cause = stack[-1]
        elif window.adopter is not None and window.adopter[1] != threading.get_ident():
            cause = window.adopter[0]
        else:
            cause = None
        unit = cause.unit if cause is not None else None
        opens = unit is None and self.name in UNITS
        if opens:
            unit = window.next_unit
            window.next_unit += 1
        self.rec = rec = Span(self.name, time.time_ns(), cause, unit, opens)
        window.spans.append(rec)
        stack.append(rec)
        self.adopt = self.name in ADOPTERS
        if self.adopt:
            self.prev_adopter = window.adopter
            window.adopter = (rec, threading.get_ident())
        self.range = torch.autograd.profiler.record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.range.__exit__(exc_type, exc, tb)
        self.rec.end_ns = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self.rec:
            stack.pop()
        if self.adopt:
            WINDOW.adopter = self.prev_adopter
        return None


_NOOPS: Dict[str, _Noop] = {}


def span(name: str):
    """A span `name` (see the module's doc): `with span(name): ...`, or
    `@span(name)` over a function. While no profiler records, the context
    is the name's one shared no-op and the decorated function is called
    directly."""
    global _fresh
    if _enabled():
        return _Live(name)
    _fresh = True
    noop = _NOOPS.get(name)
    if noop is None:
        noop = _NOOPS[name] = _Noop(name)
    return noop


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`: to `TOTALS` always, and to the
    window's counts while a profiler records. The port's counters:
    `kernel.raster_fwd`, `kernel.raster_bwd`, `kernel.segsum`,
    `kernel.ssim_fwd` and `kernel.ssim_bwd` (launches of the hand-written
    kernels; both backward epilogues count as `kernel.raster_bwd`, both
    segment-sum forms as `kernel.segsum`),
    `bin.entries` (tile entries binned) and `host_syncs` (reads of a device
    value to the host on the hot path)."""
    global _fresh
    # the one other thread that counts, autograd's device thread (the
    # backward's kernels), runs while the thread that called it waits
    TOTALS[name] = TOTALS.get(name, 0) + n
    if _enabled():
        counts = _window().counts
        counts[name] = counts.get(name, 0) + n
    else:
        _fresh = True
