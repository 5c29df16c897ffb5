"""The port's spans and counters (`utils/profiling.py`) on the CPU: the span
tree of main-stage steps and served views under a profiler, nothing
recorded without one, the span clock against the profiler's, the counters,
and the benchmark's readers of them on tiny cells (`benchmark/tests/tiny.py`)."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.lib import harness, serve, train
from benchmark.tests.tiny import make_root
from scgaussian_tpu_torch.core.cameras import Camera
from scgaussian_tpu_torch.renderer import binning, project
from scgaussian_tpu_torch.utils import profiling
from test_torch_core import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)
from time_limits import per_test_limit  # noqa: F401 (autouse: a time limit for each test)

SEED = 2**31 + 11
READERS = {
    "train": ("backward_host_ms.train", "update_host_ms.train", "loss_host_ms.train",
              "project_host_ms.train", "host_syncs_per_iter.train"),
    "serve": ("project_host_ms.serve", "project_host_ms.latency", "bin_host_ms.serve",
              "bin_host_ms.latency", "host_syncs_per_view.latency",
              "tile_entries_per_view.serve"),
}
CHILDREN = {
    "train.step": {"step.forward", "step.backward", "step.stats", "step.adam"},
    "step.forward": {"render.view", "loss.photo", "loss.match"},
    "step.backward": {"render.raster_bwd"},
    "render.view": {"render.activate", "render.project", "render.bin", "render.pack",
                    "render.raster_fwd"},
    "render.project": {"project.mean2d", "project.cov3d", "project.cov2d", "project.extent",
                       "project.color"},
}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Each tiny cell run traced (2 units in the profiled sub-window) and
    untraced: the window's spans and counts, the profile, and the new
    readers' values."""
    root = make_root(str(tmp_path_factory.mktemp("bench")),
                     {"serve": {"frames": 6, "check_frames": 2, "trace_views": 2},
                      "train": {"trace_iterations": 2}})
    path = os.path.join(root, "benchmark", "configs", "tiny.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["extras"]["init_iterations"] = 100  # the set-up is not what is looked at here
    with open(path, "w") as f:
        json.dump(cfg, f)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    for kind, runner in (("train", train.Run), ("serve", serve.Run)):
        spec = harness.load_cell(f"tiny.{kind}", root)
        metrics = [m for m in spec["per_layer"] if m["name"] in READERS[kind]]
        run = runner(spec, SEED, 0.6, True, time.perf_counter(), torch.device("cpu"))
        run.run()
        ctx = run.metrics_context()
        w = profiling.WINDOW
        out[kind] = dict(spans=list(w.spans), counts=dict(w.counts), units=ctx["units"],
                         prof=run.sub.prof, traced=harness.read_metrics(metrics, ctx))
        run = runner(spec, SEED, 0.05, False, time.perf_counter(), torch.device("cpu"))
        run.run()
        out[kind]["untraced"] = harness.read_metrics(metrics, run.metrics_context())
    torch.set_num_threads(threads)
    return out


def test_span_tree_of_steps_and_views(cells):
    """Two main-stage steps and two served views under the profiler: each
    unit's tree of spans by cause, the unit ids, every span closed."""
    for kind, top in (("train", "train.step"), ("serve", "render.view")):
        spans = cells[kind]["spans"]
        units = [s for s in spans if s.cause is None and s.name == top]
        assert [s.unit for s in units] == [0, 1] and cells[kind]["units"] == 2
        assert all(s.opens_unit for s in units)
        for s in spans:
            assert s.end_ns is not None and s.end_ns >= s.start_ns
            if s.cause is not None:
                assert s.unit == s.cause.unit and not s.opens_unit
                assert s.cause.start_ns <= s.start_ns and s.end_ns <= s.cause.end_ns
        for unit in units:
            tree = [unit]
            for parent in tree:
                kids = {s.name for s in spans if s.cause is parent}
                assert kids == CHILDREN.get(parent.name, set()), parent.name
                tree += [s for s in spans if s.cause is parent]
        # in the train cell the views are the steps' own: no unit of their own
        views = [s for s in spans if s.name == "render.view"]
        assert len(views) == 2 and all(s.unit in (0, 1) for s in views)


def test_spans_start_on_the_profilers_clock(cells):
    """Each stored start lies within 2 ms of the profiler's event for the
    same span (the events of one name paired in order)."""
    events = {}
    for e in cells["train"]["prof"].profiler.kineto_results.events():
        if e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU:
            events.setdefault(e.name(), []).append(e.start_ns())
    ours = {}
    for s in cells["train"]["spans"]:
        ours.setdefault(s.name, []).append(s.start_ns)
    assert set(ours) <= set(events)
    for name, starts in ours.items():
        assert len(events[name]) == len(starts), name
        for a, b in zip(sorted(starts), sorted(events[name])):
            assert abs(a - b) < 2_000_000, name


def test_other_threads_spans_name_the_waiting_backward():
    """A span opened on another thread with nothing open there (autograd's
    device thread, on the card) names the open `step.backward` as its cause
    and takes its unit."""
    got = {}

    def device_thread():
        # the profiler's state reaches autograd's threads, not a new thread:
        # open the span as the backward's thread would see it
        with profiling._Live("render.raster_bwd"):
            got["span"] = profiling._stack()[-1]

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("train.step"):
            with profiling.span("step.backward"):
                t = threading.Thread(target=device_thread)
                t.start()
                t.join()
            with profiling.span("step.adam"):
                pass
    span = got["span"]
    assert span.cause.name == "step.backward" and span.unit == 0
    assert profiling.WINDOW.adopter is None
    assert [s.name for s in profiling.WINDOW.spans] == [
        "train.step", "step.backward", "render.raster_bwd", "step.adam"]


def test_nothing_recorded_without_a_profiler():
    """With no profiler the context is the name's shared no-op, a decorated
    function runs as it is, and neither the window nor its counts change;
    the counter's running total still adds up."""
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("render.view"):
            profiling.count("host_syncs")
    spans, counts = list(profiling.WINDOW.spans), dict(profiling.WINDOW.counts)
    assert profiling.span("render.bin") is profiling.span("render.bin")
    assert isinstance(profiling.span("render.bin"), profiling._Noop)

    @profiling.span("render.bin")
    def f(x):
        return x + 1

    total = profiling.TOTALS.get("host_syncs", 0)
    with profiling.span("render.view"):
        assert f(1) == 2
        profiling.count("host_syncs", 3)
    assert profiling.WINDOW.spans == spans and profiling.WINDOW.counts == counts
    assert profiling.TOTALS["host_syncs"] == total + 3
    # the next profiled window starts afresh
    with profile(activities=[ProfilerActivity.CPU]):
        assert f(1) == 2
    assert [s.name for s in profiling.WINDOW.spans] == ["render.bin"]
    assert profiling.WINDOW.counts == {}


def test_counters_count_entries_and_kernel_launches():
    """`bin.entries` adds each frame's `TileBins.num_entries`; the kernel
    counters count launches only: the plain versions on the CPU leave them
    as they were."""
    g = torch.Generator().manual_seed(3)
    n = 60
    cam = Camera.create(np.eye(3), np.zeros(3), 0.9, 0.7, 48, 40, device="cpu")
    means = torch.cat([torch.rand(n, 2, generator=g) * 2 - 1,
                       torch.rand(n, 1, generator=g) * 2 + 3], dim=1)
    proj = project.project(cam, means, torch.rand(n, generator=g) * 0.9 + 0.05,
                           scales=torch.rand(n, 3, generator=g) * 0.1 + 0.02,
                           rotations=torch.randn(n, 4, generator=g),
                           colors_precomp=torch.rand(n, 3, generator=g))
    before = dict(profiling.TOTALS)
    bins = binning.bin_gaussians(proj, cam.width, cam.height)
    assert bins.num_entries > 0
    assert profiling.TOTALS["bin.entries"] == before.get("bin.entries", 0) + bins.num_entries
    from scgaussian_tpu_torch.renderer import raster

    raster.rasterize(proj, cam.width, cam.height, torch.zeros(3))
    kernels = [k for k in profiling.TOTALS if k.startswith("kernel.")]
    assert all(profiling.TOTALS[k] == before.get(k, 0) for k in kernels)


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_readers_of_the_programs_spans(cells, kind):
    """Each new per-layer reader finds a number in its tiny traced cell and
    nothing in an untraced run."""
    traced = cells[kind]["traced"]
    assert set(traced) == set(READERS[kind])
    assert all(m["value"] >= 0 for m in traced.values())
    assert cells[kind]["untraced"] == {}
    if kind == "serve":
        entries = cells[kind]["counts"]["bin.entries"] / 2
        assert traced["tile_entries_per_view.serve"]["value"] == entries
        assert traced["project_host_ms.latency"] == traced["project_host_ms.serve"]
