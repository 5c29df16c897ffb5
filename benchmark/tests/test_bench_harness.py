"""The harness finds its cells' files by name, the window's statistics, the
module check, and BENCHMARK.json against the benchmark's contract."""

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark.lib import harness

SPEC = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = harness.load_cell(cell)
    assert spec["traffic"]["kind"] in ("train_loop", "serve_closed_loop")
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert set(spec["limits"]["limits"]) and all(
        isinstance(v, (int, float)) for v in spec["limits"]["limits"].values())
    names = [m["name"] for m in spec["end_to_end"]]
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.reader(metric))


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1].startswith("benchmark/")
    assert 1 <= SPEC["run_seconds"] <= 51
    configs = {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert NAME.match(c["name"]) and os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in METRICS:
        assert NAME.match(m["name"]) and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_rate_and_p95_over_the_whole_window_move_with_a_stall():
    steady = [0.010] * 200
    stalled = [0.010] * 180 + [0.500] * 20
    ctx = dict(kind="serve", views=200, setup_s=1.0)
    fast = dict(ctx, latencies=steady, window_s=sum(steady))
    slow = dict(ctx, latencies=stalled, window_s=sum(stalled))
    p95, rate = harness.reader("view_ms_p95"), harness.reader("views_per_s")
    assert p95(fast) == pytest.approx(10.0) and rate(fast) == pytest.approx(100.0)
    assert p95(slow) == pytest.approx(500.0)  # the tail of every sample, not of a chunk
    assert rate(slow) == pytest.approx(200 / 11.8)  # all the window's time
    assert harness.percentile(list(range(1, 101)), 95) == 95


def test_train_rate_is_iterations_over_the_window():
    read = harness.reader("train_iter_per_s")
    assert read(dict(kind="train", iterations=300, window_s=12.5)) == pytest.approx(24.0)
    assert read(dict(kind="serve", views=3, window_s=1.0, latencies=[1.0])) is None


def test_module_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "scgaussian_tpu_torch.x", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "scgaussian_tpu.x", object())
    assert harness.forbidden_modules() == ["scgaussian_tpu.x"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.lib.reference, benchmark.lib.scene, "
            "benchmark.lib.yardstick, benchmark.lib.trace, benchmark.lib.harness; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('scgaussian_tpu_torch', 'scgaussian_tpu', 'jax')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_gpu_exits_without_a_result(monkeypatch, capsys):
    import torch

    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_roofline_covers_exactly_the_launches_it_times():
    from benchmark.lib import trace

    ctx = dict(kind="train", trace=dict(launches=9, kernel_s={"raster_fwd": [2e-3, 1e-3, 4e-3]}),
               launches=dict(fwd=[1e-3, 5e-4, 1e-3]))
    assert trace.roofline(ctx, "train", "raster_fwd", "fwd") == pytest.approx(100 * 2.5e-3 / 7e-3)
    assert trace.roofline(dict(ctx, kind="serve"), "train", "raster_fwd", "fwd") is None
    with pytest.raises(RuntimeError):  # a launch count that differs from the spans'
        trace.roofline(dict(ctx, launches=dict(fwd=[1e-3])), "train", "raster_fwd", "fwd")
    unpaired = dict(ctx, trace=dict(launches=9, kernel_s={"raster_fwd": [2e-3, None, 4e-3]}))
    with pytest.raises(RuntimeError):  # a launch with no kernel record paired to it
        trace.roofline(unpaired, "train", "raster_fwd", "fwd")
