"""What every cell shares: finding the cell, its configuration, traffic,
metric readers and limits by name; the statistics of the window; the
check of loaded modules; the result line.

A cell of `BENCHMARK.json` names a configuration (its `file`,
`benchmark/configs/<name>.json`) and a traffic
(`benchmark/traffic/<name>.json`, whose `kind` picks the module that runs
it); each metric of `BENCHMARK.json` has a reader
`benchmark/metrics/<name>.py` with `read(ctx) -> float | None`; each cell
has its correctness limits in `benchmark/limits/<cell>.json`. A later cell, configuration,
traffic or metric is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "scgaussian_tpu")


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell `name` of `root`/BENCHMARK.json with its configuration,
    traffic, limits and the metrics it reports (end-to-end and per-layer)."""
    spec = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = read_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = read_json(os.path.join(root, "benchmark", "traffic", cell["traffic"] + ".json"))

    def mine(metric):
        return name in metric.get("workloads", [name])

    return dict(
        cell=cell, config=config, traffic=traffic,
        limits=read_json(os.path.join(root, "benchmark", "limits", name + ".json")),
        end_to_end=[m for m in spec["end_to_end"] if mine(m)],
        per_layer=[m for m in spec["per_layer"] if mine(m)],
    )


def reader(metric: str) -> Callable[[dict], Optional[float]]:
    """`read` of `metrics/<metric>.py`."""
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], ctx: dict) -> Dict[str, dict]:
    """{name: {"value", "unit"}} for each metric whose reader finds
    something to read."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# ---------------- statistics of the window ----------------

def rate(count: int, seconds: float) -> float:
    """Work over the whole window: `count` completed in `seconds` of wall time."""
    return count / seconds


def percentile(samples: List[float], q: float) -> float:
    """The nearest-rank `q`-th percentile of every sample."""
    if not samples:
        raise ValueError("no samples")
    xs = sorted(samples)
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


# ---------------- the checks ----------------

def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit; a number that could not be
    read (None: the window never reached the work it checks) fails."""
    return {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}


def correct(checks: Dict[str, dict]) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


def result_line(ok: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: Optional[dict] = None) -> str:
    out = dict(correct=ok, attempted=attempted, failed=failed, metrics=metrics, device=device)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def checks_text(checks: Dict[str, dict]) -> str:
    return "\n".join(f"check {k}: {c['value']!r} (limit {c['limit']!r})"
                     for k, c in checks.items())
