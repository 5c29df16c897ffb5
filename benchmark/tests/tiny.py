"""A tiny copy of the benchmark's cells for CPU tests: the same traffic
kinds and limits, at 64 x 48 with a few dozen matches, in a temporary root."""

from __future__ import annotations

import json
import os
import shutil

from benchmark.lib.harness import BENCH_DIR, ROOT, read_json

SIZE = dict(width=64, height=48, matches_per_pair=40)


def make_root(tmp: str, traffic_overrides: dict | None = None) -> str:
    """A root holding BENCHMARK.json with cells tiny.train and tiny.serve,
    the tiny configuration, the traffic files (with overrides) and the
    limits of the llff_r1 cells."""
    root = os.path.join(tmp, "root")
    os.makedirs(os.path.join(root, "benchmark", "configs"))
    os.makedirs(os.path.join(root, "benchmark", "limits"))
    shutil.copytree(os.path.join(BENCH_DIR, "traffic"), os.path.join(root, "benchmark", "traffic"))
    spec = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cfg = read_json(os.path.join(BENCH_DIR, "configs", "llff_r1.json"))
    cfg.update(SIZE, name="tiny")
    cfg["extras"].update(bg_capacity=256, init_iterations=400)
    cfg["optimization"].update(densify_from_iter=3, densification_interval=5)
    cfg["serve_model"].update(ray_gaussians=200, alive_bg=50, bg_capacity=128)
    with open(os.path.join(root, "benchmark", "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    for kind in ("train", "serve"):
        limits = read_json(os.path.join(BENCH_DIR, "limits", f"llff_r1.{kind}.json"))
        if kind == "train":
            limits["follow"] = dict(limits["follow"], **{"from": 7})  # after the event at 5, before the next
        with open(os.path.join(root, "benchmark", "limits", f"tiny.{kind}.json"), "w") as f:
            json.dump(limits, f)
    for name, over in (traffic_overrides or {}).items():
        path = os.path.join(root, "benchmark", "traffic", name + ".json")
        t = read_json(path)
        t.update(over)
        with open(path, "w") as f:
            json.dump(t, f)
    cells = [dict(name="tiny.train", config="tiny", traffic="train", chips=1, why="test"),
             dict(name="tiny.serve", config="tiny", traffic="serve", chips=1, why="test")]
    spec["configs"] = [dict(name="tiny", source="test", file="benchmark/configs/tiny.json",
                            reduced=[], why="test")]
    spec["workloads"] = cells
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            kind = m["workloads"][0].rsplit(".", 1)[1]
            m["workloads"] = [f"tiny.{kind}"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root
