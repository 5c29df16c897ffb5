"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's NVIDIA GPUs. The
cell's configuration, traffic, limits and metrics are found by name through
`BENCHMARK.json` (see `lib/harness.py`). With `--trace 0` the result's
metrics are the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics, read from a `torch.profiler` sub-window of the same run. Either
way the run checks what the timed path produced against the plain
reference (`lib/reference.py`) and prints each compared number beside its
limit, last on standard error and last in the result line. The last line
of standard output is the result (one JSON object). Exits 2 without a
result when the cell's GPUs are missing, 3 when JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import harness  # noqa: E402


def power_limit() -> str:
    """The card's name and power limit as `nvidia-smi` reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t0: float, device,
             root: str = ROOT):
    """Set-up, the window, the metrics and the check of one run. Returns
    (result dict, the lines for standard error)."""
    import torch

    from benchmark.lib import serve, train

    torch.set_num_threads(2)
    spec = harness.load_cell(workload, root)
    kind = spec["traffic"]["kind"]
    runners = {"train_loop": train.Run, "serve_closed_loop": serve.Run}
    run = runners[kind](spec, seed, seconds, trace, t0, device)
    run.run()
    ctx = run.metrics_context()
    metrics = harness.read_metrics(spec["per_layer"] if trace else spec["end_to_end"], ctx)
    run.free()
    numbers = run.numbers()
    checks = harness.judge(numbers, spec["limits"]["limits"])
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               count=spec["cell"]["chips"], memory_peak_bytes=int(run.memory_peak))
    breakdown = None
    lines = []
    if trace and "trace" in ctx:
        dev["busy_s"] = ctx["trace"]["busy_s"]
        dev["window_s"] = ctx["trace"]["window_s"]
        breakdown = ctx["trace"]["breakdown"]
        lines.append("kernel launches traced (without a device record): " + ", ".join(
            f"{k} {len(v)} ({sum(x is None for x in v)})"
            for k, v in ctx["trace"]["kernel_s"].items()))
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
        lines.append(f"card: {dev['kind']}; {dev['power_limit']}")
    for name, m in metrics.items():
        lines.append(f"metric {name}: {m['value']!r} {m['unit']}")
    extra = {k: numbers[k] for k in numbers if k not in checks}
    if extra:
        lines.append(f"not compared: {json.dumps(extra)}")
    if kind == "train_loop":
        lines.append(f"window: {len(run.window_losses)} iterations to {run.iteration}, "
                     f"{run.ray_gaussians} ray Gaussians, {run.alive_bg} alive of "
                     f"{run.bg_capacity} background slots at its end")
    lines.append(harness.checks_text(checks))
    attempted = len(getattr(run, "window_losses", None) or getattr(run, "latencies", []))
    failed = sum(1 for x in getattr(run, "window_losses", []) if x != x)
    result = dict(correct=harness.correct(checks), attempted=attempted, failed=failed,
                  metrics=metrics, device=dev, breakdown=breakdown, checks=checks)
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    chips = harness.load_cell(args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T0,
                             torch.device("cuda", 0))
    found = harness.forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr)
    print(harness.result_line(result["correct"], result["attempted"], result["failed"],
                              result["metrics"], result["device"], result["checks"],
                              result["breakdown"]))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
