"""What the port's own spans and counters say about one traced run of a
benchmark cell, and where the host waits for the device in it.

    python3 tools/trace_check.py --workload llff_r8.serve --seed 2147500001 --seconds 20 \
        --sync_debug 1

from the root of a checkout, on a machine with an NVIDIA GPU. Runs the
cell's traced path (`benchmark/lib/train.py` or `serve.py`, without the
reference's check). With `--sync_debug 1` it runs under
`torch.cuda.set_sync_debug_mode("warn")` and records every synchronizing
call by the Python line that made it (recording them costs host time inside
the spans: read the spans' times from a run without it). Prints, and with
`--out DIR` writes to `DIR/trace_check.<workload>.<sync_debug>.json`:

- `sites` (with `--sync_debug 1`): each synchronizing line with its count
  over the whole run and inside the profiled sub-window, with the innermost
  line of the port (`scgaussian_tpu_torch/`) on the way to it;
- `syncs_per_unit`: the synchronizing calls made from the port's files inside
  the sub-window, per unit (iteration or view), beside the port's counter
  `host_syncs` per unit (`profiling.WINDOW`): the two should agree;
- `span_ms_per_unit`, `coverage` and `causes`: the port's spans in the
  sub-window, the share of `train.step`, `render.view` and `render.project`
  that their direct children cover, and the names of each span's causes;
- `clock_ms`: the largest gap between a span's stored start and the
  profiler's event for it (both on `time.time_ns()`'s scale);
- `off_ns`: what a span and a counter cost while no profiler records (ns
  per call, best of 5 timings of 200,000 calls, an empty loop taken off);
  `on_us`: what a decorated span costs while a profiler records the host
  and the device (us per call, best of 5 timings of 2,000 calls).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
import timeit
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
PKG = os.path.join(ROOT, "scgaussian_tpu_torch") + os.sep

from scgaussian_tpu_torch.utils import profiling  # noqa: E402


@profiling.span("check.decorated")
def decorated():
    return None


def plain():
    return None


def off_costs() -> dict:
    """ns per call of a span's context, a decorated call and a counter while
    no profiler records, over an empty loop of the same calls."""

    def ctx():
        with profiling.span("check.context"):
            pass

    def empty():
        pass

    def counted():
        profiling.count("check.counter")

    n = 200_000
    best = {f.__name__: min(timeit.repeat(f, number=n, repeat=5)) / n * 1e9
            for f in (empty, ctx, plain, decorated, counted)}
    return dict(span_context=best["ctx"] - best["empty"],
                span_decorator=best["decorated"] - best["plain"],
                count=best["counted"] - best["empty"], empty_call=best["empty"])


def on_cost_us(cuda: bool) -> float:
    """us per decorated call, over a plain call, under a profiler of the host
    (and the device, with one)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    n = 2_000
    with torch.profiler.profile(activities=acts):
        best = {f.__name__: min(timeit.repeat(f, number=n, repeat=5)) / n * 1e6
                for f in (plain, decorated)}
    return best["decorated"] - best["plain"]


def clock_gap_ms(prof, spans) -> float | None:
    """The largest |stored start - profiler start| over the window's spans,
    paired with the profiler's CPU events of the same name in order."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cpu and e.is_user_annotation():
            events[e.name()].append(e.start_ns())
    ours = collections.defaultdict(list)
    for s in spans:
        ours[s.name].append(s.start_ns)
    gaps = []
    for name, starts in ours.items():
        theirs = sorted(events.get(name, []))
        if len(theirs) != len(starts):
            return None
        gaps += [abs(a - b) for a, b in zip(sorted(starts), theirs)]
    return max(gaps) * 1e-6 if gaps else None


def coverage(spans, name: str) -> float | None:
    """The share of the `name` spans' time that their direct children cover
    (the union of each span's children); None without such spans."""
    total = covered = 0
    for p in spans:
        if p.name != name or p.end_ns is None:
            continue
        total += p.end_ns - p.start_ns
        last = p.start_ns
        for c in sorted((c for c in spans if c.cause is p and c.end_ns is not None),
                        key=lambda c: c.start_ns):
            lo, hi = max(c.start_ns, last), min(c.end_ns, p.end_ns)
            if hi > lo:
                covered += hi - lo
                last = hi
    return covered / total if total else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sync_debug", type=int, choices=(0, 1), default=1)
    ap.add_argument("--root", default=ROOT, help="the checkout whose BENCHMARK.json names the cell")
    ap.add_argument("--out", help="a directory for the JSON report")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()

    import torch

    from benchmark.lib import harness, serve, train

    total, window = collections.Counter(), collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        port = [f for f in stack if f.filename.startswith(PKG)]
        key = (f"{os.path.relpath(filename, ROOT)}:{lineno}",
               f"{os.path.relpath(port[-1].filename, ROOT)}:{port[-1].lineno}" if port else "")
        total[key] += 1
        if torch._C._autograd._profiler_enabled():
            window[key] += 1

    cuda = torch.cuda.is_available()  # without one, only the spans are looked at
    sync_debug = cuda and bool(args.sync_debug)
    spec = harness.load_cell(args.workload, args.root)
    kind = spec["traffic"]["kind"]
    runner = {"train_loop": train.Run, "serve_closed_loop": serve.Run}[kind]
    run = runner(spec, args.seed, args.seconds, True, t0,
                 torch.device("cuda", 0) if cuda else torch.device("cpu"))
    warnings.showwarning = record
    warnings.simplefilter("always")
    if sync_debug:
        torch.cuda.set_sync_debug_mode("warn")
    try:
        run.run()
    finally:
        if sync_debug:
            torch.cuda.set_sync_debug_mode("default")
    units = run.sub.units
    w = profiling.WINDOW
    unit_span = "train.step" if kind == "train_loop" else "render.view"
    names = sorted({s.name for s in w.spans})
    from_port = sum(n for (where, _), n in window.items()
                    if where.startswith("scgaussian_tpu_torch"))
    out = dict(
        workload=args.workload, seed=args.seed, sync_debug=sync_debug, units=units,
        units_in_store=w.units(unit_span),
        sites=[dict(line=k[0], port_line=k[1], total=total[k], window=window.get(k, 0))
               for k in sorted(total, key=lambda k: -total[k])],
        syncs_per_unit=dict(sync_debug_from_port=from_port / units if units and sync_debug
                            else None,
                            counter=w.counts.get("host_syncs", 0) / units if units else None),
        window_counts=dict(w.counts),
        span_ms_per_unit={n: w.total_ms(n) / units for n in names} if units else {},
        coverage={n: coverage(w.spans, n) for n in ("train.step", "render.view",
                                                    "render.project")},
        causes={n: sorted({s.cause.name if s.cause else "" for s in w.spans if s.name == n})
                for n in names},
        clock_ms=clock_gap_ms(run.sub.prof, w.spans),
        card=torch.cuda.get_device_name(0) if cuda else "cpu",
    )
    out.update(off_ns=off_costs(), on_us=on_cost_us(cuda))  # last: a profile resets WINDOW
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        name = f"trace_check.{args.workload}.{int(sync_debug)}.json"
        with open(os.path.join(args.out, name), "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
