"""Readings for the correctness limits of a cell: the program's against the
reference's (the lower readings), and the control's and the faults'
(the upper ones). Not part of a benchmark run.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...]

On the cell's own size, in one process, for each seed:
- train cells: the program runs its set-up and main stage up to and
  through the window's first densify event and the followed steps; the
  reference builds the start model and follows the first steps and the
  followed ones in float32 (TF32 off); then, each put in the program's
  place and compared with that reference: the reference with TF32 on (the
  control); the reference with half of the batch (the image's rows) left
  out and the mean taken over the rest, the start model with the kNN's
  mean over two neighbours, and the start model from the init stage's
  depths left unchanged (faults); the densify event is recomputed in
  float32 and with TF32 on, and held against its state left unchanged (a
  fault);
- serve cells: the program serves until every sampled pose has been
  served; the reference renders the sampled poses with TF32 off and on.
One JSON line per seed on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import harness, reference  # noqa: E402


class HalfBatch(reference.Trainer):
    """The reference with the top half of the image's rows left out of the
    photometric loss, its means taken over the rest."""

    def image_loss(self, img, gt):
        h = img.shape[1] // 2
        return super().image_loss(img[:, h:], gt[:, h:])


def train_readings(spec, seed, device) -> dict:
    import torch

    from benchmark.lib import train

    run = train.Run(spec, seed, 1e9, False, time.perf_counter(), device, stop_when_captured=True)
    run.run()
    run.free()
    out = dict(program=run.numbers())
    ref_start, err = run.reference_start()
    ref = run.reference_steps()
    ref_follow = run.reference_follow()

    def in_place(start, err_, steps, follow):
        """The numbers of a stand-in put in the program's place."""
        r = train.start_numbers({k: v.cpu() for k, v in start.items()}, ref_start, err_)
        r.update(train.step_numbers(steps, ref, run.start))
        r.update(run.follow_numbers(ref=ref_follow, prog=follow))
        return r

    tf_start, tf_err = run.reference_start(tf32=True)
    out["control_tf32"] = in_place(tf_start, tf_err, run.reference_steps(tf32=True),
                                   run.reference_follow(tf32=True))
    out["fault_half_batch"] = in_place(ref_start, err, run.reference_steps(HalfBatch),
                                       run.reference_follow(HalfBatch))
    # set-up's faults: the kNN's mean over two neighbours; the init stage
    # returning its depths unchanged
    knn_start, knn_err = run.reference_start(knn_k=2)
    out["fault_knn_two"] = train.start_numbers({k: v.cpu() for k, v in knn_start.items()},
                                               ref_start, knn_err)
    z0_start, z0_err = run.reference_start(z=run.inp["z0"])
    out["fault_init_unchanged"] = train.start_numbers(
        {k: v.cpu() for k, v in z0_start.items()}, ref_start, z0_err)
    cap = run.capture
    if cap is not None:
        refs = {}
        for tf32 in (False, True):
            gen = torch.Generator(device=device)
            gen.set_state(cap["generator"])
            with reference.precision(tf32):
                refs[tf32] = reference.densify(
                    cap["before"], spec["config"]["optimization"], run.inp["extent"],
                    cap["iteration"], gen, spec["config"]["extras"]["prune_min_opacity"])
        out["control_tf32"].update(train.densify_gap(refs[True], refs[False]))
        # the event returning its state unchanged, in the program's place
        out["fault_state_unchanged"] = train.densify_gap(cap["before"], refs[False])
        out["densify_iteration"] = cap["iteration"]
    out["ray_gaussians"] = run.ray_gaussians
    out["alive_bg_at_end"] = run.alive_bg
    out["bg_capacity_at_end"] = run.bg_capacity
    out["iterations"] = run.iteration
    out["iter_per_s"] = len(run.window_losses) / max(run.window_s, 1e-9)
    out["setup_s"] = run.setup_s
    out["from_matches_s"] = run.from_matches_s
    return out


def serve_readings(spec, seed, device) -> dict:
    from benchmark.lib import serve

    run = serve.Run(spec, seed, 1e9, False, time.perf_counter(), device, stop_when_sampled=True)
    run.run()
    run.free()
    ref = run.reference_frames()
    return dict(program=run.numbers(ref=ref),
                control_tf32=run.numbers(ref=ref, prog=run.reference_frames(tf32=True)),
                views=len(run.latencies), views_per_s=len(run.latencies) / run.window_s,
                setup_s=run.setup_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("calibration needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    spec = harness.load_cell(args.workload)
    fn = train_readings if spec["traffic"]["kind"] == "train_loop" else serve_readings
    for seed in args.seeds:
        t = time.perf_counter()
        out = fn(spec, seed, torch.device("cuda", 0))
        out.update(workload=args.workload, seed=seed, seconds=time.perf_counter() - t)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
