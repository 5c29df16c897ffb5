"""One-command real-data acceptance harness.

Port of the JAX package's `apps/acceptance.py`. Given an LLFF/DTU/Tanks/
Blender scene prepared exactly like the reference expects (images + COLMAP
`sparse/0` + `match_data.npy` from `data_preprocess/get_match_info.py`),
runs the complete reference protocol — init stage -> main training ->
test-set rendering -> metrics — through the port's train, render and
metrics CLIs with the reference's flags (`README.md:63-85`: `-r 8 --eval`
for LLFF, masks for DTU) and emits a `results.json` directly diffable
against the reference's `metrics.py` output.

Usage:

    python -m scgaussian_tpu_torch.apps.acceptance -s /data/nerf_llff_data/fern \
        -m out/fern --protocol llff

    python -m scgaussian_tpu_torch.apps.acceptance --synthetic   # dry-run, no data

`--synthetic` generates the in-repo synthetic COLMAP scene and runs the whole
pipeline on a reduced schedule — the harness's own acceptance test.
Everything runs on `--device` (default `cuda`; without a GPU the harness
raises unless `--device cpu` is given).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

# Per-dataset flag presets, from the reference README (`README.md:63-85`) and
# reader defaults (`scene/dataset_readers.py`).
PROTOCOLS = {
    "llff": {"resolution": 8, "white_background": False},
    "dtu": {"resolution": 4, "white_background": False},
    "tanks": {"resolution": 1, "white_background": False},
    "blender": {"resolution": 1, "white_background": True},
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source_path", "-s", default=None)
    p.add_argument("--model_path", "-m", default=None)
    p.add_argument(
        "--protocol", choices=sorted(PROTOCOLS), default="llff",
        help="dataset preset controlling -r and background",
    )
    p.add_argument("--backend", default="cuda", choices=["cuda", "oracle"])
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    p.add_argument("--init_iterations", type=int, default=2000)
    p.add_argument("--iterations", type=int, default=2000)
    p.add_argument(
        "--synthetic", action="store_true",
        help="dry-run on the generated synthetic scene (no external data)",
    )
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--no_lpips", action="store_true")
    p.add_argument("--quiet", action="store_true")
    return p


def run(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from scgaussian_tpu_torch import resolve_device
    from scgaussian_tpu_torch.apps import metrics as metrics_app
    from scgaussian_tpu_torch.apps import render as render_app
    from scgaussian_tpu_torch.apps import train as train_app

    dev = resolve_device(args.device)
    tmp = None
    if args.synthetic:
        from scgaussian_tpu_torch.data.synthetic import generate_scene

        tmp = tempfile.TemporaryDirectory(prefix="scg_acceptance_")
        src = os.path.join(tmp.name, "scene")
        generate_scene(src, n_views=10, n_gaussians=40, n_points=80,
                       width=64, height=48, device=dev)
        model_dir = args.model_path or os.path.join(tmp.name, "model")
        init_iters = min(args.init_iterations, 150)
        iters = min(args.iterations, 60)
        res = 1
        white_bg = False
    else:
        if not args.source_path:
            print("error: -s/--source_path is required without --synthetic",
                  file=sys.stderr)
            sys.exit(2)
        src = args.source_path
        model_dir = args.model_path or os.path.join(
            "output", os.path.basename(os.path.normpath(src))
        )
        init_iters = args.init_iterations
        iters = args.iterations
        preset = PROTOCOLS[args.protocol]
        res = preset["resolution"]
        white_bg = preset["white_background"]
        if not os.path.exists(os.path.join(src, "match_data.npy")):
            print(
                f"error: {src}/match_data.npy not found — run "
                "data_preprocess/get_match_info.py (reference) or "
                "scgaussian_tpu_torch.apps.get_match_info first",
                file=sys.stderr,
            )
            sys.exit(2)

    device = ["--device", str(dev)]
    try:
        if not args.skip_train:
            train_argv = [
                "-s", src, "-m", model_dir, "-r", str(res), "--eval",
                "--init_iterations", str(init_iters),
                "--iterations", str(iters),
                "--backend", args.backend,
                "--test_iterations", str(iters),
                "--save_iterations", str(iters),
            ] + device
            if white_bg:
                train_argv.append("--white_background")
            if args.synthetic:
                train_argv += [
                    "--densify_from_iter", "10",
                    "--densification_interval", "20",
                    "--opacity_reset_interval", "1000",
                    "--bg_capacity", "512",
                ]
            if args.quiet:
                train_argv.append("--quiet")
            train_app.main(train_argv)

        render_app.main(
            ["-m", model_dir, "--iteration", str(iters), "--backend", args.backend] + device
        )
        metrics_argv = ["-m", model_dir] + device
        if args.no_lpips or args.synthetic:
            metrics_argv.append("--no_lpips")
        metrics_app.main(metrics_argv)

        with open(os.path.join(model_dir, "results.json")) as f:
            results = json.load(f)
        print("\n=== acceptance results (diff against the reference's "
              "results.json) ===")
        print(json.dumps(results, indent=2))
        return results
    finally:
        if tmp is not None and args.model_path is None:
            tmp.cleanup()


def main(argv=None):
    return run(argv)


if __name__ == "__main__":
    main()
