"""Metrics CLI — `python -m scgaussian_tpu_torch.apps.metrics -m <model_path>...`
(port of the JAX package's `apps/metrics.py`, reference `metrics.py:120-128`).

SSIM and LPIPS run on `--device` (default `cuda`; without a GPU the CLI
raises unless `--device cpu` is given). LPIPS needs the weights named by
$SCGAUSSIAN_LPIPS_WEIGHTS and is reported as null without them."""

from argparse import ArgumentParser


def main(argv=None) -> dict:
    """Evaluates the model directories; returns `evaluate`'s dict."""
    from scgaussian_tpu_torch.eval.metrics import evaluate

    parser = ArgumentParser(description="Metrics script parameters")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+", type=str)
    parser.add_argument("--no_lpips", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device for SSIM and LPIPS")
    args = parser.parse_args(argv)
    return evaluate(args.model_paths, use_lpips=not args.no_lpips, device=args.device)


if __name__ == "__main__":
    main()
