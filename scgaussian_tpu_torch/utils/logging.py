"""Training observability: TensorBoard + JSONL writers (SURVEY.md 5.5).

Port of the JAX package's `utils/logging.py`: the same `train_log.jsonl`
records and TensorBoard tags.

Matches the reference's TensorBoard scalars (`train.py:236-276`: train
L1/total loss, iter_time, periodic test/train L1+PSNR, opacity histogram,
total point count) with the same tag names, via torch.utils.tensorboard
behind an import guard like the reference (`train.py:31-35`), imported when
a writer is first asked for; always also writes machine-readable JSONL."""

from __future__ import annotations

import json
import os


def _summary_writer():
    """torch's SummaryWriter class, or None when tensorboard is missing. It
    is imported only when a writer is asked for: the import is slow."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:  # pragma: no cover
        return None
    return SummaryWriter


def _host(x):
    """A numpy array of `x`, a tensor on any device or an array."""
    import numpy as np

    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


class TrainLogger:
    def __init__(
        self, model_path: str, use_tensorboard: bool = True, enabled: bool = True
    ):
        # enabled=False (non-primary multi-host processes): write nothing —
        # every process holds the identical replicated state, so extra
        # writers would only race on the same files
        self.jsonl = (
            open(os.path.join(model_path, "train_log.jsonl"), "a")
            if enabled
            else None
        )
        self.tb = None
        if enabled and use_tensorboard:
            writer = _summary_writer()
            if writer is not None:
                self.tb = writer(model_path)
            else:
                print("Tensorboard not available: not logging progress")

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)

    def step(self, iteration: int, l1: float, total: float, iter_time: float) -> None:
        """`train.py:237-240` tags."""
        self.scalar("train_loss_patches/l1_loss", l1, iteration)
        self.scalar("train_loss_patches/total_loss", total, iteration)
        self.scalar("iter_time", iter_time, iteration)

    def eval(self, name: str, l1: float, psnr: float, iteration: int) -> None:
        """`train.py:270-271` tags."""
        self.scalar(f"{name}/loss_viewpoint - l1_loss", l1, iteration)
        self.scalar(f"{name}/loss_viewpoint - psnr", psnr, iteration)

    def images(self, tag: str, image, step: int) -> None:
        """`train.py:252-260` image panels: a [3, H, W] float image in [0,1]
        logged under `<config>_view_<name>/render` (and `/ground_truth` once
        at the first test iteration)."""
        if self.tb is not None:
            self.tb.add_images(tag, _host(image)[None], global_step=step)

    def histogram(self, tag: str, values, step: int) -> None:
        if self.tb is not None:
            self.tb.add_histogram(tag, _host(values), step)

    def json(self, record: dict) -> None:
        if self.jsonl is not None:
            self.jsonl.write(json.dumps(record) + "\n")
            self.jsonl.flush()

    def close(self) -> None:
        if self.jsonl is not None:
            self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


def safe_state(silent: bool = False, seed: int = 0):
    """`safe_state` (`utils/general_utils.py:118-139`): wraps stdout so every
    completed line is stamped with "[dd/mm HH:MM:SS]" (suppressed entirely
    when `silent`), seeds the Python and NumPy RNGs, and returns a
    `torch.Generator` seeded with `seed` (on the CPU) where the JAX package
    returns a key."""
    import random as _random
    import sys
    from datetime import datetime

    import numpy as np
    import torch

    old_f = sys.stdout

    class _Stamped:
        def write(self, x):
            if silent:
                return
            if x.endswith("\n"):
                stamp = datetime.now().strftime("%d/%m %H:%M:%S")
                old_f.write(x[:-1] + f" [{stamp}]\n")
            else:
                old_f.write(x)

        def flush(self):
            old_f.flush()

    sys.stdout = _Stamped()
    _random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)
