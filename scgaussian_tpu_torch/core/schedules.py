"""Learning-rate schedules.

Port of `scgaussian_tpu/core/schedules.py`: the Plenoxels-style log-lerp
decay used for the z-val / bg-xyz learning rate
(`utils/general_utils.py:35-68`), evaluated in float32 as the JAX
schedule is.
"""

from __future__ import annotations

import math

import numpy as np


def expon_lr(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
):
    """Log-linearly interpolated (exponential) decay with optional sine delay.

    Matches `get_expon_lr_func` (`utils/general_utils.py:53-66`) including the
    step<0 / all-zero-lr disable branch. The returned schedule maps a step
    to a Python float."""

    def schedule(step) -> float:
        step = np.float32(step)
        if lr_init == 0.0 and lr_final == 0.0:
            return 0.0
        if step < 0:
            return 0.0
        if lr_delay_steps > 0:
            frac = np.clip(step / np.float32(lr_delay_steps), 0.0, 1.0)
            delay_rate = np.float32(lr_delay_mult) + np.float32(1 - lr_delay_mult) * np.sin(
                np.float32(0.5 * math.pi) * frac
            )
        else:
            delay_rate = np.float32(1.0)
        t = np.clip(step / np.float32(max_steps), 0.0, 1.0).astype(np.float32)
        log_lerp = np.exp(
            np.log(np.float32(lr_init)) * (np.float32(1) - t) + np.log(np.float32(lr_final)) * t
        )
        return float(np.float32(delay_rate * log_lerp))

    return schedule
