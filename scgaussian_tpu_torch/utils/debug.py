"""Debug / sanitizer affordances.

Port of `scgaussian_tpu/utils/debug.py`. The reference exposes
`--detect_anomaly` (torch autograd anomaly mode) and a rasterizer `debug`
flag that snapshots state on kernel exceptions (`train.py:303`,
`gaussian_renderer/__init__.py:50`). Here:

- `debug_nans(enable)` turns on `torch.autograd.set_detect_anomaly`, as the
  trainer's --detect_anomaly flag does;
- `check_model_finite(model)` scans every model parameter for NaN/Inf and
  reports the offending fields, the analog of the CUDA debug snapshot.

The JAX package's `interpret_kernels()` runs its Pallas kernels through
the interpreter. Its counterpart here is `device="cpu"` (or CPU tensors):
every kernel wrapper then runs its plain PyTorch version, which the CPU
tests hold against the JAX package. There is no switch for it.
"""

from __future__ import annotations

from typing import Dict

import torch

from scgaussian_tpu_torch.model.gaussians import PARAM_NAMES


def debug_nans(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


def check_model_finite(model) -> Dict[str, dict]:
    """Return {field: {nan: int, inf: int, max_abs: float}} for non-finite
    parameters of a GaussianModel (empty dict == healthy)."""
    report = {}
    with torch.no_grad():
        for name in PARAM_NAMES:
            arr = getattr(model, name)
            n_nan = int(torch.isnan(arr).sum())
            n_inf = int(torch.isinf(arr).sum())
            if n_nan or n_inf:
                finite = arr[torch.isfinite(arr)]
                report[name] = {
                    "nan": n_nan,
                    "inf": n_inf,
                    "max_abs": float(finite.abs().max()) if finite.numel() else None,
                }
    return report


def assert_model_finite(model) -> None:
    report = check_model_finite(model)
    if report:
        raise FloatingPointError(f"non-finite model state: {report}")
