"""Adam with torch semantics + moment surgery for densification.

Port of `scgaussian_tpu/train/optim.py`. The reference uses
torch.optim.Adam(eps=1e-15) with per-param-group learning rates
(`scene/gaussian_model.py:486-510`) and performs optimizer-state surgery on
densify/prune/reset events (`scene/gaussian_model.py:758-842`). As in the
JAX package this is a small explicit implementation, not `torch.optim`, so
that the surgery (zeroing one leaf's or some rows' moments) stays plain
tensor code that mirrors the JAX code:

    m = b1 m + (1-b1) g;  v = b2 v + (1-b2) g^2
    p -= lr * (m / (1-b1^t)) / (sqrt(v / (1-b2^t)) + eps)

The state is one (m, v) pair per named leaf plus a shared step count (the
reference's groups all step together). `apply` is functional: it returns
new tensors and leaves its inputs as they were.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch


@dataclasses.dataclass(frozen=True)
class AdamState:
    m: Dict[str, torch.Tensor]  # leaf name -> first moment
    v: Dict[str, torch.Tensor]  # leaf name -> second moment
    count: int  # steps taken


def init(params: Mapping[str, torch.Tensor]) -> AdamState:
    return AdamState(
        m={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        v={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        count=0,
    )


@torch.no_grad()
def apply(
    params: Mapping[str, torch.Tensor],
    grads: Mapping[str, torch.Tensor],
    state: AdamState,
    lrs: Mapping[str, float],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
):
    """One Adam step over the named leaves. `lrs` maps each leaf name to its
    learning rate. Returns (new params, new AdamState)."""
    count = state.count + 1
    t = torch.tensor(float(count), dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
    bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)

    new_m, new_v, new_p = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        new_m[k] = b1 * state.m[k] + (1 - b1) * g
        new_v[k] = b2 * state.v[k] + (1 - b2) * g * g
        m_hat = new_m[k] / bc1
        v_hat = new_v[k] / bc2
        new_p[k] = p - lrs[k] * m_hat / (torch.sqrt(v_hat) + eps)
    return new_p, AdamState(m=new_m, v=new_v, count=count)


def zero_moments_leaf(state: AdamState, leaf_name: str) -> AdamState:
    """Zero the full (m, v) of one named leaf — the semantics of
    `replace_tensor_to_optimizer` (`scene/gaussian_model.py:758-775`)."""
    m = dict(state.m, **{leaf_name: torch.zeros_like(state.m[leaf_name])})
    v = dict(state.v, **{leaf_name: torch.zeros_like(state.v[leaf_name])})
    return AdamState(m=m, v=v, count=state.count)


def zero_moments_rows(state: AdamState, row_mask_map: Mapping[str, torch.Tensor]) -> AdamState:
    """Zero (m, v) rows where mask is True for the named leaves — the fixed-
    capacity analog of append-with-zero-moments / prune-drops-moments
    (`scene/gaussian_model.py:777-842`)."""

    def zero_rows(tree):
        out = dict(tree)
        for name, mask in row_mask_map.items():
            x = tree[name]
            keep = (~mask).reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
            out[name] = x * keep
        return out

    return AdamState(m=zero_rows(state.m), v=zero_rows(state.v), count=state.count)
