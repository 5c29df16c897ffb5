"""Exact k-nearest-neighbour mean squared distance.

Port of `scgaussian_tpu/model/knn.py`, which replaces the reference's
`simple_knn._C.distCUDA2` (used once, at model creation, to set initial
log-scales, `scene/gaussian_model.py:444-445`): the mean squared distance
from each point to its 3 nearest neighbours, itself excluded.

Exact and blockwise, as in JAX: for each block of 1,024 columns the squared
distances come in the same |x|^2 + |y|^2 - 2 x.y form (the product is a
float32 `torch.matmul`; TF32 is off package-wide), self-distances are masked,
and the running k smallest are merged with the block's k smallest. No
[N, N] matrix is built: one [N, 1024] block lives at a time (1.8 GB at
450k points).
"""

from __future__ import annotations

import torch

BLOCK = 1024


@torch.no_grad()
def knn_mean_sq_dist(points: torch.Tensor, k: int = 3) -> torch.Tensor:
    """points [N, 3] float32 -> [N] float32: the mean squared distance to
    the k nearest other points (inf where there are fewer than k others)."""
    n = points.shape[0]
    pts = points.to(torch.float32)
    sq = torch.sum(pts * pts, dim=-1)
    best = torch.full((n, k), float("inf"), dtype=torch.float32, device=pts.device)
    for j0 in range(0, n, BLOCK):
        j1 = min(j0 + BLOCK, n)
        cols = pts[j0:j1]
        d2 = sq[:, None] + sq[None, j0:j1]
        d2.addmm_(pts, cols.T, alpha=-2.0)  # |x|^2 + |y|^2 - 2 x.y
        d2[j0:j1].diagonal().fill_(float("inf"))  # self-distances
        d2.clamp_(min=0.0)
        block_best = torch.topk(d2, min(k, j1 - j0), dim=1, largest=False).values
        del d2
        best = torch.topk(torch.cat([best, block_best], dim=1), k, dim=1, largest=False).values
    return best.mean(dim=-1)
