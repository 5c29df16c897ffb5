#!/usr/bin/env python3
"""Hold the port's geocheck on one NVIDIA GPU against the same call on the CPU.

    python3 tools/geocheck_card_vs_cpu.py

For two 20-view rigs at 504×378 (a ring of cameras over a wavy surface, one
with 0.6% per-pixel depth noise, one with 0.05%), it runs geocheck's
per-source consistency masks, its final masks and depths, and one
reprojection on the card and on the CPU, and prints how many of each differ.
It does so twice: with `eval/geo_check.py` as it is (3×3 and 4×4 products
and inverses in float64, per-pixel products elementwise in a fixed order)
and with the ablation `blas`, which puts back float32 inverses and BLAS
matrix products (`torch.linalg.inv`, `@`), as the module first had them.
geocheck's strict thresholds (< 1 px, < 1% depth) turn a last-bit
difference of the reprojection into a different per-source mask, and one
more or one fewer consistent source moves a kept pixel's averaged depth by
up to 1%/(count + 1).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scgaussian_tpu_torch.eval import geo_check  # noqa: E402


def rig(n: int, h: int, w: int, seed: int, noise: float):
    rng = np.random.default_rng(seed)
    K = np.eye(3)
    K[0, 0] = K[1, 1] = 0.8 * w
    K[0, 2], K[1, 2] = w / 2, h / 2
    extrs = []
    for i in range(n):
        a = 2 * np.pi * i / n
        E = np.eye(4)
        E[:3, 3] = [0.05 * np.cos(a), 0.04 * np.sin(a), 0.01 * i / n]
        c, s = np.cos(0.01 * np.sin(a)), np.sin(0.01 * np.sin(a))
        E[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        extrs.append(E)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = 2.0 + 0.3 * np.sin(xx / 40.0) * np.cos(yy / 30.0) + 0.002 * xx
    depths = np.stack([base * (1 + noise * rng.standard_normal((h, w))) for _ in range(n)])
    return np.stack([K] * n), np.stack(extrs), depths


def blas_mm(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if m.shape[1] > v.shape[0]:
        v = torch.cat([v, torch.ones_like(v[:1])])
    return m @ v


@contextlib.contextmanager
def variant(name: str):
    saved = geo_check._mm, geo_check._inv, geo_check._mul_inv
    if name == "blas":
        geo_check._mm, geo_check._inv = blas_mm, torch.linalg.inv
        geo_check._mul_inv = lambda a, b: a @ torch.linalg.inv(b)
    try:
        yield
    finally:
        geo_check._mm, geo_check._inv, geo_check._mul_inv = saved


def per_source_masks(intrs, extrs, depths, dev, num_select=15):
    it, et, dt = (torch.as_tensor(x.astype(np.float32), device=dev)
                  for x in (intrs, extrs, depths))
    pairs = geo_check.get_pairs(extrs, num_select)
    over = torch.func.vmap(
        lambda a, b, c, d, e, f: geo_check._pairwise_consistency(a, b, c, d, e, f, 1.0, 0.01),
        in_dims=(None, None, None, 0, 0, 0))
    out = []
    for i in range(len(depths)):
        s = torch.as_tensor(pairs[i], device=dev)
        out.append(over(dt[i], it[i], et[i], dt[s], it[s], et[s])[1].cpu().numpy())
    return np.stack(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    rigs = {"noisy_20x378x504": (20, 378, 504, 0, 0.006),
            "smooth_20x378x504": (20, 378, 504, 1, 0.0005)}
    for name, args in rigs.items():
        intrs, extrs, depths = rig(*args)
        for label in ("shipped", "blas"):
            t0 = time.perf_counter()
            with variant(label):
                pc = per_source_masks(intrs, extrs, depths, "cuda")
                pp = per_source_masks(intrs, extrs, depths, "cpu")
                cd, cm = geo_check.geocheck(intrs, extrs, depths, device="cuda")
                pd, pm = geo_check.geocheck(intrs, extrs, depths, device="cpu")
                pair = [torch.tensor(x[k].astype(np.float32)) for k in (0, 1)
                        for x in (depths, intrs, extrs)]
                rc = geo_check.reproject_with_depth(*(x.cuda() for x in pair))
                rp = geo_check.reproject_with_depth(*pair)
            both = (cm > 0) & (pm > 0)
            rel = float((np.abs(cd - pd)[both] / np.abs(pd[both])).max()) if both.any() else 0.0
            bits = sum(int((a.cpu() != b).sum()) for a, b in zip(rc, rp))
            print(f"{name} {label}: per-source masks differ at {int((pc != pp).sum())} of "
                  f"{pc.size}; final masks differ at {int((cm != pm).sum())} of {cm.size}; "
                  f"kept {pm.mean():.4f}; depth max rel where both keep {rel:.3e}; "
                  f"reprojection elements differing {bits}; {time.perf_counter() - t0:.1f} s",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
