"""The frozen yardstick: the plain counter of the pairs that change a pixel
against a direct count, and the bounds' form."""

import math

import numpy as np
import pytest
import torch

from benchmark.lib import reference, yardstick


def rows(n: int, W: int, H: int, seed: int) -> torch.Tensor:
    """Packed kernel rows [n, 12]: means in the image, conics of 1-6 px
    Gaussians, opacities in [0.02, 0.99], colours, depths, two zeros."""
    g = np.random.default_rng(seed)
    sx, sy = g.uniform(1, 6, n), g.uniform(1, 6, n)
    rho = g.uniform(-0.5, 0.5, n)
    a, b, c = sx * sx, rho * sx * sy, sy * sy
    det = a * c - b * b
    out = np.zeros((n, 12), np.float32)
    out[:, 0], out[:, 1] = g.uniform(-4, W + 4, n), g.uniform(-4, H + 4, n)
    out[:, 2], out[:, 3], out[:, 4] = c / det, -b / det, a / det
    out[:, 5] = g.uniform(0.02, 0.99, n)
    out[:, 6:9] = g.uniform(0, 1, (n, 3))
    out[:, 9] = g.uniform(1, 5, n)
    return torch.tensor(out)


def tile_rect(r: np.ndarray, W: int, H: int) -> np.ndarray:
    """[n, 4] tile rect [x0, x1) x [y0, y1) of each row's 3-sigma square."""
    out = np.zeros((r.shape[0], 4), np.int64)
    for i, row in enumerate(r):
        cov = np.linalg.inv(np.array([[row[2], row[3]], [row[3], row[4]]]))
        radius = math.ceil(3 * math.sqrt(max(np.linalg.eigvalsh(cov))))
        gx, gy = (W + 15) // 16, (H + 15) // 16
        out[i] = [min(gx, max(0, int((row[0] - radius) / 16))),
                  min(gx, max(0, int((row[0] + radius + 15) / 16))),
                  min(gy, max(0, int((row[1] - radius) / 16))),
                  min(gy, max(0, int((row[1] + radius + 15) / 16)))]
    return out


def direct_count(r: np.ndarray, W: int, H: int) -> int:
    """Pixel by pixel, front to back over the rows whose 3-sigma tile rect
    holds the pixel's tile: the pairs blended before the pixel's
    transmittance would fall under 1e-4."""
    order = np.argsort(r[:, 9], kind="stable")
    rect = tile_rect(r, W, H)
    total = 0
    for y in range(H):
        for x in range(W):
            T = 1.0
            for i in order:
                tx, ty = x // 16, y // 16
                if not (rect[i, 0] <= tx < rect[i, 1] and rect[i, 2] <= ty < rect[i, 3]):
                    continue
                dx, dy = r[i, 0] - x, r[i, 1] - y
                power = -0.5 * (r[i, 2] * dx * dx + r[i, 4] * dy * dy) - r[i, 3] * dx * dy
                if power > 0:
                    continue
                alpha = min(0.99, r[i, 5] * math.exp(power))
                if alpha < 1 / 255:
                    continue
                if T * (1 - alpha) < 1e-4:
                    break
                T *= 1 - alpha
                total += 1
    return total


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_live_pairs_match_a_direct_count_on_a_small_tile(seed):
    W = H = 16
    r = rows(24, W, H, seed)
    assert yardstick.count_pairs(r, W, H) == direct_count(r.double().numpy(), W, H)


def test_live_pairs_count_across_tiles():
    W, H = 40, 24  # three tiles across, two down, ragged on both
    r = rows(60, W, H, 3)
    assert yardstick.count_pairs(r, W, H) == direct_count(r.double().numpy(), W, H)


def test_bounds_take_the_larger_time():
    t, kind = yardstick.bound_ms(3.35e9, 1.0)
    assert kind == "bytes" and t == pytest.approx(1.0)
    t, kind = yardstick.bound_ms(1.0, 67e9)
    assert kind == "operations" and t == pytest.approx(1.0)
    assert yardstick.fwd_bytes(10, 2, 4, 16, 16) == 5 * 4 + 40 + 96 + 12 + 256 * 28
    assert yardstick.bwd_bytes(10, 2, 4, 16, 16, True) - yardstick.fwd_bytes(10, 2, 4, 16, 16) \
        == 400
    assert yardstick.route_bound(100, 10)[1] == "bytes"


def test_reference_render_alpha_is_one_minus_transmittance():
    W = H = 16
    r = rows(24, W, H, 4)[:, :10]
    a = r.clone()
    radius = torch.full((24,), 20, dtype=torch.int64)
    img, dep, alp, pairs = reference.render(a, radius, W, H, torch.zeros(3))
    assert pairs > 0 and float(alp.min()) >= 0 and float(alp.max()) <= 1
