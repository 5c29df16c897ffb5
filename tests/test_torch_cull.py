"""The compositing kernels' cull (`raster.entry_cull_rect`, the plain twin
of `cull_entry` in scgaussian_tpu_torch/csrc/raster_common.cuh).

A pair is live when power <= 0 and alpha >= 1/255 by `raster_fwd_plain`'s
arithmetic. The cull may skip only dead pairs: no live pixel lies outside an
entry's rect, and no live pair has power below the entry's threshold for
skipping expf. Held on the JAX suite's small scenes and on an adversarial
set of rows (opacity at the 1/255 edge, needles, conics that are not
positive definite); and the plain versions' warp-entry counts add up to
their pair counts."""

import math

import numpy as np
import pytest
import torch

from scgaussian_tpu_torch.renderer import binning as tbinning
from scgaussian_tpu_torch.renderer import project as tproject
from scgaussian_tpu_torch.renderer import raster
from scgaussian_tpu_torch.renderer.oracle import ALPHA_MAX, ALPHA_MIN
from test_torch_core import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)
from time_limits import per_test_limit  # noqa: F401 (autouse: a time limit for each test)
from test_torch_render import CASES, cotangents

ALPHA_MIN_F32 = float(np.float32(ALPHA_MIN))


def live_pairs(attrs: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """(live [N, P], power [N, P]) of every row against every pixel centre,
    with raster_fwd_plain's arithmetic."""
    a = attrs
    dx = a[:, 0:1] - px[None]
    dy = a[:, 1:2] - py[None]
    power = -0.5 * (a[:, 2:3] * dx * dx + a[:, 4:5] * dy * dy) - a[:, 3:4] * dx * dy
    alpha = torch.clamp(a[:, 5:6] * torch.exp(power), max=ALPHA_MAX)
    return (power <= 0.0) & (alpha >= ALPHA_MIN), power


def assert_cull_keeps_live(attrs: torch.Tensor, width: int, height: int) -> dict:
    """No live pair outside its row's rect or below its threshold. Returns
    the number of live pairs and of pairs the rect culls."""
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32),
                            torch.arange(width, dtype=torch.float32), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    live, power = live_pairs(attrs, px, py)
    rect, thr = raster.entry_cull_rect(attrs)
    inside = ((px[None].double() >= rect[:, 0:1]) & (px[None].double() <= rect[:, 1:2])
              & (py[None].double() >= rect[:, 2:3]) & (py[None].double() <= rect[:, 3:4]))
    assert int((live & ~inside).sum()) == 0, "a live pair lies outside its rect"
    assert int((live & (power < thr[:, None])).sum()) == 0, "the expf shortcut skips a live pair"
    return {"live": int(live.sum()), "culled": int((~inside).sum()),
            "shortcut": int((power < thr[:, None]).sum())}


@pytest.mark.parametrize("case", list(CASES))
def test_cull_keeps_every_live_pair_on_the_jax_scenes(case):
    (_, tcam), (means, scales, quats, opac, shs), _, _, _ = CASES[case]()
    t = torch.tensor
    proj = tproject.project(tcam, t(means), t(opac), scales=t(scales), rotations=t(quats),
                            shs=t(shs), active_sh_degree=3)
    attrs = raster.pack_attrs(proj)[proj.valid]
    got = assert_cull_keeps_live(attrs, tcam.width, tcam.height)
    assert got["live"] > 0 and got["culled"] > 0 and got["shortcut"] > 0, got


def conic_rows(n: int, rng, log_sigma, log_aspect, opacity) -> np.ndarray:
    """[n, 12] rows: means in a 64x48 image, conics of sigma exp(log_sigma)
    along one axis and exp(log_sigma - log_aspect) along the other, at
    angles of both signs."""
    rows = np.zeros((n, 12), np.float64)
    rows[:, 0] = rng.uniform(8, 56, n)
    rows[:, 1] = rng.uniform(6, 42, n)
    s1 = np.exp(rng.uniform(*log_sigma, n))
    s2 = s1 / np.exp(rng.uniform(*log_aspect, n))
    th = rng.uniform(-math.pi, math.pi, n)
    c, s = np.cos(th), np.sin(th)
    i1, i2 = 1 / s1**2, 1 / s2**2  # eigenvalues of the conic
    rows[:, 2] = c * c * i1 + s * s * i2
    rows[:, 3] = c * s * (i1 - i2)
    rows[:, 4] = s * s * i1 + c * c * i2
    rows[:, 5] = opacity(n)
    rows[:, 6:9] = rng.uniform(0, 1, (n, 3))
    rows[:, 9] = rng.uniform(2, 10, n)
    return rows


def boundary_rows(n: int, rng) -> np.ndarray:
    """[n, 12] rows whose 1/255 ellipse has its leftmost or rightmost point
    (half of them: top or bottom) on a pixel centre, in exact arithmetic:
    there the rounding alone decides whether the pair is live."""
    rows = np.zeros((n, 12), np.float64)
    op = rng.choice([ALPHA_MIN_F32 * (1 + 1e-3), 0.02, 0.3, 0.7, 0.99], n).astype(np.float32)
    r2 = 2 * np.log(op.astype(np.float64) / ALPHA_MIN_F32)
    dx = rng.integers(1, 13, n) * rng.choice([-1, 1], n)
    dy = rng.integers(-6, 7, n)
    cc = np.exp(rng.uniform(-3, 0, n))
    cb = -cc * dy / dx  # the x-extreme of q = d^T C d lies on d = (dx, dy)
    ca = cb**2 / cc * (1 + 10.0 ** rng.uniform(-3, 1, n)) + 1e-3 * cc
    scale = r2 / (ca * dx * dx + 2 * cb * dx * dy + cc * dy * dy)
    rows[:, 0] = rng.integers(16, 48, n) + dx  # mean = pixel + d
    rows[:, 1] = rng.integers(12, 36, n) + dy
    rows[:, 2], rows[:, 3], rows[:, 4] = ca * scale, cb * scale, cc * scale
    rows[:, 5] = op
    rows[:, 6:9] = rng.uniform(0, 1, (n, 3))
    rows[:, 9] = rng.uniform(2, 10, n)
    swap = np.arange(n) % 2 == 1  # the top or bottom point instead
    rows[swap] = rows[swap][:, [1, 0, 4, 3, 2, 5, 6, 7, 8, 9, 10, 11]]
    rows[swap, 0] += 8  # keep the means inside a 64x48 image
    rows[swap, 1] -= 8
    return rows


def adversarial_rows(kind: str) -> torch.Tensor:
    rng = np.random.default_rng({"opacity_edge": 0, "needles": 1, "near_singular": 2,
                                 "not_positive_definite": 3, "boundary": 4}[kind])
    n = 600
    if kind == "boundary":
        rows = boundary_rows(n, rng)
    elif kind == "opacity_edge":  # 1/255 (1 +- 1e-6), 1/255 itself, 0.99, 1
        edge = np.array([ALPHA_MIN_F32 * (1 - 1e-6), ALPHA_MIN_F32, ALPHA_MIN_F32 * (1 + 1e-6),
                         ALPHA_MIN_F32 * (1 + 1e-3), 0.99, 1.0])
        rows = conic_rows(n, rng, (0.0, 2.5), (0.0, 1.0), lambda m: rng.choice(edge, m))
    elif kind == "needles":  # axis ratios up to 1:1000
        rows = conic_rows(n, rng, (1.0, 3.0), (math.log(30), math.log(1000)),
                          lambda m: rng.choice([ALPHA_MIN_F32 * (1 + 1e-6), 0.05, 0.5, 0.99], m))
    else:
        rows = conic_rows(n, rng, (0.5, 2.5), (0.0, 2.0), lambda m: rng.uniform(0.02, 0.99, m))
        ca, cc = rows[:, 2], rows[:, 4]
        sign = rng.choice([-1.0, 1.0], n)
        if kind == "near_singular":  # det -> 0+: cb^2 = ca cc (1 - eps)
            eps = 10.0 ** rng.uniform(-8, -3, n)
            rows[:, 3] = sign * np.sqrt(ca * cc * (1 - eps))
        else:  # det <= 0, or a conic axis <= 0
            rows[: n // 2, 3] = sign[: n // 2] * np.sqrt(ca * cc)[: n // 2] * rng.uniform(
                1.0, 1.5, n // 2)
            rows[n // 2:, 2] = -np.abs(rows[n // 2:, 2])
    return torch.tensor(rows.astype(np.float32))


@pytest.mark.parametrize("kind", ["boundary", "opacity_edge", "needles", "near_singular",
                                  "not_positive_definite"])
def test_cull_keeps_every_live_pair_on_adversarial_rows(kind):
    attrs = adversarial_rows(kind)
    got = assert_cull_keeps_live(attrs, 64, 48)
    assert got["live"] > 0, got
    rect, thr = raster.entry_cull_rect(attrs)
    op = attrs[:, 5]
    dead = op < ALPHA_MIN
    # opacity below 1/255 is dead everywhere: an empty rect, every pair skipped
    assert bool((rect[dead, 0] > rect[dead, 1]).all()) and bool(torch.isinf(thr[dead]).all())
    det = attrs[:, 2].double() * attrs[:, 4].double() - attrs[:, 3].double() ** 2
    if kind == "not_positive_definite":  # never culled
        assert bool(((det <= 0) | (attrs[:, 2] <= 0)).all())
        assert bool(torch.isinf(rect[~dead]).all())
    if kind == "opacity_edge":  # round enough splats: the rect hugs the live box
        ca, cb, cc = (attrs[:, i].double() for i in (2, 3, 4))
        lnr = torch.log(op.double() / ALPHA_MIN_F32)
        hx = torch.sqrt(2 * lnr.clamp(min=0) * cc / det)
        width = rect[:, 1] - rect[:, 0]
        assert bool((width[~dead] <= 2 * hx[~dead] + 1.01).all())


@pytest.mark.parametrize("case", ["seed2_n200", "opaque_early_stop"])
def test_warp_entry_counts_add_up(case):
    """The plain versions' warp-entry counts: the pairs in visited
    warp-entries with a live pair, without one, and culled add up to the
    pair counts; culled warp-entries hold no live pair; the per-entry
    backward counts as the atomic one does."""
    (_, tcam), (means, scales, quats, opac, shs), bg, _, _ = CASES[case]()
    t = torch.tensor
    proj = tproject.project(tcam, t(means), t(opac), scales=t(scales), rotations=t(quats),
                            shs=t(shs), active_sh_degree=3)
    W, H = tcam.width, tcam.height
    bins = tbinning.bin_gaussians(proj, W, H)
    attrs = raster.pack_attrs(proj)
    bg = torch.tensor(bg, dtype=torch.float32)
    fwd = {}
    _, _, _, T, last = raster.raster_fwd_plain(bins, attrs, bg, W, H, stats=fwd)
    assert fwd["live_warp_pairs"] + fwd["dead_warp_pairs"] + fwd["culled_pairs"] == fwd["pairs"]
    assert fwd["live_warp_entries"] + fwd["culled_warp_entries"] <= fwd["warp_entries"]
    assert fwd["culled_warp_entries"] > 0 and fwd["live_warp_entries"] > 0, fwd

    args = (bins, attrs, bg, T, last, *cotangents(W, H, ("color", "depth")), W, H)
    bwd, ent = {}, {}
    raster.raster_bwd_plain(*args, stats=bwd)
    raster.raster_bwd_entries_plain(*args, stats=ent)
    assert bwd == ent
    pairs = bwd["live_pairs"] + bwd["faint_pairs"] + bwd["far_pairs"]
    assert bwd["live_warp_pairs"] + bwd["dead_warp_pairs"] + bwd["culled_pairs"] == pairs
    assert bwd["live_warp_entries"] + bwd["culled_warp_entries"] <= bwd["warp_entries"]
    assert bwd["culled_pairs"] <= bwd["faint_pairs"] + bwd["far_pairs"]
    assert bwd["culled_warp_entries"] > 0 and bwd["live_warp_entries"] > 0, bwd
    # the warps' footprints tile the tile: a warp-entry is visited when one
    # of its 64 pixels needs the entry
    assert bwd["warp_entries"] <= 4 * int((bins.tile_starts[1:] - bins.tile_starts[:-1]).sum())
