"""The PyTorch port's renderer (projection, binning, compositing, oracle)
against the JAX package on the CPU.

The JAX tile path runs its Pallas kernels in interpret mode, as
tests/test_tile_raster.py runs them. The port's tile path on CPU tensors
runs the CUDA kernels' plain PyTorch versions (the forward, and the
hand-derived backward through `raster.RasterizeFn`, by either route); the
kernels themselves are held against those plain versions on the card (the
`cuda`-marked tests here, and chip_smoke.py)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scgaussian_tpu.core.cameras import Camera as JCamera
from scgaussian_tpu.renderer import binning as jbinning
from scgaussian_tpu.renderer import oracle as joracle
from scgaussian_tpu.renderer import project as jproject
from scgaussian_tpu.config import RasterizerConfig as JRasterizerConfig
from scgaussian_tpu.renderer import render as jrender
from scgaussian_tpu.renderer import tile_raster as jtile_raster
from scgaussian_tpu_torch.config import RasterizerConfig as TRasterizerConfig
from scgaussian_tpu_torch.core.cameras import Camera as TCamera
from scgaussian_tpu_torch.renderer import binning as tbinning
from scgaussian_tpu_torch.renderer import oracle as toracle
from scgaussian_tpu_torch.renderer import project as tproject
from scgaussian_tpu_torch.renderer import raster
from scgaussian_tpu_torch.renderer import render as trender
from test_oracle_renderer import _rotmat, make_scene  # tests/ is on sys.path under pytest
from test_torch_core import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

PROJ_FIELDS = ("mean2d", "depth", "conic", "color", "opacity", "radius", "valid", "ext")


def cameras(width, height, fov=0.8, R=np.eye(3), T=np.zeros(3), fovy=None):
    fovy = fov if fovy is None else fovy
    return (
        JCamera.create(R, T, fovx=fov, fovy=fovy, width=width, height=height),
        TCamera.create(R, T, fovx=fov, fovy=fovy, width=width, height=height, device="cpu"),
    )


def scene_np(n, seed, **kw):
    return tuple(np.asarray(a) for a in make_scene(n=n, seed=seed, **kw))


def opaque_scene():
    """tests/test_tile_raster.py:44-65: heavy occlusion, the 1e-4 stop."""
    n = 64
    rng = np.random.default_rng(5)
    means = np.stack(
        [rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n), rng.uniform(2, 6, n)], axis=-1
    ).astype(np.float32)
    scales = np.full((n, 3), 0.3, np.float32)
    quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    opac = np.full((n,), 0.97, np.float32)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0] = rng.uniform(-0.5, 0.5, (n, 3))
    return means, scales, quats, opac, shs


def rotated_case():
    """tests/test_oracle_renderer.py:324-341: rotated + translated camera."""
    Rw2c = _rotmat([1.0, 0.5, -0.3], -0.35)
    T = np.array([0.1, 0.2, -0.3])
    _, scales, quats, opac, shs = scene_np(48, 21, z_range=(2.5, 7.0))
    rng = np.random.default_rng(5)
    cam_pts = np.stack(
        [rng.uniform(-1, 1, 48), rng.uniform(-0.8, 0.8, 48), rng.uniform(2.5, 7, 48)], -1
    )
    means = ((cam_pts - T) @ np.linalg.inv(Rw2c).T).astype(np.float32)
    return cameras(64, 48, 0.85, Rw2c.T, T, fovy=0.65), (means, scales, quats, opac, shs)


# the forward cases of tests/test_tile_raster.py:28-78 plus the rotated camera
# (name, cameras, scene, bg, image/alpha tol, depth tol)
CASES = {
    "seed0_n16": lambda: (cameras(64, 48), scene_np(16, 0), [0.1, 0.2, 0.3], 2e-5, 1e-4),
    "seed1_n64": lambda: (cameras(64, 48), scene_np(64, 1), [0.1, 0.2, 0.3], 2e-5, 1e-4),
    "seed2_n200": lambda: (cameras(64, 48), scene_np(200, 2), [0.1, 0.2, 0.3], 2e-5, 1e-4),
    "opaque_early_stop": lambda: (cameras(48, 48), opaque_scene(), [1.0, 1.0, 1.0], 5e-5, 1e-4),
    "nonsquare_50x35": lambda: (cameras(50, 35), scene_np(32, 3), [0.0, 0.0, 0.0], 2e-5, 1e-4),
    "rotated_camera": lambda: (*rotated_case(), [0.2, 0.1, 0.4], 2e-5, 1e-4),
}


@functools.lru_cache(maxsize=None)
def jax_outputs(case):
    """JAX oracle and JAX tile-path (Pallas, interpret mode) renders."""
    (jcam, _), (means, scales, quats, opac, shs), bg, _, _ = CASES[case]()
    outs = {}
    for backend in ("oracle", "tpu"):
        out = jrender(jcam, jnp.asarray(means), jnp.asarray(opac), jnp.asarray(bg, jnp.float32),
                      scales=jnp.asarray(scales), rotations=jnp.asarray(quats),
                      shs=jnp.asarray(shs), active_sh_degree=3, backend=backend)
        outs[backend] = {f.name: np.asarray(getattr(out, f.name)) for f in dataclasses.fields(out)}
    return outs


def port_render(case, backend="cuda"):
    (_, tcam), (means, scales, quats, opac, shs), bg, _, _ = CASES[case]()
    t = torch.tensor
    return trender(tcam, t(means), t(opac), t(bg, dtype=torch.float32), scales=t(scales),
                   rotations=t(quats), shs=t(shs), active_sh_degree=3, backend=backend)


@functools.lru_cache(maxsize=None)
def _jax_project(case):
    """The JAX projection of a forward case, computed once and compiled as
    one program: op by op it takes seconds, and a dozen tests read it."""
    (jcam, _), (means, scales, quats, opac, shs), _, _, _ = CASES[case]()

    def project(means, opac, scales, quats, shs):
        return jproject.project(jcam, means, opac, scales=scales, rotations=quats, shs=shs,
                                active_sh_degree=3)

    return jax.jit(project)(*(jnp.asarray(a) for a in (means, opac, scales, quats, shs)))


def project_both(case):
    """(JAX projection, port projection, port camera) of a forward case."""
    j = _jax_project(case)
    (_, tcam), (means, scales, quats, opac, shs), _, _, _ = CASES[case]()
    t = tproject.project(tcam, torch.tensor(means), torch.tensor(opac),
                         scales=torch.tensor(scales), rotations=torch.tensor(quats),
                         shs=torch.tensor(shs), active_sh_degree=3)
    return j, t, tcam


# ---------------- projection ----------------

@pytest.mark.parametrize("case", list(CASES))
def test_project_matches_jax(case):
    j, t, _ = project_both(case)
    for name in PROJ_FIELDS:
        a = getattr(t, name).detach().numpy()
        b = np.asarray(getattr(j, name))
        assert a.shape == b.shape, name
        if name in ("radius", "ext", "valid"):
            np.testing.assert_array_equal(a, b, err_msg=name)
            assert a.dtype == b.dtype, name
        else:
            scale = max(float(np.abs(b).max()), 1.0)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("case", ["seed2_n200", "nonsquare_50x35"])
def test_tile_rect_matches_jax(case):
    j, t, tcam = project_both(case)
    W, H = tcam.width, tcam.height
    for radius_y in (False, True):
        jr = jproject.tile_rect(j.mean2d, j.ext[:, 0] if radius_y else j.radius, W, H, 16,
                                radius_y=j.ext[:, 1] if radius_y else None)
        tr = tproject.tile_rect(t.mean2d, t.ext[:, 0] if radius_y else t.radius, W, H, 16,
                                radius_y=t.ext[:, 1] if radius_y else None)
        for a, b in zip(tr, jr):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_projection_culls_behind_near_plane():
    _, tcam = cameras(64, 48)
    proj = tproject.project(
        tcam, torch.tensor([[0.0, 0.0, 0.1], [0.0, 0.0, 3.0]]), torch.tensor([0.8, 0.8]),
        scales=torch.full((2, 3), 0.05), rotations=torch.tensor([[1.0, 0, 0, 0]] * 2),
        colors_precomp=torch.ones(2, 3),
    )
    assert proj.radius.tolist()[0] == 0 and not bool(proj.valid[0])
    assert proj.ext[0].tolist() == [0, 0] and bool(proj.valid[1])


# ---------------- binning ----------------

@pytest.mark.parametrize("case", list(CASES))
def test_binning_per_tile_lists_match_jax(case):
    j, t, tcam = project_both(case)
    W, H = tcam.width, tcam.height
    jb = jax.jit(lambda proj: jbinning.bin_gaussians(proj, W, H, 16, 1 << 14, ptile=16,
                                                     tile_cull=False))(j)
    assert int(jb.overflow) == 0
    tb = tbinning.bin_gaussians(t, W, H)
    num_tiles = tb.nx * tb.ny
    assert tb.tile_starts.shape == (num_tiles + 1,)
    assert tb.tile_starts.dtype == torch.int32 and tb.gauss_ids.dtype == torch.int32
    j_ids, j_starts, j_counts = (np.asarray(x) for x in (jb.orig_idx_sorted, jb.starts, jb.counts))
    t_ids, t_starts = tb.gauss_ids.numpy(), tb.tile_starts.numpy()
    for tile in range(num_tiles):
        want = j_ids[j_starts[tile]: j_starts[tile] + j_counts[tile]]
        got = t_ids[t_starts[tile]: t_starts[tile + 1]]
        np.testing.assert_array_equal(got, want, err_msg=f"tile {tile}")
    assert tb.num_entries == int(jb.total_entries)


def test_binning_with_nothing_visible():
    _, tcam = cameras(40, 24)
    proj = tproject.project(
        tcam, torch.tensor([[0.0, 0.0, -3.0]]), torch.tensor([0.8]),
        scales=torch.full((1, 3), 0.05), rotations=torch.tensor([[1.0, 0, 0, 0]]),
        colors_precomp=torch.ones(1, 3),
    )
    bins = tbinning.bin_gaussians(proj, 40, 24)
    assert bins.num_entries == 0 and (bins.nx, bins.ny) == (3, 2)
    assert bins.tile_starts.tolist() == [0] * 7
    out = trender(tcam, torch.tensor([[0.0, 0.0, -3.0]]), torch.tensor([0.8]),
                  torch.tensor([0.2, 0.4, 0.6]), scales=torch.full((1, 3), 0.05),
                  rotations=torch.tensor([[1.0, 0, 0, 0]]), colors_precomp=torch.ones(1, 3))
    np.testing.assert_array_equal(out.render[:, 3, 5].numpy(), np.float32([0.2, 0.4, 0.6]))
    assert float(out.rendered_alpha.abs().max()) == 0.0


# ---------------- compositing ----------------

@pytest.mark.parametrize("case", list(CASES))
def test_tile_path_matches_jax(case):
    """The port's tile path (CUDA kernel's plain version on the CPU) against
    the JAX oracle and the JAX Pallas tile path."""
    *_, tol, dtol = CASES[case]()
    out = port_render(case)
    assert int(out.overflow) == 0
    for backend, ref in jax_outputs(case).items():
        np.testing.assert_allclose(out.render.numpy(), ref["render"], atol=tol, err_msg=backend)
        np.testing.assert_allclose(out.rendered_depth.numpy(), ref["rendered_depth"], atol=dtol,
                                   err_msg=backend)
        np.testing.assert_allclose(out.rendered_alpha.numpy(), ref["rendered_alpha"], atol=tol,
                                   err_msg=backend)
        np.testing.assert_array_equal(out.radii.numpy(), ref["radii"])
        np.testing.assert_array_equal(out.visibility_filter.numpy(), ref["visibility_filter"])


@pytest.mark.parametrize("case", ["seed1_n64", "opaque_early_stop"])
def test_plain_outputs_consistent(case):
    """T and the last contributor of the plain version: alpha == 1 - T, and
    a pixel with a contributor has T < 1."""
    _, t, tcam = project_both(case)
    W, H = tcam.width, tcam.height
    bins = tbinning.bin_gaussians(t, W, H)
    attrs = raster.pack_attrs(t)
    color, depth, alpha, T, last = raster.raster_fwd(bins, attrs, torch.zeros(3), W, H)
    assert color.shape == (3, H, W) and last.dtype == torch.int32
    assert torch.equal(alpha, 1.0 - T)
    assert bool(((last > 0) == (T < 1.0)).all())
    counts = (bins.tile_starts[1:] - bins.tile_starts[:-1]).reshape(bins.ny, bins.nx)
    per_pixel = counts.repeat_interleave(16, 0).repeat_interleave(16, 1)[:H, :W]
    assert bool((last <= per_pixel).all())


def test_raster_checks_its_inputs():
    _, t, tcam = project_both("seed0_n16")
    bins = tbinning.bin_gaussians(t, 64, 48)
    attrs = raster.pack_attrs(t)
    with pytest.raises(ValueError, match="grid"):
        raster.raster_fwd(bins, attrs, torch.zeros(3), 80, 48)
    with pytest.raises(ValueError, match="attrs"):
        raster.raster_fwd(bins, attrs[:, :10].contiguous(), torch.zeros(3), 64, 48)
    with pytest.raises(ValueError, match="float32"):
        raster.raster_fwd(bins, attrs.double(), torch.zeros(3), 64, 48)
    with pytest.raises(ValueError, match="tile"):
        raster.rasterize(t, 64, 48, torch.zeros(3), tile=8)
    with pytest.raises(ValueError, match="backend"):
        port_render("seed0_n16", backend="tpu")


def gradients_case():
    """tests/test_tile_raster.py:81-109: opacities below the 0.99 cap."""
    jcam, tcam = cameras(48, 32)
    return jcam, tcam, scene_np(24, 9, opacity_range=(0.3, 0.8))


@functools.lru_cache(maxsize=None)
def _jax_oracle_grads(tile, deg):
    """JAX oracle loss and gradients of gradients_case, computed once."""
    jcam, _, arrays = gradients_case()
    return _jax_grads(jcam, arrays, "oracle", tile, deg)


def _jax_grads(jcam, arrays, backend, tile, deg):
    bg = jnp.asarray([0.3, 0.3, 0.3])
    target = jnp.ones((3, jcam.height, jcam.width)) * 0.5

    def loss(means, scales, quats, opac, shs):
        out = jrender(jcam, means, opac, bg, scales=scales, rotations=quats, shs=shs,
                      active_sh_degree=deg, backend=backend, tile=tile)
        return (jnp.mean((out.render - target) ** 2) + 0.05 * jnp.mean(out.rendered_depth)
                + 0.05 * jnp.mean(out.rendered_alpha))

    args = tuple(jnp.asarray(a) for a in arrays)
    # compiled as one program: op by op, the smooth oracle's gradient took ~20 s
    value, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4)))(*args)
    return float(value), grads


def _port_grads(tcam, arrays, backend, tile, deg):
    bg = torch.tensor([0.3, 0.3, 0.3])
    target = torch.ones(3, tcam.height, tcam.width) * 0.5
    args = [torch.tensor(a, requires_grad=True) for a in arrays]
    means, scales, quats, opac, shs = args
    out = trender(tcam, means, opac, bg, scales=scales, rotations=quats, shs=shs,
                  active_sh_degree=deg, backend=backend, tile=tile)
    loss = (torch.mean((out.render - target) ** 2) + 0.05 * torch.mean(out.rendered_depth)
            + 0.05 * torch.mean(out.rendered_alpha))
    loss.backward()
    return float(loss.detach()), [a.grad for a in args]


@pytest.mark.parametrize(
    "port_backend,jax_backend,tile,deg",
    [("oracle", "oracle", 0, 3), ("oracle", "oracle", 16, 2), ("cuda", "oracle", 16, 2)],
    ids=["oracle_smooth", "oracle_tiled", "tile_path_autograd"],
)
def test_gradients_match_jax(port_backend, jax_backend, tile, deg):
    """Autograd through the port's oracle (smooth tile=0 variant and the
    tiled one) and through the tile path's plain version on the CPU,
    against JAX autodiff of the oracle."""
    _, tcam, arrays = gradients_case()
    assert jax_backend == "oracle"
    l_j, g_j = _jax_oracle_grads(tile, deg)
    l_t, g_t = _port_grads(tcam, arrays, port_backend, tile, deg)
    assert abs(l_j - l_t) < 1e-6
    for name, a, b in zip(["means", "scales", "quats", "opac", "shs"], g_j, g_t):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, atol=5e-4 * (np.abs(a).max() + 1e-8),
                                   err_msg=name)


@pytest.mark.parametrize("case", ["seed1_n64", "opaque_early_stop", "rotated_camera"])
def test_oracle_forward_matches_jax(case):
    *_, tol, dtol = CASES[case]()
    j, t, tcam = project_both(case)
    bg = np.asarray(CASES[case]()[2], np.float32)
    jo = joracle.composite_dense(j, tcam.width, tcam.height, jnp.asarray(bg))
    to = toracle.composite_dense(t, tcam.width, tcam.height, torch.tensor(bg))
    for a, b, tl in zip(to, jo, (tol, dtol, tol)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=tl)
    order_j = np.asarray(joracle.depth_order(j.depth, j.valid))
    np.testing.assert_array_equal(toracle.depth_order(t.depth, t.valid).numpy(), order_j)


def test_mean2d_offset_reaches_the_plain_tile_path():
    (_, tcam), (means, scales, quats, opac, shs), *_ = CASES["seed0_n16"]()
    off = torch.zeros(16, 2, requires_grad=True)
    out = trender(tcam, torch.tensor(means), torch.tensor(opac), torch.zeros(3),
                  scales=torch.tensor(scales), rotations=torch.tensor(quats),
                  shs=torch.tensor(shs), active_sh_degree=0, mean2d_offset=off)
    (out.render ** 2).sum().backward()
    assert bool(torch.isfinite(off.grad).all()) and float(off.grad.abs().max()) > 0


# ---------------- backward ----------------

GRAD_GROUPS = {"mean2d": (0, 2), "conic": (2, 5), "opacity": (5, 6), "rgb": (6, 9),
               "depth": (9, 10)}


def cotangents(width, height, which, seed=0):
    """Random cotangents of (color, depth, alpha); those not in `which` are 0."""
    rng = np.random.default_rng(seed)
    shapes = {"color": (3, height, width), "depth": (height, width), "alpha": (height, width)}
    return [torch.tensor(rng.normal(size=shapes[k]).astype(np.float32)) if k in which
            else torch.zeros(shapes[k]) for k in ("color", "depth", "alpha")]


def assert_grad_groups(got, want, rel, msg=""):
    """Per column group of d_attrs: max abs error <= rel * max|want|."""
    for name, (lo, hi) in GRAD_GROUPS.items():
        a, b = got[:, lo:hi], want[:, lo:hi]
        tol = rel * float(b.abs().max())
        assert float((a - b).abs().max()) <= tol, f"{msg} {name}"
    assert float(got[:, 10:].abs().max()) == 0.0


@pytest.mark.parametrize("which", [("color",), ("depth",), ("alpha",), ("color", "depth", "alpha")],
                         ids=["color", "depth", "alpha", "all"])
@pytest.mark.parametrize("case", ["seed2_n200", "opaque_early_stop"])
def test_plain_backward_matches_autograd(case, which):
    """raster_bwd_plain (hand-derived) against autograd of raster_fwd_plain
    on the same bins. Opacities are below the 0.99 cap, where the two
    conventions agree. Tolerance 1e-5 * max|g| per column group: the same
    arithmetic, summed in another order."""
    _, t, tcam = project_both(case)
    W, H = tcam.width, tcam.height
    bg = torch.tensor(CASES[case]()[2], dtype=torch.float32)
    bins = tbinning.bin_gaussians(t, W, H)
    attrs = raster.pack_attrs(t).detach().requires_grad_()
    gC, gD, gA = cotangents(W, H, which)
    color, depth, alpha, T, last = raster.raster_fwd_plain(bins, attrs, bg, W, H)
    loss = (color * gC).sum() + (depth * gD).sum() + (alpha * gA).sum()
    (want,) = torch.autograd.grad(loss, attrs)
    got = raster.raster_bwd(bins, attrs.detach(), bg, T.detach(), last, gC, gD, gA, W, H)
    assert got.shape == (attrs.shape[0], raster.ATTR_WIDTH)
    assert_grad_groups(got, want, 1e-5, f"{case} {which}")
    if case == "opaque_early_stop":  # the 1e-4 stop leaves entries without gradient
        assert bool((T.min() < 1e-3) and (last < (bins.tile_starts[1:] - bins.tile_starts[:-1]).max()).any())


@pytest.mark.parametrize("case", ["seed2_n200", "opaque_early_stop"])
def test_plain_backward_pair_counts(case):
    """The backward's work counts (what its bound prices) against a direct
    count, tile by tile, of the (pixel, entry) pairs before each pixel's last
    contributor: live, faint (power <= 0, alpha < 1/255) and far (power > 0)."""
    _, t, tcam = project_both(case)
    W, H = tcam.width, tcam.height
    bg = torch.tensor(CASES[case]()[2], dtype=torch.float32)
    bins = tbinning.bin_gaussians(t, W, H)
    attrs = raster.pack_attrs(t)
    _, _, _, T, last = raster.raster_fwd_plain(bins, attrs, bg, W, H)
    stats = {}
    raster.raster_bwd_plain(bins, attrs, bg, T, last, *cotangents(W, H, ("color",)), W, H,
                            stats=stats)

    want = {"live_pairs": 0, "faint_pairs": 0, "far_pairs": 0}
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    for tile in range(bins.nx * bins.ny):
        y0, x0 = (tile // bins.nx) * 16, (tile % bins.nx) * 16
        px, py = xs[y0:y0 + 16, x0:x0 + 16].reshape(-1), ys[y0:y0 + 16, x0:x0 + 16].reshape(-1)
        lt = last[y0:y0 + 16, x0:x0 + 16].reshape(-1)
        ids = bins.gauss_ids[int(bins.tile_starts[tile]):int(bins.tile_starts[tile + 1])].long()
        a = attrs[ids]  # [count, 12]
        dx, dy = a[:, 0:1] - px, a[:, 1:2] - py
        power = -0.5 * (a[:, 2:3] * dx * dx + a[:, 4:5] * dy * dy) - a[:, 3:4] * dx * dy
        alpha = torch.clamp(a[:, 5:6] * torch.exp(power), max=0.99)
        before = torch.arange(len(ids))[:, None] < lt  # [count, pixels]
        near = before & (power <= 0)
        live = near & (alpha >= 1 / 255)
        want["live_pairs"] += int(live.sum())
        want["faint_pairs"] += int((near & ~live).sum())
        want["far_pairs"] += int((before & ~near).sum())
    assert {k: stats[k] for k in want} == want
    assert sum(want.values()) == int(last.sum()) and want["live_pairs"] > 0


def test_rasterize_function_uses_the_hand_backward():
    """Through RasterizeFn the gradient is raster_bwd's, also for bg."""
    _, t, tcam = project_both("seed1_n64")
    W, H = tcam.width, tcam.height
    bins = tbinning.bin_gaussians(t, W, H)
    attrs = raster.pack_attrs(t).detach().requires_grad_()
    bg = torch.tensor([0.1, 0.2, 0.3], requires_grad=True)
    gC, gD, gA = cotangents(W, H, ("color", "depth", "alpha"), seed=1)
    color, depth, alpha = raster.RasterizeFn.apply(attrs, bg, bins, W, H)
    g_attrs, g_bg = torch.autograd.grad(
        (color * gC).sum() + (depth * gD).sum() + (alpha * gA).sum(), (attrs, bg))
    with torch.no_grad():
        _, _, _, T, last = raster.raster_fwd(bins, attrs, bg, W, H)
        want = raster.raster_bwd(bins, attrs, bg, T, last, gC, gD, gA, W, H)
    assert torch.equal(g_attrs, want)
    torch.testing.assert_close(g_bg, (gC * T).sum((1, 2)), rtol=1e-6, atol=1e-6)


def test_mean2d_offset_gradient_matches_jax():
    """d loss / d mean2d_offset through the tile path (hand backward)
    against JAX oracle autodiff, at 5e-4 * max|g|."""
    jcam, tcam, (means, scales, quats, opac, shs) = gradients_case()
    n = means.shape[0]
    bg = np.float32([0.3, 0.3, 0.3])
    target = np.full((3, tcam.height, tcam.width), 0.5, np.float32)

    def jloss(off):
        out = jrender(jcam, jnp.asarray(means), jnp.asarray(opac), jnp.asarray(bg),
                      scales=jnp.asarray(scales), rotations=jnp.asarray(quats),
                      shs=jnp.asarray(shs), active_sh_degree=2, mean2d_offset=off,
                      backend="oracle")
        return (jnp.mean((out.render - target) ** 2) + 0.05 * jnp.mean(out.rendered_depth)
                + 0.05 * jnp.mean(out.rendered_alpha))

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.zeros((n, 2), jnp.float32)))
    off = torch.zeros(n, 2, requires_grad=True)
    out = trender(tcam, torch.tensor(means), torch.tensor(opac), torch.tensor(bg),
                  scales=torch.tensor(scales), rotations=torch.tensor(quats),
                  shs=torch.tensor(shs), active_sh_degree=2, mean2d_offset=off)
    loss = (torch.mean((out.render - torch.tensor(target)) ** 2)
            + 0.05 * torch.mean(out.rendered_depth) + 0.05 * torch.mean(out.rendered_alpha))
    (got,) = torch.autograd.grad(loss, off)
    assert float(np.abs(want).max()) > 0
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4 * np.abs(want).max())


def test_backward_ignores_the_alpha_cap():
    """One Gaussian whose opacity * G exceeds 0.99 near its centre gets the
    uncapped d_opacity of the JAX tile kernel (tile_raster.py:816-819):
    d_op = sum over its live pixels of d_alpha * G, where for a lone
    Gaussian d_alpha = g_color . c + g_depth d - (g_color . bg - g_alpha).
    Autograd of the oracle (the min(0.99, .) clamp) instead gives those
    capped pixels nothing."""
    _, tcam = cameras(48, 32)
    W, H = tcam.width, tcam.height
    args = dict(scales=torch.full((1, 3), 0.3), rotations=torch.tensor([[1.0, 0.0, 0.0, 0.0]]),
                colors_precomp=torch.tensor([[0.8, 0.4, 0.2]]))
    means = torch.tensor([[0.05, -0.03, 3.0]])
    bg = torch.tensor([0.1, 0.2, 0.3])
    gC, gD, gA = cotangents(W, H, ("color", "depth", "alpha"), seed=3)

    def d_opacity(backend):
        op = torch.tensor([0.998], requires_grad=True)
        out = trender(tcam, means, op, bg, backend=backend, **args)
        loss = ((out.render * gC).sum() + (out.rendered_depth[0] * gD).sum()
                + (out.rendered_alpha[0] * gA).sum())
        return float(torch.autograd.grad(loss, op)[0])

    proj = tproject.project(tcam, means, torch.tensor([0.998]), **args)
    bins = tbinning.bin_gaussians(proj, W, H)
    tiles_hit = torch.zeros(bins.ny * bins.nx, dtype=torch.bool)
    tiles_hit[(bins.tile_starts[1:] - bins.tile_starts[:-1]) > 0] = True
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    in_rect = tiles_hit.reshape(bins.ny, bins.nx).repeat_interleave(16, 0).repeat_interleave(
        16, 1)[:H, :W]
    (mx, my), (ca, cb, cc), o = proj.mean2d[0], proj.conic[0], proj.opacity[0]
    dx, dy = mx - xs, my - ys
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    G = torch.exp(power)
    alpha_pre = o * G
    live = in_rect & (power <= 0) & (torch.clamp(alpha_pre, max=0.99) >= 1 / 255)
    capped = live & (alpha_pre > 0.99)
    assert int(capped.sum()) > 0  # the cap is reached
    d_alpha = ((gC * proj.color[0][:, None, None]).sum(0) + gD * proj.depth[0]
               - ((gC * bg[:, None, None]).sum(0) - gA))
    uncapped = float((d_alpha * G)[live].sum())
    clamped = float((d_alpha * G)[live & ~capped].sum())
    assert abs(uncapped - clamped) > 1e-2 * abs(uncapped)
    assert d_opacity("cuda") == pytest.approx(uncapped, rel=1e-4, abs=1e-5)
    assert d_opacity("oracle") == pytest.approx(clamped, rel=1e-4, abs=1e-5)


# ---------------- segment sum and the route by sort ----------------

def _segsum_reference(keys, vals, n):
    """The JAX suite's numpy reference (tests/test_tile_raster.py:488-494):
    per-key sums of rows, keys sorted, key n the sentinel."""
    out = np.zeros((n, vals.shape[1]), np.float64)
    for k, v in zip(keys, vals):
        if k < n:
            out[k] += v
    return out.astype(np.float32)


SEG_B = 1024  # the JAX kernel's block (tile_raster.SEG_B)
SEG_N = 2200  # keys 0..2199; key 2200 is the sentinel


def segsum_layouts(cols=10):
    """The four adversarial key layouts of
    tests/test_tile_raster.py::test_segsum_mxu_kernel_adversarial over
    4 * 1024 rows, rebuilt in numpy: a run over three whole blocks; dense
    runs crossing block boundaries with a sentinel suffix; sparse keys
    jumping close to the JAX kernel's window; one key per block. Values are
    normal ([4096, cols]), NaN on the sentinel rows."""
    rng = np.random.default_rng(3)
    n, L = SEG_N, 4 * SEG_B
    layouts = {
        "deep_run": np.sort(np.concatenate([
            np.full(SEG_B // 2, 7), np.full(2 * SEG_B + SEG_B // 2, 8), np.full(SEG_B, n)])),
    }
    k = np.sort(rng.integers(0, 900, 3 * SEG_B + 17))
    layouts["dense_suffix"] = np.concatenate([k, np.full(L - k.size, n)])
    base = np.sort(rng.choice(np.arange(0, SEG_B + 192 - 8, 13), 40, replace=False))
    layouts["sparse_jumps"] = np.sort(np.concatenate([
        rng.choice(base, 2 * SEG_B), base + 960, np.full(L - 2 * SEG_B - base.size, n)]))
    layouts["one_key_per_block"] = np.repeat(np.asarray([3, 3, 1700, n]), SEG_B)
    out = {}
    for name, keys in layouts.items():
        keys = keys.astype(np.int32)
        assert keys.shape == (L,) and np.all(np.diff(keys) >= 0)
        vals = rng.normal(size=(L, cols)).astype(np.float32)
        vals[keys == n] = np.nan
        out[name] = (keys, vals)
    return out


@pytest.mark.parametrize("layout", ["deep_run", "dense_suffix", "sparse_jumps",
                                    "one_key_per_block"])
def test_segsum_plain_adversarial(layout):
    """segsum (its plain version on the CPU) against the numpy reference
    of the JAX suite: absent keys 0, NaN sentinel rows ignored. 2e-6 *
    (max|ref| + 1): float32 sums of up to 3,072 rows in another order."""
    keys, vals = segsum_layouts()[layout]
    ref = _segsum_reference(keys, np.where(np.isnan(vals), 0, vals), SEG_N)
    got = raster.segsum(torch.tensor(keys), torch.tensor(vals), SEG_N)
    assert got.shape == (SEG_N, 10) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6 * (np.abs(ref).max() + 1))
    absent = np.setdiff1d(np.arange(SEG_N), keys)
    assert float(got[torch.tensor(absent)].abs().max()) == 0.0


def test_segsum_plain_matches_jax_kernel():
    """segsum against the JAX kernel `_segsum_sorted_mxu` (interpret mode,
    as test_segsum_mxu_kernel_adversarial runs it) on the dense layout, at
    the JAX test's 2e-5 * (max + 1)."""
    keys, vals = segsum_layouts()["dense_suffix"]
    keys2d = keys.reshape(-1, SEG_B)
    valsT16 = np.zeros((16, keys.size), np.float32)
    valsT16[:10] = vals.T
    want = np.asarray(jax.jit(jtile_raster._segsum_sorted_mxu, static_argnums=3)(
        jnp.asarray(keys2d), jnp.asarray((keys2d[:, 0] // 8) * 8), jnp.asarray(valsT16),
        SEG_N))[:SEG_N, :10]
    got = raster.segsum(torch.tensor(keys), torch.tensor(vals), SEG_N).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * (np.abs(want).max() + 1))


def test_segsum_checks_its_inputs():
    keys, vals = torch.zeros(4, dtype=torch.int32), torch.zeros(4, 10)
    with pytest.raises(ValueError, match="int32"):
        raster.segsum(keys.long(), vals, 3)
    with pytest.raises(ValueError, match="columns"):
        raster.segsum(keys, torch.zeros(4, 17), 3)
    with pytest.raises(ValueError, match="vals"):
        raster.segsum(keys, torch.zeros(5, 10), 3)
    assert raster.segsum(keys[:0], vals[:0], 3).abs().sum() == 0


@pytest.mark.parametrize("budget", [None, 1 << 19, 1 << 20])
@pytest.mark.parametrize("size", [(1920, 1080), (3840, 2160), (4112, 2160), (64, 48)])
def test_sort_route_follows_the_jax_rule(size, budget):
    """The route decision against JAX's rule: an entry budget (given, or
    default_entry_budget(n, resolved_ptile // 16)) of at least
    SORT_ROUTE_MIN_L. Below 4096 px the default flips above 262,144 slots."""
    W, H = size
    jcfg = JRasterizerConfig(entry_budget=budget)
    tcfg = TRasterizerConfig(entry_budget=budget)
    assert tcfg.resolved_ptile(W, H) == jcfg.resolved_ptile(W, H)
    for n in (106_384, 262_144, 262_145, 515_536):
        want = (budget or jbinning.default_entry_budget(
            n, jcfg.resolved_ptile(W, H) // 16)) >= jtile_raster.SORT_ROUTE_MIN_L
        assert raster.sort_route(n, W, H, tcfg) == want, n
        assert tbinning.default_entry_budget(n, 2) == jbinning.default_entry_budget(n, 2)
    if budget is None and W < 4096:
        assert not raster.sort_route(262_144, W, H, tcfg) and raster.sort_route(262_145, W, H, tcfg)


def test_gaussian_major_order_without_a_second_sort():
    """The bins' Gaussian-major keys are sorted, and reordering the sorted
    entries by `order` gives back those keys: the route needs no sort."""
    _, t, tcam = project_both("seed2_n200")
    bins = tbinning.bin_gaussians(t, tcam.width, tcam.height)
    assert bool((bins.gmaj_ids[1:] >= bins.gmaj_ids[:-1]).all())
    back = raster.gaussian_major(bins, bins.gauss_ids[:, None].float())[:, 0]
    assert torch.equal(back.int(), bins.gmaj_ids)
    assert torch.equal(bins.gmaj_ids[bins.order], bins.gauss_ids)


@pytest.mark.parametrize("case", ["seed2_n200", "opaque_early_stop"])
def test_per_entry_backward_sums_to_the_atomic_one(case):
    """raster_bwd_entries (rows in Gaussian-major order), summed per
    Gaussian, is raster_bwd: 1e-6 * max|g| per column group (the same
    terms, summed in another order)."""
    _, t, tcam = project_both(case)
    W, H = tcam.width, tcam.height
    bg = torch.tensor(CASES[case]()[2], dtype=torch.float32)
    bins = tbinning.bin_gaussians(t, W, H)
    attrs = raster.pack_attrs(t)
    _, _, _, T, last = raster.raster_fwd(bins, attrs, bg, W, H)
    cots = cotangents(W, H, ("color", "depth", "alpha"), seed=2)
    entries = raster.raster_bwd_entries(bins, attrs, bg, T, last, *cots, W, H)
    assert entries.shape == (bins.num_entries, raster.NUM_GRADS)
    atomic = raster.raster_bwd(bins, attrs, bg, T, last, *cots, W, H)
    summed = torch.zeros(attrs.shape[0], raster.ATTR_WIDTH)
    summed[:, :10].index_add_(0, bins.gmaj_ids.long(), entries)
    assert_grad_groups(summed, atomic, 1e-6, case)
    routed = raster.route_by_sort(bins, entries, attrs.shape[0])
    assert_grad_groups(routed, atomic, 1e-6, case)
    # entries past every pixel's last contributor (sorted slots) get nothing
    unreached = torch.ones(bins.num_entries, dtype=torch.bool)
    starts = bins.tile_starts[:-1].long()
    for tile in range(bins.nx * bins.ny):
        y0, x0 = (tile // bins.nx) * 16, (tile % bins.nx) * 16
        reach = int(last[y0:y0 + 16, x0:x0 + 16].max()) if last[y0:y0 + 16, x0:x0 + 16].numel() else 0
        unreached[starts[tile]:starts[tile] + reach] = False
    assert float(entries[bins.order[unreached]].abs().sum()) == 0.0


ROUTE_BY_SORT = raster.route_by_sort  # the real one, for the spies below


def test_sort_route_matches_atomic_route(monkeypatch):
    """Through RasterizeFn on seed2_n200 with SORT_ROUTE_MIN_L at 0 (as
    tests/test_tile_raster.py:479 forces it in JAX): the sort route's d_attrs
    against the atomic route's within 1e-6 * max|g| per column group, and
    the route is really taken."""
    _, t, tcam = project_both("seed2_n200")
    W, H = tcam.width, tcam.height
    bins = tbinning.bin_gaussians(t, W, H)
    attrs = raster.pack_attrs(t).detach()
    bg = torch.tensor([0.1, 0.2, 0.3])
    cots = cotangents(W, H, ("color", "depth", "alpha"), seed=4)

    def grads(by_sort):
        a = attrs.clone().requires_grad_()
        color, depth, alpha = raster.RasterizeFn.apply(a, bg, bins, W, H, by_sort)
        loss = (color * cots[0]).sum() + (depth * cots[1]).sum() + (alpha * cots[2]).sum()
        return torch.autograd.grad(loss, a)[0]

    calls = []
    monkeypatch.setattr(raster, "route_by_sort",
                        lambda *a: calls.append(1) or ROUTE_BY_SORT(*a))
    atomic = grads(False)
    assert not calls
    by_sort = grads(True)
    assert calls
    assert_grad_groups(by_sort, atomic, 1e-6, "sort vs atomic")
    monkeypatch.setattr(raster, "SORT_ROUTE_MIN_L", 0)
    assert raster.sort_route(attrs.shape[0], W, H, TRasterizerConfig())



def test_sort_route_gradients_match_jax(monkeypatch):
    """The tile path's gradients with the backward routed by sort
    (SORT_ROUTE_MIN_L at 0) against JAX autodiff of the oracle, at the
    5e-4 * max|g| of test_gradients_match_jax."""
    calls = []
    monkeypatch.setattr(raster, "SORT_ROUTE_MIN_L", 0)
    monkeypatch.setattr(raster, "route_by_sort", lambda *a: calls.append(1) or ROUTE_BY_SORT(*a))
    _, tcam, arrays = gradients_case()
    l_j, g_j = _jax_oracle_grads(16, 2)
    l_t, g_t = _port_grads(tcam, arrays, "cuda", 16, 2)
    assert calls == [1]
    assert abs(l_j - l_t) < 1e-6
    for name, a, b in zip(["means", "scales", "quats", "opac", "shs"], g_j, g_t):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, atol=5e-4 * (np.abs(a).max() + 1e-8),
                                   err_msg=name)


# ---------------- on the card ----------------

@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA kernels against their plain versions on the same bins: the
    forward exactly where it decides thresholds, the backward per column
    group within 1e-5 * max|g| (atomics change the order of the sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    (_, tcam), (means, scales, quats, opac, shs), bg, tol, dtol = CASES["seed2_n200"]()
    cam = tcam.to("cuda")
    with torch.no_grad():
        proj = tproject.project(cam, *(torch.tensor(a, device="cuda") for a in (means, opac)),
                                scales=torch.tensor(scales, device="cuda"),
                                rotations=torch.tensor(quats, device="cuda"),
                                shs=torch.tensor(shs, device="cuda"), active_sh_degree=3)
        bins = tbinning.bin_gaussians(proj, cam.width, cam.height)
        attrs = raster.pack_attrs(proj)
        bg_t = torch.tensor(bg, dtype=torch.float32, device="cuda")
        before = dict(raster.LAUNCHES)
        k = raster.raster_fwd(bins, attrs, bg_t, cam.width, cam.height)
        torch.cuda.synchronize()
        assert raster.LAUNCHES["raster_fwd"] == before["raster_fwd"] + 1
        p = raster.raster_fwd_plain(bins, attrs, bg_t, cam.width, cam.height)
        for a, b, tl in zip(k[:4], p[:4], (tol, dtol, tol, tol)):
            torch.testing.assert_close(a, b, atol=tl, rtol=0)
        assert torch.equal(k[4], p[4])

        cots = [c.cuda() for c in cotangents(cam.width, cam.height, ("color", "depth", "alpha"))]
        T, last = k[3], k[4]
        kb = raster.raster_bwd(bins, attrs, bg_t, T, last, *cots, cam.width, cam.height)
        torch.cuda.synchronize()
        assert raster.LAUNCHES["raster_bwd"] == before["raster_bwd"] + 1
        pb = raster.raster_bwd_plain(bins, attrs, bg_t, T, last, *cots, cam.width, cam.height)
    assert_grad_groups(kb, pb, 1e-5, "kernel vs plain")
    # the kernel's outputs carry no history: a differentiable call must go
    # through RasterizeFn, so raster_fwd refuses one under grad mode
    with pytest.raises(ValueError, match="differentiable"):
        raster.raster_fwd(bins, attrs.clone().requires_grad_(), bg_t, cam.width, cam.height)


@pytest.mark.cuda
def test_cuda_segsum_matches_plain():
    """The segment-sum kernel against segsum_plain on the adversarial
    layouts: within 1e-5 * (max|plain| + 1) per column (index_add_ sums in
    another order on the card), and two launches bitwise equal (no atomics,
    a fixed order). At the route's width (10 columns) on every layout, and
    at 3 and 16 columns (the kernel's instance for other widths) on two."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    cases = list(segsum_layouts().items())
    for cols in (3, 16):
        layouts = segsum_layouts(cols)
        cases += [(f"{name}@c={cols}", layouts[name]) for name in ("deep_run", "sparse_jumps")]
    for name, (keys, vals) in cases:
        k = torch.tensor(keys, device="cuda")
        v = torch.tensor(vals, device="cuda")
        before = raster.LAUNCHES["segsum"]
        a = raster.segsum(k, v, SEG_N)
        b = raster.segsum(k, v, SEG_N)
        torch.cuda.synchronize()
        assert raster.LAUNCHES["segsum"] == before + 2
        p = raster.segsum_plain(k, v, SEG_N)
        assert torch.equal(a, b), name
        tol = 1e-5 * (p.abs().amax(0) + 1)
        assert bool(((a - p).abs() <= tol).all()), name


@pytest.mark.cuda
def test_cuda_route_matches_plain():
    """The segment-sum kernel's route form (`route_by_sort`: the runs
    `gmaj_starts` of the per-entry rows, which the backward stores in
    Gaussian-major order) against its plain version on seed2_n200: within
    1e-5 * (max|plain| + 1) per column, the padding columns zero, two
    launches bitwise equal, one launch counted each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    (_, tcam), (means, scales, quats, opac, shs), bg, _, _ = CASES["seed2_n200"]()
    cam = tcam.to("cuda")
    with torch.no_grad():
        proj = tproject.project(cam, *(torch.tensor(a, device="cuda") for a in (means, opac)),
                                scales=torch.tensor(scales, device="cuda"),
                                rotations=torch.tensor(quats, device="cuda"),
                                shs=torch.tensor(shs, device="cuda"), active_sh_degree=3)
        bins = tbinning.bin_gaussians(proj, cam.width, cam.height)
        attrs = raster.pack_attrs(proj)
        bg_t = torch.tensor(bg, dtype=torch.float32, device="cuda")
        _, _, _, T, last = raster.raster_fwd(bins, attrs, bg_t, cam.width, cam.height)
        cots = [c.cuda() for c in cotangents(cam.width, cam.height, ("color", "depth", "alpha"))]
        d_gmaj = raster.raster_bwd_entries(bins, attrs, bg_t, T, last, *cots, cam.width,
                                           cam.height)
        n = attrs.shape[0]
        before = raster.LAUNCHES["segsum"]
        a = raster.route_by_sort(bins, d_gmaj, n)
        b = raster.route_by_sort(bins, d_gmaj, n)
        torch.cuda.synchronize()
        assert raster.LAUNCHES["segsum"] == before + 2
        p = raster.segsum_runs_plain(bins.gmaj_starts, d_gmaj, n, raster.ATTR_WIDTH)
    assert a.shape == (n, raster.ATTR_WIDTH) and torch.equal(a, b)
    assert float(a[:, raster.NUM_GRADS:].abs().max()) == 0.0
    assert bool(((a - p).abs() <= 1e-5 * (p.abs().amax(0) + 1)).all())


@pytest.mark.cuda
def test_cuda_sort_route_matches_atomic_route():
    """On the card, seed2_n200: RasterizeFn's sort route (per-entry kernel
    storing Gaussian-major, then the segment-sum kernel's route form)
    against the atomic route within 1e-5 * max|g| per column group (atomics
    reorder the latter's sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    (_, tcam), (means, scales, quats, opac, shs), bg, _, _ = CASES["seed2_n200"]()
    cam = tcam.to("cuda")
    with torch.no_grad():
        proj = tproject.project(cam, *(torch.tensor(a, device="cuda") for a in (means, opac)),
                                scales=torch.tensor(scales, device="cuda"),
                                rotations=torch.tensor(quats, device="cuda"),
                                shs=torch.tensor(shs, device="cuda"), active_sh_degree=3)
        bins = tbinning.bin_gaussians(proj, cam.width, cam.height)
        attrs = raster.pack_attrs(proj)
    bg_t = torch.tensor(bg, dtype=torch.float32, device="cuda")
    cots = [c.cuda() for c in cotangents(cam.width, cam.height, ("color", "depth", "alpha"))]

    def grads(by_sort):
        a = attrs.clone().requires_grad_()
        color, depth, alpha = raster.RasterizeFn.apply(a, bg_t, bins, cam.width, cam.height,
                                                       by_sort)
        loss = (color * cots[0]).sum() + (depth * cots[1]).sum() + (alpha * cots[2]).sum()
        return torch.autograd.grad(loss, a)[0]

    before = dict(raster.LAUNCHES)
    atomic = grads(False)
    by_sort = grads(True)
    torch.cuda.synchronize()
    assert raster.LAUNCHES["segsum"] == before["segsum"] + 1
    assert raster.LAUNCHES["raster_bwd"] == before["raster_bwd"] + 2
    assert_grad_groups(by_sort, atomic, 1e-5, "sort vs atomic")
