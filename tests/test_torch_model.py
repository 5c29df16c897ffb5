"""The PyTorch port's model, PLY persistence and `render_model` against the
JAX package on the CPU: the slice as a whole (model loaded -> projection ->
binning -> compositing -> image/depth/alpha)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scgaussian_tpu.core.cameras import Camera as JCamera
from scgaussian_tpu.model import io as jio
from scgaussian_tpu.model.gaussians import GaussianModel as JModel
from scgaussian_tpu.model.gaussians import GaussianParams
from scgaussian_tpu.train.main_stage import render_model as j_render_model
from scgaussian_tpu_torch.core.cameras import Camera as TCamera
from scgaussian_tpu_torch.model import io as tio
from scgaussian_tpu_torch.model.gaussians import (
    BUFFER_NAMES, PARAM_NAMES, STAT_NAMES, model_from_numpy,
)
from scgaussian_tpu_torch.train.main_stage import render_model as t_render_model
from test_torch_core import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)
from time_limits import per_test_limit  # noqa: F401 (autouse: a time limit for each test)

W, H = 64, 48
NUM_RAY, NUM_ALIVE, CAPACITY = 150, 40, 64


def hybrid_leaves(seed=0, active_sh_degree=3):
    """150 ray Gaussians + 40 alive of 64 background slots, SH degree 3
    with every band non-zero; dead slots hold random values too."""
    rng = np.random.default_rng(seed)
    rayd = np.stack([rng.uniform(-0.35, 0.35, NUM_RAY), rng.uniform(-0.3, 0.3, NUM_RAY),
                     np.ones(NUM_RAY)], -1)
    rayd /= np.linalg.norm(rayd, axis=-1, keepdims=True)

    def block(n, prefix=""):
        return {
            prefix + "f_dc": rng.uniform(-1.5, 1.5, (n, 1, 3)),
            prefix + "f_rest": rng.normal(size=(n, 15, 3)) * 0.1,
            prefix + "scaling": rng.uniform(-3.0, -1.5, (n, 3)),
            prefix + "rotation": rng.normal(size=(n, 4)),
            prefix + "opacity": rng.uniform(-1.0, 2.0, (n, 1)),
        }

    leaves = dict(
        zval=rng.uniform(2.0, 6.0, (NUM_RAY, 1)),
        rayo=rng.normal(size=(NUM_RAY, 3)) * 0.02,
        rayd=rayd,
        bg_xyz=np.stack([rng.uniform(-1.5, 1.5, CAPACITY), rng.uniform(-1, 1, CAPACITY),
                         rng.uniform(3, 8, CAPACITY)], -1),
        **block(NUM_RAY),
        **block(CAPACITY, "bg_"),
    )
    leaves = {k: np.asarray(v, np.float32) for k, v in leaves.items()}
    alive = np.zeros(CAPACITY, bool)
    alive[rng.choice(CAPACITY, NUM_ALIVE, replace=False)] = True
    leaves["bg_alive"] = alive
    leaves["active_sh_degree"] = np.int32(active_sh_degree)
    return leaves


def jax_model(leaves):
    n = NUM_RAY + CAPACITY
    return JModel(
        params=GaussianParams(**{k: jnp.asarray(leaves[k]) for k in PARAM_NAMES}),
        rayo=jnp.asarray(leaves["rayo"]),
        rayd=jnp.asarray(leaves["rayd"]),
        bg_alive=jnp.asarray(leaves["bg_alive"]),
        active_sh_degree=jnp.int32(leaves["active_sh_degree"]),
        xyz_gradient_accum=jnp.zeros((n, 1)),
        denom=jnp.zeros((n, 1)),
        max_radii2d=jnp.zeros((n,)),
        max_sh_degree=3,
        spatial_lr_scale=1.0,
    )


def jax_leaves(model):
    leaves = {f.name: np.asarray(getattr(model.params, f.name))
              for f in dataclasses.fields(GaussianParams)}
    for name in BUFFER_NAMES:
        leaves[name] = np.asarray(getattr(model, name))
    return leaves


def cameras(i=0):
    R = np.eye(3)
    T = np.array([0.05 * i, -0.03 * i, 0.0])
    return (JCamera.create(R, T, 0.8, 0.7, W, H),
            TCamera.create(R, T, 0.8, 0.7, W, H, device="cpu"))


def assert_render_close(port, ref, tol=2e-5, dtol=1e-4):
    np.testing.assert_allclose(port.render.detach().numpy(), np.asarray(ref.render), atol=tol)
    np.testing.assert_allclose(port.rendered_depth.detach().numpy(),
                               np.asarray(ref.rendered_depth), atol=dtol)
    np.testing.assert_allclose(port.rendered_alpha.detach().numpy(),
                               np.asarray(ref.rendered_alpha), atol=tol)
    np.testing.assert_array_equal(port.radii.numpy(), np.asarray(ref.radii))
    np.testing.assert_array_equal(port.visibility_filter.numpy(),
                                  np.asarray(ref.visibility_filter))


# ---------------- model ----------------

@pytest.mark.parametrize("active", [0, 1, 3])
def test_model_getters_match_jax(active):
    leaves = hybrid_leaves(1, active)
    j = jax_model(leaves)
    t = model_from_numpy(jax_leaves(j), 3, device="cpu")
    assert (t.num_ray, t.bg_capacity, t.total) == (j.num_ray, j.bg_capacity, j.total)
    assert sorted(n for n, _ in t.named_parameters()) == sorted(PARAM_NAMES)
    assert sorted(n for n, _ in t.named_buffers()) == sorted(BUFFER_NAMES + STAT_NAMES)
    for getter in ("get_xyz", "get_scaling", "get_rotation", "get_opacity_raw",
                   "alive_mask", "get_opacity", "get_features", "get_covariance"):
        np.testing.assert_allclose(getattr(t, getter)().detach().numpy(),
                                   np.asarray(getattr(j, getter)()),
                                   rtol=1e-6, atol=1e-6, err_msg=getter)


def test_model_from_numpy_rejects_missing_leaves():
    leaves = hybrid_leaves()
    del leaves["rayd"]
    with pytest.raises(ValueError, match="rayd"):
        model_from_numpy(leaves, 3, device="cpu")


# ---------------- the slice as a whole ----------------

@pytest.mark.parametrize("view", [0, 1])
def test_render_model_matches_jax(view):
    """Port render_model (tile path; its plain version on the CPU) against
    JAX render_model with the oracle backend, on a model carried across
    with model_from_numpy."""
    j = jax_model(hybrid_leaves(3))
    t = model_from_numpy(jax_leaves(j), 3, device="cpu")
    jcam, tcam = cameras(view)
    bg = np.float32([0.1, 0.2, 0.3])
    ref = j_render_model(jcam, j, jnp.asarray(bg), backend="oracle")
    out = t_render_model(tcam, t, torch.tensor(bg))
    assert float(out.rendered_alpha.detach().mean()) > 0.1  # the scene covers the view
    assert_render_close(out, ref)
    assert_render_close(t_render_model(tcam, t, torch.tensor(bg), backend="oracle"), ref)


@pytest.mark.parametrize("flag", ["convert_shs_python", "compute_cov3d_python"])
def test_render_model_debug_paths_match_jax(flag):
    j = jax_model(hybrid_leaves(4, 2))
    t = model_from_numpy(jax_leaves(j), 3, device="cpu")
    jcam, tcam = cameras()
    ref = j_render_model(jcam, j, jnp.zeros(3), backend="oracle", **{flag: True})
    assert_render_close(t_render_model(tcam, t, torch.zeros(3), **{flag: True}), ref)


def test_render_model_gradients_reach_the_parameters():
    t = model_from_numpy(hybrid_leaves(5), 3, device="cpu")
    _, tcam = cameras()
    out = t_render_model(tcam, t, torch.zeros(3))
    (out.render.sum() + out.rendered_depth.mean()).backward()
    for name in ("zval", "f_dc", "f_rest", "scaling", "rotation", "opacity", "bg_xyz"):
        g = getattr(t, name).grad
        assert g is not None and bool(torch.isfinite(g).all()), name
        assert float(g.abs().max()) > 0, name


def test_default_device_is_the_gpu(monkeypatch, tmp_path):
    """Without a GPU nothing renders on the CPU unless asked: the entry
    points raise instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    leaves = hybrid_leaves(6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_render_model(TCamera.create(np.eye(3), np.zeros(3), 0.8, 0.7, W, H),
                       model_from_numpy(leaves, 3), torch.zeros(3))
    path = str(tmp_path / "point_cloud" / "point_cloud.ply")
    tio.save_ply(model_from_numpy(leaves, 3, device="cpu"), path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.load_ply(path, 3, bg_capacity=CAPACITY)


# ---------------- PLY ----------------

def _same_leaves(a, b):
    for name in PARAM_NAMES + BUFFER_NAMES:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_ply_from_jax_loads_in_port(tmp_path):
    j = jax_model(hybrid_leaves(7))
    path = str(tmp_path / "jax" / "point_cloud.ply")
    jio.save_ply(j, path)
    t = tio.load_ply(path, 3, bg_capacity=CAPACITY, device="cpu")
    j_back = jio.load_ply(path, 3, bg_capacity=CAPACITY)
    port = {n: getattr(t, n).detach().numpy() for n in PARAM_NAMES + BUFFER_NAMES}
    _same_leaves(port, jax_leaves(j_back))
    assert int(t.active_sh_degree) == 3 and int(t.bg_alive.sum()) == NUM_ALIVE


def test_ply_from_port_loads_in_jax(tmp_path):
    t = model_from_numpy(hybrid_leaves(8), 3, device="cpu")
    path = str(tmp_path / "port" / "point_cloud.ply")
    tio.save_ply(t, path)
    for name in ("point_cloud.ply", "point_cloud_bg.ply", "point_cloud_color.ply"):
        assert (tmp_path / "port" / name).exists()
    j = jio.load_ply(path, 3, bg_capacity=CAPACITY)
    t_back = tio.load_ply(path, 3, bg_capacity=CAPACITY, device="cpu")
    port = {n: getattr(t_back, n).detach().numpy() for n in PARAM_NAMES + BUFFER_NAMES}
    _same_leaves(port, jax_leaves(j))
    # alive rows come back first, in slot order; fg rows unchanged
    alive = t.bg_alive.numpy()
    np.testing.assert_array_equal(port["bg_xyz"][:NUM_ALIVE], t.bg_xyz.detach().numpy()[alive])
    np.testing.assert_array_equal(port["zval"], t.zval.detach().numpy())


def test_ply_files_match_byte_for_byte(tmp_path):
    leaves = hybrid_leaves(9)
    jio.save_ply(jax_model(leaves), str(tmp_path / "j" / "point_cloud.ply"))
    tio.save_ply(model_from_numpy(leaves, 3, device="cpu"), str(tmp_path / "t" / "point_cloud.ply"))
    for name in ("point_cloud.ply", "point_cloud_bg.ply", "point_cloud_color.ply"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name


def test_load_ply_rejects_small_capacity(tmp_path):
    path = str(tmp_path / "m" / "point_cloud.ply")
    tio.save_ply(model_from_numpy(hybrid_leaves(10), 3, device="cpu"), path)
    with pytest.raises(ValueError, match="capacity"):
        tio.load_ply(path, 3, bg_capacity=NUM_ALIVE - 1, device="cpu")
