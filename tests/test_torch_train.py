"""The PyTorch port's main-stage training step and its parts (schedule,
Adam, densify statistics, DTU mask, learning rates) against the JAX package
on the CPU.

The JAX reference step runs with `backend="oracle"` (the dense renderer,
differentiated by JAX); the port's step runs its tile path, whose plain
versions on the CPU give the hand-derived backward of `raster_bwd`. The
model comes from JAX `create_model` on `tests/synthetic_scene.py` and is
carried across with `model_from_numpy` and `bundle_from_numpy`."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scgaussian_tpu import config as jconfig
from scgaussian_tpu.core.schedules import expon_lr as j_expon_lr
from scgaussian_tpu.model import densify as jdensify
from scgaussian_tpu.model.gaussians import create_model
from scgaussian_tpu.train import main_stage as jmain
from scgaussian_tpu.train import optim as joptim
from scgaussian_tpu_torch import config as tconfig
from scgaussian_tpu_torch.core.cameras import Camera as TCamera
from scgaussian_tpu_torch.core.schedules import expon_lr as t_expon_lr
from scgaussian_tpu_torch.model import densify as tdensify
from scgaussian_tpu_torch.model.gaussians import (
    BUFFER_NAMES, PARAM_NAMES, STAT_NAMES, model_from_numpy,
)
from scgaussian_tpu_torch.model.matches import bundle_from_numpy
from scgaussian_tpu_torch.train import main_stage as tmain
from scgaussian_tpu_torch.train import optim as toptim
from synthetic_scene import make_synthetic  # tests/ is on sys.path under pytest
from test_torch_core import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

B1 = 0.9


@pytest.fixture(scope="module")
def scene():
    return make_synthetic()


def logit(p):
    return np.log(p / (1.0 - p))


def jax_model(scene, seed=11):
    """`create_model` on the scene's matched rays at the true depth moved by
    a seeded +-5%, then 24 of 64 background slots made alive with random
    values, SH degree 1 active and non-zero densify statistics."""
    jb = scene["bundle"]
    pv = np.asarray(jb.pad_valid)
    pairs = [(i, j) for i in range(3) for j in range(3) if j != i]
    true_z = np.concatenate([scene["true_z"][p] for p in pairs])
    rng = np.random.default_rng(seed)
    z = (true_z * (1.0 + 0.05 * rng.uniform(-1, 1, true_z.shape))).astype(np.float32)
    m = create_model(np.asarray(jb.rays_o)[pv], np.asarray(jb.rays_d)[pv], z,
                     np.asarray(jb.color)[pv], 3, 1.0, bg_capacity=64)
    cb, nr = m.bg_capacity, m.num_ray
    alive = np.zeros(cb, bool)
    alive[rng.choice(cb, 24, replace=False)] = True
    f = np.float32
    params = dataclasses.replace(
        m.params,
        f_rest=jnp.asarray(rng.normal(size=(nr, 15, 3)).astype(f) * 0.05),
        bg_xyz=jnp.asarray(np.stack([rng.uniform(-1, 1, cb), rng.uniform(-0.8, 0.8, cb),
                                     rng.uniform(3.5, 6, cb)], -1).astype(f)),
        bg_f_dc=jnp.asarray(rng.uniform(-0.5, 0.5, (cb, 1, 3)).astype(f)),
        bg_f_rest=jnp.asarray(rng.normal(size=(cb, 15, 3)).astype(f) * 0.05),
        bg_scaling=jnp.asarray(np.log(rng.uniform(0.04, 0.1, (cb, 3))).astype(f)),
        bg_rotation=jnp.asarray(rng.normal(size=(cb, 4)).astype(f)),
        bg_opacity=jnp.asarray(logit(rng.uniform(0.3, 0.7, (cb, 1))).astype(f)),
    )
    n = m.total
    return dataclasses.replace(
        m, params=params, bg_alive=jnp.asarray(alive), active_sh_degree=jnp.int32(1),
        xyz_gradient_accum=jnp.asarray(rng.uniform(0, 1e-3, (n, 1)).astype(f)),
        denom=jnp.asarray(rng.integers(0, 3, (n, 1)).astype(f)),
        max_radii2d=jnp.asarray(rng.integers(0, 4, n).astype(f)),
    )


def port_model(jm):
    leaves = {name: np.asarray(getattr(jm.params, name)) for name in PARAM_NAMES}
    for name in BUFFER_NAMES + STAT_NAMES:
        leaves[name] = np.asarray(getattr(jm, name))
    return model_from_numpy(leaves, jm.max_sh_degree, device="cpu",
                            spatial_lr_scale=jm.spatial_lr_scale)


def port_bundle(jb):
    fields = {f.name: getattr(jb, f.name) for f in dataclasses.fields(jb)}
    return bundle_from_numpy({k: v if k in ("width", "height") else np.asarray(v)
                              for k, v in fields.items()}, device="cpu")


def port_camera(view):
    """tests/synthetic_scene.py's cameras."""
    ts = [np.array([0.0, 0, 0]), np.array([0.35, 0, 0]), np.array([0.0, 0.35, 0])]
    return TCamera.create(np.eye(3), ts[view], 0.9, 0.9, 64, 48, device="cpu")


# ---------------- parts ----------------

@pytest.mark.parametrize(
    "kw,steps",
    [
        (dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_mult=0.01, max_steps=2000),
         [0, 1, 7, 500, 1999, 2000, 5000]),
        (dict(lr_init=1e-2, lr_final=1e-4, lr_delay_steps=100, lr_delay_mult=0.1,
              max_steps=1000), [0, 1, 50, 99, 100, 101, 999]),
        (dict(lr_init=0.0, lr_final=0.0), [0, 10]),
        (dict(lr_init=1e-3, lr_final=1e-5), [-1, -5]),
    ],
    ids=["position", "delayed", "disabled", "negative_step"],
)
def test_expon_lr_matches_jax(kw, steps):
    j, t = j_expon_lr(**kw), t_expon_lr(**kw)
    for s in steps:
        got, want = t(s), float(j(s))
        assert isinstance(got, float)
        assert got == pytest.approx(want, rel=1e-6, abs=0.0), s


def test_adam_apply_matches_jax():
    """Two steps with per-leaf learning rates, then the moment surgery; at
    1e-6 relative (the same float32 arithmetic)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": (7, 1, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    lrs = {"a": 0.01, "b": 1.6e-4}
    jp, js = dict(params), joptim.init({k: jnp.asarray(v) for k, v in params.items()})
    tp, ts = {k: torch.tensor(v) for k, v in params.items()}, None
    ts = toptim.init(tp)
    for step in range(2):
        grads = {k: rng.normal(size=s).astype(np.float32) * 10 ** -step for k, s in shapes.items()}
        jp, js = joptim.apply({k: jnp.asarray(v) for k, v in jp.items()},
                              {k: jnp.asarray(v) for k, v in grads.items()}, js, lrs)
        tp, ts = toptim.apply(tp, {k: torch.tensor(v) for k, v in grads.items()}, ts, lrs)
    assert ts.count == int(js.count) == 2
    for k in shapes:
        for got, want in ((tp[k], jp[k]), (ts.m[k], js.m[k]), (ts.v[k], js.v[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)

    z = toptim.zero_moments_leaf(ts, "a")
    assert float(z.m["a"].abs().max()) == 0.0 and float(z.v["a"].abs().max()) == 0.0
    assert torch.equal(z.m["b"], ts.m["b"]) and z.count == ts.count
    mask = torch.tensor([True, False, True, False, False, True, False])
    r = toptim.zero_moments_rows(ts, {"b": mask})
    assert float(r.m["b"][mask].abs().max()) == 0.0
    assert torch.equal(r.v["b"][~mask], ts.v["b"][~mask]) and torch.equal(r.m["a"], ts.m["a"])


def test_update_stats_matches_jax(scene):
    jm = jax_model(scene, seed=3)
    tm = port_model(jm)
    rng = np.random.default_rng(4)
    radii = rng.integers(0, 5, jm.total).astype(np.int32)
    grad = rng.normal(size=(jm.total, 2)).astype(np.float32) * 1e-4
    ref = jdensify.update_stats(jm, jnp.asarray(radii), jnp.asarray(grad), 64, 48)
    out = tdensify.update_stats(tm, torch.tensor(radii), torch.tensor(grad), 64, 48)
    assert out is tm
    for name in STAT_NAMES:
        np.testing.assert_allclose(getattr(tm, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-9, err_msg=name)


def test_stats_buffers_and_oneup_sh_degree(scene):
    jm = jax_model(scene, seed=5)
    leaves = {name: np.asarray(getattr(jm.params, name)) for name in PARAM_NAMES}
    leaves.update({name: np.asarray(getattr(jm, name)) for name in BUFFER_NAMES})
    tm = model_from_numpy(leaves, 3, device="cpu")
    assert sorted(n for n, _ in tm.named_buffers()) == sorted(BUFFER_NAMES + STAT_NAMES)
    assert tm.xyz_gradient_accum.shape == (tm.total, 1) and tm.max_radii2d.shape == (tm.total,)
    assert float(tm.denom.abs().sum()) == 0.0
    for _ in range(3):
        jm = jm.oneup_sh_degree()
        assert tm.oneup_sh_degree() is tm
        assert int(tm.active_sh_degree) == int(jm.active_sh_degree)
    assert int(tm.active_sh_degree) == 3
    leaves["denom"] = np.zeros((tm.total + 1, 1), np.float32)
    with pytest.raises(ValueError, match="denom"):
        model_from_numpy(leaves, 3, device="cpu")


def test_dtu_background_mask_matches_jax():
    rng = np.random.default_rng(0)
    gt = rng.uniform(size=(3, 80, 12)).astype(np.float32)
    gt[:, :60] = 0.01
    gt[:, 20:23, 4] = 0.5  # a bright spot breaks the run below it
    for shift in (1, 7, 50):
        want = np.asarray(jmain.dtu_background_mask(jnp.asarray(gt), 30 / 255, shift))
        got = tmain.dtu_background_mask(torch.tensor(gt), 30 / 255, shift)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)


def test_lr_tree_matches_jax(scene):
    jm = jax_model(scene)
    cfg = jconfig.OptimizationConfig()
    for it in (1, 250, 1999):
        want = jmain.lr_tree(jm.params, cfg, 2.5, jnp.int32(it))
        got = tmain.lr_tree(tconfig.OptimizationConfig(), 2.5, it)
        assert set(got) == set(PARAM_NAMES)
        for name in PARAM_NAMES:
            assert got[name] == pytest.approx(float(getattr(want, name)), rel=1e-6), name
    assert got["bg_xyz"] == pytest.approx(cfg.position_lr_init * 2.5)  # never scheduled


# ---------------- one step ----------------

@pytest.mark.parametrize("is_dtu", [False, True], ids=["llff", "dtu"])
def test_train_step_matches_jax(scene, is_dtu):
    """One port train_step against JAX train_step(backend="oracle") from the
    same state: loss within 1e-5; Adam m within 5e-4 * max|m| and v within
    1e-3 * max|v| per leaf (the gradient-test tolerance of the tile path,
    squared for v); densify stats at 5e-4 * max of the accumulated norm
    (denom and max_radii2d exactly).

    After one Adam step from zero moments a parameter moves by about
    lr * sign(g), so where g sits at the noise floor the sign may differ
    between the packages and the parameter by 2 lr: parameters are compared
    (within 1e-6 * (1 + |p|)) only where |g_jax| > 1e-3 * max|g| of the leaf."""
    view, iteration = 1, 1
    jm = jax_model(scene)
    jb = scene["bundle"]
    extras = dict(dtu_shift_rows=8)
    jm2, jopt, jmet = jmain.train_step(
        jm, joptim.init(jm.params), jb, scene["cams"][view], scene["gts"][view],
        jnp.int32(view), jnp.int32(iteration), jnp.zeros(3), jconfig.OptimizationConfig(),
        extras=jconfig.TrainExtras(**extras), backend="oracle", is_dtu=is_dtu,
    )
    tm = port_model(jm)
    t_state = toptim.init({name: getattr(tm, name) for name in PARAM_NAMES})
    tm2, topt, tmet = tmain.train_step(
        tm, t_state, port_bundle(jb), port_camera(view),
        torch.tensor(np.asarray(scene["gts"][view])), view, iteration, torch.zeros(3),
        tconfig.OptimizationConfig(), extras=tconfig.TrainExtras(**extras), is_dtu=is_dtu,
    )
    assert tm2 is tm
    assert abs(float(tmet.loss) - float(jmet.loss)) < 1e-5
    assert abs(float(tmet.l1) - float(jmet.l1)) < 1e-5
    assert abs(float(tmet.match_loss) - float(jmet.match_loss)) < 1e-5
    assert int(tmet.num_visible) == int(jmet.num_visible) > 0
    assert topt.count == int(jopt.count) == 1

    firm_count = moved = 0
    for name in PARAM_NAMES:
        jmom, jvar = np.asarray(getattr(jopt.m, name)), np.asarray(getattr(jopt.v, name))
        np.testing.assert_allclose(topt.m[name].numpy(), jmom,
                                   atol=5e-4 * np.abs(jmom).max(), err_msg=f"m {name}")
        np.testing.assert_allclose(topt.v[name].numpy(), jvar,
                                   atol=1e-3 * np.abs(jvar).max(), err_msg=f"v {name}")
        g = np.abs(jmom) / (1 - B1)
        firm = g > 1e-3 * g.max() if g.max() > 0 else np.zeros(g.shape, bool)
        jp = np.asarray(getattr(jm2.params, name))
        tp = getattr(tm, name).detach().numpy()
        assert np.all(np.abs(tp[firm] - jp[firm]) <= 1e-6 * (1 + np.abs(jp[firm]))), name
        firm_count += int(firm.sum())
        moved += int((g > 0).sum())
    assert firm_count > 0.5 * moved  # most of the step is compared
    assert float(np.abs(np.asarray(jopt.m.zval)).max()) > 0  # the step reached the rays

    acc_j = np.asarray(jm2.xyz_gradient_accum)
    grown = acc_j - np.asarray(jm.xyz_gradient_accum)
    assert grown.max() > 0
    np.testing.assert_allclose(tm.xyz_gradient_accum.numpy(), acc_j, atol=5e-4 * grown.max())
    np.testing.assert_array_equal(tm.denom.numpy(), np.asarray(jm2.denom))
    np.testing.assert_array_equal(tm.max_radii2d.numpy(), np.asarray(jm2.max_radii2d))


def test_final_iteration_skips_the_update(scene):
    """At iteration == opt_cfg.iterations the parameters and the Adam state
    (count included) stay as they were (`train.py:203`); the densify stats
    still grow while iteration < densify_until_iter, and stop after."""
    jm = jax_model(scene, seed=8)
    tm = port_model(jm)
    bundle = port_bundle(scene["bundle"])
    gt = torch.tensor(np.asarray(scene["gts"][0]))
    state = toptim.init({name: getattr(tm, name) for name in PARAM_NAMES})
    cfg = tconfig.OptimizationConfig(iterations=3)
    tm, state, _ = tmain.train_step(tm, state, bundle, port_camera(0), gt, 0, 1,
                                    torch.zeros(3), cfg)
    assert state.count == 1
    before = {name: getattr(tm, name).detach().clone() for name in PARAM_NAMES}
    denom = tm.denom.clone()
    tm, after, metrics = tmain.train_step(tm, state, bundle, port_camera(0), gt, 0, 3,
                                          torch.zeros(3), cfg)
    assert after is state and after.count == 1
    for name in PARAM_NAMES:
        assert torch.equal(getattr(tm, name).detach(), before[name]), name
    assert bool(torch.isfinite(metrics.loss)) and float(tm.denom.sum()) > float(denom.sum())

    stop = tconfig.OptimizationConfig(iterations=3, densify_until_iter=3)
    denom = tm.denom.clone()
    tmain.train_step(tm, state, bundle, port_camera(0), gt, 0, 3, torch.zeros(3), stop)
    assert torch.equal(tm.denom, denom)
