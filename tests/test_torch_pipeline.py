"""The PyTorch port's two-stage pipeline and its parts (kNN, create_model,
the init stage and promotion, densify / prune / reset / capacity growth,
run_main_stage) against the JAX package on the CPU.

Inputs come from `tests/synthetic_scene.py` (64x48, exact matches) and numpy
seeds. Random draws do not match across frameworks, so the tests hand the
port JAX's z0, JAX's split normals and JAX's camera-stack seed. The JAX
main stage runs with `backend="oracle"` (the dense renderer, differentiated
by JAX); the port's runs its tile path, whose plain versions on the CPU
give the hand-derived backward."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scgaussian_tpu import config as jconfig
from scgaussian_tpu.model import densify as jdensify
from scgaussian_tpu.model import matches as jmatches
from scgaussian_tpu.model.gaussians import create_model as j_create_model
from scgaussian_tpu.model.knn import knn_mean_sq_dist as j_knn
from scgaussian_tpu.train import optim as joptim
from scgaussian_tpu.train import pipeline as jpipeline
from scgaussian_tpu_torch import config as tconfig
from scgaussian_tpu_torch.model import densify as tdensify
from scgaussian_tpu_torch.model import matches as tmatches
from scgaussian_tpu_torch.model.gaussians import (
    BUFFER_NAMES, PARAM_NAMES, STAT_NAMES, create_model as t_create_model,
)
from scgaussian_tpu_torch.model.knn import knn_mean_sq_dist as t_knn
from scgaussian_tpu_torch.train import optim as toptim
from scgaussian_tpu_torch.train import pipeline as tpipeline
from synthetic_scene import make_synthetic  # tests/ is on sys.path under pytest
from test_torch_train import jax_model, port_bundle, port_camera, port_model
from test_torch_core import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)
from time_limits import per_test_limit  # noqa: F401 (autouse: a time limit for each test)

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def synth():
    return make_synthetic()


def to_np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_models_equal(tm, jm, rtol=1e-6, atol=1e-7, stats=True):
    """Every parameter, buffer and (with `stats`) densify statistic."""
    assert tm.num_ray == jm.num_ray and tm.bg_capacity == jm.bg_capacity
    for name in PARAM_NAMES:
        np.testing.assert_allclose(to_np(getattr(tm, name)), np.asarray(getattr(jm.params, name)),
                                   rtol=rtol, atol=atol, err_msg=name)
    for name in BUFFER_NAMES + (STAT_NAMES if stats else ()):
        np.testing.assert_allclose(to_np(getattr(tm, name)), np.asarray(getattr(jm, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


# ---------------- kNN and create_model ----------------

def test_knn_mean_sq_dist_matches_jax():
    """3,000 points: three column blocks of 1,024, the last one ragged, with
    duplicate points. Tolerance: 1e-5 relative, plus 16 ulp of the largest
    squared norm absolute, the rounding floor of the |x|^2 + |y|^2 - 2 x.y
    form (JAX's dot rounds as an FMA chain, torch's CPU matmul otherwise)."""
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(3000, 3)) * 2).astype(np.float32)
    pts[11] = pts[10]
    pts[2999] = pts[5]  # a duplicate across blocks
    want = np.asarray(j_knn(jnp.asarray(pts), 3))
    got = t_knn(torch.tensor(pts), 3).numpy()
    assert got.shape == (3000,) and got.dtype == np.float32
    floor = 16 * EPS32 * float((pts.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=floor)
    assert got[10] == pytest.approx(want[10], abs=floor) and got[10] < got[12]


def test_create_model_matches_jax(synth):
    """`create_model` on the scene's matched rays, leaf by leaf: the
    squared scales exp(2 * log-scale), which are the kNN's mean squared
    distances, at the kNN test's tolerance; everything else exactly."""
    jb = synth["bundle"]
    pv = np.asarray(jb.pad_valid)
    rng = np.random.default_rng(1)
    rayo = np.asarray(jb.rays_o)[pv]
    rayd = np.asarray(jb.rays_d)[pv]
    z = rng.uniform(3.0, 5.0, rayo.shape[0]).astype(np.float32)
    color = np.asarray(jb.color)[pv]
    jm = j_create_model(rayo, rayd, z, color, 3, 2.5, bg_capacity=96)
    tm = t_create_model(rayo, rayd, z, color, 3, 2.5, bg_capacity=96, device="cpu")
    assert tm.spatial_lr_scale == 2.5 and tm.max_sh_degree == 3
    assert int(tm.active_sh_degree) == 0 and not bool(tm.bg_alive.any())
    for name in PARAM_NAMES:
        want = np.asarray(getattr(jm.params, name))
        got = to_np(getattr(tm, name))
        assert got.shape == want.shape, name
        if name == "scaling":
            pts = rayo + rayd * z[:, None]
            floor = 16 * EPS32 * float((pts.astype(np.float64) ** 2).sum(1).max())
            np.testing.assert_allclose(np.exp(2 * got.astype(np.float64)),
                                       np.exp(2 * want.astype(np.float64)),
                                       rtol=1e-5, atol=floor, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    for name in BUFFER_NAMES + STAT_NAMES:
        np.testing.assert_array_equal(to_np(getattr(tm, name)), np.asarray(getattr(jm, name)),
                                      err_msg=name)


# ---------------- init stage ----------------

def test_matchloss_from_base_matches_jax(synth):
    """Value and gradient with respect to z from random depths: 1e-6
    relative (the same float32 arithmetic; the projection's products may
    round in another order)."""
    jb = synth["bundle"]
    tb = port_bundle(jb)
    z0 = jmatches.init_zvals(jb, jax.random.key(4))
    (jl, je), jg = jax.value_and_grad(jmatches.matchloss_from_base, has_aux=True)(z0, jb)
    z = torch.tensor(np.asarray(z0), requires_grad=True)
    tl, te = tmatches.matchloss_from_base(z, tb)
    (tg,) = torch.autograd.grad(tl, z)
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-6)
    np.testing.assert_allclose(te.detach().numpy(), np.asarray(je), rtol=1e-5, atol=1e-7)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=1e-6 * np.abs(jg).max())


def test_init_zvals_draws_between_near_and_far(synth):
    tb = port_bundle(synth["bundle"])
    gen = torch.Generator().manual_seed(0)
    z = tmatches.init_zvals(tb, gen)
    assert z.shape == tb.mask.shape
    near, far = tb.near_far[:, 0:1], tb.near_far[:, 1:2]
    assert bool(((z >= near) & (z <= far)).all()) and float(z.std()) > 0.1
    again = tmatches.init_zvals(tb, torch.Generator().manual_seed(0))
    assert torch.equal(z, again)


def test_init_stage_and_promotion_match_jax(synth):
    """300 init iterations from JAX's z0. The final loss within 5%
    relative: at lr 0.5 (no drop before iteration 500) Adam keeps z
    oscillating around its optimum, so the loss of any one iteration
    carries the oscillation, and rounding differences in the projection
    move its phase. best_z within 1e-4 relative, min_err within 1e-6
    absolute.
    Promotion: matches whose min_err lies within 1e-5 of the 0.1 threshold
    could flip on the last bit and are excluded from the comparison
    (counted); the rest must be promoted alike, and the promoted arrays
    equal."""
    jb = synth["bundle"]
    tb = port_bundle(jb)
    z0 = jmatches.init_zvals(jb, jax.random.key(0))
    jr = jmatches.run_init_stage(jb, z0, iterations=300)
    tr = tmatches.run_init_stage(tb, torch.tensor(np.asarray(z0)), iterations=300)
    assert float(tr.final_loss) == pytest.approx(float(jr.final_loss), rel=5e-2)
    assert float(tr.final_loss) < 0.05  # converged: exact matches
    pv = np.asarray(jb.pad_valid)
    np.testing.assert_allclose(tr.best_z.numpy()[pv], np.asarray(jr.best_z)[pv], rtol=1e-4)
    np.testing.assert_allclose(tr.min_err.numpy()[pv], np.asarray(jr.min_err)[pv], atol=1e-6)

    edge = np.abs(np.asarray(jr.min_err) - 0.1) <= 1e-5
    excluded = int((edge & pv).sum())
    assert excluded == 0, f"{excluded} matches sit on the promotion threshold"
    want = jmatches.promote_matches(jb, np.asarray(jr.best_z), np.asarray(jr.min_err))
    got = tmatches.promote_matches(tb, tr.best_z, tr.min_err)
    assert got[0].shape[0] == want[0].shape[0] == int(pv.sum())
    for g, w, name in zip(got, want, ("rayo", "rayd", "zval", "color")):
        np.testing.assert_allclose(g, w, rtol=1e-4 if name == "zval" else 0, err_msg=name)


def test_setup_from_matches_matches_jax(synth):
    """The whole setup (init stage, promotion, create_model) from JAX's z0:
    the same ray Gaussians, depths within 1e-4 relative. The scales are not
    compared here: each match gives two rays to one point, so most kNN
    distances are between such twins and sit at their rounding floor, where
    depths 1e-4 apart move them by any factor; `create_model`'s own test
    holds them on identical inputs."""
    jb = synth["bundle"]
    key = jax.random.key(1)
    extras = dict(bg_capacity=64, init_iterations=300)
    jm, jr = jpipeline.setup_from_matches(jb, key, 3, 1.0, extras=jconfig.TrainExtras(**extras))
    z0 = torch.tensor(np.asarray(jmatches.init_zvals(jb, key)))
    tm, tr = tpipeline.setup_from_matches(port_bundle(jb), None, 3, 1.0,
                                          extras=tconfig.TrainExtras(**extras), z0=z0)
    assert tm.num_ray == jm.num_ray > 0 and tm.bg_capacity == 64
    np.testing.assert_allclose(to_np(tm.zval), np.asarray(jm.params.zval), rtol=1e-4)
    for name in ("f_dc", "rotation", "opacity", "bg_opacity"):
        np.testing.assert_array_equal(to_np(getattr(tm, name)),
                                      np.asarray(getattr(jm.params, name)), err_msg=name)
    np.testing.assert_array_equal(to_np(tm.rayo), np.asarray(jm.rayo))


# ---------------- densify, prune, reset, capacity ----------------

def densify_inputs(synth, seed):
    """A JAX model with random stats and bg slots (24 alive of 64), random
    Adam moments, an extent that splits about half the Gaussians and clones
    the rest, JAX's split normals for a key, and the gradient threshold
    that selects the 12 alive Gaussians of largest mean gradient (at most
    36 candidates: they fit in the 40 free slots)."""
    jm = jax_model(synth, seed=seed)
    jm = dataclasses.replace(jm, denom=jnp.maximum(jm.denom, 1.0))  # finite mean gradients
    rng = np.random.default_rng(seed + 100)
    opt = joptim.init(jm.params)
    opt = joptim.AdamState(
        m=jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), opt.m),
        v=jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.uniform(size=x.shape).astype(np.float32)), opt.v),
        count=jnp.int32(7),
    )
    max_scale = np.asarray(jnp.max(jm.get_scaling(), axis=1))
    extent = float(np.median(max_scale[np.asarray(jm.alive_mask())])) / 0.01
    key = jax.random.key(seed)
    normals = np.stack([np.asarray(jax.random.normal(k, (jm.total, 3)))
                        for k in jax.random.split(key, 2)])
    grads = np.nan_to_num(np.asarray(jm.xyz_gradient_accum / jm.denom))[:, 0]
    fit_threshold = float(np.sort(grads[np.asarray(jm.alive_mask())])[-12])
    return jm, opt, extent, key, normals, fit_threshold


def port_state(jopt):
    return toptim.AdamState(
        m={n: torch.tensor(np.asarray(getattr(jopt.m, n))) for n in PARAM_NAMES},
        v={n: torch.tensor(np.asarray(getattr(jopt.v, n))) for n in PARAM_NAMES},
        count=int(jopt.count),
    )


def assert_states_equal(tstate, jstate):
    assert tstate.count == int(jstate.count)
    for name in PARAM_NAMES:
        for t, j in ((tstate.m, jstate.m), (tstate.v, jstate.v)):
            np.testing.assert_array_equal(to_np(t[name]), np.asarray(getattr(j, name)),
                                          err_msg=name)


@pytest.mark.parametrize("threshold,screen", [(None, None), (1e-4, 20)],
                         ids=["fits", "dropped_then_grow"])
def test_densify_and_prune_matches_jax(synth, threshold, screen):
    """One event from the same state with JAX's split normals: clones,
    split children (positions within 1e-6 relative: a rotated product
    rounds in another order), fg split parents with the log-domain quirk,
    prunes, the alive mask, Adam moment surgery and the zeroed stats, and
    the dropped count. With a low threshold more candidates come than the
    40 free slots hold: then grow_bg_capacity is held against JAX too."""
    jm, jopt, extent, key, normals, fit_threshold = densify_inputs(synth, seed=21)
    tm, tstate = port_model(jm), port_state(jopt)
    args = (threshold or fit_threshold, 0.005, extent, screen, 0.01)
    jm2, jopt2, jdropped = jdensify.densify_and_prune(jm, jopt, key, *args)
    tm2, tstate2, tdropped = tdensify.densify_and_prune(tm, tstate, *args,
                                                        normals=torch.tensor(normals))
    assert tm2 is tm
    assert tdropped == int(jdropped)
    assert (tdropped > 0) == (screen is not None)
    born = np.asarray(jm2.bg_alive) & ~np.asarray(jm.bg_alive)
    died = np.asarray(jm.bg_alive) & ~np.asarray(jm2.bg_alive)
    split_fg = np.asarray(jm2.params.scaling != jm.params.scaling).any(1)
    assert born.sum() > 0
    if screen is not None:  # many candidates: bg split parents die, fg ones grow
        assert died.sum() > 0 and split_fg.sum() > 0
    assert_models_equal(tm2, jm2, rtol=1e-6, atol=1e-6)
    assert_states_equal(tstate2, jopt2)
    if tdropped:
        cb = jm.bg_capacity
        jm3, jopt3 = jdensify.grow_bg_capacity(jm2, jopt2, 2 * cb)
        tm3, tstate3 = tdensify.grow_bg_capacity(tm2, tstate2, 2 * cb)
        assert tm3.bg_capacity == 2 * cb and tm2.bg_capacity == cb
        assert_models_equal(tm3, jm3, rtol=1e-6, atol=1e-6)
        assert_states_equal(tstate3, jopt3)
        same, same_state = tdensify.grow_bg_capacity(tm3, tstate3, cb)
        assert same is tm3 and same_state is tstate3


def test_densify_draws_split_noise_from_a_generator(synth):
    """Without injected normals the split children come from the
    generator: the same seed gives the same event."""
    jm, jopt, extent, *_ = densify_inputs(synth, seed=22)
    outs = []
    for _ in range(2):
        tm = port_model(jm)
        gen = torch.Generator().manual_seed(5)
        tdensify.densify_and_prune(tm, port_state(jopt), 4e-4, 0.005, extent, None, 0.01,
                                   generator=gen)
        outs.append(to_np(tm.bg_xyz))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_reset_opacity_matches_jax(synth):
    jm, jopt, *_ = densify_inputs(synth, seed=23)
    tm, tstate = port_model(jm), port_state(jopt)
    jm2, jopt2 = jdensify.reset_opacity(jm, jopt)
    tm2, tstate2 = tdensify.reset_opacity(tm, tstate)
    assert tm2 is tm
    assert_models_equal(tm2, jm2, rtol=1e-6, atol=1e-6)
    assert_states_equal(tstate2, jopt2)
    assert float(tm.get_opacity_raw().max()) <= 0.01 + 1e-7


# ---------------- the main stage ----------------

def test_run_main_stage_matches_jax(synth):
    """50 iterations of the port's main stage against JAX
    `run_main_stage(backend="oracle")` from the same model (JAX's
    setup_from_matches), with densify events at 20 and 40, one opacity
    reset at 30, the same camera stack (JAX's key data as the seed) and an
    extent at which every candidate clones (the split noise cannot match
    across frameworks). The alive counts after each densify event are
    equal and the per-iteration losses within 1e-3 relative (one step
    agrees to 1e-5; the runs drift apart through 50 Adam steps)."""
    jb = synth["bundle"]
    extras = dict(bg_capacity=256, init_iterations=200)
    jm, _ = jpipeline.setup_from_matches(jb, jax.random.key(1), 3, 1.0,
                                         extras=jconfig.TrainExtras(**extras))
    tm = port_model(jm)
    cfg = dict(iterations=50, densify_from_iter=10, densification_interval=20,
               opacity_reset_interval=30)
    key = jax.random.key(2)
    stack_seed = int(np.asarray(jax.random.key_data(key))[-1])
    extent = 1000.0

    def recorder(log):
        def cb(iteration, model, metrics, opt_state=None, **kw):
            log.append((iteration, float(metrics.loss), int(to_np(model.bg_alive).sum()),
                        float(to_np(model.get_opacity_raw()).max())))
        return cb

    jlog, tlog = [], []
    jstate = jpipeline.run_main_stage(
        jm, jb, synth["cams"], synth["gts"], [0, 1, 2], key,
        opt_cfg=jconfig.OptimizationConfig(**cfg), extras=jconfig.TrainExtras(**extras),
        backend="oracle", cameras_extent=extent, callback=recorder(jlog))
    gts = [torch.tensor(np.asarray(g)) for g in synth["gts"]]
    tstate = tpipeline.run_main_stage(
        tm, port_bundle(jb), [port_camera(v) for v in range(3)], gts, [0, 1, 2], stack_seed,
        opt_cfg=tconfig.OptimizationConfig(**cfg), extras=tconfig.TrainExtras(**extras),
        cameras_extent=extent, callback=recorder(tlog))
    assert tstate.iteration == 50 and tstate.opt_state.count == int(jstate.opt_state.count)
    assert [r[0] for r in tlog] == list(range(1, 51))
    for (it, tl, ta, _), (_, jl, ja, _) in zip(tlog, jlog):
        assert tl == pytest.approx(jl, rel=1e-3), it
        if it in (20, 40):
            assert ta == ja, it
    assert tlog[19][2] > 0  # the first event cloned
    assert tlog[29][3] <= 0.01 + 1e-7  # right after the reset
