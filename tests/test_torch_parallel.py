"""The PyTorch port's parallelism (`scgaussian_tpu_torch/parallel/`, the
process-group path of `run_main_stage`, the train CLI's `--multihost`) on
the CPU, against the port's single-process functions and the JAX package.

Ranks are processes in a gloo group over a free localhost port, started
with `torch.multiprocessing` (spawn) from functions of this file, one
intra-op thread each. The three runs (2 ranks for the DP steps, the main
stage and the tile-sharded render; 4 ranks for the 2 x 2 grid; 2 train
CLI processes) start together, once per module, and run while the JAX
reference step is computed; each is joined with a timeout, and every
process still alive when its test or the module ends is killed. This
module imports no JAX at its top, so a rank imports only torch and the
port: the JAX references are computed inside the fixtures and handed to
the ranks as numpy arrays. Each rank writes what it computed into a file
of the run's directory; the tests compare.

The JAX package runs the same semantics on 8 virtual CPU devices
(`tests/test_parallel.py`, `tests/test_hosts.py`)."""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from scgaussian_tpu_torch import config as tconfig
from scgaussian_tpu_torch.core.cameras import Camera
from scgaussian_tpu_torch.model.gaussians import PARAM_NAMES, model_from_numpy
from scgaussian_tpu_torch.model.matches import bundle_from_numpy
from scgaussian_tpu_torch.parallel import dp, hosts, primitives, tiles
from scgaussian_tpu_torch.renderer import project as tproject
from scgaussian_tpu_torch.renderer import raster
from scgaussian_tpu_torch.renderer.binning import bin_gaussians
from scgaussian_tpu_torch.train import main_stage as tmain
from scgaussian_tpu_torch.train import optim as toptim
from scgaussian_tpu_torch.train import pipeline as tpipe
from time_limits import per_test_limit  # noqa: F401 (autouse: a time limit for each test)

JOIN_TIMEOUT = 120  # seconds for every start of ranks
W, H = 64, 48  # tests/synthetic_scene.py's views
TS = [np.array([0.0, 0, 0]), np.array([0.35, 0, 0]), np.array([0.0, 0.35, 0])]
B1 = 0.9
RUN_CFG = dict(iterations=8, densification_interval=4, densify_from_iter=1,
               densify_until_iter=100, densify_grad_threshold=1e-6,
               opacity_reset_interval=6, opacity_reset_until_iter=100)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as every port test file (`test_torch_core.py`
    holds the reason; it is not imported here because it imports JAX)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------- starting ranks ----------------

def _rank_entry(rank, fn, world, port, group_init, args):
    torch.set_num_threads(1)
    if group_init:
        hosts.initialize_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        fn(rank, port, *args)
    finally:
        hosts.shutdown()


class Ranks:
    """`fn(rank, port, *args)` in `world` spawned processes, each in a gloo
    group of `world` ranks over a free localhost port unless `group_init`
    is off. `join` waits at most `timeout` seconds from the start and kills
    every process still alive when it returns or raises; `kill` does so at
    once."""

    def __init__(self, fn, world, *args, group_init=True, timeout=JOIN_TIMEOUT):
        self.name, self.timeout = fn.__name__, timeout
        self.start = time.monotonic()
        self.ctx = mp.start_processes(
            _rank_entry, args=(fn, world, hosts.free_port(), group_init, args), nprocs=world,
            join=False, start_method="spawn")

    def join(self):
        deadline = self.start + self.timeout
        try:
            while not self.ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"the ranks of {self.name} did not end in {self.timeout} s")
        finally:
            self.kill()

    def kill(self):
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


# ---------------- inputs shared by the ranks and the tests ----------------

def port_camera(view):
    return Camera.create(np.eye(3), TS[view], 0.9, 0.9, W, H, device="cpu")


def port_model(leaves, meta):
    return model_from_numpy({k: torch.tensor(v) for k, v in leaves.items()}, meta["max_sh"],
                            device="cpu", spatial_lr_scale=meta["spatial_lr_scale"])


def adam(model):
    return toptim.init({name: getattr(model, name) for name in PARAM_NAMES})


def snapshot(model, state=None, metrics=None):
    out = {name: getattr(model, name).detach().clone() for name in PARAM_NAMES}
    for name in ("xyz_gradient_accum", "denom", "max_radii2d", "bg_alive"):
        out[name] = getattr(model, name).clone()
    if state is not None:
        out.update({f"m.{k}": v.clone() for k, v in state.m.items()})
        out.update({f"v.{k}": v.clone() for k, v in state.v.items()})
        out["count"] = state.count
    if metrics is not None:
        out.update({f"metric.{k}": v.clone() for k, v in metrics._asdict().items()})
    return out


def dtu_image(gt):
    """The image darkened below row 20, so that the DTU mask is not empty
    (`tests/test_parallel.py:108`)."""
    return gt * (np.arange(H)[None, :, None] < 20)


# ---------------- the two-rank run ----------------

def _two_rank_worker(rank, port, tmp, inputs):
    """Everything the 2-rank tests read, in one group: DP steps (same
    camera, different cameras, DTU, the final iteration), the main stage
    over the group, the main stage over a world-1 subgroup (rank 0) beside
    the single-process loop (rank 1), and the tile-sharded render."""
    group = dp.make_group(2)
    leaves, meta, bundle_np, gts = (inputs[k] for k in ("leaves", "meta", "bundle", "gts"))
    bundle = bundle_from_numpy(bundle_np, device="cpu")
    gts = [torch.tensor(g) for g in gts]
    zeros = torch.zeros(3)
    extras = tconfig.TrainExtras(dtu_shift_rows=8)
    res = {}

    def step(views, images, iteration=1, cfg=tconfig.OptimizationConfig(), is_dtu=False):
        model = port_model(leaves, meta)
        model, state, metrics = dp.dp_train_step(
            group, model, adam(model), bundle, [port_camera(v) for v in views], images, views,
            iteration, zeros, cfg, extras=extras, is_dtu=is_dtu)
        return snapshot(model, state, metrics)

    res["same"] = step([1, 1], [gts[1], gts[1]])
    res["different"] = step([1, 2], [gts[1], gts[2]])
    dark = torch.tensor(dtu_image(gts[0].numpy()))
    res["dtu"] = step([0, 0], [dark, dark], is_dtu=True)
    res["final"] = step([1, 2], [gts[1], gts[2]], iteration=7,
                        cfg=tconfig.OptimizationConfig(iterations=7))

    # the main stage over the group, 8 iterations with a densify event and a reset
    cams = [port_camera(v) for v in range(3)]
    kw = dict(stack_seed=3, opt_cfg=tconfig.OptimizationConfig(**RUN_CFG), extras=extras,
              iterations=8)

    def run(group_):
        model = port_model(leaves, meta)
        if group_ is not None:
            dp.broadcast_model(group_, model)
        losses = []
        state = tpipe.run_main_stage(
            model, bundle, cams, gts, [0, 1, 2], group=group_,
            generator=torch.Generator().manual_seed(5),
            callback=lambda it, m, met, **_: losses.append(float(met.loss)), **kw)
        out = snapshot(state.model, state.opt_state)
        out["losses"] = losses
        return out

    res["run"] = run(group)
    singles = [dist.new_group([0]), dist.new_group([1])]
    res["run_world1" if rank == 0 else "run_none"] = run(singles[0] if rank == 0 else None)

    # the tile-sharded render of view 0 and its gradients
    model = port_model(leaves, meta)
    proj = tproject.project(port_camera(0), model.get_xyz(), model.get_opacity().reshape(-1),
                            scales=model.get_scaling(), rotations=model.get_rotation(),
                            shs=model.get_features(), active_sh_degree=3)
    mean2d = proj.mean2d.detach().requires_grad_()
    opacity = proj.opacity.detach().requires_grad_()
    p = dataclasses.replace(proj, mean2d=mean2d, opacity=opacity)
    img, depth, alpha, overflow = tiles.rasterize_tile_sharded(group, p, W, H, zeros)
    loss = (img ** 2).sum() + (depth ** 2).sum() + alpha.sum()
    g_mean, g_opac = torch.autograd.grad(loss, [mean2d, opacity])
    res["tiles"] = dict(img=img.detach(), depth=depth.detach(), alpha=alpha.detach(),
                        overflow=overflow, g_mean2d=g_mean, g_opacity=g_opac)
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def jax_inputs():
    """The JAX scene and hybrid model of `test_torch_train.py`, as numpy."""
    from synthetic_scene import make_synthetic  # tests/ is on sys.path under pytest
    from test_torch_train import jax_model

    scene = make_synthetic()
    jm = jax_model(scene)
    leaves = {name: np.asarray(getattr(jm.params, name)) for name in PARAM_NAMES}
    for name in ("rayo", "rayd", "bg_alive", "active_sh_degree", "xyz_gradient_accum",
                 "denom", "max_radii2d"):
        leaves[name] = np.asarray(getattr(jm, name))
    jb = scene["bundle"]
    bundle = {f.name: (getattr(jb, f.name) if f.name in ("width", "height")
                       else np.asarray(getattr(jb, f.name))) for f in dataclasses.fields(jb)}
    return dict(scene=scene, jm=jm, leaves=leaves, bundle=bundle,
                meta=dict(max_sh=jm.max_sh_degree, spatial_lr_scale=jm.spatial_lr_scale),
                gts=[np.asarray(g) for g in scene["gts"]])


@pytest.fixture(scope="module")
def runs(jax_inputs, tmp_path_factory):
    """The three runs of ranks, started together (their directories and
    handles); then, while they run, JAX `dp_train_step` on a 2-device mesh
    (`backend="oracle"`) on views 1 and 2, the reference of
    `test_dp_different_cameras_match_jax`. Kills what is left at the end."""
    import jax.numpy as jnp

    from scgaussian_tpu import config as jconfig
    from scgaussian_tpu.parallel import dp as jdp
    from scgaussian_tpu.train import optim as joptim
    from scgaussian_tpu_torch.data.synthetic import generate_scene

    dirs = {k: str(tmp_path_factory.mktemp(k)) for k in ("two", "grid", "cli")}
    scene = os.path.join(dirs["cli"], "scene")
    generate_scene(scene, n_views=4, n_gaussians=24, n_points=48, width=48, height=32,
                   device="cpu")
    model_dirs = [os.path.join(dirs["cli"], f"model{r}") for r in (0, 1)]
    inputs = {k: jax_inputs[k] for k in ("leaves", "meta", "bundle", "gts")}
    started = {
        "two": Ranks(_two_rank_worker, 2, dirs["two"], inputs),
        "grid": Ranks(_grid_worker, 4, dirs["grid"], inputs),
        "cli": Ranks(_cli_worker, 2, scene, model_dirs, group_init=False),
    }
    try:
        sc, jm = jax_inputs["scene"], jax_inputs["jm"]
        jm2, jopt, jmet = jdp.dp_train_step(
            jdp.make_mesh(2), jm, joptim.init(jm.params), sc["bundle"],
            jdp.stack_cameras([sc["cams"][1], sc["cams"][2]]),
            jnp.stack([sc["gts"][1], sc["gts"][2]]), jnp.asarray([1, 2], jnp.int32),
            jnp.int32(1), jnp.zeros(3), jconfig.OptimizationConfig(),
            extras=jconfig.TrainExtras(dtu_shift_rows=8), backend="oracle")
        yield dict(dirs=dirs, started=started, model_dirs=model_dirs,
                   jax_dp=(jm2, jopt, jmet))
    finally:
        for ranks in started.values():
            ranks.kill()


def results(runs, key, world):
    runs["started"][key].join()
    return [torch.load(os.path.join(runs["dirs"][key], f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def two_ranks(runs):
    return results(runs, "two", 2)


def single_step(jax_inputs, view, gt, iteration=1, cfg=tconfig.OptimizationConfig(),
                is_dtu=False):
    model = port_model(jax_inputs["leaves"], jax_inputs["meta"])
    model, state, metrics = tmain.train_step(
        model, adam(model), bundle_from_numpy(jax_inputs["bundle"], device="cpu"),
        port_camera(view), torch.tensor(gt), view, iteration, torch.zeros(3), cfg,
        extras=tconfig.TrainExtras(dtu_shift_rows=8), is_dtu=is_dtu)
    return snapshot(model, state, metrics)


def assert_replicas_equal(a, b):
    for key in a:
        if isinstance(a[key], torch.Tensor):
            assert torch.equal(a[key], b[key]), key
        else:
            assert a[key] == b[key], key


# ---------------- (1), (2): row slices, in process ----------------

def random_projection(W_, H_, n=200, seed=0):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n),
                      rng.uniform(3, 6, n)], -1).astype(np.float32)
    scales = np.exp(rng.uniform(-3, -1.5, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, n).astype(np.float32)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0] = rng.uniform(-1, 1, (n, 3))
    cam = Camera.create(np.eye(3), np.zeros(3), 0.9, 0.7, W_, H_, device="cpu")
    t = [torch.tensor(x) for x in (means, opac, scales, quats, shs)]
    return tproject.project(cam, t[0], t[1], scales=t[2], rotations=t[3], shs=t[4],
                            active_sh_degree=3)


@pytest.mark.parametrize("size,k", [((64, 48), 2), ((64, 48), 3), ((64, 48), 4), ((70, 50), 3)],
                         ids=["64x48/2", "64x48/3", "64x48/4-padded", "70x50/3"])
def test_row_restricted_bins_equal_the_whole_bins(size, k):
    """Each slice's local tile t holds the entries, in the order, of tile
    (row_lo * nx + t) of the unrestricted bins; its Gaussian-major fields
    are those of its own entries; rows past the image are empty."""
    W_, H_ = size
    proj = random_projection(W_, H_)
    whole = bin_gaussians(proj, W_, H_)
    rows_per, _ = tiles.row_slices(H_, k)
    starts = whole.tile_starts.long()
    total = 0
    for r in range(k):
        b = bin_gaussians(proj, W_, H_, row_lo=r * rows_per, ny_rows=rows_per)
        assert (b.row_lo, b.ny, b.nx, b.grid_ny) == (r * rows_per, rows_per, whole.nx, whole.ny)
        for t in range(b.nx * b.ny):
            g = b.tile_starts[t:t + 2].long()
            got = b.gauss_ids[g[0]:g[1]]
            gt = r * rows_per * whole.nx + t
            want = (whole.gauss_ids[starts[gt]:starts[gt + 1]] if gt < whole.nx * whole.ny
                    else whole.gauss_ids[:0])
            assert torch.equal(got, want), (r, t)
        counts = torch.bincount(b.gauss_ids.long(), minlength=proj.depth.shape[0])
        assert torch.equal((b.gmaj_starts[1:] - b.gmaj_starts[:-1]).long(), counts)
        assert torch.equal(b.gmaj_ids[b.order], b.gauss_ids)
        assert bool((b.gmaj_ids[1:] >= b.gmaj_ids[:-1]).all())
        total += b.num_entries
    assert total == whole.num_entries


@pytest.mark.parametrize("by_sort", [False, True], ids=["atomic", "sort"])
@pytest.mark.parametrize("size,k", [((64, 48), 2), ((64, 48), 4), ((70, 50), 3)],
                         ids=["64x48/2", "64x48/4-padded", "70x50/3"])
def test_row_slices_composite_the_whole_image(size, k, by_sort, monkeypatch):
    """`rasterize_rows` over every slice, on the plain versions: the slabs
    stacked are bitwise `rasterize`'s image, depth and alpha; the slices'
    gradients of the projected attributes and the background, summed,
    are the whole image's within 1e-5 of scale, by either route."""
    if by_sort:
        monkeypatch.setattr(raster, "SORT_ROUTE_MIN_L", 0)
    W_, H_ = size
    proj = random_projection(W_, H_, seed=1)
    rng = np.random.default_rng(2)
    cots = [torch.tensor(rng.normal(size=s).astype(np.float32))
            for s in ((3, H_, W_), (1, H_, W_), (1, H_, W_))]
    fields = ("mean2d", "conic", "color", "opacity", "depth")

    def grads(render):
        leaves = {f: getattr(proj, f).detach().requires_grad_() for f in fields}
        bg = torch.tensor([0.1, 0.2, 0.3], requires_grad=True)
        outs = render(dataclasses.replace(proj, **leaves), bg)
        loss = sum((o * c).sum() for o, c in zip(outs, cots))
        return outs, torch.autograd.grad(loss, list(leaves.values()) + [bg])

    rows_per, _ = tiles.row_slices(H_, k)
    want, g_want = grads(lambda p, bg: raster.rasterize(p, W_, H_, bg))

    def sliced(p, bg):
        slabs = [raster.rasterize_rows(p, W_, H_, bg, r * rows_per, rows_per) for r in range(k)]
        return [torch.cat([s[i] for s in slabs], dim=1) for i in range(3)]

    got, g_got = grads(sliced)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(g_got, g_want):
        scale = float(b.abs().max()) + 1e-12
        assert float((a - b).abs().max()) <= 1e-5 * scale


# ---------------- (3)-(5): DP steps ----------------

def test_dp_same_camera_equals_train_step(two_ranks, jax_inputs):
    """Both ranks on view 1: parameters, Adam moments, loss and max radii
    bitwise `train_step`'s ((g + g) / 2 = g); the densify statistics
    summed over the two cameras, twice the step's."""
    want = single_step(jax_inputs, 1, jax_inputs["gts"][1])
    for res in two_ranks:
        got = res["same"]
        for name in PARAM_NAMES:
            for key in (name, f"m.{name}", f"v.{name}"):
                assert torch.equal(got[key], want[key]), key
        assert got["count"] == want["count"] == 1
        for key in ("metric.loss", "metric.l1", "metric.match_loss", "metric.num_visible",
                    "max_radii2d"):
            assert torch.equal(got[key], want[key]), key
    d0 = torch.tensor(jax_inputs["leaves"]["denom"])
    a0 = torch.tensor(jax_inputs["leaves"]["xyz_gradient_accum"])
    got = two_ranks[0]["same"]
    assert torch.equal(got["denom"] - d0, 2 * (want["denom"] - d0))
    torch.testing.assert_close(got["xyz_gradient_accum"] - a0,
                               2 * (want["xyz_gradient_accum"] - a0), rtol=1e-6, atol=1e-9)
    assert_replicas_equal(two_ranks[0]["same"], two_ranks[1]["same"])


def test_dp_different_cameras_match_jax(two_ranks, runs, jax_inputs):
    """Views 1 and 2 on two ranks against JAX `dp_train_step` on a 2-device
    mesh (`backend="oracle"`, the `runs` fixture), at
    `test_torch_train.py`'s tolerances: loss 1e-5, Adam m 5e-4 max|m|, v
    1e-3 max|v|, densify accumulator 5e-4 of its growth, denom and max
    radii exact."""
    jm = jax_inputs["jm"]
    jm2, jopt, jmet = runs["jax_dp"]
    got = two_ranks[0]["different"]
    for key, ref in (("loss", jmet.loss), ("l1", jmet.l1), ("match_loss", jmet.match_loss)):
        assert abs(float(got[f"metric.{key}"]) - float(ref)) < 1e-5, key
    assert int(got["metric.num_visible"]) == int(jmet.num_visible) > 0
    assert int(got["metric.overflow"]) == int(jmet.overflow) == 0
    for name in PARAM_NAMES:
        jmom, jvar = np.asarray(getattr(jopt.m, name)), np.asarray(getattr(jopt.v, name))
        np.testing.assert_allclose(got[f"m.{name}"].numpy(), jmom,
                                   atol=5e-4 * np.abs(jmom).max(), err_msg=f"m {name}")
        np.testing.assert_allclose(got[f"v.{name}"].numpy(), jvar,
                                   atol=1e-3 * np.abs(jvar).max(), err_msg=f"v {name}")
    acc_j = np.asarray(jm2.xyz_gradient_accum)
    grown = acc_j - np.asarray(jm.xyz_gradient_accum)
    assert grown.max() > 0
    np.testing.assert_allclose(got["xyz_gradient_accum"].numpy(), acc_j, atol=5e-4 * grown.max())
    np.testing.assert_array_equal(got["denom"].numpy(), np.asarray(jm2.denom))
    np.testing.assert_array_equal(got["max_radii2d"].numpy(), np.asarray(jm2.max_radii2d))
    assert_replicas_equal(two_ranks[0]["different"], two_ranks[1]["different"])


def test_dp_dtu_step_equals_train_step(two_ranks, jax_inputs):
    """The DTU branch under DP (`tests/test_parallel.py:96-126`): both ranks
    on the darkened view 0 with `is_dtu` equal `train_step(is_dtu=True)`
    bitwise: mask, alpha penalty and update go through the same closure."""
    want = single_step(jax_inputs, 0, dtu_image(jax_inputs["gts"][0]), is_dtu=True)
    for res in two_ranks:
        got = res["dtu"]
        for name in PARAM_NAMES:
            assert torch.equal(got[name], want[name]), name
        assert torch.equal(got["metric.loss"], want["metric.loss"])
        assert torch.equal(got["metric.num_visible"], want["metric.num_visible"])


def test_dp_final_iteration_skips_the_update(two_ranks, jax_inputs):
    """At iteration == iterations the DP step leaves the parameters and
    the Adam state as they were (`train.py:203`;
    `tests/test_parallel.py:129-150`), while the densify statistics grow."""
    for res in two_ranks:
        got = res["final"]
        assert got["count"] == 0
        for name in PARAM_NAMES:
            assert torch.equal(got[name], torch.tensor(jax_inputs["leaves"][name])), name
            assert float(got[f"m.{name}"].abs().max()) == 0.0
        assert float(got["denom"].sum()) > float(jax_inputs["leaves"]["denom"].sum())


# ---------------- (6): the main stage over a group ----------------

def test_run_main_stage_world_one_group_equals_no_group(two_ranks):
    """`run_main_stage` over a group of one (rank 0's subgroup) is bitwise
    the single-process loop (rank 1, `group=None`) through 8 iterations
    with a densify event and an opacity reset."""
    a, b = two_ranks[0]["run_world1"], two_ranks[1]["run_none"]
    assert a["losses"] == b["losses"] and len(a["losses"]) == 8
    assert_replicas_equal(a, b)


def test_run_main_stage_two_ranks_keeps_the_replicas_equal(two_ranks, jax_inputs):
    """Two ranks, 8 iterations (two cameras each), a densify event at 4 and
    8 and an opacity reset at 6 (`tests/test_parallel.py:153-208`): the
    replicas are bitwise equal, the losses finite, the parameters moved
    and the densify events filled background slots."""
    a, b = two_ranks[0]["run"], two_ranks[1]["run"]
    assert_replicas_equal(a, b)
    assert a["losses"] == b["losses"] and len(a["losses"]) == 8
    assert all(np.isfinite(a["losses"]))
    assert not torch.equal(a["zval"], torch.tensor(jax_inputs["leaves"]["zval"]))
    assert int(a["bg_alive"].sum()) > int(jax_inputs["leaves"]["bg_alive"].sum()) > 0
    assert a["count"] == 7  # the final iteration skips the update


# ---------------- (7): sharded renders ----------------

def test_tile_sharded_render_equals_rasterize(two_ranks, jax_inputs):
    """`rasterize_tile_sharded` over 2 ranks (3 tile rows padded to 4):
    image, depth and alpha bitwise `rasterize`'s on every rank; gradients
    through the gather and the all-reduce within 5e-4 of scale
    (`tests/test_parallel.py:211-262`)."""
    model = port_model(jax_inputs["leaves"], jax_inputs["meta"])
    proj = tproject.project(port_camera(0), model.get_xyz(), model.get_opacity().reshape(-1),
                            scales=model.get_scaling(), rotations=model.get_rotation(),
                            shs=model.get_features(), active_sh_degree=3)
    mean2d = proj.mean2d.detach().requires_grad_()
    opacity = proj.opacity.detach().requires_grad_()
    img, depth, alpha = raster.rasterize(
        dataclasses.replace(proj, mean2d=mean2d, opacity=opacity), W, H, torch.zeros(3))
    loss = (img ** 2).sum() + (depth ** 2).sum() + alpha.sum()
    g_mean, g_opac = torch.autograd.grad(loss, [mean2d, opacity])
    for res in two_ranks:
        got = res["tiles"]
        for key, want in (("img", img), ("depth", depth), ("alpha", alpha)):
            assert torch.equal(got[key], want.detach()), key
        assert int(got["overflow"]) == 0
        for key, want in (("g_mean2d", g_mean), ("g_opacity", g_opac)):
            scale = float(want.abs().max()) + 1e-8
            assert float((got[key] - want).abs().max()) <= 5e-4 * scale, key


def _grid_worker(rank, port, tmp, inputs):
    """A rank of the 2 x 2 grid: `render_sharded` of view 0 and its
    gradients."""
    grid = primitives.make_group_grid(2, 2)
    model = port_model(inputs["leaves"], inputs["meta"])
    args = padded_inputs(model)
    means, opac = (args[0].detach().requires_grad_(), args[1].detach().requires_grad_())
    img, depth, alpha, overflow = primitives.render_sharded(
        grid, port_camera(0), means, opac, *args[2:], torch.zeros(3))
    g_means, g_opac = torch.autograd.grad((img ** 2).sum(), [means, opac])
    torch.save(dict(img=img.detach(), depth=depth.detach(), alpha=alpha.detach(),
                    overflow=overflow, g_means=g_means, g_opacity=g_opac),
               os.path.join(tmp, f"rank{rank}.pt"))


def padded_inputs(model):
    """The model's activated inputs, padded to an even count with invisible
    Gaussians, as `tests/test_parallel.py:269-276` pads them."""
    with torch.no_grad():
        n = model.total
        pad = n % 2
        means = torch.cat([model.get_xyz(), torch.zeros(pad, 3)])
        opac = torch.cat([model.get_opacity().reshape(-1), torch.zeros(pad)])
        scl = torch.cat([model.get_scaling(), torch.full((pad, 3), 1e-6)])
        rot = torch.cat([model.get_rotation(), torch.tensor([[1.0, 0, 0, 0]]).repeat(pad, 1)])
        shs = torch.cat([model.get_features(), torch.zeros(pad, 16, 3)])
    return means, opac, scl, rot, shs


def test_render_sharded_on_a_two_by_two_grid_equals_the_single_render(runs, jax_inputs):
    """`render_sharded` on 4 ranks as 2 primitive shards x 2 tile-row
    slices: image, depth and alpha bitwise the single-process render on
    every rank; gradients of the means and opacities through both
    collectives within 5e-4 of scale (`tests/test_parallel.py:265-317`)."""
    ranks = results(runs, "grid", 4)
    model = port_model(jax_inputs["leaves"], jax_inputs["meta"])
    means, opac, scl, rot, shs = padded_inputs(model)
    means.requires_grad_()
    opac.requires_grad_()
    cam = port_camera(0)
    proj = tproject.project(cam, means, opac, scales=scl, rotations=rot, shs=shs,
                            active_sh_degree=3)
    img, depth, alpha = raster.rasterize(proj, W, H, torch.zeros(3))
    g_means, g_opac = torch.autograd.grad((img ** 2).sum(), [means, opac])
    for r, got in enumerate(ranks):
        for key, want in (("img", img), ("depth", depth), ("alpha", alpha)):
            assert torch.equal(got[key], want.detach()), (r, key)
        assert int(got["overflow"]) == 0
        for key, want in (("g_means", g_means), ("g_opacity", g_opac)):
            scale = float(want.abs().max()) + 1e-8
            assert float((got[key] - want).abs().max()) <= 5e-4 * scale, (r, key)


# ---------------- (8): the train CLI across two processes ----------------

def _cli_worker(rank, port, scene, model_dirs):
    """A `--multihost` process of the train CLI."""
    from scgaussian_tpu_torch.apps import train as train_cli

    train_cli.main([
        "-s", scene, "-m", model_dirs[rank], "-r", "1", "--device", "cpu",
        "--multihost", "--coordinator_address", f"127.0.0.1:{port}",
        "--num_processes", "2", "--process_id", str(rank), "--data_parallel", "2",
        "--iterations", "8", "--init_iterations", "60", "--densify_from_iter", "2",
        "--densification_interval", "4", "--opacity_reset_interval", "1000",
        "--bg_capacity", "256", "--test_iterations", "8", "--save_iterations", "8",
        "--no_tensorboard",
    ])


def test_train_cli_multihost_two_processes(runs):
    """The train CLI under `--multihost --num_processes 2 --data_parallel 2
    --device cpu` on a 48x32 synthetic scene (the `runs` fixture writes
    it) for 8 iterations, a densify event included: only the primary
    writes the checkpoint, the PLY and `cfg_args.json`
    (`tests/test_hosts.py:50-106`)."""
    runs["started"]["cli"].join()
    model_dirs = runs["model_dirs"]
    assert os.path.exists(os.path.join(model_dirs[0], "chkpnt8.npz"))
    assert os.path.exists(os.path.join(model_dirs[0], "point_cloud", "iteration_8",
                                       "point_cloud.ply"))
    assert os.path.exists(os.path.join(model_dirs[0], "cfg_args.json"))
    assert not os.path.exists(os.path.join(model_dirs[1], "chkpnt8.npz"))
    assert not os.path.exists(os.path.join(model_dirs[1], "cfg_args.json"))
    assert not os.path.exists(os.path.join(model_dirs[1], "point_cloud"))
