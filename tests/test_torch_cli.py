"""The PyTorch port's train and render CLIs, checkpoints and the training
utilities against the JAX package on the CPU.

The port's train CLI runs once per module on the JAX generator's 10-view
64x48 scene, with `tests/test_cli_end_to_end.py`'s flags (40 iterations,
150 init iterations) and `--device cpu`, on its default tile path (the CUDA
kernels' plain versions on the CPU). The JAX train CLI is not run here: on
the CPU it compiles for minutes, and `test_cli_end_to_end.py` runs it. The
references are JAX's render CLI (`--backend oracle`) on a copy of the
port's model directory, and JAX's checkpoint and matchpoint writers."""

import json
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from scgaussian_tpu.apps import render as j_render_app
from scgaussian_tpu.apps import train as j_train_app
from scgaussian_tpu.data import scene as jscene
from scgaussian_tpu.data.synthetic import generate_scene as j_generate_scene
from scgaussian_tpu.eval import metrics as j_metrics
from scgaussian_tpu.model import io as j_io
from scgaussian_tpu.model.gaussians import create_model as j_create_model
from scgaussian_tpu.train import optim as joptim
from scgaussian_tpu.train.main_stage import render_model as j_render_model
from scgaussian_tpu_torch.apps import acceptance as t_acceptance_app
from scgaussian_tpu_torch.apps import metrics as t_metrics_app
from scgaussian_tpu_torch.apps import render as t_render_app
from scgaussian_tpu_torch.apps import render_video as t_video_app
from scgaussian_tpu_torch.apps import train as t_train_app
from scgaussian_tpu_torch.data import ply as tply
from scgaussian_tpu_torch.data import scene as tscene
from scgaussian_tpu_torch.data.pose_utils import gen_poses
from scgaussian_tpu_torch.eval import geo_check as t_geo_check
from scgaussian_tpu_torch.eval import lpips as t_lpips
from scgaussian_tpu_torch.model import io as t_io
from scgaussian_tpu_torch.viewer import network_gui as t_gui
from scgaussian_tpu_torch.utils import colormap, logging as tlogging, profiling
from test_torch_core import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)
from time_limits import per_test_limit  # noqa: F401 (autouse: a time limit for each test)

ITERATIONS, INIT, CHECKPOINT = 40, 150, 20
# tests/test_cli_end_to_end.py:25-43, on the port's default backend
FLAGS = ["-r", "1", "--eval", "--init_iterations", str(INIT), "--densify_from_iter", "10",
         "--densification_interval", "20", "--opacity_reset_interval", "1000",
         "--bg_capacity", "512", "--no_tensorboard", "--device", "cpu"]
LSB = 1  # one 8-bit step


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cliscene")
    j_generate_scene(str(d), n_views=10, n_gaussians=40, n_points=80, width=64, height=48)
    return str(d)


@pytest.fixture(scope="module")
def trained(scene_dir, tmp_path_factory):
    """(model dir, TrainState) of one port train CLI run."""
    model_dir = str(tmp_path_factory.mktemp("climodel") / "model")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the autouse fixture is not set up yet at module scope
    try:
        state = t_train_app.main(
            ["-s", scene_dir, "-m", model_dir, "--iterations", str(ITERATIONS),
             "--test_iterations", str(ITERATIONS), "--save_iterations", str(ITERATIONS),
             "--checkpoint_iterations", str(CHECKPOINT)] + FLAGS)
    finally:
        torch.set_num_threads(threads)
    return model_dir, state


def png(path) -> np.ndarray:
    return np.asarray(Image.open(path)).astype(np.int32)


def jax_pair(nr=16, cb=32, seed=0):
    """A JAX (model, Adam state) whose every leaf holds distinct values."""
    rng = np.random.default_rng(seed)
    model = j_create_model(rng.normal(size=(nr, 3)).astype(np.float32),
                           rng.normal(size=(nr, 3)).astype(np.float32),
                           rng.uniform(1, 5, nr).astype(np.float32),
                           rng.uniform(size=(nr, 3)).astype(np.float32), 3, 1.5, bg_capacity=cb)
    leaves, treedef = jax.tree_util.tree_flatten((model, joptim.init(model.params)))
    filled = []
    for leaf in leaves:
        a = np.asarray(leaf)
        if a.dtype == np.bool_:
            a = rng.uniform(size=a.shape) > 0.5
        elif a.dtype == np.int32:
            a = np.int32(2 if a.ndim == 0 else 0)
        else:
            a = rng.normal(size=a.shape).astype(a.dtype)
        filled.append(jnp.asarray(a))
    return jax.tree_util.tree_unflatten(treedef, filled)


def port_leaves(model, opt_state) -> list:
    """The 44 leaves the port writes, copied off the (CPU) tensors."""
    payload = t_io._checkpoint_payload(model, opt_state, 0, copy=True)
    return [payload[f"leaf_{i}"] for i in range(len(t_io.CHECKPOINT_LEAVES))]


def assert_leaves_equal(got: list, want: list):
    assert len(got) == len(want) == len(t_io.CHECKPOINT_LEAVES)
    for name, a, b in zip(t_io.CHECKPOINT_LEAVES, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------- the train CLI ----------------

def test_train_cli_writes_the_jax_cli_artifacts(trained):
    model_dir, state = trained
    assert state.iteration == ITERATIONS
    for rel in (f"point_cloud/iteration_{ITERATIONS}/point_cloud.ply", "cfg_args.json",
                f"chkpnt{ITERATIONS}.npz", f"chkpnt{CHECKPOINT}.npz", "cameras.json",
                f"init_point_cloud/iteration_{INIT}/point_cloud_matchpoint.ply"):
        assert os.path.exists(os.path.join(model_dir, rel)), rel
    with open(os.path.join(model_dir, "cfg_args.json")) as f:
        cfg = json.load(f)
    assert (cfg["backend"], cfg["device"], cfg["resolution"]) == ("cuda", "cpu", 1)
    with open(os.path.join(model_dir, "train_log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["iter"] for r in records] == [1]
    assert all(math.isfinite(r["loss"]) and r["visible"] > 0 for r in records)
    assert state.model.zval.device.type == "cpu"


def test_resume_reaches_the_target_iteration(scene_dir, trained, tmp_path):
    model_dir, _ = trained
    resumed = str(tmp_path / "resumed")
    state = t_train_app.main(
        ["-s", scene_dir, "-m", resumed, "--iterations", str(CHECKPOINT + 5),
         "--test_iterations", "-1", "--save_iterations", "-1",
         "--start_checkpoint", os.path.join(model_dir, f"chkpnt{CHECKPOINT}.npz")] + FLAGS)
    assert state.iteration == CHECKPOINT + 5
    # Adam steps on; the run's last iteration takes no update (`apply_update`)
    assert state.opt_state.count == CHECKPOINT + 4
    assert os.path.exists(os.path.join(resumed, f"chkpnt{CHECKPOINT + 5}.npz"))
    assert not os.path.exists(os.path.join(resumed, "init_point_cloud"))  # no init stage


def test_shared_flags_have_the_same_defaults():
    port = vars(t_train_app.build_parser().parse_args([]))
    ref = vars(j_train_app.build_parser().parse_args([]))
    assert set(ref) <= set(port) and set(port) - set(ref) == {"device"}
    # the backends differ by name: JAX's tile path is "tpu", the port's "cuda"
    assert (ref["backend"], port["backend"], port["device"]) == ("tpu", "cuda", "cuda")
    for key in set(ref) - {"backend"}:
        assert port[key] == ref[key], key


def test_train_and_render_clis_raise_without_a_gpu(scene_dir, trained, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train_app.main(["-s", scene_dir, "-m", str(tmp_path / "m")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_render_app.main(["-m", trained[0]])
    assert not os.path.exists(tmp_path / "m")


@pytest.mark.parametrize("flags,message", [
    (["--multihost", "--data_parallel", "2", "-m", ""], "requires an explicit -m"),
    (["--multihost"], "requires --data_parallel"),
    (["--coordinator_address", "localhost:1234", "--data_parallel", "1"],
     "requires --data_parallel"),
    (["--data_parallel", str(10 ** 6)], "available devices"),
    (["--multihost", "--data_parallel", "2", "--port", "0"], "unsupported with --multihost"),
], ids=["multihost_without_model_path", "multihost_without_data_parallel",
        "coordinator_without_data_parallel", "more_ranks_than_devices", "viewer_with_multihost"])
def test_parallel_flags_exit_with_the_jax_guards(scene_dir, tmp_path, flags, message):
    """The JAX CLI's guards on `--multihost`, `--coordinator_address`,
    `--data_parallel` and `--port` (`apps/train.py:119-124, 265-266,
    391-412`), before the scene is read and before any process group
    forms: nothing is written and nothing trains."""
    with pytest.raises(SystemExit, match=message):
        t_train_app.main(["-s", scene_dir, "-m", str(tmp_path / "m"), "--device", "cpu"] + flags)
    assert not os.path.exists(tmp_path / "m")
    assert not torch.distributed.is_initialized()


# ---------------- the render CLI ----------------

def test_render_cli_matches_jax_render_cli(trained, tmp_path):
    """The port's render CLI (tile path, plain versions) and JAX's (dense
    oracle) on copies of one model directory."""
    model_dir, _ = trained
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    shutil.copytree(model_dir, port_dir)
    shutil.copytree(model_dir, jax_dir)
    common = ["--iteration", str(ITERATIONS), "--bg_capacity", "4096"]
    seconds = t_render_app.main(["-m", port_dir, "--device", "cpu"] + common)
    j_render_app.main(["-m", jax_dir, "--backend", "oracle"] + common)
    assert {k: len(v["render"]) for k, v in seconds.items()} == {"train": 3, "test": 2}

    for split, views in (("train", 3), ("test", 2)):
        base = os.path.join(split, f"ours_{ITERATIONS}")
        for kind in ("renders", "gt", "depth", "error_map"):
            names = sorted(os.listdir(os.path.join(jax_dir, base, kind)))
            assert sorted(os.listdir(os.path.join(port_dir, base, kind))) == names
            assert len([n for n in names if n[0].isdigit()]) == views
            for name in names:
                if name.startswith("color_"):
                    continue  # turbo: test_turbo_matches_matplotlib
                a = png(os.path.join(port_dir, base, kind, name))
                b = png(os.path.join(jax_dir, base, kind, name))
                assert a.shape == b.shape
                assert np.abs(a - b).max() <= (0 if kind == "gt" else LSB), (kind, name)
    t = tply.read_ply(os.path.join(port_dir, "train", "point_cloud_color.ply"))
    j = tply.read_ply(os.path.join(jax_dir, "train", "point_cloud_color.ply"))
    assert t.keys() == j.keys()
    for key in j:
        np.testing.assert_allclose(t[key].astype(np.float64), j[key].astype(np.float64),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_turbo_matches_matplotlib(tmp_path):
    """The port's turbo table and mapping, bitwise against matplotlib's, as
    the JAX render CLI writes it (`save_turbo_depth`)."""
    rng = np.random.default_rng(5)
    cases = [rng.uniform(size=(37, 51)).astype(np.float32),
             rng.uniform(-2, 3, size=(16, 16)),
             np.full((8, 8), 0.25, np.float32),
             np.linspace(0, 1, 4096, dtype=np.float32).reshape(64, 64)]
    nan = rng.uniform(size=(8, 8))
    nan[2, 3] = np.nan
    import matplotlib as mpl
    import matplotlib.cm as cm

    for depth in cases:
        t_render_app.save_turbo_depth(depth, str(tmp_path / "t.png"))
        j_render_app.save_turbo_depth(depth, str(tmp_path / "j.png"))
        np.testing.assert_array_equal(png(tmp_path / "t.png"), png(tmp_path / "j.png"))
    mapper = cm.ScalarMappable(norm=mpl.colors.Normalize(vmin=0.1, vmax=0.7), cmap="turbo")
    np.testing.assert_array_equal(colormap.turbo_rgb(nan, 0.1, 0.7),
                                  (mapper.to_rgba(nan)[:, :, :3] * 255).astype(np.uint8))
    np.testing.assert_array_equal(colormap.TURBO, mpl.colormaps["turbo"].colors)


# ---------------- metrics, acceptance, video and the viewer ----------------

@pytest.fixture(scope="module")
def rendered(trained, tmp_path_factory):
    """A copy of the trained model directory holding the port's render
    CLI's test renders."""
    model_dir = str(tmp_path_factory.mktemp("evalmodel") / "model")
    shutil.copytree(trained[0], model_dir)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the autouse fixture is not set up yet at module scope
    try:
        t_render_app.main(["-m", model_dir, "--iteration", str(ITERATIONS), "--bg_capacity",
                           "4096", "--skip_train", "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    return model_dir


def read_json(model_dir, name) -> dict:
    with open(os.path.join(model_dir, name)) as f:
        return json.load(f)


def test_metrics_cli_matches_jax_evaluate(rendered, tmp_path, monkeypatch):
    """The port's metrics CLI and JAX's `evaluate` on the same renders:
    the same keys in results.json and per_view.json, SSIM, PSNR and AVG of
    each view within 1e-5, LPIPS null without weights."""
    monkeypatch.delenv(t_lpips._ENV_VAR, raising=False)
    model_dir = str(tmp_path / "model")
    shutil.copytree(rendered, model_dir)
    full = t_metrics_app.main(["-m", model_dir, "--device", "cpu"])
    port = read_json(model_dir, "results.json"), read_json(model_dir, "per_view.json")
    assert full == {model_dir: port[0]}
    j_metrics.evaluate([model_dir])
    ref = read_json(model_dir, "results.json"), read_json(model_dir, "per_view.json")
    method = f"ours_{ITERATIONS}"
    assert port[0].keys() == ref[0].keys() == {method}
    assert port[0][method].keys() == ref[0][method].keys()
    assert port[0][method]["LPIPS"] is None and "AVG_definition" in port[0][method]
    views = port[1][method]
    assert views.keys() == ref[1][method].keys()
    assert len(views["PSNR"]) == 2
    for metric, per_view in views.items():
        for name, value in per_view.items():
            want = ref[1][method][metric][name]
            if metric == "LPIPS":
                assert value is None and want is None
            else:
                assert abs(value - want) <= 1e-5 * max(1.0, abs(want)), (metric, name)


def test_acceptance_skip_train_equals_the_metrics_cli(scene_dir, rendered, tmp_path):
    """`acceptance --skip_train` renders the trained model again and gives
    the metrics CLI's results.json."""
    model_dir = str(tmp_path / "model")
    shutil.copytree(rendered, model_dir)
    t_metrics_app.main(["-m", model_dir, "--no_lpips", "--device", "cpu"])
    want = read_json(model_dir, "results.json")
    shutil.rmtree(os.path.join(model_dir, "test"))
    results = t_acceptance_app.main(["-s", scene_dir, "-m", model_dir, "--skip_train",
                                     "--iterations",
                                     str(ITERATIONS), "--no_lpips", "--device", "cpu"])
    assert results == want == read_json(model_dir, "results.json")
    assert len(os.listdir(os.path.join(model_dir, "train", f"ours_{ITERATIONS}", "renders"))) == 3


def test_render_video_matches_jax_render_model(trained, scene_dir, tmp_path):
    """`render_video --max_frames 3` on the LLFF spiral (poses_bounds.npy
    from `gen_poses`): frame PNGs within one 8-bit step of JAX's dense
    oracle on the same PLY and cameras, and both videos readable."""
    import cv2

    scene = str(tmp_path / "scene")
    shutil.copytree(scene_dir, scene)
    gen_poses(scene)
    model_dir = str(tmp_path / "model")
    shutil.copytree(trained[0], model_dir)
    seconds = t_video_app.main(["-m", model_dir, "-s", scene, "--max_frames", "3",
                                "--bg_capacity", "4096", "--device", "cpu"])
    assert [len(v) for v in seconds.values()] == [3, 3]
    base = os.path.join(model_dir, "video", f"ours_{ITERATIONS}")
    names = sorted(os.listdir(os.path.join(base, "frames")))
    assert names == [f"{p}{i:05d}.png" for p in ("", "depth_") for i in range(3)]
    for video in ("video_rgb.avi", "video_depth.avi"):
        cap = cv2.VideoCapture(os.path.join(base, video))
        assert cap.isOpened() and int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3, video
        cap.release()

    jvideo = jscene.VideoScene(source_path=scene, model_path=model_dir, resolution=1)
    assert len(jvideo.test_cameras) == 180  # the LLFF spiral (readers.py:346-348)
    jmodel = j_io.load_ply(os.path.join(model_dir, "point_cloud", f"iteration_{ITERATIONS}",
                                        "point_cloud.ply"), max_sh_degree=3, bg_capacity=4096)
    for i, cam in enumerate(jvideo.test_cameras[:3]):
        out = j_render_model(cam.camera, jmodel, jnp.zeros(3), backend="oracle")
        want = (np.clip(np.asarray(out.render), 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
        got = png(os.path.join(base, "frames", f"{i:05d}.png"))
        assert got.shape == want.shape == (48, 64, 3)
        assert np.abs(got - want.astype(np.int32)).max() <= LSB, i


def test_train_cli_serves_the_viewer(scene_dir, tmp_path, monkeypatch):
    """`--port 0` starts the listener; a viewer that connected and sent one
    request before training gets its render at iteration 1, the CLI polls
    at every iteration, and it closes the listener at the end."""
    import socket

    from test_torch_eval import read_reply, send_message, viewer_message

    opened = []

    class Recording(t_gui.NetworkGUI):
        def __init__(self, host, port):
            super().__init__(host, port)
            self.polls = 0
            client = socket.create_connection(self.listener.getsockname(), timeout=30)
            send_message(client, viewer_message(64, 48))
            client.shutdown(socket.SHUT_WR)  # the next read sees the viewer leave
            opened.append((self, client))

        def poll(self, *args, **kwargs):
            self.polls += 1
            return super().poll(*args, **kwargs)

    monkeypatch.setattr(t_gui, "NetworkGUI", Recording)
    t_train_app.main(["-s", scene_dir, "-m", str(tmp_path / "m"), "--iterations", "3",
                      "--test_iterations", "-1", "--save_iterations", "-1",
                      "--port", "0"] + FLAGS)
    gui, client = opened[0]
    try:
        assert len(opened) == 1 and gui.polls == 3
        img, verify = read_reply(client, 64 * 48 * 3)
        assert verify == os.path.abspath(scene_dir) and len(img) == 64 * 48 * 3
        assert gui.conn is None and gui.listener.fileno() == -1
    finally:
        client.close()


def test_eval_entry_points_raise_without_a_gpu(trained, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (t_metrics_app.main, t_video_app.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["-m", trained[0]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_acceptance_app.main(["-m", str(tmp_path / "m"), "--skip_train"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_geo_check.geocheck(np.eye(3)[None], np.eye(4)[None], np.ones((1, 4, 4)))
    assert not os.path.exists(os.path.join(trained[0], "results.json"))
    assert not os.path.exists(os.path.join(trained[0], "video"))


# ---------------- checkpoints ----------------

def test_checkpoint_leaf_order_matches_jax_tree_flatten():
    model, opt = jax_pair()
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path((model, opt))[0]]
    names = []
    for path in paths:
        attrs = [k.name for k in path if isinstance(k, jax.tree_util.GetAttrKey)]
        attrs = [a for a in attrs if a != "params"]
        names.append(".".join(attrs))
    assert tuple(names) == t_io.CHECKPOINT_LEAVES
    assert len(names) == 44


def test_checkpoints_cross_both_ways(trained, tmp_path):
    model_dir, _ = trained
    # the port's file, read by JAX
    path = os.path.join(model_dir, f"chkpnt{ITERATIONS}.npz")
    model, opt, it = t_io.load_checkpoint(path, "cpu")
    data = np.load(path)
    nr, cb = int(data["num_ray"]), int(data["bg_capacity"])
    template = j_create_model(np.zeros((nr, 3), np.float32), np.ones((nr, 3), np.float32),
                              np.ones((nr,), np.float32), np.zeros((nr, 3), np.float32),
                              int(data["max_sh_degree"]), float(data["spatial_lr_scale"]),
                              bg_capacity=cb)
    jm, jo, jit = j_io.load_checkpoint(path, template, joptim.init(template.params))
    assert it == jit == ITERATIONS and model.num_ray == nr and model.bg_capacity == cb
    assert_leaves_equal(port_leaves(model, opt), jax.tree_util.tree_leaves((jm, jo)))
    assert isinstance(opt.count, int) and opt.count == ITERATIONS - 1  # last step skipped

    # JAX's file, read by the port, written again and read back by JAX
    jm, jo = jax_pair(seed=3)
    j_io.save_checkpoint(str(tmp_path / "jax.npz"), jm, jo, 77)
    model, opt, it = t_io.load_checkpoint(str(tmp_path / "jax.npz"), "cpu")
    want = jax.tree_util.tree_leaves((jm, jo))
    assert it == 77 and model.max_sh_degree == jm.max_sh_degree
    assert model.spatial_lr_scale == jm.spatial_lr_scale
    assert_leaves_equal(port_leaves(model, opt), want)
    t_io.save_checkpoint(str(tmp_path / "port.npz"), model, opt, 78)
    back, back_opt, it = j_io.load_checkpoint(str(tmp_path / "port.npz"), jm, jo)
    assert it == 78
    assert_leaves_equal(jax.tree_util.tree_leaves((back, back_opt)), want)
    ref, port = np.load(str(tmp_path / "jax.npz")), np.load(str(tmp_path / "port.npz"))
    assert sorted(ref.files) == sorted(port.files)
    for key in ("num_leaves", "max_sh_degree", "spatial_lr_scale", "num_ray", "bg_capacity"):
        assert ref[key].dtype == port[key].dtype and ref[key] == port[key], key


def test_async_checkpointer_round_trip(trained, tmp_path):
    model, opt, _ = t_io.load_checkpoint(
        os.path.join(trained[0], f"chkpnt{ITERATIONS}.npz"), "cpu")
    want = port_leaves(model, opt)
    ck = t_io.AsyncCheckpointer()
    ck.save(str(tmp_path / "async"), model, opt, 91)
    with torch.no_grad():
        model.zval.add_(1.0)  # training goes on in place; the save holds its copy
    m2, o2, it = ck.restore(str(tmp_path / "async"), "cpu")
    assert it == 91
    assert_leaves_equal(port_leaves(m2, o2), want)
    ck.save(str(tmp_path / "async"), model, opt, 92)
    ck.wait()
    assert t_io.load_checkpoint(str(tmp_path / "async" / ck.FILE), "cpu")[2] == 92


def test_save_matchpoints_matches_jax(scene_dir, tmp_path):
    t = tscene.Scene(scene_dir, str(tmp_path / "tm"), resolution=1, device="cpu")
    j = jscene.Scene(scene_dir, str(tmp_path / "jm"), resolution=1)
    assert t.base_names == j.base_names
    rng = np.random.default_rng(6)
    near_far = t.bundle.near_far.numpy()
    z = rng.uniform(near_far[:, :1], near_far[:, 1:], size=t.bundle.mask.shape)
    z = z.astype(np.float32)
    t_io.save_matchpoints(t.bundle, torch.tensor(z), t.base_names, str(tmp_path / "t"))
    j_io.save_matchpoints(j.bundle, z, j.base_names, str(tmp_path / "j"))
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names and len(names) == 1 + 2 * 3
    a = tply.read_ply(str(tmp_path / "t" / "point_cloud_matchpoint.ply"))
    b = tply.read_ply(str(tmp_path / "j" / "point_cloud_matchpoint.ply"))
    for key in b:
        np.testing.assert_allclose(a[key].astype(np.float64), b[key].astype(np.float64),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    for name in t.base_names:
        np.testing.assert_allclose(np.load(tmp_path / "t" / f"{name}.npy"),
                                   np.load(tmp_path / "j" / f"{name}.npy"), rtol=1e-6, atol=1e-6)
        diff = png(tmp_path / "t" / f"sparsedepth_{name}.png") - png(
            tmp_path / "j" / f"sparsedepth_{name}.png")
        assert np.abs(diff).max() <= LSB


# ---------------- logging and profiling ----------------

def test_logger_timer_trace_and_safe_state(tmp_path, monkeypatch):
    logger = tlogging.TrainLogger(str(tmp_path), use_tensorboard=False)
    assert logger.tb is None
    logger.step(1, 0.5, 0.25, 0.01)
    logger.images("view/render", torch.zeros(3, 4, 5), 1)
    logger.json({"iter": 1, "loss": 0.25})
    logger.close()
    with open(tmp_path / "train_log.jsonl") as f:
        assert [json.loads(line) for line in f] == [{"iter": 1, "loss": 0.25}]

    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.span("phase"):
            torch.ones(4).sum()
    assert os.listdir(tmp_path / "trace")
    assert [s.name for s in profiling.WINDOW.spans] == ["phase"]

    import sys

    monkeypatch.setattr(sys, "stdout", sys.stdout)  # safe_state replaces it; restored after
    gen = tlogging.safe_state(silent=True, seed=4)
    assert torch.equal(torch.rand(3, generator=gen),
                       torch.rand(3, generator=torch.Generator().manual_seed(4)))
    assert np.random.rand() == np.random.RandomState(4).rand()
