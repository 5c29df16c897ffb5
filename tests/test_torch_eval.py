"""The PyTorch port's evaluation (metrics, LPIPS, geo_check), auxiliary
losses, transforms' helpers, debug helpers, viewer and offline tools
against the JAX package on the CPU.

Inputs come from numpy seeds and go to both packages; the port runs with
`device="cpu"`. LPIPS weights are random, written to a temporary `.npz`
as `tests/test_lpips.py` does (the repo ships no VGG weights)."""

import json
import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from scgaussian_tpu.apps import convert as j_convert
from scgaussian_tpu.apps import get_match_info as j_match
from scgaussian_tpu.eval import geo_check as jgc
from scgaussian_tpu.eval import lpips_jax
from scgaussian_tpu.eval import metrics as jmetrics
from scgaussian_tpu.losses import aux as jaux
from scgaussian_tpu.utils import debug as jdebug
from scgaussian_tpu.viewer import network_gui as jgui
from scgaussian_tpu_torch.apps import convert as t_convert
from scgaussian_tpu_torch.apps import get_match_info as t_match
from scgaussian_tpu_torch.core.cameras import projection_matrix, world_to_view
from scgaussian_tpu_torch.eval import geo_check as tgc
from scgaussian_tpu_torch.eval import lpips as tlpips
from scgaussian_tpu_torch.eval import metrics as tmetrics
from scgaussian_tpu_torch.losses import aux as taux
from scgaussian_tpu_torch.model.gaussians import model_from_numpy
from scgaussian_tpu_torch.utils import debug as tdebug
from scgaussian_tpu_torch.viewer import network_gui as tgui
from test_torch_core import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)
from time_limits import per_test_limit  # noqa: F401 (autouse: a time limit for each test)
from test_torch_model import hybrid_leaves, jax_model

METRIC_TOL = 1e-5
LPIPS_REL = 1e-4  # tests/test_lpips.py:175
LSB = 1


# ---------------- LPIPS ----------------

def lpips_params(net: str, seed: int) -> dict:
    """Random weights in the `.npz` layout both packages read, He-scaled so
    every tap stays well conditioned; lin heads as tests/test_lpips.py."""
    rng = np.random.default_rng(seed)
    params = {}

    def conv(key, cout, cin, k):
        std = np.sqrt(2.0 / (cin * k * k))
        params[f"{key}_w"] = rng.normal(size=(cout, cin, k, k), scale=std).astype(np.float32)
        params[f"{key}_b"] = rng.normal(size=(cout,), scale=0.05).astype(np.float32)

    if net == "vgg":
        cin, ci = 3, 0
        for item in lpips_jax._VGG_CFG:
            if item != "M":
                conv(f"conv{ci}", item, cin, 3)
                cin, ci = item, ci + 1
        chans = [64, 128, 256, 512, 512]
    elif net == "alex":
        cin = 3
        for ci, (cout, k, _, _) in enumerate(c for c in lpips_jax._ALEX_CFG if c != "M"):
            conv(f"conv{ci}", cout, cin, k)
            cin = cout
        chans = [64, 192, 384, 256, 256]
    else:
        conv("conv0", 64, 3, 3)
        cin, fi = 64, 0
        for item in lpips_jax._SQUEEZE_CFG:
            if item != "M" and item[0] == "fire":
                _, s, e1, e3 = item
                conv(f"fire{fi}_squeeze", s, cin, 1)
                conv(f"fire{fi}_e1", e1, s, 1)
                conv(f"fire{fi}_e3", e3, s, 3)
                cin, fi = e1 + e3, fi + 1
        chans = [64, 128, 256, 384, 384, 512, 512]
    for i, c in enumerate(chans):
        params[f"lin{i}_w"] = np.abs(rng.normal(size=(1, c, 1, 1), scale=0.05)).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def lpips_weights(tmp_path_factory):
    """{net: path of a random-weight `.npz`}."""
    d = tmp_path_factory.mktemp("lpips")
    paths = {}
    for seed, net in enumerate(("vgg", "alex", "squeeze")):
        paths[net] = str(d / f"lpips_{net}.npz")
        np.savez(paths[net], **lpips_params(net, seed))
    return paths


@pytest.mark.parametrize("net", ["vgg", "alex", "squeeze"])
@pytest.mark.parametrize("size", [(64, 64), (75, 53)])
def test_lpips_matches_jax(net, size, lpips_weights):
    """All three towers, at 64x64 and at an odd size where the SqueezeNet
    ceil-mode pools and AlexNet's stride-4 conv leave ragged edges."""
    h, w = size
    rng = np.random.default_rng(h * w)
    x = rng.uniform(size=(2, 3, h, w)).astype(np.float32)
    y = np.clip(x + rng.normal(size=x.shape, scale=0.1), 0, 1).astype(np.float32)
    want = np.asarray(lpips_jax.LPIPS(net, weights_path=lpips_weights[net])(
        jnp.asarray(x), jnp.asarray(y)))
    model = tlpips.LPIPS(net, weights_path=lpips_weights[net], device="cpu")
    with torch.no_grad():
        got = model(torch.tensor(x), torch.tensor(y)).numpy()
    assert got.shape == want.shape == (2,)
    for a, b in zip(got, want):
        assert abs(a - b) <= LPIPS_REL * max(abs(b), 1e-3), (net, size, got, want)


def test_lpips_weights_lookup(tmp_path, monkeypatch):
    monkeypatch.delenv(tlpips._ENV_VAR, raising=False)
    assert not tlpips.lpips_available()
    with pytest.raises(FileNotFoundError):
        tlpips.LPIPS("vgg", device="cpu")
    path = tmp_path / "w.npz"
    np.savez(path, **lpips_params("alex", 0))
    monkeypatch.setenv(tlpips._ENV_VAR, str(path))
    assert tlpips.lpips_available() == lpips_jax.lpips_available() is True
    assert tlpips.LPIPS("alex", device="cpu").conv0_w.shape == (64, 3, 11, 11)
    with pytest.raises(ValueError, match="unknown"):
        tlpips.LPIPS("resnet", device="cpu")


# ---------------- metrics ----------------

def write_method_dir(root, views=3, w=64, h=48, masked=(0, 2), seed=0):
    """<root>/test/ours_7/{renders,gt,dtumask}: random renders, noisy ground
    truth, and DTU masks (at half size, so that they are resized) for the
    views in `masked`."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "test", "ours_7")
    for kind in ("renders", "gt", "dtumask"):
        os.makedirs(os.path.join(base, kind), exist_ok=True)
    for i in range(views):
        gt = rng.uniform(size=(h, w, 3))
        render = np.clip(gt + rng.normal(size=gt.shape, scale=0.08), 0, 1)
        name = f"{i:05d}.png"
        Image.fromarray((render * 255).astype(np.uint8)).save(os.path.join(base, "renders", name))
        Image.fromarray((gt * 255).astype(np.uint8)).save(os.path.join(base, "gt", name))
        if i in masked:
            m = (rng.uniform(size=(h // 2, w // 2)) > 0.3).astype(np.uint8) * 255
            Image.fromarray(m).save(os.path.join(base, "dtumask", name))
    return base


def assert_metrics_close(got: dict, want: dict, lpips: bool):
    assert got.keys() == want.keys()
    for k in ("SSIM", "PSNR", "AVG"):
        assert abs(got[k] - want[k]) <= METRIC_TOL * max(1.0, abs(want[k])), (k, got, want)
    if lpips:
        assert abs(got["LPIPS"] - want["LPIPS"]) <= LPIPS_REL * max(abs(want["LPIPS"]), 1e-3)
    else:
        assert got["LPIPS"] is None and want["LPIPS"] is None


def test_read_images_and_compute_image_metrics_match_jax(tmp_path):
    base = write_method_dir(str(tmp_path))
    args = [os.path.join(base, k) for k in ("renders", "gt", "dtumask")]
    from pathlib import Path

    t = tmetrics.read_images(*map(Path, args))
    j = jmetrics.read_images(*map(Path, args))
    assert t[2] == j[2]
    for a, b in zip(t[0] + t[1] + t[3], j[0] + j[1] + j[3]):
        np.testing.assert_array_equal(a, b)
    assert not t[3][0].all() and t[3][1].all()  # view 0 masked, view 1 not
    for r, g, m in zip(t[0], t[1], t[3]):
        assert_metrics_close(tmetrics.compute_image_metrics(r, g, m, device="cpu"),
                             jmetrics.compute_image_metrics(r, g, m), lpips=False)


@pytest.mark.parametrize("use_lpips", [False, True])
def test_evaluate_matches_jax(tmp_path, monkeypatch, lpips_weights, use_lpips):
    """results.json and per_view.json of both packages on one model
    directory: same keys, values within the tolerances, LPIPS null (and the
    AVG_definition marker) without weights."""
    if use_lpips:
        monkeypatch.setenv(tlpips._ENV_VAR, lpips_weights["vgg"])
    else:
        monkeypatch.delenv(tlpips._ENV_VAR, raising=False)
    model = str(tmp_path / "model")
    write_method_dir(model)

    def files():
        out = []
        for name in ("results.json", "per_view.json"):
            with open(os.path.join(model, name)) as f:
                out.append(json.load(f))
        return out

    jmetrics.evaluate([model], use_lpips=True)
    j_results, j_views = files()
    full = tmetrics.evaluate([model], use_lpips=True, device="cpu")
    t_results, t_views = files()
    assert full == {model: t_results}
    assert t_results.keys() == j_results.keys() == {"ours_7"}
    assert t_results["ours_7"].keys() == j_results["ours_7"].keys()
    assert ("AVG_definition" in t_results["ours_7"]) is (not use_lpips)
    if use_lpips:
        assert t_results["ours_7"]["AVG"] == t_results["ours_7"]["LPIPS"]  # the quirk
    assert t_views.keys() == j_views.keys()
    tv, jv = t_views["ours_7"], j_views["ours_7"]
    assert tv.keys() == jv.keys() == set(tmetrics.METRICS)
    for name in jv["PSNR"]:
        assert_metrics_close({k: tv[k][name] for k in tv}, {k: jv[k][name] for k in jv},
                             lpips=use_lpips)


# ---------------- geo_check ----------------

def small_rig(n=4, h=24, w=32, seed=0):
    """`tests/test_geo_check.py::_small_rig`: slanted-plane depths seen from
    small baseline shifts."""
    rng = np.random.default_rng(seed)
    K = np.eye(3, dtype=np.float64)
    K[0, 0] = K[1, 1] = 40.0
    K[0, 2], K[1, 2] = w / 2, h / 2
    intrs = np.stack([K] * n)
    extrs = []
    for i in range(n):
        E = np.eye(4)
        E[:3, 3] = [0.03 * i, 0.01 * i, 0.0]
        extrs.append(E)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = 2.0 + 0.01 * xx + 0.005 * yy
    depths = np.stack([base + 0.001 * rng.standard_normal((h, w)) for _ in range(n)])
    return intrs, np.stack(extrs), depths


def test_reproject_with_depth_matches_jax():
    intrs, extrs, depths = small_rig()
    args = [x.astype(np.float32) for x in (depths[0], intrs[0], extrs[0],
                                            depths[1], intrs[1], extrs[1])]
    got = tgc.reproject_with_depth(*map(torch.tensor, args))
    want = jgc.reproject_with_depth(*args)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("view_thresh,num_select", [(1, 3), (5, 15)])
def test_geocheck_matches_jax(view_thresh, num_select):
    """Masks equal; depths within 1e-5 relative where both keep a pixel. The
    second case is the default (15 sources) on 4 cameras: the pair table
    truncates, so every view also checks itself (the reference quirk)."""
    intrs, extrs, depths = small_rig()
    depths[3] *= 1.02  # one view off by 2%
    td, tm = tgc.geocheck(intrs, extrs, depths, view_thresh=view_thresh,
                          num_select=num_select, device="cpu")
    jd, jm = jgc.geocheck(intrs, extrs, depths, view_thresh=view_thresh,
                          num_select=num_select)
    assert tm.dtype == jm.dtype == np.float32
    np.testing.assert_array_equal(tm, jm)
    keep = tm > 0
    np.testing.assert_allclose(td[keep], jd[keep], rtol=1e-5)
    assert (td[~keep] == 0).all()
    np.testing.assert_array_equal(tgc.get_pairs(extrs, num_select),
                                  jgc.get_pairs(extrs, num_select))


def test_geocheck_rejects_inconsistent_view():
    """`tests/test_geo_check.py:68-76` on the port."""
    intrs, extrs, depths = small_rig()
    depths[2] *= 1.5
    _, masks = tgc.geocheck(intrs, extrs, depths, view_thresh=1, num_select=3, device="cpu")
    assert masks[2].mean() < 0.05
    assert masks[0].mean() > 0.5


def test_visualize_depth_matches_jax():
    """`tests/test_geo_check.py:79-80` on the port, and the pixels equal JAX's."""
    depth = np.linspace(0.5, 2.0, 48).reshape(6, 8)
    depth[0, 0] = 0.0
    img = tgc.visualize_depth(depth)
    assert img.size == (8, 6)
    np.testing.assert_array_equal(np.asarray(img), np.asarray(jgc.visualize_depth(depth)))
    np.testing.assert_array_equal(np.asarray(tgc.visualize_depth(depth, (0.5, 1.5))),
                                  np.asarray(jgc.visualize_depth(depth, (0.5, 1.5))))


# ---------------- auxiliary losses ----------------

AUX_H, AUX_W, PATCH = 18, 26, 4  # not whole patches: patchify crops


def aux_case(name: str, seed: int = 0):
    """(inputs as numpy, the names of the differentiated inputs, a function
    of (module, inputs) -> loss): the same call on either package."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def depth(scale=1.0):
        return (2.0 + scale * rng.normal(size=(1, 1, AUX_H, AUX_W))).astype(f32)

    if name.startswith("smooth"):
        guide = {"smooth": None, "smooth_guide2d": rng.uniform(size=(AUX_H, AUX_W)),
                 "smooth_guide3d": rng.uniform(size=(3, AUX_H, AUX_W))}[name]
        inputs = {"depth": depth(0.3)[0, 0]}
        if guide is not None:
            inputs["guide"] = guide.astype(f32)
        return inputs, ["depth"] + (["guide"] if guide is not None else []), \
            lambda m, x: m.get_smooth_loss(x["depth"], x.get("guide"))
    if name == "margin_l2":
        a = rng.normal(size=(20, 9)).astype(f32)
        b = rng.normal(size=(20, 9)).astype(f32)
        return {"a": a, "b": b, "mask": rng.uniform(size=20) > 0.4}, ["a", "b"], \
            lambda m, x: m.margin_l2_loss(x["a"], x["b"], x["mask"], 0.3)
    if name == "patch_norm_mse":
        mask = (rng.uniform(size=(1, 1, AUX_H, AUX_W)) > 0.8).astype(f32)
        return {"inp": depth(), "tgt": depth(), "mask": mask}, ["inp", "tgt"], \
            lambda m, x: m.patch_norm_mse_loss(x["inp"], x["tgt"], x["mask"], PATCH)
    if name == "ranking":
        idx = rng.choice(PATCH * PATCH, 6, replace=False).astype(np.int32)
        return {"inp": depth(), "tgt": depth(), "idx": idx}, ["inp"], \
            lambda m, x: m.ranking_loss(x["inp"], x["tgt"], PATCH, margin=0.05,
                                        sample_idx=x["idx"])
    if name == "cons":
        tgt = depth(0.004)  # target gaps below 0.01, so pairs take part
        tgt[0, 0, :4, :4] = 2.0  # ties in the target: the stable sort orders them
        return {"inp": depth(0.01), "tgt": tgt}, ["inp"], \
            lambda m, x: m.cons_loss(x["inp"], x["tgt"], PATCH, margin=1e-3)
    if name == "virtual_warp":
        v = 3
        K = np.array([[30.0, 0, AUX_W / 2, 0], [0, 30.0, AUX_H / 2, 0], [0, 0, 1, 0],
                      [0, 0, 0, 1]], f32)
        w2cs = np.stack([np.eye(4, dtype=f32) for _ in range(v)])
        for i in range(v):
            w2cs[i, :3, 3] = [0.04 * (i - 1), 0.02 * i, 0.0]
        c2w = np.eye(4, dtype=f32)[:3]
        c2w[:, 3] = [0.01, -0.01, 0.0]
        return {"img": rng.uniform(size=(3, AUX_H, AUX_W)).astype(f32),
                "depth": (2.0 + 0.1 * rng.uniform(size=(AUX_H, AUX_W))).astype(f32),
                "c2w": c2w, "intrs": np.stack([K] * v), "w2cs": w2cs,
                "colors": rng.uniform(size=(v, 3, AUX_H, AUX_W)).astype(f32),
                "mask": rng.uniform(size=(AUX_H, AUX_W)) > 0.2}, ["img", "depth", "colors"], \
            lambda m, x: m.get_virtual_warp_loss(x["img"], x["depth"], x["c2w"], x["intrs"],
                                                 x["w2cs"], x["colors"], x["mask"])
    raise KeyError(name)


AUX_CASES = ["smooth", "smooth_guide2d", "smooth_guide3d", "margin_l2", "patch_norm_mse",
             "ranking", "cons", "virtual_warp"]


@pytest.mark.parametrize("name", AUX_CASES)
def test_aux_loss_matches_jax(name):
    """Value ≤ 1e-5 relative, autograd gradients against `jax.grad` ≤
    1e-4·max|g| for every differentiated input."""
    inputs, diff, fn = aux_case(name)
    j_in = {k: jnp.asarray(v) for k, v in inputs.items()}

    def j_loss(*xs):
        return fn(jaux, {**j_in, **dict(zip(diff, xs))})

    j_val, j_grads = jax.jit(jax.value_and_grad(j_loss, argnums=tuple(range(len(diff)))))(
        *[j_in[k] for k in diff])
    t_in = {k: torch.tensor(v, requires_grad=k in diff) for k, v in inputs.items()}
    t_val = fn(taux, t_in)
    t_grads = torch.autograd.grad(t_val, [t_in[k] for k in diff])
    assert abs(float(t_val.detach()) - float(j_val)) <= 1e-5 * max(abs(float(j_val)), 1.0)
    assert float(j_val) != 0.0  # the case exercises the loss
    for k, a, b in zip(diff, t_grads, j_grads):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max(),
                                   err_msg=k)


def test_aux_patchify_masks_and_draws():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 1, AUX_H, AUX_W)).astype(np.float32)
    np.testing.assert_array_equal(taux.patchify(torch.tensor(x), PATCH).numpy(),
                                  np.asarray(jaux.patchify(jnp.asarray(x), PATCH)))
    with pytest.raises(ValueError):
        taux.patchify(torch.zeros(1, 2, 8, 8), PATCH)
    inputs, _, _ = aux_case("patch_norm_mse")
    t = taux.patch_norm_mse_loss(*(torch.tensor(inputs[k]) for k in ("inp", "tgt", "mask")),
                                 PATCH, return_mask=True)[1]
    j = jaux.patch_norm_mse_loss(*(jnp.asarray(inputs[k]) for k in ("inp", "tgt", "mask")),
                                 PATCH, return_mask=True)[1]
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the draw: 6 distinct in-patch positions from the generator, repeatable
    d = torch.tensor(x[:1])
    a = taux.ranking_loss(d, d.flip(-1), PATCH, generator=torch.Generator().manual_seed(3))
    b = taux.ranking_loss(d, d.flip(-1), PATCH, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="generator"):
        taux.ranking_loss(d, d, PATCH)


# ---------------- debug ----------------

def test_check_model_finite_matches_jax():
    leaves = hybrid_leaves(2)
    assert tdebug.check_model_finite(model_from_numpy(leaves, 3, device="cpu")) == {}
    leaves["zval"][3, 0] = np.nan
    leaves["bg_scaling"][1, 2] = np.inf
    leaves["bg_scaling"][5, 0] = -np.inf
    leaves["f_dc"][:] = np.nan
    report = tdebug.check_model_finite(model_from_numpy(leaves, 3, device="cpu"))
    assert report == jdebug.check_model_finite(jax_model(leaves))
    assert report["bg_scaling"]["inf"] == 2 and report["f_dc"]["max_abs"] is None
    with pytest.raises(FloatingPointError, match="non-finite"):
        tdebug.assert_model_finite(model_from_numpy(leaves, 3, device="cpu"))


def test_debug_nans_sets_anomaly_mode():
    try:
        tdebug.debug_nans(True)
        assert torch.is_anomaly_enabled()
        tdebug.debug_nans(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)


# ---------------- viewer ----------------

VIEW_W, VIEW_H = 64, 48


def viewer_message(width=32, height=24, train=True, keep_alive=True) -> dict:
    """A SIBR request: matrices transposed (row-vector) with y/z flipped, as
    the viewer sends them, for the camera of `test_torch_model.cameras(1)`."""
    w2c = world_to_view(np.eye(3), np.array([0.05, -0.03, 0.0]))
    full = projection_matrix(0.01, 100.0, 0.8, 0.7) @ w2c
    view_t, proj_t = w2c.T.copy(), full.T.copy()
    view_t[:, 1:3] *= -1
    proj_t[:, 1] *= -1
    return {"resolution_x": width, "resolution_y": height, "train": train,
            "fov_y": 0.7, "fov_x": 0.8, "z_near": 0.01, "z_far": 100.0,
            "shs_python": False, "rot_scale_python": False, "keep_alive": keep_alive,
            "scaling_modifier": 1.0, "view_matrix": [float(v) for v in view_t.flatten()],
            "view_projection_matrix": [float(v) for v in proj_t.flatten()]}


def send_message(sock, msg):
    payload = json.dumps(msg).encode()
    sock.sendall(len(payload).to_bytes(4, "little") + payload)


def recv_exact(sock, n):
    """`n` bytes (a socket with a timeout returns what has arrived)."""
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, f"connection closed after {len(buf)} of {n} bytes"
        buf += chunk
    return buf


def read_reply(sock, n_bytes):
    img = recv_exact(sock, n_bytes)
    n = int.from_bytes(recv_exact(sock, 4), "little")
    return img, recv_exact(sock, n).decode()


def connect(gui):
    """A client socket whose connection `gui` has accepted."""
    client = socket.create_connection(("127.0.0.1", gui.listener.getsockname()[1]), timeout=30)
    for _ in range(3000):
        gui.try_connect()
        if gui.conn is not None:
            return client
        time.sleep(0.01)
    raise AssertionError("viewer client never connected")


def test_network_gui_protocol():
    """`tests/test_apps_extras.py:81-132` on the port: the request decodes
    to the same camera dict as JAX's, and the reply's wire format."""
    gui = tgui.NetworkGUI(port=0)
    client = connect(gui)
    try:
        msg = viewer_message()
        send_message(client, msg)
        cam, do_training, shs, rot, keep_alive, scaling = gui.receive()
        assert (do_training, shs, rot, keep_alive, scaling) == (True, False, False, True, 1.0)
        jgui_cam = jgui.NetworkGUI.receive(
            type("Stub", (), {"_read": lambda self: json.loads(json.dumps(msg))})())[0]
        assert cam.keys() == jgui_cam.keys()
        for k in cam:
            np.testing.assert_array_equal(np.asarray(cam[k]), np.asarray(jgui_cam[k]), err_msg=k)
        gui.send(bytes(32 * 24 * 3), "ok")
        img, verify = read_reply(client, 32 * 24 * 3)
        assert verify == "ok" and len(img) == 32 * 24 * 3
        send_message(client, dict(msg, resolution_x=0))
        assert gui.receive() == (None,) * 6
    finally:
        client.close()
        gui.close()


def test_render_for_viewer_matches_jax():
    """The port's tile path (plain versions on the CPU) against JAX's dense
    oracle on the same model and request: H*W*3 bytes within one 8-bit step."""
    leaves = hybrid_leaves(3)
    msg = viewer_message(VIEW_W, VIEW_H)
    stub = type("Stub", (), {"_read": lambda self: msg})()
    cam = tgui.NetworkGUI.receive(stub)[0]
    got = tgui.render_for_viewer(cam, model_from_numpy(leaves, 3, device="cpu"))
    want = jgui.render_for_viewer(jgui.NetworkGUI.receive(stub)[0], jax_model(leaves),
                                  backend="oracle")
    assert len(got) == len(want) == VIEW_W * VIEW_H * 3
    a = np.frombuffer(got, np.uint8).astype(np.int32)
    b = np.frombuffer(want, np.uint8).astype(np.int32)
    assert np.abs(a - b).max() <= LSB
    assert a.max() > 0  # the model is in view


def test_poll_serves_drops_on_protocol_errors_and_propagates_render_errors(monkeypatch):
    gui = tgui.NetworkGUI(port=0)
    model = model_from_numpy(hybrid_leaves(4), 3, device="cpu")
    try:
        # a request at viewer size, then training released: poll returns
        client = connect(gui)
        send_message(client, viewer_message(VIEW_W, VIEW_H))
        gui.poll(model, "/scene", 1, 10)
        img, verify = read_reply(client, VIEW_W * VIEW_H * 3)
        assert verify == "/scene" and len(img) == VIEW_W * VIEW_H * 3
        assert gui.conn is not None
        # garbage on the wire: a protocol error drops the connection only
        client.sendall((5).to_bytes(4, "little") + b"{nope")
        gui.poll(model, "/scene", 2, 10)
        assert gui.conn is None
        client.close()
        # a failing render propagates and keeps the connection
        client = connect(gui)

        def broken(*args, **kwargs):
            raise RuntimeError("kernel launch failed")

        monkeypatch.setattr(tgui, "render_for_viewer", broken)
        send_message(client, viewer_message(VIEW_W, VIEW_H))
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            gui.poll(model, "/scene", 3, 10)
        assert gui.conn is not None
        client.close()
    finally:
        gui.close()


# ---------------- offline tools ----------------

def textured_views(img_dir, views=10):
    """`tests/test_apps_extras.py:14-41`'s textured views, shifted per view."""
    import cv2

    rng = np.random.default_rng(0)
    base = np.full((160, 200, 3), 40, np.uint8)
    for _ in range(120):
        x, y = rng.integers(5, 195), rng.integers(5, 155)
        c = tuple(int(v) for v in rng.integers(60, 255, 3))
        if rng.random() < 0.5:
            cv2.circle(base, (x, y), int(rng.integers(3, 9)), c, -1)
        else:
            s = int(rng.integers(3, 10))
            cv2.rectangle(base, (x - s, y - s), (x + s, y + s), c, -1)
    os.makedirs(img_dir)
    for v in range(views):
        M = np.float32([[1, 0, -v * 3], [0, 1, -v * 2]])
        cv2.imwrite(os.path.join(img_dir, f"v_{v:03d}.png"), cv2.warpAffine(base, M, (200, 160)))


def test_extract_matches_equals_jax(tmp_path):
    import cv2

    img_dir = str(tmp_path / "images")
    textured_views(img_dir)
    out = {}
    for name, mod in (("jax", j_match), ("port", t_match)):
        cv2.setRNGSeed(0)
        out[name] = mod.extract_matches(img_dir, str(tmp_path / f"{name}.npy"), "sift", 500,
                                        vis_dir=str(tmp_path / f"vis_{name}"))
    assert out["port"].keys() == out["jax"].keys() and len(out["jax"]) == 3
    for a in out["jax"]:
        assert out["port"][a].keys() == out["jax"][a].keys()
        for b in out["jax"][a]:
            assert len(out["jax"][a][b]) > 20
            np.testing.assert_array_equal(out["port"][a][b], out["jax"][a][b])
    figs = sorted(os.listdir(tmp_path / "vis_jax"))
    assert sorted(os.listdir(tmp_path / "vis_port")) == figs and len(figs) == 3
    assert t_match.llff_train_split([f"{i}.png" for i in range(20)]) == \
        j_match.llff_train_split([f"{i}.png" for i in range(20)])


def test_convert_runs_the_same_commands(tmp_path, monkeypatch):
    src = tmp_path / "scene"
    (src / "images").mkdir(parents=True)
    for name in ("a.png", "b.png"):
        (src / "images" / name).write_bytes(b"png")
    commands = []
    monkeypatch.setattr(os, "system", lambda cmd: commands.append(cmd) or 0)
    argv = ["-s", str(src), "--resize", "--camera", "PINHOLE", "--no_gpu"]
    j_convert.main(argv)
    jax_commands, commands[:] = list(commands), []
    t_convert.main(argv)
    assert commands == jax_commands and len(commands) == 4 + 3 * 2
    assert all("colmap" in c or "magick" in c for c in commands)


# ---------------- on the card ----------------

@pytest.mark.cuda
def test_cuda_lpips_and_ssim_match_the_cpu(lpips_weights):
    """LPIPS (all three towers, cuDNN convolutions with TF32 off) and SSIM on
    the card against the same functions on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from scgaussian_tpu_torch.losses import ssim

    rng = np.random.default_rng(9)
    x = rng.uniform(size=(2, 3, 75, 53)).astype(np.float32)
    y = np.clip(x + rng.normal(size=x.shape, scale=0.1), 0, 1).astype(np.float32)
    for net, path in lpips_weights.items():
        cpu = tlpips.LPIPS(net, weights_path=path, device="cpu")
        card = tlpips.LPIPS(net, weights_path=path, device="cuda")
        with torch.no_grad():
            want = cpu(torch.tensor(x), torch.tensor(y)).numpy()
            got = card(torch.tensor(x, device="cuda"), torch.tensor(y, device="cuda")).cpu().numpy()
        for a, b in zip(got, want):
            assert abs(a - b) <= LPIPS_REL * max(abs(b), 1e-3), (net, got, want)
    for i in range(2):
        want = float(ssim(torch.tensor(x[i]), torch.tensor(y[i])))
        got = float(ssim(torch.tensor(x[i], device="cuda"), torch.tensor(y[i], device="cuda")))
        assert abs(got - want) <= 1e-5


def noisy_rig(n=8, h=96, w=128, seed=5):
    """`small_rig`'s cameras with 0.8% per-pixel depth noise, so that many
    (pixel, source) pairs lie near geocheck's 1% threshold."""
    intrs, extrs, depths = small_rig(n, h, w, seed)
    rng = np.random.default_rng(seed + 1)
    return intrs, extrs, depths * (1.0 + 0.008 * rng.standard_normal(depths.shape))


@pytest.mark.cuda
def test_cuda_geocheck_matches_the_cpu():
    """The reprojection gives the CPU's bits on the card, so the per-source
    masks, the counts and the averaged depths agree and no strict threshold
    can split them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    intrs, extrs, depths = noisy_rig()
    args = [x.astype(np.float32) for x in (depths[0], intrs[0], extrs[0],
                                            depths[3], intrs[3], extrs[3])]
    want = tgc.reproject_with_depth(*map(torch.tensor, args))
    got = tgc.reproject_with_depth(*(torch.tensor(a, device="cuda") for a in args))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    cd, cm = tgc.geocheck(intrs, extrs, depths, view_thresh=3, num_select=7, device="cuda")
    pd, pm = tgc.geocheck(intrs, extrs, depths, view_thresh=3, num_select=7, device="cpu")
    np.testing.assert_array_equal(cm, pm)
    assert 0.05 < pm.mean() < 0.95
    np.testing.assert_allclose(cd[pm > 0], pd[pm > 0], rtol=1e-5)
