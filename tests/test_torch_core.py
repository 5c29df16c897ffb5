"""The PyTorch port's core (config, cameras, transforms, SH) against the JAX
package, and the port's package guards.

Inputs come from numpy seeds and go to both packages; the port runs on the
CPU (`device="cpu"`)."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scgaussian_tpu_torch
from scgaussian_tpu import config as jconfig
from scgaussian_tpu.core import cameras as jcam
from scgaussian_tpu.core import sh as jsh
from scgaussian_tpu.core import transforms as jtr
from scgaussian_tpu_torch import config as tconfig
from scgaussian_tpu_torch.core import cameras as tcam
from scgaussian_tpu_torch.core import sh as tsh
from scgaussian_tpu_torch.core import transforms as ttr
from time_limits import per_test_limit  # noqa: F401 (autouse: a time limit for each test)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "scgaussian_tpu_torch"
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for each port test; the other test_torch_* files
    import this fixture. Their ops are small, and with PyTorch's default of
    a thread per core the waiting threads spin on cores that the other test
    workers need, which slows every worker many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(port, ref, **tol):
    np.testing.assert_allclose(
        port.detach().cpu().numpy(), np.asarray(ref), **(tol or TOL)
    )


def _rotmat(axis, angle):
    axis = np.asarray(axis, float)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


# ---------------- config ----------------

@pytest.mark.parametrize(
    "name", ["ModelConfig", "PipelineConfig", "OptimizationConfig", "RasterizerConfig", "TrainExtras"]
)
def test_config_fields_match(name):
    j = dataclasses.asdict(getattr(jconfig, name)())
    t = dataclasses.asdict(getattr(tconfig, name)())
    assert t == j


def test_config_json_round_trip(tmp_path):
    path = str(tmp_path / "cfg" / "config.json")
    tconfig.save_config(path, opt=tconfig.OptimizationConfig(iterations=7))
    jpath = str(tmp_path / "cfg" / "jconfig.json")
    jconfig.save_config(jpath, opt=jconfig.OptimizationConfig(iterations=7))
    assert tconfig.load_config(path) == jconfig.load_config(jpath)


# ---------------- cameras ----------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_camera_create_matches(seed):
    rng = np.random.default_rng(seed)
    R = _rotmat(rng.normal(size=3), rng.uniform(-0.6, 0.6)).T
    T = rng.normal(size=3)
    fovx, fovy = rng.uniform(0.5, 1.2, 2)
    W, H = int(rng.integers(20, 90)), int(rng.integers(20, 90))
    translate, scale = rng.normal(size=3), float(rng.uniform(0.5, 2.0))
    j = jcam.Camera.create(R, T, fovx, fovy, W, H, translate=translate, scale=scale)
    t = tcam.Camera.create(R, T, fovx, fovy, W, H, translate=translate, scale=scale,
                           device="cpu")
    assert (t.width, t.height) == (j.width, j.height)
    for f in ("world_view", "full_proj", "cam_center", "K", "tanfovx", "tanfovy", "znear", "zfar"):
        close(getattr(t, f), getattr(j, f))
        assert getattr(t, f).dtype == torch.float32
    moved = t.to("cpu")
    assert moved.device.type == "cpu" and torch.equal(moved.world_view, t.world_view)


def test_camera_helpers_match():
    for fov, px in [(0.7, 64), (1.1, 1920)]:
        assert tcam.fov2focal(fov, px) == jcam.fov2focal(fov, px)
        f = jcam.fov2focal(fov, px)
        assert tcam.focal2fov(f, px) == jcam.focal2fov(f, px)
    R, T = _rotmat([1, 2, 3], 0.3), np.array([0.1, -0.2, 0.4])
    np.testing.assert_array_equal(
        tcam.world_to_view(R, T, np.array([0.5, 0, 0]), 1.5),
        jcam.world_to_view(R, T, np.array([0.5, 0, 0]), 1.5),
    )
    np.testing.assert_array_equal(
        tcam.projection_matrix(0.01, 100.0, 0.8, 0.6),
        jcam.projection_matrix(0.01, 100.0, 0.8, 0.6),
    )
    np.testing.assert_array_equal(
        tcam.intrinsic_matrix(0.8, 0.6, 64, 48), jcam.intrinsic_matrix(0.8, 0.6, 64, 48)
    )


# ---------------- transforms ----------------

def test_transforms_match():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(50, 4)).astype(np.float32)
    s = np.exp(rng.uniform(-3, 0, (50, 3))).astype(np.float32)
    p = rng.uniform(0.01, 0.99, 50).astype(np.float32)
    tq, ts = torch.tensor(q), torch.tensor(s)
    close(ttr.quat_to_rotmat(tq), jtr.quat_to_rotmat(jnp.asarray(q)))
    close(ttr.build_scaling_rotation(ts, tq), jtr.build_scaling_rotation(jnp.asarray(s), jnp.asarray(q)))
    cov_t = ttr.covariance_from_scaling_rotation(ts, 1.3, tq)
    cov_j = jtr.covariance_from_scaling_rotation(jnp.asarray(s), 1.3, jnp.asarray(q))
    close(cov_t, cov_j)
    close(ttr.strip_symmetric(cov_t), jtr.strip_symmetric(cov_j))
    close(ttr.inverse_sigmoid(torch.tensor(p)), jtr.inverse_sigmoid(jnp.asarray(p)), rtol=1e-5)
    six = rng.normal(size=(50, 6)).astype(np.float32)
    full = ttr.unpack_symmetric(torch.tensor(six))
    close(full, jtr.unpack_symmetric(jnp.asarray(six)))
    close(ttr.strip_symmetric(full), six)
    close(ttr.unpack_symmetric(ttr.strip_symmetric(cov_t)), cov_j)
    v = rng.normal(size=(50, 3, 4)).astype(np.float32)
    for axis, eps in ((-1, 0.0), (1, 1e-3)):
        close(ttr.normalize(torch.tensor(v), axis, eps), jtr.normalize(jnp.asarray(v), axis, eps))


# ---------------- spherical harmonics ----------------

@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_matches(deg):
    rng = np.random.default_rng(10 + deg)
    k = tsh.num_sh_coeffs(deg)
    assert k == jsh.num_sh_coeffs(deg)
    dirs = rng.normal(size=(40, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    coeffs = rng.normal(size=(40, 3, k)).astype(np.float32)
    close(tsh.eval_sh(deg, torch.tensor(coeffs), torch.tensor(dirs)),
          jsh.eval_sh(deg, jnp.asarray(coeffs), jnp.asarray(dirs)))
    close(tsh.eval_sh_basis(deg, torch.tensor(dirs)), jsh.eval_sh_basis(deg, jnp.asarray(dirs)))
    rgb = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    close(tsh.rgb_to_sh(torch.tensor(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)))
    close(tsh.sh_to_rgb(torch.tensor(coeffs[..., 0])), jsh.sh_to_rgb(jnp.asarray(coeffs[..., 0])))


def test_sh_rejects_bad_degree():
    with pytest.raises(ValueError):
        tsh.eval_sh_basis(5, torch.zeros(2, 3))
    with pytest.raises(ValueError):
        tsh.eval_sh(2, torch.zeros(2, 3, 4), torch.zeros(2, 3))


# ---------------- guards ----------------

def test_tf32_off_after_import():
    assert scgaussian_tpu_torch.__name__ == "scgaussian_tpu_torch"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT.rglob("*.py")
    )
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in modules)
        + "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'scgaussian_tpu' or m.startswith('scgaussian_tpu.')]\n"
        "print(repr(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(REPO), env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    assert "scgaussian_tpu_torch.renderer.raster" in modules


def test_port_sources_never_name_jax_or_the_jax_package():
    pattern = re.compile(r"\bjax\b|scgaussian_tpu(?!_torch)")
    for path in list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("#", 1)[0]
            if re.match(r"\s*(import|from)\s", code):
                assert not pattern.search(code), f"{path}:{n}: {line}"


def test_resolve_device_never_picks_the_cpu_itself(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scgaussian_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError):
        scgaussian_tpu_torch.resolve_device("cuda")
    assert scgaussian_tpu_torch.resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError):
        tcam.Camera.create(np.eye(3), np.zeros(3), 0.8, 0.8, 32, 32)
