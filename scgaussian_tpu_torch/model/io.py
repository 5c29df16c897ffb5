"""Model persistence: reference-compatible PLY snapshots + checkpoints.

Port of `scgaussian_tpu/model/io.py`, in the same PLY layout, so a file
written by either package loads in the other (and in the reference's
tooling):

- foreground: x,y,z,nx,ny,nz,f_dc_*,f_rest_* (channel-major),opacity,
  scale_*,rot_*,zval_*,rayo_*,rayd_* (`scene/gaussian_model.py:531-549,
  565-586`)
- background: b-prefixed names in point_cloud_bg.ply (`:551-563, 588-601`)
- colored cloud point_cloud_color.ply (`:603-609`)
- init-stage sparse depth maps + matchpoint cloud (`save_ply_at_matchpoint`,
  `:611-642`)

Checkpoints are one .npz of the (model, Adam state) leaves under the keys
`leaf_0` ... `leaf_43`, in the order in which the JAX package flattens its
`(GaussianModel, AdamState)` pytree (`CHECKPOINT_LEAVES`), with the same
scalar keys beside them, so each package loads the other's files. The
asynchronous checkpointer writes the same file from a background thread.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from scgaussian_tpu_torch.data import ply as ply_io
from scgaussian_tpu_torch.model.gaussians import (
    BUFFER_NAMES, PARAM_NAMES, STAT_NAMES, GaussianModel, model_from_numpy,
)
from scgaussian_tpu_torch.train import optim


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_ply(model: GaussianModel, path: str) -> None:
    """save_ply (`scene/gaussian_model.py:565-609`). Only alive bg rows are
    written; fg is written in full (it is always fully alive)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    nr = model.num_ray
    xyz = _np(model.rayo + model.rayd * model.zval)
    f_dc = _np(model.f_dc).transpose(0, 2, 1).reshape(nr, -1)  # channel-major
    f_rest = _np(model.f_rest).transpose(0, 2, 1).reshape(nr, -1)

    props = {}
    for i, n in enumerate("xyz"):
        props[n] = xyz[:, i].astype(np.float32)
    for n in ["nx", "ny", "nz"]:
        props[n] = np.zeros(nr, np.float32)
    for i in range(f_dc.shape[1]):
        props[f"f_dc_{i}"] = f_dc[:, i].astype(np.float32)
    for i in range(f_rest.shape[1]):
        props[f"f_rest_{i}"] = f_rest[:, i].astype(np.float32)
    props["opacity"] = _np(model.opacity)[:, 0].astype(np.float32)
    for i in range(3):
        props[f"scale_{i}"] = _np(model.scaling)[:, i].astype(np.float32)
    for i in range(4):
        props[f"rot_{i}"] = _np(model.rotation)[:, i].astype(np.float32)
    props["zval_0"] = _np(model.zval)[:, 0].astype(np.float32)
    for i in range(3):
        props[f"rayo_{i}"] = _np(model.rayo)[:, i].astype(np.float32)
    for i in range(3):
        props[f"rayd_{i}"] = _np(model.rayd)[:, i].astype(np.float32)
    ply_io.write_ply(path, props)

    alive = _np(model.bg_alive)
    bg_dir = os.path.dirname(path)
    all_xyz, all_dc = xyz, f_dc
    if alive.any():
        nb = int(alive.sum())
        bg_xyz = _np(model.bg_xyz)[alive]
        bg_dc = _np(model.bg_f_dc)[alive].transpose(0, 2, 1).reshape(nb, -1)
        bg_rest = _np(model.bg_f_rest)[alive].transpose(0, 2, 1).reshape(nb, -1)
        bprops = {}
        for i, n in enumerate(["bx", "by", "bz"]):
            bprops[n] = bg_xyz[:, i].astype(np.float32)
        for n in ["bnx", "bny", "bnz"]:
            bprops[n] = np.zeros(nb, np.float32)
        for i in range(bg_dc.shape[1]):
            bprops[f"bf_dc_{i}"] = bg_dc[:, i].astype(np.float32)
        for i in range(bg_rest.shape[1]):
            bprops[f"bf_rest_{i}"] = bg_rest[:, i].astype(np.float32)
        bprops["bopacity"] = _np(model.bg_opacity)[alive][:, 0].astype(np.float32)
        for i in range(3):
            bprops[f"bscale_{i}"] = _np(model.bg_scaling)[alive][:, i].astype(np.float32)
        for i in range(4):
            bprops[f"brot_{i}"] = _np(model.bg_rotation)[alive][:, i].astype(np.float32)
        ply_io.write_ply(os.path.join(bg_dir, "point_cloud_bg.ply"), bprops)
        all_xyz = np.concatenate([xyz, bg_xyz])
        all_dc = np.concatenate([f_dc, bg_dc])

    ply_io.store_point_cloud(
        os.path.join(bg_dir, "point_cloud_color.ply"), all_xyz, all_dc * 255
    )


def _stack(v: dict, prefix: str, n: int) -> np.ndarray:
    names = sorted(
        [nm for nm in v if nm.startswith(prefix)], key=lambda s: int(s.split("_")[-1])
    )
    if len(names) != n:
        raise ValueError(f"expected {n} '{prefix}*' properties, found {len(names)}")
    return np.stack([v[nm] for nm in names], axis=1)


def load_ply(path: str, max_sh_degree: int, bg_capacity: int = 65536,
             spatial_lr_scale: float = 1.0,
             device: str | torch.device | None = None) -> GaussianModel:
    """load_ply incl. point_cloud_bg.ply (`scene/gaussian_model.py:653-756`).
    active_sh_degree is set to max (`:715`). Runs on `device` (default: the
    GPU)."""
    v = ply_io.read_ply(path)
    nr = len(v["x"])
    k = (max_sh_degree + 1) ** 2

    leaves = dict(
        f_dc=_stack(v, "f_dc_", 3).reshape(nr, 3, 1).transpose(0, 2, 1),
        f_rest=_stack(v, "f_rest_", 3 * (k - 1)).reshape(nr, 3, k - 1).transpose(0, 2, 1),
        scaling=_stack(v, "scale_", 3),
        rotation=_stack(v, "rot_", 4),
        zval=v["zval_0"].reshape(nr, 1),
        rayo=_stack(v, "rayo_", 3),
        rayd=_stack(v, "rayd_", 3),
        opacity=v["opacity"].reshape(nr, 1),
    )

    cb = bg_capacity
    bg = dict(
        bg_xyz=np.zeros((cb, 3), np.float32),
        bg_f_dc=np.zeros((cb, 1, 3), np.float32),
        bg_f_rest=np.zeros((cb, k - 1, 3), np.float32),
        bg_scaling=np.full((cb, 3), -10.0, np.float32),
        bg_rotation=np.tile(np.array([1, 0, 0, 0], np.float32), (cb, 1)),
        bg_opacity=np.full((cb, 1), -10.0, np.float32),
    )
    bg_alive = np.zeros((cb,), bool)

    bg_path = os.path.join(os.path.dirname(path), "point_cloud_bg.ply")
    if os.path.exists(bg_path):
        bv = ply_io.read_ply(bg_path)
        nb = len(bv["bx"])
        if nb > cb:
            raise ValueError(f"bg capacity {cb} < saved bg count {nb}")
        bg["bg_xyz"][:nb] = np.stack([bv["bx"], bv["by"], bv["bz"]], axis=1)
        bg["bg_f_dc"][:nb] = _stack(bv, "bf_dc_", 3).reshape(nb, 3, 1).transpose(0, 2, 1)
        bg["bg_f_rest"][:nb] = (
            _stack(bv, "bf_rest_", 3 * (k - 1)).reshape(nb, 3, k - 1).transpose(0, 2, 1)
        )
        bg["bg_scaling"][:nb] = _stack(bv, "bscale_", 3)
        bg["bg_rotation"][:nb] = _stack(bv, "brot_", 4)
        bg["bg_opacity"][:nb] = bv["bopacity"].reshape(nb, 1)
        bg_alive[:nb] = True

    leaves.update(bg)
    leaves = {kk: np.ascontiguousarray(vv, np.float32) for kk, vv in leaves.items()}
    leaves["bg_alive"] = bg_alive
    leaves["active_sh_degree"] = np.int32(max_sh_degree)
    return model_from_numpy(leaves, max_sh_degree, device, spatial_lr_scale)


def save_matchpoints(bundle, zvals, view_names, out_dir: str) -> None:
    """save_ply_at_matchpoint (`scene/gaussian_model.py:611-642`): matchpoint
    colored cloud + per-view sparse depth .npy/.png. `zvals` [P, M] is the
    init stage's best z (a tensor or an array)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    zvals = _np(zvals) if isinstance(zvals, torch.Tensor) else np.asarray(zvals)
    rays_o = _np(bundle.rays_o)
    rays_d = _np(bundle.rays_d)
    cam_rays_d = _np(bundle.cam_rays_d)
    uv = _np(bundle.uv)
    color = _np(bundle.color)
    valid = _np(bundle.pad_valid)
    src = _np(bundle.src)
    H, W = bundle.height, bundle.width

    xyz = (rays_o + rays_d * zvals[..., None]).reshape(-1, 3)[valid.reshape(-1)]
    col = color.reshape(-1, 3)[valid.reshape(-1)]
    ply_io.store_point_cloud(
        os.path.join(out_dir, "point_cloud_matchpoint.ply"), xyz, col * 255
    )

    for v, name in enumerate(view_names):
        sparse = np.zeros((H, W), np.float32)
        pair_ids = np.nonzero(src == v)[0]
        for pid in pair_ids:
            m = valid[pid]
            d = zvals[pid, m] * cam_rays_d[pid, m, 2]
            px = np.clip(uv[pid, m, 0], 0, W - 1).astype(np.int64)
            py = np.clip(uv[pid, m, 1], 0, H - 1).astype(np.int64)
            sparse[py, px] = d
        np.save(os.path.join(out_dir, f"{name}.npy"), sparse)
        rng = sparse.max() - sparse.min()
        norm = (sparse - sparse.min()) / (rng if rng > 0 else 1.0)
        Image.fromarray((norm * 255).astype(np.uint8)).save(
            os.path.join(out_dir, f"sparsedepth_{name}.png")
        )


# ---------------- checkpoints ----------------

# The leaves of JAX's `tree_flatten((model, opt_state))`: the 12 parameters,
# the 4 buffers and the 3 densify statistics of `GaussianModel` in field
# order, then `AdamState`'s m and v (12 each, in the parameters' order) and
# its step count.
CHECKPOINT_LEAVES = (
    PARAM_NAMES + BUFFER_NAMES + STAT_NAMES
    + tuple(f"m.{n}" for n in PARAM_NAMES) + tuple(f"v.{n}" for n in PARAM_NAMES)
    + ("count",)
)


def _checkpoint_payload(model: GaussianModel, opt_state: optim.AdamState, iteration: int,
                        copy: bool = False) -> dict:
    """The npz's arrays, moved to the CPU (copied when `copy`, so that the
    arrays do not alias the tensors of a CPU model that training goes on
    updating in place). Dtypes as in JAX: float32 leaves, bool `bg_alive`,
    int32 `active_sh_degree` and `count`."""
    def host(t):
        return t.detach().to("cpu", copy=copy).numpy()

    leaves = [host(getattr(model, n)) for n in PARAM_NAMES + BUFFER_NAMES + STAT_NAMES]
    leaves += [host(opt_state.m[n]) for n in PARAM_NAMES]
    leaves += [host(opt_state.v[n]) for n in PARAM_NAMES]
    leaves.append(np.asarray(opt_state.count, np.int32))
    return dict(
        iteration=iteration,
        num_leaves=len(leaves),
        max_sh_degree=model.max_sh_degree,
        spatial_lr_scale=model.spatial_lr_scale,
        num_ray=model.num_ray,
        bg_capacity=model.bg_capacity,
        **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)},
    )


def save_checkpoint(path: str, model: GaussianModel, opt_state: optim.AdamState,
                    iteration: int) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_checkpoint_payload(model, opt_state, iteration))


def load_checkpoint(
    path: str, device: str | torch.device | None = None
) -> Tuple[GaussianModel, optim.AdamState, int]:
    """(model, Adam state, iteration) from a checkpoint of either package,
    on `device` (default: the GPU)."""
    data = np.load(path)
    n = int(data["num_leaves"])
    if n != len(CHECKPOINT_LEAVES):
        raise ValueError(f"{path}: {n} leaves, expected {len(CHECKPOINT_LEAVES)}")
    leaves = {name: data[f"leaf_{i}"] for i, name in enumerate(CHECKPOINT_LEAVES)}
    model = model_from_numpy(
        {name: leaves[name] for name in PARAM_NAMES + BUFFER_NAMES + STAT_NAMES},
        int(data["max_sh_degree"]), device, float(data["spatial_lr_scale"]),
    )
    dev = model.zval.device
    opt_state = optim.AdamState(
        m={name: torch.tensor(leaves[f"m.{name}"], device=dev) for name in PARAM_NAMES},
        v={name: torch.tensor(leaves[f"v.{name}"], device=dev) for name in PARAM_NAMES},
        count=int(leaves["count"]),
    )
    return model, opt_state, int(data["iteration"])


class AsyncCheckpointer:
    """Checkpoints written by a background thread (the JAX package's uses
    Orbax): `save` copies the state to the CPU and returns while the file
    is written to `<directory>/checkpoint.npz` in `save_checkpoint`'s
    format; `restore` waits for the write, then loads it."""

    FILE = "checkpoint.npz"

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, directory: str, model: GaussianModel, opt_state: optim.AdamState,
             iteration: int) -> None:
        self.wait()
        payload = _checkpoint_payload(model, opt_state, iteration, copy=True)
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, self.FILE)

        def write():
            try:
                np.savez(path, **payload)
            except BaseException as e:  # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def restore(self, directory: str, device: str | torch.device | None = None
                ) -> Tuple[GaussianModel, optim.AdamState, int]:
        self.wait()
        return load_checkpoint(os.path.join(directory, self.FILE), device)

    def wait(self) -> None:
        """Block until the last save is on disk; raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
