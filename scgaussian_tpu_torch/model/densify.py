"""Densification statistics, densify / prune, opacity reset, capacity growth.

Port of `scgaussian_tpu/model/densify.py`: `update_stats` (36-63),
`densify_and_prune` + clone + split (66-227), `grow_bg_capacity` (230-283)
and `reset_opacity` (286-304), the reference's `densify_and_prune`,
`densify_and_clone`, `densify_and_split` and `reset_opacity`
(`scene/gaussian_model.py:644-651, 864-928`), on the fixed-capacity
alive-mask model: new Gaussians go into free background slots, prunes clear
the alive mask, and Adam moments are zeroed row by row.

Reference invariants kept exactly:
- clone/split both *emit into the background set* regardless of whether the
  source is a ray or bg Gaussian (`scene/gaussian_model.py:844-858`);
- ray Gaussians are never pruned (`:927`); split-selected ray Gaussians
  instead get their log-scale divided by 0.8*N in place (`:888-893`, the
  reference divides the *log-domain* scaling; replicated verbatim unless
  `fg_split_log_quirk` is False);
- split-selected bg Gaussians are pruned (`:895-896`);
- `replace_tensor_to_optimizer` zeroes the whole group's Adam moments
  (`:758-775`), applied to fg scaling on split and to opacity on reset;
- densification stats are zeroed after each event (`:860-862`).

The model's parameters and statistics are updated in place (their shapes do
not change), except by `grow_bg_capacity`, which returns a new, larger
model; the Adam state is returned anew, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from scgaussian_tpu_torch.core import transforms
from scgaussian_tpu_torch.model.gaussians import (
    BUFFER_NAMES, PARAM_NAMES, STAT_NAMES, GaussianModel,
)
from scgaussian_tpu_torch.train import optim

BG_LEAVES = ("bg_xyz", "bg_f_dc", "bg_f_rest", "bg_scaling", "bg_rotation", "bg_opacity")


@torch.no_grad()
def update_stats(
    model: GaussianModel,
    radii: torch.Tensor,
    viewspace_grad_pix: torch.Tensor,
    width: int,
    height: int,
) -> GaussianModel:
    """Accumulate one iteration's stats into the model's buffers, in place.

    `viewspace_grad_pix` is d(loss)/d(mean2d in pixels); the reference's
    screenspace gradient is in NDC units, i.e. pixel-grad * (0.5 W, 0.5 H)
    (CUDA backward's ddelx_dx factor), so it is rescaled before the norm to
    keep the densify_grad_threshold semantics identical. Returns `model`."""
    vis = radii > 0
    model.max_radii2d.copy_(torch.where(
        vis, torch.maximum(model.max_radii2d, radii.to(torch.float32)), model.max_radii2d
    ))
    scale = torch.tensor([0.5 * width, 0.5 * height], dtype=torch.float32,
                         device=viewspace_grad_pix.device)
    norm = torch.linalg.norm(viewspace_grad_pix * scale[None, :], dim=-1, keepdim=True)
    model.xyz_gradient_accum.add_(torch.where(vis[:, None], norm, 0.0))
    model.denom.add_(vis[:, None].to(torch.float32))
    return model


def _free_slot_table(bg_alive: torch.Tensor) -> torch.Tensor:
    """free_positions[r] = index of the r-th dead bg slot (stable order)."""
    return torch.argsort(bg_alive.to(torch.int32), stable=True)


@torch.no_grad()
def densify_and_prune(
    model: GaussianModel,
    opt_state: optim.AdamState,
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size: Optional[int],
    percent_dense: float,
    split_n: int = 2,
    fg_split_log_quirk: bool = True,
    generator: Optional[torch.Generator] = None,
    normals: Optional[torch.Tensor] = None,
) -> Tuple[GaussianModel, optim.AdamState, int]:
    """One densify + prune event (`train.py:195-197`), in place on `model`.

    Returns (model, new Adam state, dropped), `dropped` being the number of
    would-be new Gaussians that did not fit in the bg capacity. The split
    children's offsets are N(0, 1) draws scaled by the activated scale and
    rotated into the world frame: `normals` [split_n, N, 3] if given (a test
    hands in JAX's draws), else drawn from `generator`."""
    nr = model.num_ray
    cb = model.bg_capacity
    n = nr + cb
    dev = model.zval.device

    grads = model.xyz_gradient_accum / model.denom
    grads = torch.where(torch.isnan(grads), 0.0, grads).squeeze(-1)  # [N]

    alive = model.alive_mask()
    xyz = model.get_xyz()
    scaling_act = model.get_scaling()
    max_scale = torch.max(scaling_act, dim=1).values
    rot_all = torch.cat([model.rotation, model.bg_rotation], dim=0)
    f_dc_all = torch.cat([model.f_dc, model.bg_f_dc], dim=0)
    f_rest_all = torch.cat([model.f_rest, model.bg_f_rest], dim=0)
    opac_all = torch.cat([model.opacity, model.bg_opacity], dim=0)
    scal_all = torch.cat([model.scaling, model.bg_scaling], dim=0)

    # clone (`scene/gaussian_model.py:898-913`) and split (`:864-896`) selection
    sel_clone = (grads >= max_grad) & (max_scale <= percent_dense * extent) & alive
    sel_split = (grads >= max_grad) & (max_scale > percent_dense * extent) & alive

    # split children: N(0, scaling) samples rotated into the world frame
    if normals is None:
        normals = torch.randn(split_n, n, 3, generator=generator, device=dev)
    if tuple(normals.shape) != (split_n, n, 3):
        raise ValueError(f"normals must be [{split_n}, {n}, 3], got {list(normals.shape)}")
    R = transforms.quat_to_rotmat(rot_all)  # [N, 3, 3]
    child_xyz = [torch.einsum("nij,nj->ni", R, normals[k] * scaling_act) + xyz
                 for k in range(split_n)]
    child_scaling = torch.log(scaling_act / (0.8 * split_n))

    # candidate table: [clones; child_1; ...; child_N]
    reps = 1 + split_n
    cand_mask = torch.cat([sel_clone] + [sel_split] * split_n, dim=0)
    cand = dict(
        bg_xyz=torch.cat([xyz] + child_xyz, dim=0),
        bg_scaling=torch.cat([scal_all] + [child_scaling] * split_n, dim=0),
        bg_rotation=rot_all.repeat(reps, 1),
        bg_f_dc=f_dc_all.repeat(reps, 1, 1),
        bg_f_rest=f_rest_all.repeat(reps, 1, 1),
        bg_opacity=opac_all.repeat(reps, 1),
    )

    # allocation into free bg slots, in candidate order
    free_pos = _free_slot_table(model.bg_alive)  # [Cb]
    num_free = torch.sum(~model.bg_alive)
    rank = torch.cumsum(cand_mask.to(torch.int64), 0) - 1
    fits = cand_mask & (rank < num_free) & (rank < cb)
    dropped = int(torch.sum(cand_mask) - torch.sum(fits))
    dest = free_pos[rank[fits]]
    for name, values in cand.items():
        getattr(model, name)[dest] = values[fits]
    new_slot = torch.zeros(cb, dtype=torch.bool, device=dev)
    new_slot[dest] = True
    bg_alive = model.bg_alive | new_slot

    # fg split parents: the reference divides the LOG-domain scaling by
    # 0.8*N (`scene/gaussian_model.py:889-890`), which GROWS typical
    # (negative-log) scales; fg_split_log_quirk=False applies the
    # activated-domain shrink log(scale / (0.8*N)) that the bg children use.
    sel_split_fg = sel_split[:nr]
    if fg_split_log_quirk:
        fg_split_scaling = model.scaling / (0.8 * split_n)
    else:
        fg_split_scaling = model.scaling - torch.log(torch.tensor(0.8 * split_n))
    model.scaling.copy_(torch.where(sel_split_fg[:, None], fg_split_scaling, model.scaling))

    # prune (`scene/gaussian_model.py:915-928`): opacity, world size; never
    # fg; bg split parents always. As in the reference, the screen-size term
    # is dead logic (max_radii2D was zeroed just before, `:862`, `:924`).
    bg_opacity_act = torch.sigmoid(model.bg_opacity.squeeze(-1))
    bg_max_scale = torch.max(torch.exp(model.bg_scaling), dim=1).values
    prune_bg = bg_opacity_act < min_opacity
    if max_screen_size is not None:
        prune_bg = prune_bg | (bg_max_scale > 0.2 * extent)
    prune_bg = prune_bg | sel_split[nr:]  # split bg parents die
    model.bg_alive.copy_(bg_alive & ~prune_bg)

    # optimizer surgery: all fg scaling moments (replace_tensor semantics on
    # split) and the rows of every bg slot that changed identity
    opt_state = optim.zero_moments_leaf(opt_state, "scaling")
    changed_bg = new_slot | prune_bg
    opt_state = optim.zero_moments_rows(opt_state, {name: changed_bg for name in BG_LEAVES})

    for name in STAT_NAMES:
        getattr(model, name).zero_()
    return model, opt_state, dropped


@torch.no_grad()
def grow_bg_capacity(
    model: GaussianModel, opt_state: optim.AdamState, new_capacity: int
) -> Tuple[GaussianModel, optim.AdamState]:
    """Grow the background slot pool to `new_capacity` (the fixed-capacity
    analog of the reference's unbounded growth, `scene/gaussian_model.py:
    777-842`). New slots are dead (alive False, opacity and scale logits
    -10, identity rotation) with zero Adam moments and zero stats. Returns
    a new model (and Adam state); the old one is left as it was."""
    cb = model.bg_capacity
    if new_capacity <= cb:
        return model, opt_state
    add = new_capacity - cb

    def pad(x, fill=0.0):
        block = torch.full((add,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        return torch.cat([x.detach(), block], dim=0)

    fills = dict(bg_scaling=-10.0, bg_opacity=-10.0, bg_alive=False)
    leaves = {name: getattr(model, name).detach() for name in PARAM_NAMES + BUFFER_NAMES}
    for name in BG_LEAVES + ("bg_alive",):
        leaves[name] = pad(leaves[name], fills.get(name, 0.0))
    leaves["bg_rotation"][cb:, 0] = 1.0
    for name in STAT_NAMES:  # the stats' bg rows come last
        leaves[name] = pad(getattr(model, name))
    grown = GaussianModel(leaves, model.max_sh_degree, model.spatial_lr_scale)

    def pad_state(tree):
        return {k: pad(v) if k in BG_LEAVES else v for k, v in tree.items()}

    return grown, optim.AdamState(m=pad_state(opt_state.m), v=pad_state(opt_state.v),
                                  count=opt_state.count)


@torch.no_grad()
def reset_opacity(
    model: GaussianModel, opt_state: optim.AdamState
) -> Tuple[GaussianModel, optim.AdamState]:
    """`reset_opacity` (`scene/gaussian_model.py:644-651`), in place: clamp
    the activated opacity to <= 0.01, store it back in the logit domain and
    zero the opacity moments (fg and bg)."""
    for name in ("opacity", "bg_opacity"):
        raw = getattr(model, name)
        raw.copy_(transforms.inverse_sigmoid(torch.clamp(torch.sigmoid(raw), max=0.01)))
    opt_state = optim.zero_moments_leaf(opt_state, "opacity")
    opt_state = optim.zero_moments_leaf(opt_state, "bg_opacity")
    return model, opt_state
