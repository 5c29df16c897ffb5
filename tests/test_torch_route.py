"""The backward's route by sort in the port: the bins' Gaussian-major runs
and permutation (`TileBins.gmaj_starts`, `order`), the per-entry backward
storing its rows in Gaussian-major order, the segment sum by runs
(`raster.segsum_runs`) and `raster.route_by_sort`, on the CPU (plain
versions), against the two-step form they replace (reorder, then the keys
form) and against the JAX package's `_route_by_sort`.

Scenes are the forward cases of test_torch_render.py, projected by the port
only, so each test takes a fraction of a second.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from scgaussian_tpu.renderer import tile_raster as jtile_raster
from scgaussian_tpu_torch.core.cameras import Camera as TCamera
from scgaussian_tpu_torch.renderer import binning as tbinning
from scgaussian_tpu_torch.renderer import project as tproject
from scgaussian_tpu_torch.renderer import raster
from test_torch_core import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)
from test_torch_render import CASES, SEG_N, cotangents, segsum_layouts

SCENES = [*CASES, "nothing_visible"]


def port_scene(case):
    """(projection, width, height, bg) of a forward case, by the port."""
    if case == "nothing_visible":  # test_torch_render.py::test_binning_with_nothing_visible
        cam = TCamera.create(np.eye(3), np.zeros(3), fovx=0.8, fovy=0.8, width=40, height=24,
                             device="cpu")
        proj = tproject.project(
            cam, torch.tensor([[0.0, 0.0, -3.0]]), torch.tensor([0.8]),
            scales=torch.full((1, 3), 0.05), rotations=torch.tensor([[1.0, 0, 0, 0]]),
            colors_precomp=torch.ones(1, 3))
        return proj, 40, 24, torch.tensor([0.2, 0.4, 0.6])
    (_, tcam), (means, scales, quats, opac, shs), bg, _, _ = CASES[case]()
    proj = tproject.project(tcam, torch.tensor(means), torch.tensor(opac),
                            scales=torch.tensor(scales), rotations=torch.tensor(quats),
                            shs=torch.tensor(shs), active_sh_degree=3)
    return proj, tcam.width, tcam.height, torch.tensor(bg, dtype=torch.float32)


def per_entry_rows(case):
    """(bins, per-entry backward rows [E, 10] in Gaussian-major order,
    Gaussians) of a forward case with random cotangents."""
    proj, W, H, bg = port_scene(case)
    bins = tbinning.bin_gaussians(proj, W, H)
    attrs = raster.pack_attrs(proj)
    _, _, _, T, last = raster.raster_fwd(bins, attrs, bg, W, H)
    assert T.is_contiguous() and last.is_contiguous()  # as the backward needs them
    cots = cotangents(W, H, ("color", "depth", "alpha"), seed=5)
    rows = raster.raster_bwd_entries(bins, attrs, bg, T, last, *cots, W, H)
    return bins, rows, attrs.shape[0]


@pytest.mark.parametrize("case", SCENES)
def test_gmaj_starts_are_the_runs_of_gmaj_ids(case):
    """gmaj_starts[g] is where Gaussian g's run of the sorted gmaj_ids
    starts, its last element the entry count."""
    proj, W, H, _ = port_scene(case)
    bins = tbinning.bin_gaussians(proj, W, H)
    n = proj.depth.shape[0]
    assert bins.gmaj_starts.dtype == torch.int32 and bins.gmaj_starts.shape == (n + 1,)
    want = torch.searchsorted(bins.gmaj_ids, torch.arange(n + 1, dtype=torch.int32),
                              out_int32=True)
    assert torch.equal(bins.gmaj_starts, want)
    assert int(bins.gmaj_starts[-1]) == bins.num_entries


@pytest.mark.parametrize("case", SCENES)
def test_order_maps_sorted_slots_to_gaussian_major_slots(case):
    """order is an int64 permutation; sorted slot e holds the entry that
    Gaussian-major slot order[e] laid out: the same Gaussian, in the tile
    the layout gives that slot (row-major over the Gaussian's tile rect)."""
    proj, W, H, _ = port_scene(case)
    bins = tbinning.bin_gaussians(proj, W, H)
    assert bins.order.dtype == torch.int64
    assert torch.equal(torch.sort(bins.order).values, torch.arange(bins.num_entries))
    assert torch.equal(bins.gmaj_ids[bins.order], bins.gauss_ids)
    # the tile of each sorted slot, from the tile ranges
    tile_of_sorted = torch.repeat_interleave(
        torch.arange(bins.nx * bins.ny), (bins.tile_starts[1:] - bins.tile_starts[:-1]).long())
    rmin, rmax = tproject.tile_rect(proj.mean2d, proj.ext[:, 0], W, H, 16,
                                    radius_y=proj.ext[:, 1])
    g = bins.gmaj_ids.long()
    j = torch.arange(bins.num_entries) - bins.gmaj_starts.long()[g]
    w = (rmax - rmin)[g, 0].long()
    tile = (rmin[g, 1].long() + j // w) * bins.nx + rmin[g, 0].long() + j % w
    assert torch.equal(tile_of_sorted, tile[bins.order])


@pytest.mark.parametrize("case", ["seed2_n200", "opaque_early_stop", "nothing_visible"])
def test_route_equals_the_two_step_plain_route(case):
    """The route's CPU path (the backward storing rows in Gaussian-major
    order, then one sum by runs) is bitwise the two-step route it replaced:
    the rows in the tiles' order (row e at sorted slot e) reordered by
    `gaussian_major`, then the keys form. Columns 10-11 are zero."""
    bins, d_gmaj, n = per_entry_rows(case)
    tile_order = d_gmaj[bins.order]
    assert torch.equal(raster.gaussian_major(bins, tile_order), d_gmaj)
    got = raster.route_by_sort(bins, d_gmaj, n)
    want = F.pad(raster.segsum_plain(bins.gmaj_ids, raster.gaussian_major(bins, tile_order), n),
                 (0, raster.ATTR_WIDTH - raster.NUM_GRADS))
    assert got.shape == (n, raster.ATTR_WIDTH) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert case == "nothing_visible" or float(got.abs().max()) > 0


@pytest.mark.parametrize("case", ["nonsquare_50x35", "nothing_visible"])
def test_routes_agree_at_a_ragged_size(case):
    """Through RasterizeFn on the CPU at image sizes that are not whole
    tiles (50x35, 40x24): the forward's final T and last contributor come
    out contiguous, and the sort route's d_attrs match the atomic route's
    within 1e-6 * max|g| per column (the same terms summed in another
    order)."""
    proj, W, H, bg = port_scene(case)
    bins = tbinning.bin_gaussians(proj, W, H)
    attrs = raster.pack_attrs(proj).detach()
    cots = cotangents(W, H, ("color", "depth", "alpha"), seed=7)

    def grads(by_sort):
        a = attrs.clone().requires_grad_()
        color, depth, alpha = raster.RasterizeFn.apply(a, bg, bins, W, H, by_sort)
        loss = (color * cots[0]).sum() + (depth * cots[1]).sum() + (alpha * cots[2]).sum()
        return torch.autograd.grad(loss, a)[0]

    atomic, by_sort = grads(False), grads(True)
    tol = 1e-6 * atomic.abs().amax(0)
    assert bool(((by_sort - atomic).abs() <= tol).all())
    assert case == "nothing_visible" or float(atomic.abs().max()) > 0


@pytest.mark.parametrize("layout", ["deep_run", "dense_suffix", "sparse_jumps",
                                    "one_key_per_block"])
def test_segsum_runs_on_adversarial_layouts(layout):
    """segsum_runs on the JAX suite's adversarial key layouts, with runs from
    one searchsorted: bitwise the keys form (a single-threaded index_add_
    sums in row order); the sentinel rows after starts[n] (NaN) are never
    read; absent keys and the padding columns are 0."""
    keys, vals = (torch.tensor(a) for a in segsum_layouts()[layout])
    starts = torch.searchsorted(keys, torch.arange(SEG_N + 1, dtype=torch.int32),
                                out_int32=True)
    want = raster.segsum(keys, vals, SEG_N)
    got = raster.segsum_runs(starts, vals, SEG_N, width=12)
    assert got.shape == (SEG_N, 12) and bool(torch.isfinite(got).all())
    assert torch.equal(got[:, :10], want) and float(got[:, 10:].abs().max()) == 0.0
    absent = np.setdiff1d(np.arange(SEG_N), keys.numpy())
    assert float(got[torch.from_numpy(absent)].abs().max()) == 0.0


def test_route_matches_jax_route_by_sort():
    """route_by_sort against the JAX package's `_route_by_sort` (one sort
    by Gaussian, then `_segsum_sorted_mxu` in interpret mode) on the same
    per-entry rows of seed2_n200 (the port's in Gaussian-major order, JAX's
    in the tiles' order with their Gaussian ids as keys, padded to whole
    1,024-entry blocks with the sentinel key n and NaN rows). 2e-5 * (max +
    1), the tolerance of test_segsum_plain_matches_jax_kernel."""
    bins, d_gmaj, n = per_entry_rows("seed2_n200")
    entries = d_gmaj[bins.order]  # the tiles' order
    e = bins.num_entries
    l_pad = -(-e // jtile_raster.SEG_B) * jtile_raster.SEG_B
    keys = np.full(l_pad, n, np.int32)
    keys[:e] = bins.gauss_ids.numpy()
    dT = np.full((raster.NUM_GRADS, l_pad), np.nan, np.float32)
    dT[:, :e] = entries.numpy().T
    route = jax.jit(lambda d, k: jtile_raster._route_by_sort(
        d, types.SimpleNamespace(orig_idx_aligned=k), n + 1, raster.NUM_GRADS))
    want = np.asarray(route(jnp.asarray(dT), jnp.asarray(keys)))[:n, :raster.ATTR_WIDTH]
    got = raster.route_by_sort(bins, d_gmaj, n).numpy()
    assert float(np.abs(want).max()) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * (np.abs(want).max() + 1))


def test_segsum_runs_checks_its_inputs():
    starts, vals = torch.tensor([0, 2, 4], dtype=torch.int32), torch.zeros(4, 10)
    with pytest.raises(ValueError, match="starts must be torch.int32"):
        raster.segsum_runs(starts.long(), vals, 2)
    with pytest.raises(ValueError, match="vals must be torch.float32"):
        raster.segsum_runs(starts, vals.double(), 2)
    with pytest.raises(ValueError, match=r"starts must be \[4\]"):
        raster.segsum_runs(starts, vals, 3)
    with pytest.raises(ValueError, match="1 <= C"):
        raster.segsum_runs(starts, vals, 2, width=8)
    with pytest.raises(ValueError, match="d_gmaj"):
        bins, entries, n = per_entry_rows("seed1_n64")
        raster.route_by_sort(bins, entries[:, :8].contiguous(), n)
    assert raster.segsum_runs(torch.zeros(1, dtype=torch.int32), vals[:0], 0).shape == (0, 10)
