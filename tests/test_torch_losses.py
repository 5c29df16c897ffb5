"""The PyTorch port's losses (image losses, bilinear sampling) and match
machinery (MatchBundle, the render-depth match loss) against the JAX package
on the CPU. Inputs come from numpy seeds and go to both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from scgaussian_tpu import losses as jl
from scgaussian_tpu.model import matches as jmatches
from scgaussian_tpu_torch import losses as tl
from scgaussian_tpu_torch.losses.image import SSIMFunction
from scgaussian_tpu_torch.model import matches as tmatches
from synthetic_scene import make_synthetic  # tests/ is on sys.path under pytest
from test_torch_core import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)
from time_limits import per_test_limit  # noqa: F401 (autouse: a time limit for each test)


def images(seed, c=3, h=24, w=32):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (c, h, w)).astype(np.float32),
            rng.uniform(0, 1, (c, h, w)).astype(np.float32))


def close(port, ref, atol=1e-6, rtol=1e-5):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def scene():
    return make_synthetic()


# ---------------- image losses ----------------

def test_pixel_losses_match_jax():
    a, b = images(0)
    ta, tb = torch.tensor(a), torch.tensor(b)
    for name in ("l1_loss", "l2_loss"):
        close(getattr(tl, name)(ta, tb), getattr(jl, name)(jnp.asarray(a), jnp.asarray(b)))
    close(tl.mse(ta, tb), jl.mse(jnp.asarray(a), jnp.asarray(b)))
    close(tl.psnr(ta, tb), jl.psnr(jnp.asarray(a), jnp.asarray(b)), atol=1e-5)
    assert tl.psnr(ta, tb).shape == (3, 1)


@pytest.mark.parametrize("masked, grads", [
    pytest.param(False, "img1", id="False"),
    pytest.param(True, "img1", id="True"),
    pytest.param(False, "both", id="False-both"),
    pytest.param("per_channel", "both", id="per_channel-both"),
])
def test_ssim_matches_jax(masked, grads):
    """The CPU route (`SSIMFunction` over the plain forward and its
    hand-derived backward) against JAX's `ssim` and `jax.value_and_grad`:
    values at 1e-6 and gradients at 1e-4 * max|g| (fp32 convolutions, summed
    in another order), for img1's gradient alone (the training path) and for
    both images', with a mask of one plane or one per channel, and both
    values of `size_average`."""
    a, b = images(1)
    mask = (np.random.default_rng(2).uniform(size=a.shape[1:]) > 0.3).astype(np.float32)
    if masked == "per_channel":
        mask = (np.random.default_rng(2).uniform(size=a.shape) > 0.3).astype(np.float32)
    jkw = dict(mask=jnp.asarray(mask)) if masked else {}
    tkw = dict(mask=torch.tensor(mask)) if masked else {}
    both = grads == "both"
    ref, jg = jax.value_and_grad(lambda x, y: jl.ssim(x, y, **jkw), argnums=(0, 1) if both else 0)(
        jnp.asarray(a), jnp.asarray(b))
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=both)
    got = tl.ssim(ta, tb, **tkw)
    assert type(got.grad_fn).__name__ == "SSIMFunctionBackward"
    tg = torch.autograd.grad(got, (ta, tb) if both else (ta,))
    close(got, ref)
    for t, j in zip(tg, jg if both else (jg,)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, atol=1e-4 * np.abs(j).max())
    for size_average in (True, False):
        close(tl.ssim(ta, tb, size_average=size_average, **tkw),
              jl.ssim(jnp.asarray(a), jnp.asarray(b), size_average=size_average, **jkw))


@pytest.mark.parametrize("masked", [False, True])
def test_ssim_function_gradcheck(masked):
    """float64 `gradcheck` of `SSIMFunction`'s hand-derived backward on a
    ragged 3 x 13 x 9 image: the 11-px window is wider than the image, so
    the zero padding takes part everywhere."""
    rng = np.random.default_rng(11)
    a = torch.tensor(rng.uniform(0, 1, (3, 13, 9)), requires_grad=True)
    b = torch.tensor(rng.uniform(0, 1, (3, 13, 9)), requires_grad=True)
    mask = torch.tensor((rng.uniform(size=(13, 9)) > 0.3).astype(np.float64)) if masked else None
    assert torch.autograd.gradcheck(
        lambda x, y: SSIMFunction.apply(x, y, mask, 11), (a, b))


def test_ssim_at_most_one_on_flat_images():
    """The TF32 trap (STATUS.md:517-522): C2 = 9e-4 is below TF32's error,
    and SSIM of a flat image with itself would then exceed 1."""
    flat = torch.full((3, 40, 56), 0.73)
    assert float(tl.ssim(flat, flat)) <= 1.0
    a, _ = images(3, h=40, w=56)
    assert float(tl.ssim(torch.tensor(a), torch.tensor(a))) == pytest.approx(1.0, abs=1e-6)


def test_avgpool_ssim_map_and_pixel_loss_map_match_jax():
    a, b = images(4)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.tensor(a), torch.tensor(b)
    m = tl.avgpool_ssim_map(ta, tb)
    assert m.shape == a.shape
    close(m, jl.avgpool_ssim_map(ja, jb))
    close(tl.pixel_loss_map(ta, tb), jl.pixel_loss_map(ja, jb))


# ---------------- sampling ----------------

def sample_grid(seed, m=300):
    """Normalized coords in [-1.2, 1.2] (some outside the image) plus exact
    pixel centres and borders."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(-1.2, 1.2, (m, 2)).astype(np.float32)
    g[:4] = [[-1, -1], [1, 1], [0, 0], [-1, 1]]
    return g


def test_grid_sample_matches_jax_and_torch():
    """Against JAX's 4-tap gather (values and gradients with respect to the
    image and the grid, at 1e-5) and against F.grid_sample with
    align_corners=False and zero padding (values at 1e-6)."""
    img, _ = images(5, c=2, h=9, w=13)
    grid = sample_grid(6)
    cot = np.random.default_rng(7).normal(size=(2, grid.shape[0])).astype(np.float32)

    def jfn(im, gr):
        return jnp.sum(jl.grid_sample_2d(im, gr) * cot)

    jv = jl.grid_sample_2d(jnp.asarray(img), jnp.asarray(grid))
    jgi, jgg = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(grid))
    ti = torch.tensor(img, requires_grad=True)
    tg = torch.tensor(grid, requires_grad=True)
    tv = tl.grid_sample_2d(ti, tg)
    tgi, tgg = torch.autograd.grad((tv * torch.tensor(cot)).sum(), (ti, tg))
    close(tv, jv)
    close(tgi, jgi, atol=1e-5)
    close(tgg, jgg, atol=1e-5)
    lib = F.grid_sample(torch.tensor(img)[None], torch.tensor(grid)[None, None],
                        mode="bilinear", padding_mode="zeros", align_corners=False)[0, :, 0]
    close(tv, lib.numpy())


def test_bilinear_sample_pix_matches_jax():
    img, _ = images(8, c=3, h=7, w=11)
    rng = np.random.default_rng(9)
    ix = rng.uniform(-2, 12, 200).astype(np.float32)
    iy = rng.uniform(-2, 8, 200).astype(np.float32)
    close(tl.bilinear_sample_pix(torch.tensor(img), torch.tensor(ix), torch.tensor(iy)),
          jl.bilinear_sample_pix(jnp.asarray(img), jnp.asarray(ix), jnp.asarray(iy)))


# ---------------- matches ----------------

def jax_bundle_fields(bundle):
    return {f.name: np.asarray(getattr(bundle, f.name)) if f.name not in ("width", "height")
            else getattr(bundle, f.name) for f in dataclasses.fields(bundle)}


@pytest.mark.parametrize("masked", [False, True], ids=["no_masks", "blender_masks"])
def test_build_match_bundle_matches_jax(scene, masked):
    images_np = [np.asarray(g).transpose(1, 2, 0) for g in scene["gts"]]
    near_fars = [np.array([1.5, 8.0], np.float32)] * 3
    masks = None
    if masked:
        rng = np.random.default_rng(12)
        masks = [rng.uniform(size=(scene["H"], scene["W"])).astype(np.float32), None,
                 (rng.uniform(size=(scene["H"], scene["W"])) > 0.5).astype(np.float32)]
    args = (images_np, scene["intrs"], scene["w2cs"], near_fars, scene["match_pixels"], masks)
    t = tmatches.build_match_bundle(*args, device="cpu")
    ref = jax_bundle_fields(jmatches.build_match_bundle(*args) if masked else scene["bundle"])
    assert (t.width, t.height) == (ref["width"], ref["height"])
    assert (t.num_pairs, t.matches_per_pair) == ref["rays_o"].shape[:2]
    for name, want in ref.items():
        if name in ("width", "height"):
            continue
        got = getattr(t, name).numpy()
        if want.dtype.kind in "iub":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5, err_msg=name)


def test_bundle_from_numpy_round_trip(scene):
    fields = jax_bundle_fields(scene["bundle"])
    t = tmatches.bundle_from_numpy(fields, device="cpu")
    assert t.src.dtype == torch.int64 and t.pad_valid.dtype == torch.bool
    assert t.to("cpu").uv.data_ptr() == t.uv.data_ptr()
    del fields["partner"]
    with pytest.raises(ValueError, match="partner"):
        tmatches.bundle_from_numpy(fields, device="cpu")


@pytest.fixture(scope="module")
def padded_bundle(scene):
    """The scene's JAX bundle with pair (0, 1) and its partner cut short, so
    that some rows are padding (zero rays: the safe divide)."""
    pixels = dict(scene["match_pixels"])
    for key in ((0, 1), (1, 0)):
        pixels[key] = pixels[key][:-6]
    images_np = [np.asarray(g).transpose(1, 2, 0) for g in scene["gts"]]
    near_fars = [np.array([1.5, 8.0], np.float32)] * 3
    return jmatches.build_match_bundle(images_np, scene["intrs"], scene["w2cs"], near_fars,
                                       pixels)


@pytest.mark.parametrize("view", [0, 2])
def test_matchloss_from_renderdepth_matches_jax(padded_bundle, view):
    """Value at 1e-6 relative, gradient with respect to the depth map at
    1e-5 * max|g|, on a depth map made from a numpy seed (padding rows and
    out-of-bounds reprojections included)."""
    jb = padded_bundle
    assert not np.asarray(jb.pad_valid).all()
    rng = np.random.default_rng(10 + view)
    depth = rng.uniform(2.5, 5.5, (1, jb.height, jb.width)).astype(np.float32)
    fn = lambda d: jmatches.matchloss_from_renderdepth(jb, jnp.int32(view), d)  # noqa: E731
    ref, jg = jax.value_and_grad(fn)(jnp.asarray(depth))
    tb = tmatches.bundle_from_numpy(jax_bundle_fields(jb), device="cpu")
    td = torch.tensor(depth, requires_grad=True)
    got = tmatches.matchloss_from_renderdepth(tb, view, td)
    (tg,) = torch.autograd.grad(got, td)
    assert float(ref) > 0
    close(got, ref, atol=0, rtol=1e-6)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, atol=1e-5 * np.abs(jg).max())
