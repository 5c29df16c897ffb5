"""The SSIM kernels (`csrc/ssim.cu`) on the card against their plain versions
(`losses/image.py`: `ssim_fwd_plain`, `ssim_bwd_plain`), which the CPU
tests hold against the JAX package.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs as it is on the machine with the card:

    python3 -m pytest tests/test_torch_ssim_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from scgaussian_tpu_torch.losses import image
from scgaussian_tpu_torch.utils import profiling
from time_limits import per_test_limit  # noqa: F401 (autouse: a time limit for each test)

LOSS_REL = 1e-6  # kernel vs plain: fp64 partial sums against torch.mean's fp32 sum
GRAD_REL = 1e-5  # of max|g|: separable taps against the 2-D window, summed in another order


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def pair(shape, seed, dev):
    """img1 a noisy copy of img2 in [0, 1], both [C, H, W] float32 on `dev`."""
    rng = np.random.default_rng(seed)
    y = rng.uniform(size=shape).astype(np.float32)
    x = np.clip(y + rng.normal(scale=0.1, size=shape), 0, 1).astype(np.float32)
    return torch.tensor(x, device=dev), torch.tensor(y, device=dev)


def launches():
    return {k: profiling.TOTALS.get("kernel." + k, 0) for k in ("ssim_fwd", "ssim_bwd")}


def kernel_and_grads(x, y, mask):
    """The loss through `ssim` (the kernels) and both images' gradients."""
    xg, yg = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    loss = image.ssim(xg, yg, mask=mask)
    return (loss.detach(), *torch.autograd.grad(loss, (xg, yg)))


def plain_and_grads(x, y, mask):
    """The same from the plain versions, run on the card."""
    loss, (a1, a2, b, c) = image.ssim_fwd_plain(x, y, mask, 11, (True, True))
    g = torch.ones((), device=x.device)
    return (loss, image.ssim_bwd_plain(a1, b, c, x, y, g),
            image.ssim_bwd_plain(a2, b, c, y, x, g))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(67, 45), (4032, 3024)], ids=["67x45", "4032x3024"])
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_ssim_matches_plain_and_repeats(card, size, masked):
    """Loss within 1e-6 relative and both gradients within 1e-5 * max|g| of
    the plain versions; a second launch on the same inputs gives the same
    bits (no atomics); one forward and one backward launch per image."""
    W, H = size
    x, y = pair((3, H, W), 5, card)
    mask = None
    if masked:
        rng = np.random.default_rng(6)
        mask = torch.tensor((rng.uniform(size=(H, W)) > 0.3).astype(np.float32), device=card)
    before = launches()
    got = kernel_and_grads(x, y, mask)
    torch.cuda.synchronize()
    after = launches()
    assert after["ssim_fwd"] - before["ssim_fwd"] == 1
    assert after["ssim_bwd"] - before["ssim_bwd"] == 2  # img1's and img2's
    want = plain_and_grads(x, y, mask)
    assert abs(float(got[0]) - float(want[0])) <= LOSS_REL * abs(float(want[0])), (got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert float((g - w).abs().max()) <= GRAD_REL * float(w.abs().max())
    again = kernel_and_grads(x, y, mask)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_ssim_training_path_launches_and_maps(card):
    """With only img1 taking a gradient (the training loss) the forward
    writes three maps and the backward launches once; under no_grad (the
    metrics) only the forward launches and no map is allocated."""
    x, y = pair((3, 512, 384), 7, card)
    plane = x.numel() * 4
    before = launches()
    xg = x.clone().requires_grad_(True)
    base = torch.cuda.memory_allocated(card)
    loss = image.ssim(xg, y)
    held = torch.cuda.memory_allocated(card) - base  # the maps the backward keeps
    (g,) = torch.autograd.grad(loss, xg)
    mid = launches()
    assert (mid["ssim_fwd"] - before["ssim_fwd"], mid["ssim_bwd"] - before["ssim_bwd"]) == (1, 1)
    assert 3 * plane <= held < 4 * plane, held
    want = plain_and_grads(x, y, None)
    assert float((g - want[1]).abs().max()) <= GRAD_REL * float(want[1].abs().max())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(card)
    base = torch.cuda.memory_allocated(card)
    with torch.no_grad():
        value = image.ssim(xg, y)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(card) - base < plane
    after = launches()
    assert (after["ssim_fwd"] - mid["ssim_fwd"], after["ssim_bwd"] - mid["ssim_bwd"]) == (1, 0)
    assert float(value) == float(loss.detach())


@pytest.mark.cuda
def test_cuda_ssim_at_most_one_and_refusals(card):
    """SSIM of a flat image with itself is at most 1 (the TF32 trap), of a
    textured one with itself 1 within 1e-6; the kernel refuses what it does
    not take instead of falling back."""
    flat = torch.full((3, 301, 203), 0.73, device=card)
    assert float(image.ssim(flat, flat)) <= 1.0
    x, _ = pair((3, 301, 203), 8, card)
    assert abs(float(image.ssim(x, x)) - 1.0) <= 1e-6
    with pytest.raises(ValueError, match="window"):
        image.ssim(x, x, window_size=7)
    with pytest.raises(ValueError, match="float32"):
        image.ssim(x.double(), x.double())
