"""Image losses: L1, windowed SSIM, PSNR.

Port of `scgaussian_tpu/losses/image.py`, with the reference's constants
and padding:
- `l1_loss`/`l2_loss` (`utils/loss_utils.py:40-44`)
- 11x11 sigma-1.5 Gaussian-window SSIM with zero padding
  (`utils/loss_utils.py:46-94`), used by training (`train.py:161`) and
  metrics (`metrics.py:87`)
- 5x5 AvgPool + reflection-pad SSIM error map (`utils/loss_utils.py:162-205`)
  used for render.py error visualizations
- `psnr`/`mse` (`utils/image_utils.py:15-19`)

`ssim` is differentiable through `SSIMFunction`, whose forward and backward
are the wrappers `ssim_fwd` and `ssim_bwd`: on CUDA tensors they launch the
hand-written kernels of `csrc/ssim.cu` (counted as `kernel.ssim_fwd` and
`kernel.ssim_bwd`), on CPU tensors they run the plain versions
`ssim_fwd_plain` and `ssim_bwd_plain`, the same math in PyTorch ops (the
forward with its coefficient maps, and the hand-derived backward). There is
no other fallback: a CUDA tensor never reaches a plain version through a
wrapper, and a build or launch failure raises.

The plain versions and `avgpool_ssim_map` take their windows as depthwise
`F.conv2d` calls (`groups=C`), a plain library convolution as the JAX
package's is plain XLA. They must run in full fp32: the package turns TF32
off at import, since C2 = 9e-4 is below TF32's error and SSIM would then
exceed 1 on flat regions.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from scgaussian_tpu_torch import _build
from scgaussian_tpu_torch.utils.profiling import count

C1 = 0.01**2
C2 = 0.03**2


def l1_loss(output: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(output - gt))


def l2_loss(output: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((output - gt) ** 2)


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image MSE over flattened pixels (`utils/image_utils.py:15-16`)."""
    b = img1.shape[0]
    return torch.mean((img1.reshape(b, -1) - img2.reshape(b, -1)) ** 2, dim=1, keepdim=True)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """`utils/image_utils.py:18-19`: 20 log10(1/sqrt(mse)) per image."""
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(img1, img2)))


SSIM_SIGMA = 1.5
KERNEL_WINDOW = 11  # the only window size csrc/ssim.cu takes


@functools.lru_cache(maxsize=8)
def _gaussian_1d(window_size: int, sigma: float) -> np.ndarray:
    """The normalised fp32 1-D Gaussian whose outer product is the window."""
    g = np.array(
        [math.exp(-((x - window_size // 2) ** 2) / (2 * sigma**2)) for x in range(window_size)],
        dtype=np.float32,
    )
    g /= g.sum()
    return g


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    g = _gaussian_1d(window_size, sigma)
    return np.outer(g, g).astype(np.float32)


def _depthwise_conv(img: torch.Tensor, window: torch.Tensor, padding: int) -> torch.Tensor:
    """img [C, H, W], window [kh, kw] applied per channel (groups=C)."""
    c = img.shape[0]
    kernel = window[None, None].expand(c, 1, *window.shape)
    return F.conv2d(img[None], kernel, padding=padding, groups=c)[0]


def _window_conv(like: torch.Tensor, window_size: int):
    """x -> the window's zero-padded depthwise convolution of x [C, H, W],
    the window in `like`'s dtype and device."""
    window = torch.as_tensor(_gaussian_window(window_size, SSIM_SIGMA), dtype=like.dtype,
                             device=like.device)
    return lambda x: _depthwise_conv(x, window, window_size // 2)


SSIMMaps = Tuple[Optional[torch.Tensor], ...]  # (A1, A2, B, C), each [C, H, W] or None


def ssim_fwd_plain(img1: torch.Tensor, img2: torch.Tensor, mask: Optional[torch.Tensor] = None,
                   window_size: int = 11, grads: Tuple[bool, bool] = (False, False)
                   ) -> Tuple[torch.Tensor, SSIMMaps]:
    """The forward in PyTorch ops: the mean over [C, H, W] of the SSIM map S
    (times M, the window sum of `mask`, where one is given), and the
    coefficient maps of its gradient (csrc/ssim.cu gives the math): A1 where
    `grads[0]` asks for img1's gradient, A2 where `grads[1]` asks for img2's,
    B and C where either does; None otherwise."""
    conv = _window_conv(img1, window_size)
    mu1 = conv(img1)
    mu2 = conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = conv(img1 * img1) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu1_mu2

    n1 = 2 * mu1_mu2 + C1
    n2 = 2 * sigma12 + C2
    d1 = mu1_sq + mu2_sq + C1
    d2 = sigma1_sq + sigma2_sq + C2
    dd = d1 * d2
    s = (n1 * n2) / dd
    m = None
    if mask is not None:
        m = conv(mask[None] if mask.dim() == 2 else mask)
    loss = torch.mean(s if m is None else s * m)
    a1 = a2 = b = c = None
    if grads[0] or grads[1]:
        e = 2 / dd if m is None else 2 * m / dd
        dn = n2 - n1
        sd = s * (d1 - d2)
        if grads[0]:
            a1 = e * (mu2 * dn + mu1 * sd)
        if grads[1]:
            a2 = e * (mu1 * dn + mu2 * sd)
        b = -s / d2 if m is None else -m * s / d2
        c = e * n1
    return loss, (a1, a2, b, c)


def ssim_bwd_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, own: torch.Tensor,
                   other: torch.Tensor, grad_out: torch.Tensor, window_size: int = 11
                   ) -> torch.Tensor:
    """The hand-derived gradient of the mean for one image, in PyTorch ops:
    (g / N) [w * a + 2 own (w * b) + other (w * c)], with (a, b, c) =
    (A1, B, C) and (own, other) = (img1, img2) for img1's gradient, (A2, B,
    C) and (img2, img1) for img2's; N = C * H * W, g the upstream gradient."""
    conv = _window_conv(own, window_size)
    return (grad_out / own.numel()) * (conv(a) + 2 * own * conv(b) + other * conv(c))


def ssim_fwd(img1: torch.Tensor, img2: torch.Tensor, mask: Optional[torch.Tensor] = None,
             window_size: int = 11, grads: Tuple[bool, bool] = (False, False)
             ) -> Tuple[torch.Tensor, SSIMMaps]:
    """`ssim_fwd_plain`'s outputs: on CUDA tensors from csrc/ssim.cu (the
    window must be 11 wide, the images fp32), on CPU tensors from the plain
    version."""
    dev = img1.device
    if dev.type == "cpu":
        return ssim_fwd_plain(img1, img2, mask, window_size, grads)
    if dev.type != "cuda":
        raise ValueError(f"no SSIM for device {dev}")
    _check_kernel_inputs(img1, window_size)
    return _ssim_fwd_cuda(img1, img2, mask, grads)


def ssim_bwd(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, own: torch.Tensor,
             other: torch.Tensor, grad_out: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """`ssim_bwd_plain`'s gradient: on CUDA tensors from csrc/ssim.cu, which
    reads g on the device, on CPU tensors from the plain version."""
    dev = own.device
    if dev.type == "cpu":
        return ssim_bwd_plain(a, b, c, own, other, grad_out, window_size)
    if dev.type != "cuda":
        raise ValueError(f"no SSIM for device {dev}")
    _check_kernel_inputs(own, window_size)
    return _ssim_bwd_cuda(a, b, c, own, other, grad_out)


def _check_kernel_inputs(img: torch.Tensor, window_size: int) -> None:
    if window_size != KERNEL_WINDOW:
        raise ValueError(f"the SSIM kernel takes an {KERNEL_WINDOW}-px window, got {window_size}")
    if img.dtype != torch.float32:
        raise ValueError(f"the SSIM kernel takes float32 images, got {img.dtype}")


@functools.cache
def _ssim_lib() -> ctypes.CDLL:
    """csrc/ssim.cu's library with its C signatures set, built and loaded on
    first use."""
    lib = _build.load("ssim")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    taps = ctypes.POINTER(ctypes.c_float)
    lib.ssim_fwd_blocks.argtypes = [i32] * 4
    lib.ssim_fwd_blocks.restype = ctypes.c_longlong
    lib.ssim_fwd.argtypes = [ptr] * 3 + [ctypes.c_longlong] + [i32] * 3 + [taps] + [ptr] * 7
    lib.ssim_fwd.restype = i32
    lib.ssim_bwd.argtypes = [ptr] * 6 + [i32] * 3 + [taps] + [ptr] * 2
    lib.ssim_bwd.restype = i32
    return lib


@functools.cache
def _kernel_taps() -> ctypes.Array:
    """The 1-D window's 11 fp32 taps, passed to the kernels by value."""
    return (ctypes.c_float * KERNEL_WINDOW)(*_gaussian_1d(KERNEL_WINDOW, SSIM_SIGMA).tolist())


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _ssim_fwd_cuda(img1, img2, mask, grads) -> Tuple[torch.Tensor, SSIMMaps]:
    lib = _ssim_lib()
    dev = img1.device
    img1, img2 = img1.contiguous(), img2.contiguous()
    C, H, W = img1.shape
    m, m_stride = None, 0
    if mask is not None:
        m = mask.to(torch.float32).contiguous()
        if m.dim() == 3 and m.shape[0] > 1:
            m_stride = H * W  # a plane per channel; else one plane for all
    blocks = lib.ssim_fwd_blocks(C, H, W, int(m is not None))
    if blocks == 0:
        raise ValueError(f"the SSIM kernel cannot take an image of shape {(C, H, W)}")
    with torch.cuda.device(dev):
        partials = torch.empty(blocks, dtype=torch.float64, device=dev)
        loss = torch.empty((), dtype=torch.float32, device=dev)
        a1 = torch.empty_like(img1) if grads[0] else None
        a2 = torch.empty_like(img1) if grads[1] else None
        b = torch.empty_like(img1) if grads[0] or grads[1] else None
        c = torch.empty_like(img1) if b is not None else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssim_fwd(img1.data_ptr(), img2.data_ptr(), _ptr(m), m_stride, C, H, W,
                           _kernel_taps(), _ptr(a1), _ptr(a2), _ptr(b), _ptr(c),
                           partials.data_ptr(), loss.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ssim_fwd launch failed: CUDA error {err}")
    count("kernel.ssim_fwd")
    return loss, (a1, a2, b, c)


def _ssim_bwd_cuda(a, b, c, own, other, grad_out) -> torch.Tensor:
    lib = _ssim_lib()
    dev = own.device
    if grad_out.numel() != 1 or grad_out.dtype != torch.float32:
        raise ValueError(f"the upstream gradient must be one float32, got "
                         f"{tuple(grad_out.shape)} {grad_out.dtype}")
    own, other, grad_out = own.contiguous(), other.contiguous(), grad_out.contiguous()
    C, H, W = own.shape
    with torch.cuda.device(dev):
        out = torch.empty_like(own)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssim_bwd(a.data_ptr(), b.data_ptr(), c.data_ptr(), own.data_ptr(),
                           other.data_ptr(), grad_out.data_ptr(), C, H, W, _kernel_taps(),
                           out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ssim_bwd launch failed: CUDA error {err}")
    count("kernel.ssim_bwd")
    return out


class SSIMFunction(torch.autograd.Function):
    """The mean SSIM of two [C, H, W] images with its hand-derived gradient
    (`ssim_fwd`, `ssim_bwd`). The forward writes only the coefficient maps
    that the images which need a gradient take."""

    @staticmethod
    def forward(ctx, img1, img2, mask, window_size):
        loss, maps = ssim_fwd(img1, img2, mask, window_size, tuple(ctx.needs_input_grad[:2]))
        ctx.save_for_backward(img1, img2, *maps)
        ctx.window_size = window_size
        return loss

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        img1, img2, a1, a2, b, c = ctx.saved_tensors
        g1 = g2 = None
        if a1 is not None:
            g1 = ssim_bwd(a1, b, c, img1, img2, grad_out, ctx.window_size)
        if a2 is not None:
            g2 = ssim_bwd(a2, b, c, img2, img1, grad_out, ctx.window_size)
        return g1, g2, None, None


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    window_size: int = 11,
    mask: torch.Tensor | None = None,
    size_average: bool = True,
) -> torch.Tensor:
    """Windowed SSIM, zero padding (matches `_ssim`, `utils/loss_utils.py:66-94`):
    the mean over [C, H, W] of the SSIM map, times the window sum of `mask`
    where one is given. On a [C, H, W] image both values of `size_average`
    give that mean, as in the reference.

    Args: img1/img2 [C, H, W] in [0, 1]; mask [H, W], [1, H, W] or [C, H, W].
    A gradient flows to either image (never to the mask) through
    `SSIMFunction`.
    """
    if img1.dim() != 3 or img1.shape != img2.shape:
        raise ValueError(f"images must be [C, H, W] of one shape, got {tuple(img1.shape)}, "
                         f"{tuple(img2.shape)}")
    if img1.device != img2.device or img1.dtype != img2.dtype:
        raise ValueError(f"images on {img1.device}/{img2.device} as {img1.dtype}/{img2.dtype}")
    if window_size < 1 or window_size % 2 == 0:
        raise ValueError(f"window_size must be odd, got {window_size}")
    grad_on = torch.is_grad_enabled()
    if mask is not None:
        if mask.device != img1.device:
            raise ValueError(f"mask is on {mask.device}, the images on {img1.device}")
        if mask.shape[-2:] != img1.shape[1:] or not (
                mask.dim() == 2 or (mask.dim() == 3 and mask.shape[0] in (1, img1.shape[0]))):
            raise ValueError(f"mask must be [H, W], [1, H, W] or [C, H, W], "
                             f"got {tuple(mask.shape)}")
        if grad_on and mask.requires_grad:
            raise ValueError("ssim gives no gradient for the mask")
        mask = mask.to(img1.dtype)
    if not (grad_on and (img1.requires_grad or img2.requires_grad)):
        return ssim_fwd(img1, img2, mask, window_size)[0]  # the forward alone, no maps
    return SSIMFunction.apply(img1, img2, mask, window_size)


def avgpool_ssim_map(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """5x5 AvgPool SSIM error map with reflection padding.

    Matches the `SSIM` module (`utils/loss_utils.py:162-193`): returns
    clamp((1 - SSIM_n/SSIM_d)/2, 0, 1) as [C, H, W].
    """

    def refl(im):
        return F.pad(im[None], (2, 2, 2, 2), mode="reflect")[0]

    x, y = refl(x), refl(y)
    window = torch.full((5, 5), 1.0 / 25.0, dtype=x.dtype, device=x.device)

    def pool(im):
        return _depthwise_conv(im, window, 0)

    mu_x, mu_y = pool(x), pool(y)
    sigma_x = pool(x**2) - mu_x**2
    sigma_y = pool(y**2) - mu_y**2
    sigma_xy = pool(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)
    d = (mu_x**2 + mu_y**2 + C1) * (sigma_x + sigma_y + C2)
    return torch.clamp((1 - n / d) / 2, 0.0, 1.0)


def pixel_loss_map(image: torch.Tensor, gt_image: torch.Tensor) -> torch.Tensor:
    """0.5 L1 + 0.5 avgpool-SSIM per-pixel error map
    (`get_pixel_loss`, `utils/loss_utils.py:195-205`), used by render.py."""
    l1 = torch.mean(torch.abs(image - gt_image), dim=0)
    sl = torch.mean(avgpool_ssim_map(image, gt_image), dim=0)
    return 0.5 * l1 + 0.5 * sl
