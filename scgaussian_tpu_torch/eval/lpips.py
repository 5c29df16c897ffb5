"""LPIPS perceptual metric (VGG16 / AlexNet / SqueezeNet towers).

Port of `scgaussian_tpu/eval/lpips_jax.py` (reference lpipsPyTorch,
`lpipsPyTorch/modules/lpips.py:8-36`, `networks.py:12-96`,
`utils.py:11-30`): images are shifted and scaled by the ImageNet
statistics, passed through the frozen backbone, each tap unit-normalized
along channels, squared-differenced, weighted by the learned 1x1 "lin"
heads and spatially averaged, then summed over taps.

Weights load from the same local `.npz` as the JAX package's (keys
`conv{i}_w/b`, `fire{i}_{squeeze,e1,e3}_w/b`, `lin{i}_w`): set
SCGAUSSIAN_LPIPS_WEIGHTS=/path/to/lpips_<net>.npz, or pass `weights_path`.
`convert_torch_weights` writes that file from torchvision's backbone and
richzhang's lin heads on a machine that can fetch them. Without weights,
`lpips_available()` is False and the metrics report LPIPS as null.

The convolutions are `F.conv2d` in fp32 (TF32 is off package-wide, as the
JAX package pins `Precision.HIGHEST`).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from scgaussian_tpu_torch import resolve_device

_ENV_VAR = "SCGAUSSIAN_LPIPS_WEIGHTS"

# ImageNet scaling used by LPIPS v0.1 (lpipsPyTorch/modules/utils.py)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# VGG16 conv layout: (out_channels per conv, 'M' = maxpool). LPIPS taps after
# relu1_2, relu2_2, relu3_3, relu4_3, relu5_3.
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
_VGG_TAPS = [1, 3, 6, 9, 12]  # conv indices (0-based) after which to tap (post-relu)

# AlexNet features: conv(64,k11,s4,p2) M conv(192,k5,p2) M conv(384,k3,p1)
# conv(256,k3,p1) conv(256,k3,p1); taps after each relu.
_ALEX_CFG = [
    (64, 11, 4, 2),
    "M",
    (192, 5, 1, 2),
    "M",
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_ALEX_TAPS = [0, 1, 2, 3, 4]

# SqueezeNet 1.1 features (reference `lpipsPyTorch/modules/networks.py:66-73`:
# the outputs of relu0, fire2, fire4, fire5, fire6, fire7, fire8). Fire(s, e1,
# e3) = squeeze 1x1 conv -> relu -> [expand 1x1 + expand 3x3 (pad 1), both
# relu'd, channel-concatenated]. Maxpools are k3 s2 ceil_mode like torchvision.
_SQUEEZE_CFG = [
    ("conv", 64, 3, 2, 0),
    "M",
    ("fire", 16, 64, 64),
    ("fire", 16, 64, 64),
    "M",
    ("fire", 32, 128, 128),
    ("fire", 32, 128, 128),
    "M",
    ("fire", 48, 192, 192),
    ("fire", 48, 192, 192),
    ("fire", 64, 256, 256),
    ("fire", 64, 256, 256),
]
# taps: output of conv0's relu + fires 2,4,5,6,7,8 (1-based)
_SQUEEZE_TAPS = [("conv", 0), ("fire", 1), ("fire", 3), ("fire", 4),
                 ("fire", 5), ("fire", 6), ("fire", 7)]

_NUM_TAPS = {"vgg": 5, "alex": 5, "squeeze": 7}


def _maxpool3_ceil(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(kernel_size=3, stride=2, ceil_mode=True) (squeezenet).
    It equals the JAX package's `reduce_window` with -inf padding of
    (out - 1) * 2 + 3 - n on the high side, out = ceil((n - 3) / 2) + 1:
    with no padding, ceil mode's last window always starts inside the
    input, so it keeps every window that padding adds."""
    return F.max_pool2d(x, 3, 2, ceil_mode=True)


def _normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x**2, dim=1, keepdim=True))
    return x / (norm + eps)


class LPIPS(nn.Module):
    """LPIPS metric on `device` (default: the GPU). Construct once; the
    weights are buffers on the device. `forward(x, y)` takes [B, 3, H, W]
    images as `eval/metrics.py` passes them and returns [B]."""

    def __init__(self, net: str = "vgg", weights_path: Optional[str] = None,
                 device: str | torch.device | None = None):
        super().__init__()
        path = weights_path or os.environ.get(_ENV_VAR)
        if path is None or not os.path.exists(path or ""):
            raise FileNotFoundError(
                f"LPIPS weights not found (set ${_ENV_VAR} or pass weights_path); "
                "use convert_torch_weights() on a connected machine."
            )
        if net not in _NUM_TAPS:
            raise ValueError(f"unknown LPIPS net {net!r}")
        dev = resolve_device(device)
        self.net = net
        with np.load(path) as data:
            for key in data.files:
                self.register_buffer(key, torch.tensor(data[key], device=dev))
        self.register_buffer("shift", torch.tensor(_SHIFT, device=dev)[None, :, None, None])
        self.register_buffer("scale", torch.tensor(_SCALE, device=dev)[None, :, None, None])

    def _conv(self, x, name: str, stride: int = 1, padding: int = 0):
        return F.conv2d(x, getattr(self, f"{name}_w"), getattr(self, f"{name}_b"),
                        stride=stride, padding=padding)

    def _vgg_features(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        ci = 0
        for item in _VGG_CFG:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(self._conv(x, f"conv{ci}", padding=1))
                if ci in _VGG_TAPS:
                    feats.append(x)
                ci += 1
        return feats

    def _alex_features(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        ci = 0
        for item in _ALEX_CFG:
            if item == "M":
                x = F.max_pool2d(x, 3, 2)  # floor mode
            else:
                _, _, s, p = item
                x = F.relu(self._conv(x, f"conv{ci}", stride=s, padding=p))
                if ci in _ALEX_TAPS:
                    feats.append(x)
                ci += 1
        return feats

    def _fire(self, i: int, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self._conv(x, f"fire{i}_squeeze"))
        e1 = F.relu(self._conv(s, f"fire{i}_e1"))
        e3 = F.relu(self._conv(s, f"fire{i}_e3", padding=1))
        return torch.cat([e1, e3], dim=1)

    def _squeeze_features(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = set(_SQUEEZE_TAPS)
        feats = []
        fi = 0
        for item in _SQUEEZE_CFG:
            if item == "M":
                x = _maxpool3_ceil(x)
            elif item[0] == "conv":
                _, _, _, s, p = item
                x = F.relu(self._conv(x, "conv0", stride=s, padding=p))
                if ("conv", 0) in taps:
                    feats.append(x)
            else:
                x = self._fire(fi, x)
                if ("fire", fi) in taps:
                    feats.append(x)
                fi += 1
        return feats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        feat_fn = {"vgg": self._vgg_features, "alex": self._alex_features,
                   "squeeze": self._squeeze_features}[self.net]
        fx = feat_fn((x - self.shift) / self.scale)
        fy = feat_fn((y - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            d = (_normalize_tensor(a) - _normalize_tensor(b)) ** 2
            w = getattr(self, f"lin{i}_w")  # [1, C, 1, 1]
            total = total + torch.mean(torch.sum(d * w, dim=1, keepdim=True), dim=(2, 3))
        return total[:, 0]


def lpips_available(net: str = "vgg", weights_path: Optional[str] = None) -> bool:
    path = weights_path or os.environ.get(_ENV_VAR)
    return bool(path) and os.path.exists(path)


def convert_torch_weights(out_path: str, net: str = "vgg") -> None:
    """One-time converter (run on a machine with torchvision and the
    richzhang weights at hand): exports the backbone convs + lin heads to
    the `.npz` that `LPIPS` reads."""
    import torchvision

    if net == "vgg":
        tv = torchvision.models.vgg16(weights="IMAGENET1K_V1").features
    elif net == "alex":
        tv = torchvision.models.alexnet(weights="IMAGENET1K_V1").features
    else:
        tv = torchvision.models.squeezenet1_1(weights="IMAGENET1K_V1").features

    params = {}
    if net == "squeeze":
        fi = 0
        for layer in tv:
            if isinstance(layer, nn.Conv2d):
                params["conv0_w"] = layer.weight.detach().numpy()
                params["conv0_b"] = layer.bias.detach().numpy()
            elif hasattr(layer, "squeeze"):  # Fire module
                for attr, key in (
                    ("squeeze", "squeeze"), ("expand1x1", "e1"), ("expand3x3", "e3"),
                ):
                    conv = getattr(layer, attr)
                    params[f"fire{fi}_{key}_w"] = conv.weight.detach().numpy()
                    params[f"fire{fi}_{key}_b"] = conv.bias.detach().numpy()
                fi += 1
    else:
        ci = 0
        for layer in tv:
            if isinstance(layer, nn.Conv2d):
                params[f"conv{ci}_w"] = layer.weight.detach().numpy()
                params[f"conv{ci}_b"] = layer.bias.detach().numpy()
                ci += 1

    url = (
        "https://raw.githubusercontent.com/richzhang/PerceptualSimilarity/"
        f"master/lpips/weights/v0.1/{net}.pth"
    )
    lin = torch.hub.load_state_dict_from_url(url, progress=False, map_location="cpu")
    for i in range(_NUM_TAPS[net]):
        params[f"lin{i}_w"] = lin[f"lin{i}.model.1.weight"].numpy()
    np.savez(out_path, **params)
