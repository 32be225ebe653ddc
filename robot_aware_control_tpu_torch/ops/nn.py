"""Layer library of the port, float path (NHWC activations).

Counterpart of `robot_aware_control_tpu/ops/nn.py`. Activations stay
contiguous (N, H, W, C) tensors as in the JAX package; a convolution hands
`F.conv2d` the free `x.permute(0, 3, 1, 2)` view, which is channels-last
NCHW, and permutes the channels-last result back. Convolution weights are
OIHW in the compute dtype; BatchNorm parameters and statistics stay
float32 and normalize in float32, as the JAX layer does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


class Conv2d(nn.Module):
    """SAME-padded stride-1 convolution, NHWC in and out."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(cout, cin, k, k, dtype=dtype, device=device))
        self.bias = (nn.Parameter(torch.empty(cout, dtype=dtype, device=device))
                     if bias else None)

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                     padding=self.weight.shape[-1] // 2)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """Inference BatchNorm over N, H, W: (x - mean) * rsqrt(var + eps) *
    scale + bias in float32, cast back to x's type."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        return ((x.float() - self.running_mean) * inv + self.bias).to(x.dtype)


def max_pool2(x):
    """2x2 max pool, stride 2 (torch MaxPool2d(2, 2)), NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def upsample_nearest2(x):
    """Nearest-neighbour 2x upsample (torch UpsamplingNearest2d), NHWC."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    return y.permute(0, 2, 3, 1)


class VGGLayer(nn.Module):
    """conv3x3 (no bias) + BatchNorm + LeakyReLU(0.2)
    (reference: src/prediction/models/vgg_64.py:8-18)."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32, device=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3, bias=False, dtype=dtype, device=device)
        self.bn = BatchNorm(cout, device=device)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), 0.2)


def vgg_stack(channels: Sequence[int], dtype=torch.float32, device=None):
    """A chain of VGGLayers: channels = [cin, c1, c2, ...]."""
    return nn.Sequential(*[
        VGGLayer(channels[i], channels[i + 1], dtype, device)
        for i in range(len(channels) - 1)
    ])
