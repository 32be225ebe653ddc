"""Layer library of the port, float path (NHWC activations).

Counterpart of `robot_aware_control_tpu/ops/nn.py`. Activations stay
contiguous (N, H, W, C) tensors as in the JAX package; a convolution hands
`F.conv2d` the free `x.permute(0, 3, 1, 2)` view, which is channels-last
NCHW, and permutes the channels-last result back. Convolution weights are
OIHW, stored in the compute dtype for inference models and in float32 for
training models, and cast to the activations' type at use as JAX `conv2d`
does; BatchNorm parameters and statistics stay float32 and normalize in
float32, as the JAX layer does.

BatchNorm in train mode normalizes by the batch's statistics and does not
touch its running statistics: it appends (module, batch mean, unbiased
batch variance) to a list the caller passes, and the caller applies them
with `apply_batch_stats` once, after the forward. A forward that autograd
recomputes for a checkpointed backward thus updates nothing twice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


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
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), b,
                     padding=self.weight.shape[-1] // 2)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """BatchNorm over N, H, W: (x - mean) * rsqrt(var + eps) * scale + bias
    in float32, cast back to x's type. With `stats` None it uses the
    running statistics (inference); given a list, the batch's biased
    statistics, and it appends its update to the list (train mode)."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))

    def forward(self, x, stats: Optional[list] = None):
        xf = x.float()
        if stats is None:
            mean, var = self.running_mean, self.running_var
        else:
            var, mean = torch.var_mean(xf, dim=(0, 1, 2), unbiased=False)
            n = x.shape[0] * x.shape[1] * x.shape[2]
            # torch tracks the *unbiased* variance in running statistics
            stats.append((self, mean.detach(),
                          var.detach() * (n / max(n - 1, 1))))
        inv = torch.rsqrt(var + BN_EPS) * self.weight
        return ((xf - mean) * inv + self.bias).to(x.dtype)


@torch.no_grad()
def apply_batch_stats(stats):
    """Fold train-mode BatchNorm statistics into the running statistics, in
    the order they were taken (momentum 0.1, as torch and the JAX layer)."""
    for bn, mean, var in stats:
        bn.running_mean.copy_((1 - BN_MOMENTUM) * bn.running_mean
                              + BN_MOMENTUM * mean)
        bn.running_var.copy_((1 - BN_MOMENTUM) * bn.running_var
                             + BN_MOMENTUM * var)


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

    def forward(self, x, stats: Optional[list] = None):
        return F.leaky_relu(self.bn(self.conv(x), stats), 0.2)


class VGGStack(nn.Sequential):
    """A chain of VGGLayers that passes the BatchNorm `stats` list on."""

    def forward(self, x, stats: Optional[list] = None):
        for layer in self:
            x = layer(x, stats)
        return x


def vgg_stack(channels: Sequence[int], dtype=torch.float32, device=None):
    """A chain of VGGLayers: channels = [cin, c1, c2, ...]."""
    return VGGStack(*[
        VGGLayer(channels[i], channels[i + 1], dtype, device)
        for i in range(len(channels) - 1)
    ])
