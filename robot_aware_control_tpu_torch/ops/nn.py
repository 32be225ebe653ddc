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
recomputes for a checkpointed backward thus updates nothing twice. Inside
`batch_stats_group(group)` (a data-parallel train step) the batch's
statistics are those of every rank's rows together: sums all-reduced over
the group, differentiably, as XLA reduces them over a sharded batch (a
group of one rank keeps the local statistics' bits).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


# rows of the batch a convolution takes at once (None: all of them)
_CONV_ROWS = contextvars.ContextVar("conv_rows", default=None)


@contextlib.contextmanager
def conv_rows(rows: Optional[int]):
    """Inside, every Conv2d runs on `rows` rows of its batch at a time, so
    that a batch of several requests' rows convolves each request at the
    batch size it has alone (cuDNN may choose another algorithm, which
    adds in another order, for another batch size)."""
    token = _CONV_ROWS.set(rows)
    try:
        yield
    finally:
        _CONV_ROWS.reset(token)


# the process group whose ranks' rows make up train-mode BatchNorm's batch
# (None: this rank's rows alone)
_BN_GROUP = contextvars.ContextVar("batch_stats_group", default=None)


@contextlib.contextmanager
def batch_stats_group(group):
    """Inside, train-mode BatchNorm normalizes by the statistics of the
    whole batch split over `group`'s ranks (parallel/mesh.py)."""
    token = _BN_GROUP.set(group)
    try:
        yield
    finally:
        _BN_GROUP.reset(token)


class _SumOverGroup(torch.autograd.Function):
    """x summed over the ranks of a process group; the gradient of every
    rank's sum reaches every rank's x (an all-reduce both ways)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _global_var_mean(xf, group):
    """Biased variance, mean and count over N, H, W of the rows of every
    rank of `group` (equal shards), in two passes like the local
    statistics; the all-reduces carry the gradient to every rank's rows."""
    n = xf.shape[0] * xf.shape[1] * xf.shape[2] * dist.get_world_size(group)
    mean = _SumOverGroup.apply(xf.sum((0, 1, 2)), group) / n
    var = _SumOverGroup.apply(((xf - mean) ** 2).sum((0, 1, 2)), group) / n
    return var, mean, n


def same_pads(size: int, k: int, stride: int):
    """XLA's SAME padding of one spatial axis: (low, high), the odd pixel
    at the high end (a stride-2 convolution of an even map pads 1, 2 for
    k = 5 and 0, 1 for k = 3, where torch's symmetric padding would not)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """Convolution, NHWC in and out: SAME padding as XLA pads it (the
    default) or VALID, stride 1 unless given, a square kernel of size `k`
    or a (kh, kw) one."""

    def __init__(self, cin: int, cout: int, k, bias: bool = True,
                 dtype=torch.float32, device=None, stride: int = 1,
                 padding: str = "same"):
        super().__init__()
        kh, kw = (k, k) if isinstance(k, int) else k
        self.weight = nn.Parameter(
            torch.empty(cout, cin, kh, kw, dtype=dtype, device=device))
        self.bias = (nn.Parameter(torch.empty(cout, dtype=dtype, device=device))
                     if bias else None)
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        rows = _CONV_ROWS.get()
        if rows is not None and x.shape[0] > rows:
            return torch.cat([self(part) for part in x.split(rows)])
        b = None if self.bias is None else self.bias.to(x.dtype)
        kh, kw = self.weight.shape[-2:]
        xc = x.permute(0, 3, 1, 2)
        pad = (0, 0)
        if self.padding == "same":
            ph, pw = (same_pads(n, k, self.stride)
                      for n, k in zip(x.shape[1:3], (kh, kw)))
            if ph[0] == ph[1] and pw[0] == pw[1]:
                pad = (ph[0], pw[0])
            else:
                xc = F.pad(xc, pw + ph)
        y = F.conv2d(xc, self.weight.to(x.dtype), b, stride=self.stride,
                     padding=pad)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """The stride-1 VALID transpose convolution of a vector to a (kh, kw)
    map (JAX `encoders.py:_conv_transpose_valid`): x (B, cin) -> (B, kh,
    kw, cout). The weight is the JAX kernel HWIO (kh, kw, cin, cout) in
    `Conv2d`'s OIHW order, as every convolution's. `lax.conv_transpose`
    does not flip its kernel and `F.conv_transpose2d` does, so the forward
    flips it spatially: out[:, i, j] = x @ w_jax[kh-1-i, kw-1-j]."""

    def __init__(self, cin: int, cout: int, k, dtype=torch.float32,
                 device=None):
        super().__init__()
        kh, kw = (k, k) if isinstance(k, int) else k
        self.weight = nn.Parameter(
            torch.empty(cout, cin, kh, kw, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.empty(cout, dtype=dtype, device=device))

    def forward(self, x):
        w = self.weight.to(x.dtype).permute(1, 0, 2, 3).flip(2, 3)
        y = F.conv_transpose2d(x[:, :, None, None], w, self.bias.to(x.dtype))
        return y.permute(0, 2, 3, 1)


class Linear(nn.Module):
    """x @ w + b over the last axis (JAX `nn.linear`), the weight in
    `F.linear`'s (out, in) layout and cast to x's type at use."""

    def __init__(self, din: int, dout: int, dtype=torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(dout, din, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.empty(dout, dtype=dtype, device=device))

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


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
        elif _BN_GROUP.get() is not None and dist.get_world_size(_BN_GROUP.get()) > 1:
            var, mean, n = _global_var_mean(xf, _BN_GROUP.get())
        else:
            var, mean = torch.var_mean(xf, dim=(0, 1, 2), unbiased=False)
            n = x.shape[0] * x.shape[1] * x.shape[2]
        if stats is not None:
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


def leaky_relu(x, slope: float = 0.2):
    """LeakyReLU(0.2), the VGG blocks' activation (JAX `nn.leaky_relu`)."""
    return F.leaky_relu(x, slope)


class MLPEncoder(nn.Module):
    """Linear -> Tanh -> Linear, hidden 32 (JAX `nn.mlp_encoder`;
    reference: src/prediction/models/base.py:5-23)."""

    def __init__(self, din: int, dout: int, hidden: int = 32,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.l1 = Linear(din, hidden, dtype, device)
        self.l2 = Linear(hidden, dout, dtype, device)

    def forward(self, x):
        return self.l2(torch.tanh(self.l1(x)))


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
        return leaky_relu(self.bn(self.conv(x), stats))


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
