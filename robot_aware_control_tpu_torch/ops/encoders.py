"""VGG-style encoders/decoders for 48x64 / 64x64 frames, NHWC (counterpart
of `robot_aware_control_tpu/ops/encoders.py`; reference:
src/prediction/models/vgg_64.py:21-241). Two families:

  * ConvEncoder / ConvDecoder: the spatial-latent path of the conv models
    (svg, det, CDNA's encoder): an (H/8, W/8) feature map and 3 skip levels
    (vgg_64.py:87-129, 196-241);
  * Encoder / Decoder: the vector-latent path of svg_vec and det_vec: the
    encoder bottlenecks to a g_dim vector by a VALID (H/16, W/16) conv,
    BatchNorm and tanh; the decoder starts from a transpose conv of that
    vector to an (H/16, W/16) map (vgg_64.py:21-84, 146-193).

Given a `stats` list their BatchNorms run in train mode and append their
updates to it (ops/nn.py); without one they use the running statistics, as
the JAX functions' `train` argument selects."""

from __future__ import annotations

import torch
from typing import Optional

from torch import nn

from robot_aware_control_tpu_torch.ops import nn as N


class ConvEncoder(nn.Module):
    """nc -> (H/8, W/8, g_dim) feature map + 3 skip levels."""

    def __init__(self, g_dim: int, nc: int, dtype=torch.float32, device=None):
        super().__init__()
        self.c1 = N.vgg_stack([nc, 64, 64], dtype, device)
        self.c2 = N.vgg_stack([64, 128, 128], dtype, device)
        self.c3 = N.vgg_stack([128, 256, 256, 256], dtype, device)
        self.c4_head = N.vgg_stack([256, 512, 512], dtype, device)
        # final vgg layer 512 -> g_dim completes c4 (reference: vgg_64.py:115-119)
        self.c4_out = N.VGGLayer(512, g_dim, dtype, device)

    def forward(self, x, stats: Optional[list] = None):
        """x (B, H, W, nc) -> (feat (B, H/8, W/8, g), skips [h1, h2, h3, h4])."""
        h1 = self.c1(x, stats)
        h2 = self.c2(N.max_pool2(h1), stats)
        h3 = self.c3(N.max_pool2(h2), stats)
        h4 = self.c4_out(self.c4_head(N.max_pool2(h3), stats), stats)
        return h4, [h1, h2, h3, h4]


class ConvDecoder(nn.Module):
    """(H/8, W/8, dim) + skips -> (H, W, nc), sigmoid."""

    def __init__(self, dim: int, nc: int, dtype=torch.float32, device=None):
        super().__init__()
        self.upc2 = N.vgg_stack([dim, 512, 512, 256], dtype, device)
        self.upc3 = N.vgg_stack([256 * 2, 256, 256, 128], dtype, device)
        self.upc4 = N.vgg_stack([128 * 2, 128, 64], dtype, device)
        self.upc5 = N.vgg_stack([64 * 2, 64], dtype, device)
        # ConvTranspose2d(64, nc, 3, 1, 1) with stride 1 == SAME 3x3 conv
        self.out = N.Conv2d(64, nc, 3, dtype=dtype, device=device)

    def forward(self, vec, skips, stats: Optional[list] = None):
        h1, h2, h3, _ = skips
        d2 = self.upc2(vec, stats)
        d3 = self.upc3(torch.cat([N.upsample_nearest2(d2), h3], -1), stats)
        d4 = self.upc4(torch.cat([N.upsample_nearest2(d3), h2], -1), stats)
        d5 = self.upc5(torch.cat([N.upsample_nearest2(d4), h1], -1), stats)
        return torch.sigmoid(self.out(d5))


# ---------------------------------------------------------------------------
# the vector path (svg_vec, det_vec)

SKIP_CHANNELS = (64, 128, 256, 512)  # the vector encoder's stage outputs


def dropout2d(h, keep, rate: float):
    """Channel dropout (torch nn.Dropout2d; JAX `encoders.py:_dropout2d`):
    h (B, H, W, C) times a keep mask (B, C) of whole feature maps, the
    survivors scaled by 1 / (1 - rate). The mask is drawn by the caller
    (training/step.py:draw_noise), so a recomputed step reuses it."""
    return h * keep[:, None, None, :].to(h.dtype) / (1.0 - rate)


class _ConvBN(nn.Module):
    """A convolution and its BatchNorm, the JAX tree's {"conv", "bn"}."""

    def __init__(self, conv: nn.Module, c: int, device=None):
        super().__init__()
        self.conv = conv
        self.bn = N.BatchNorm(c, device=device)


class Encoder(nn.Module):
    """nc -> (B, g_dim) + skips of 64/128/256/512 channels at H, H/2, H/4
    and H/8 (`encoders.py:encoder`). feat_hw is the map after four pools
    ((3, 4) at 48x64), which c5's VALID conv takes whole."""

    def __init__(self, g_dim: int, nc: int, feat_hw, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.c1 = N.vgg_stack([nc, 64, 64], dtype, device)
        self.c2 = N.vgg_stack([64, 128, 128], dtype, device)
        self.c3 = N.vgg_stack([128, 256, 256, 256], dtype, device)
        self.c4 = N.vgg_stack([256, 512, 512, 512], dtype, device)
        self.c5 = _ConvBN(N.Conv2d(512, g_dim, tuple(feat_hw), dtype=dtype,
                                   device=device, padding="valid"),
                          g_dim, device)

    def forward(self, x, stats: Optional[list] = None, keep=None,
                rate: Optional[float] = None):
        """x (B, H, W, nc) -> (h (B, g_dim), skips [h1, h2, h3, h4]). With
        `keep`, four channel-dropout masks ((B, 64), (B, 128), (B, 256),
        (B, 512)), each stage's output is dropped at `rate` (train mode)."""
        drop = ((lambda h, i: dropout2d(h, keep[i], rate)) if keep is not None
                else (lambda h, i: h))
        h1 = drop(self.c1(x, stats), 0)
        h2 = drop(self.c2(N.max_pool2(h1), stats), 1)
        h3 = drop(self.c3(N.max_pool2(h2), stats), 2)
        h4 = drop(self.c4(N.max_pool2(h3), stats), 3)
        h5 = torch.tanh(self.c5.bn(self.c5.conv(N.max_pool2(h4)), stats))
        return h5.reshape(h5.shape[0], -1), [h1, h2, h3, h4]


class Decoder(nn.Module):
    """(B, g_dim) + skips -> (H, W, nc), sigmoid (`encoders.py:decoder`):
    upc1 the transpose conv to (H/16, W/16, 512) + BatchNorm + LeakyReLU,
    then four times upsample, concat the skip, VGG stack."""

    def __init__(self, g_dim: int, nc: int, feat_hw, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.upc1 = _ConvBN(N.ConvTranspose(g_dim, 512, tuple(feat_hw), dtype,
                                            device), 512, device)
        self.upc2 = N.vgg_stack([512 * 2, 512, 512, 256], dtype, device)
        self.upc3 = N.vgg_stack([256 * 2, 256, 256, 128], dtype, device)
        self.upc4 = N.vgg_stack([128 * 2, 128, 64], dtype, device)
        self.upc5 = N.vgg_stack([64 * 2, 64], dtype, device)
        self.out = N.Conv2d(64, nc, 3, dtype=dtype, device=device)

    def forward(self, vec, skips, stats: Optional[list] = None):
        h1, h2, h3, h4 = skips
        d1 = N.leaky_relu(self.upc1.bn(self.upc1.conv(vec), stats))
        d2 = self.upc2(torch.cat([N.upsample_nearest2(d1), h4], -1), stats)
        d3 = self.upc3(torch.cat([N.upsample_nearest2(d2), h3], -1), stats)
        d4 = self.upc4(torch.cat([N.upsample_nearest2(d3), h2], -1), stats)
        d5 = self.upc5(torch.cat([N.upsample_nearest2(d4), h1], -1), stats)
        return torch.sigmoid(self.out(d5))
