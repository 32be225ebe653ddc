"""VGG-style conv encoder/decoder for 48x64 / 64x64 frames, NHWC
(counterpart of `robot_aware_control_tpu/ops/encoders.py:conv_encoder` and
`conv_decoder`; reference: src/prediction/models/vgg_64.py:87-129,
196-241). Given a `stats` list their BatchNorms run in train mode and
append their updates to it (ops/nn.py); without one they use the running
statistics, as the JAX functions' `train` argument selects."""

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
