"""Evaluation metrics: PSNR and SSIM (counterpart of
`robot_aware_control_tpu/ops/metrics.py:15-76`; reference:
src/utils/metrics.py:45-78). NHWC inputs, float32 arithmetic."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def psnr(estimates, targets, data_dims=3):
    """PSNR exactly as the reference defines it (metrics.py:59-78).

    The reference maps inputs through (x+1)/2 although callers pass [0,1]
    images (trainer.py:689), which adds 20*log10(2) ~= 6.02 dB to a
    textbook PSNR; kept so the numbers compare. `true_psnr` is the
    standard definition."""
    est = (estimates.float() + 1) / 2
    tgt = (targets.float() + 1) / 2
    mse = ((est - tgt) ** 2).mean(dim=tuple(range(-data_dims, 0)))
    return 10 * torch.log(1.0 / mse) / math.log(10)


def true_psnr(estimates, targets, data_dims=3, max_val=1.0):
    mse = ((estimates.float() - targets.float()) ** 2).mean(
        dim=tuple(range(-data_dims, 0)))
    return 10 * torch.log(max_val ** 2 / mse) / math.log(10)


def _gaussian_window(window_size=11, sigma=1.5):
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.from_numpy(np.outer(g, g).astype(np.float32))


def ssim(img1, img2, window_size=11):
    """Per-pixel SSIM map through a depthwise Gaussian filter, with the
    torch implementation's constants (reference: metrics.py:14-57).

    img: (B, H, W, C) in [0,1]. Returns the SSIM map (B, H, W, C). The
    filter runs in full float32 whatever torch's TF32 flags say:
    filt(x*x) - mu^2 cancels catastrophically at reduced precision
    (variances go negative, SSIM above 1), which is why the JAX version
    asks for Precision.HIGHEST."""
    x = img1.float().permute(0, 3, 1, 2)
    y = img2.float().permute(0, 3, 1, 2)
    c = x.shape[1]
    w = _gaussian_window(window_size).to(x.device)[None, None].expand(
        c, 1, window_size, window_size)
    cudnn = torch.backends.cudnn

    def filt(z):
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            return F.conv2d(z, w, padding=window_size // 2, groups=c)

    mu1, mu2 = filt(x), filt(y)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = filt(x * x) - mu1_sq
    s2 = filt(y * y) - mu2_sq
    s12 = filt(x * y) - mu12
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    out = ((2 * mu12 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return out.permute(0, 2, 3, 1)
