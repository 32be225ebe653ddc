"""Evaluation metrics: PSNR and SSIM (counterpart of
`robot_aware_control_tpu/ops/metrics.py`; reference:
src/utils/metrics.py:45-78), and the SAVP family's cosine, pixel-distance
and perceptual metrics (reference: robonet/robonet/video_prediction/
metrics.py). NHWC inputs, float32 arithmetic."""

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


# SAVP/robonet metric family (JAX `metrics.py:84-156`)
def normalize_tensor(tensor, eps=1e-10):
    """L2-normalize over the last axis (reference: metrics.py:253-256)."""
    t = tensor.float()
    return t / (torch.sqrt((t * t).sum(-1, keepdim=True)) + eps)


def cosine_similarity(t0, t1):
    """Dot product of L2-normalized tensors over the last axis
    (reference: metrics.py:258-263)."""
    return (normalize_tensor(t0) * normalize_tensor(t1)).sum(-1)


def cosine_distance(t0, t1):
    """(reference: metrics.py:265-272)"""
    return (1.0 - cosine_similarity(t0, t1)).mean()


def expected_pixel_distance(real_dist, pred_dist):
    """E_pred[ || p - argmax(real) || ] over pixel distributions
    (B, T, H, W, K): the DNA family's designation metric
    (reference: metrics.py:13-22)."""
    r, p = real_dist.float(), pred_dist.float()
    h, w = r.shape[-3], r.shape[-2]
    obj_w = r.argmax(-2).amax(-2).float()
    obj_h = r.argmax(-3).amax(-2).float()
    ys = torch.arange(h, dtype=torch.float32, device=r.device).reshape(1, 1, -1, 1, 1)
    xs = torch.arange(w, dtype=torch.float32, device=r.device).reshape(1, 1, 1, -1, 1)
    dist = torch.sqrt((ys - obj_h[..., None, None, :]) ** 2
                      + (xs - obj_w[..., None, None, :]) ** 2)
    return (dist * p).sum((-3, -2))


def expected_square_pixel_distance(real_dist, pred_dist):
    """E[(p - p_true)^T (p - p_true)] between pixel distributions shaped
    (..., H, W, K) (reference: metrics.py:25-47)."""
    def moments(t):
        t = t.float()
        h, w = t.shape[-3], t.shape[-2]
        ys = torch.arange(h, dtype=torch.float32, device=t.device)[:, None]
        xs = torch.arange(w, dtype=torch.float32, device=t.device)[:, None]
        row, col = t.sum(-2), t.sum(-3)  # (..., H, K), (..., W, K)
        mh, mw = (ys * row).sum(-2), (xs * col).sum(-2)
        sh, sw = (ys ** 2 * row).sum(-2), (xs ** 2 * col).sum(-2)
        return torch.stack([mh, mw], -1), sh + sw

    mp, sq_p = moments(pred_dist)
    mr, sq_r = moments(real_dist)
    return sq_p - 2.0 * (mp * mr).sum(-1) + sq_r


def perceptual_cosine_distance(image0, image1, features_fn):
    """Perceptual distance with the caller's feature extractor
    (reference: metrics.py:275-293 uses pretrained VGG19):
    `features_fn(images) -> [(B, ..., C) feature tensors]`; the mean over
    the feature tensors of their cosine distance."""
    f0s, f1s = features_fn(image0), features_fn(image1)
    total = 0.0
    for f0, f1 in zip(f0s, f1s):
        total = total + cosine_distance(f0.reshape(f0.shape[0], -1, f0.shape[-1]),
                                        f1.reshape(f1.shape[0], -1, f1.shape[-1]))
    return total / len(f0s)
