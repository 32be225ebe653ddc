"""Reconstruction losses, robot-aware "don't-care" criteria and KL
(counterpart of `robot_aware_control_tpu/ops/losses.py:23-120`; reference:
src/prediction/losses.py:11-106), in mask-multiply form:

    dontcare(x, y, m) = mean_b( sum(|y - x| * w(m)) / (#world_px(m) + 1) )
    with w(m) = robot_weight on robot pixels, 1 elsewhere.

Shapes are NHWC: prediction/target (B, H, W, C), mask (B, H, W, 1). Every
reduction is in float32 whatever the compute dtype.
"""

from __future__ import annotations

import math

import torch


def _f32(*xs):
    return tuple(x.float() for x in xs)


def mse_criterion(prediction, target):
    """Plain MSE (reference: losses.py:11)."""
    p, t = _f32(prediction, target)
    return ((t - p) ** 2).mean()


def l1_criterion(prediction, target, batch_weight=None):
    """L1; optional per-batch-element weights (reference: losses.py:13-19)."""
    p, t = _f32(prediction, target)
    diff = (t - p).abs()
    if batch_weight is None:
        return diff.mean()
    per_elem = diff.mean(dim=tuple(range(1, diff.dim())))
    return (batch_weight.float() * per_elem).mean()


def _robot_pixels(mask, channels):
    """(B,H,W,1) mask -> (B,H,W,C) bool robot pixels and the per-batch
    world pixel count + 1."""
    m3 = (mask.float() > 0.5).expand(*mask.shape[:3], channels)
    num_world = (~m3).sum(dim=(1, 2, 3)).float() + 1.0
    return m3, num_world


def dontcare_mse_criterion(prediction, target, mask, robot_weight):
    """Robot pixels weighted by robot_weight (0 drops them), normalized by
    the world pixel count + 1 (reference: losses.py:21-33). The reference
    scales the difference before squaring, so the weight enters squared."""
    p, t = _f32(prediction, target)
    m3, num_world = _robot_pixels(mask, p.shape[-1])
    weights = torch.where(m3, robot_weight, 1.0)
    sq = ((t - p) * weights) ** 2
    return (sq.sum(dim=(1, 2, 3)) / num_world).mean()


def dontcare_l1_criterion(prediction, target, mask, robot_weight,
                          batch_weight=None):
    """(reference: losses.py:35-50)"""
    p, t = _f32(prediction, target)
    m3, num_world = _robot_pixels(mask, p.shape[-1])
    weights = torch.where(m3, robot_weight, 1.0)
    per_elem = ((t - p) * weights).abs().sum(dim=(1, 2, 3)) / num_world
    if batch_weight is not None:
        per_elem = batch_weight.float() * per_elem
    return per_elem.mean()


def robot_mse_criterion(prediction, target, mask):
    """MSE restricted to robot pixels (reference: losses.py:52-64)."""
    p, t = _f32(prediction, target)
    m3, _ = _robot_pixels(mask, p.shape[-1])
    sq = torch.where(m3, (t - p) ** 2, 0.0)
    num_robot = m3.sum(dim=(1, 2, 3)).float() + 1.0
    return (sq.sum(dim=(1, 2, 3)) / num_robot).mean()


def _world_mse(prediction, target, mask):
    p, t = _f32(prediction, target)
    m3, num_world = _robot_pixels(mask, p.shape[-1])
    sq = torch.where(m3, 0.0, (t - p) ** 2)
    return sq.sum(dim=(1, 2, 3)) / num_world


def world_mse_criterion(prediction, target, mask):
    """MSE restricted to world pixels (reference: losses.py:66-78)."""
    return _world_mse(prediction, target, mask).mean()


def world_psnr_criterion(prediction, target, mask):
    """Per-batch-element PSNR over world pixels (reference: losses.py:80-94)."""
    return 10.0 * torch.log(1.0 / _world_mse(prediction, target, mask)) / math.log(10.0)


def kl_criterion(mu1, logvar1, mu2, logvar2, batch_size):
    """Analytic KL(N1 || N2), summed and divided by the batch size
    (reference: losses.py:97-106)."""
    mu1, logvar1, mu2, logvar2 = _f32(mu1, logvar1, mu2, logvar2)
    sigma1 = torch.exp(0.5 * logvar1)
    sigma2 = torch.exp(0.5 * logvar2)
    kld = (torch.log(sigma2 / sigma1)
           + (torch.exp(logvar1) + (mu1 - mu2) ** 2) / (2 * torch.exp(logvar2))
           - 0.5)
    return kld.sum() / batch_size


def zero_robot_region(mask, image):
    """Zero out robot pixels (reference: src/utils/image.py:5-13).
    mask (B,H,W,1), image (B,H,W,C)."""
    keep = 1.0 - (mask.float() > 0.5).to(image.dtype)
    return image * keep
