"""Shared helpers for model steps (counterpart of
`robot_aware_control_tpu/models/common.py`)."""

from __future__ import annotations

import torch

from robot_aware_control_tpu_torch.config import Config


def skip_zeros(cfg: Config, batch: int, dtype=torch.float32, device=None):
    """Zero-filled encoder skips of the encoder's output shapes: the skip
    carry before the first step, which always overwrites it (reference:
    src/prediction/trainer.py:370, 409-410)."""
    h, w = cfg.image_height, cfg.image_width
    z = lambda *s: torch.zeros(batch, *s, dtype=dtype, device=device)
    return [z(h, w, 64), z(h // 2, w // 2, 128), z(h // 4, w // 4, 256),
            z(h // 8, w // 8, cfg.g_dim)]


def composite(cfg: Config, x_pred, prev_image):
    """(1 - m̂)·prev + m̂·rgb when the decoder emits the extra attention
    channel (conv models, reference: src/prediction/trainer.py:406-407);
    identity for a prediction without it."""
    if x_pred.shape[-1] != cfg.channels + 1:
        return x_pred
    rgb, attn = x_pred[..., :-1], x_pred[..., -1:]
    prev = prev_image.to(rgb.dtype)
    return (1.0 - attn) * prev + attn * rgb
