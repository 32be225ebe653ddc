"""Shared helpers for model steps (counterpart of
`robot_aware_control_tpu/models/common.py`)."""

from __future__ import annotations

import torch

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.ops.lstm import ConvLSTMCell
from robot_aware_control_tpu_torch.ops.nn import (
    BatchNorm,
    Conv2d,
    ConvTranspose,
    Linear,
)


@torch.no_grad()
def init_weights(model, seed: int, train: bool):
    """The reference's init (reference: src/prediction/models/base.py:26-35):
    convolution, cell and linear weights N(0, 0.02), biases 0, BatchNorm
    scale N(1, 0.02) (GroupNorm keeps scale 1, bias 0, as the JAX init),
    drawn on the CPU from `seed` in float32 in module order and copied into
    each parameter's own type and device. Returns the model in train mode
    if `train`, else in inference mode (eval, no grad)."""
    gen = torch.Generator().manual_seed(seed)

    def normal(p, mean=0.0, std=0.02):
        p.copy_(mean + std * torch.randn(p.shape, generator=gen))

    for m in model.modules():
        if isinstance(m, (Conv2d, ConvLSTMCell, ConvTranspose, Linear)):
            normal(m.weight)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            normal(m.weight, mean=1.0)
            m.bias.zero_()
    if train:
        return model.train()
    return model.eval().requires_grad_(False)


def skip_zeros(cfg: Config, batch: int, dtype=torch.float32, device=None):
    """Zero-filled encoder skips of the encoder's output shapes: the skip
    carry before the first step, which always overwrites it (reference:
    src/prediction/trainer.py:370, 409-410); the vector encoder's last
    skip has 512 channels."""
    h, w = cfg.image_height, cfg.image_width
    last = 512 if cfg.model in ("svg_vec", "det_vec") else cfg.g_dim
    z = lambda *s: torch.zeros(batch, *s, dtype=dtype, device=device)
    return [z(h, w, 64), z(h // 2, w // 2, 128), z(h // 4, w // 4, 256),
            z(h // 8, w // 8, last)]


def composite(cfg: Config, x_pred, prev_image):
    """(1 - m̂)·prev + m̂·rgb when the decoder emits the extra attention
    channel (conv models, reference: src/prediction/trainer.py:406-407);
    identity for models that predict the frame itself (the vector models;
    CDNA's output is already composited)."""
    if x_pred.shape[-1] != cfg.channels + 1:
        return x_pred
    rgb, attn = x_pred[..., :-1], x_pred[..., -1:]
    prev = prev_image.to(rgb.dtype)
    return (1.0 - attn) * prev + attn * rgb
