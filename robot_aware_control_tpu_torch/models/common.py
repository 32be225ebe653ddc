"""Shared helpers for model steps."""

from __future__ import annotations


def composite(x_pred, prev_image):
    """(1 - m̂)·prev + m̂·rgb with the decoder's extra attention channel
    (conv models, reference: src/prediction/trainer.py:406-407)."""
    rgb, attn = x_pred[..., :-1], x_pred[..., -1:]
    prev = prev_image.to(rgb.dtype)
    return (1.0 - attn) * prev + attn * rgb
