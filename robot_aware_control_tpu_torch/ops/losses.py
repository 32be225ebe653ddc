"""Loss helpers the planner uses (counterpart of
`robot_aware_control_tpu/ops/losses.py`); the training losses come with
the training slice."""

from __future__ import annotations


def zero_robot_region(mask, image):
    """Zero out robot pixels (reference: src/utils/image.py:5-13).
    mask (B,H,W,1), image (B,H,W,C)."""
    keep = 1.0 - (mask.float() > 0.5).to(image.dtype)
    return image * keep
