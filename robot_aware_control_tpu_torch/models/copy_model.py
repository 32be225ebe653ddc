"""Copy baseline: the previous frame's world pixels carried through the
next mask (counterpart of `robot_aware_control_tpu/models/copy_model.py`;
reference: src/prediction/models/dynamics.py:341-360).

World pixels of the next frame (next_mask == 0) take the previous image's
values; robot pixels keep the next image's. It has no parameters: the
floor for world-pixel error.
"""

from __future__ import annotations


def step(image, next_image, next_mask):
    """image/next_image (B, H, W, C), next_mask (B, H, W, 1). Returns the
    prediction (B, H, W, C)."""
    robot = (next_mask.float() > 0.5).to(image.dtype)
    return robot * next_image + (1.0 - robot) * image
