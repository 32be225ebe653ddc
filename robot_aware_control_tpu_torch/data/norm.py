"""Workspace-bound state normalization
(reference: src/dataset/robonet/robonet_dataset.py:470-479)."""

from __future__ import annotations

import numpy as np

# Locobot workspace bounds used across training and planning
# (reference: robonet_dataset.py:201-203, src/cem/trajectory_sampler.py:22-23)
LOCOBOT_LOW = np.array([0.015, -0.3, 0.1, 0.0, 0.0], dtype=np.float32)
LOCOBOT_HIGH = np.array([0.55, 0.3, 0.4, 1.0, 1.0], dtype=np.float32)
# planar offsets of the franka / wx250s eef frames in the locobot frame
# (reference: src/utils/camera_calibration.py)
LOCO_FRANKA_DIFF = np.array([-0.365, -0.06103333], dtype=np.float32)
LOCO_WX250S_DIFF = np.array([-0.13, -0.01], dtype=np.float32)


def normalize(states, low, high):
    return (states - low) / (high - low)


def denormalize(states, low, high):
    return states * (high - low) + low
