"""Camera calibration for the locobot viewpoint the planner renders from.

The measured camera_to_world extrinsics of `locobot_c0` and the intrinsics
of its Intel RealSense D435 (reference: src/utils/camera_calibration.py;
the reference's realsense matrix has fy in K[1,0], a row typo, stored here
with fy at K[1,1]). Other robots and viewpoints come with the slices that
plan for them.
"""

from __future__ import annotations

import numpy as np

# intrinsics at the native 640x480 capture resolution
CAM_INTRINSICS = {
    "intel_realsense_d435": np.array(
        [[612.45, 0.0, 330.55], [0.0, 612.56, 248.61], [0.0, 0.0, 1.0]]
    ),
}
CAM_RESOLUTION = {"intel_realsense_d435": (640, 480)}

_MEASURED_CAMERA_TO_WORLD = {
    "locobot_c0": [
        [0.10142061, 0.72632463, -0.67386291, 0.78975893],
        [0.98958408, -0.08242317, 0.06193354, -0.03911564],
        [-0.00928995, -0.68100839, -0.72849251, 0.64767807],
    ],
}


def get_world_to_camera(key: str) -> np.ndarray:
    """4x4 world-to-camera matrix (float64) of a measured viewpoint."""
    if key not in _MEASURED_CAMERA_TO_WORLD:
        raise KeyError(f"no measured calibration for viewpoint {key!r}")
    c2w = np.eye(4)
    c2w[:3] = np.asarray(_MEASURED_CAMERA_TO_WORLD[key], np.float64)
    return np.linalg.inv(c2w)
