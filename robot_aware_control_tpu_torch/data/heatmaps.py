"""End-effector gaussian heatmaps of the data layer (reference:
src/dataset/robonet/robonet_dataset.py:482-544, 420-431); a copy of
`robot_aware_control_tpu/data/heatmaps.py` (numpy only).

Projects denormalized eef positions through the camera intrinsics and
extrinsics and rasterizes a 2-D gaussian bump per frame, on an integer
pixel grid with subpixel centres (the planner's `render_heatmaps` uses the
renderer's grid instead, robot/mask_renderer.py)."""

from __future__ import annotations

import numpy as np

from robot_aware_control_tpu_torch.data import calibration as calib
from robot_aware_control_tpu_torch.data.norm import denormalize

# per-robot gripper z offsets (reference: robonet_dataset.py:497-516)
_Z_OFFSET = {"sawyer": -0.15, "widowx": 0.05}


def project_eef(states_xyz, world_to_cam, K, target_dim, orig_dim):
    """(T,3) world eef -> (T,2) pixel coordinates in the target image
    (reference: robonet_dataset.py:420-431)."""
    T = states_xyz.shape[0]
    pts = np.concatenate([states_xyz, np.ones((T, 1))], 1).T  # (4,T)
    proj = K @ world_to_cam[:3]
    pix = proj @ pts
    pix = pix[:2] / pix[2:3]
    pix[0] *= target_dim[0] / orig_dim[0]
    pix[1] *= target_dim[1] / orig_dim[1]
    return pix.T  # (T, 2) as (x, y)


def gaussian_2d(w, h, mx, my, sx=5.0, sy=5.0, height=100.0):
    x = np.arange(w)[None, :]
    y = np.arange(h)[:, None]
    z = height / (2 * np.pi * sx * sy) * np.exp(
        -((x - mx) ** 2 / (2 * sx ** 2) + (y - my) ** 2 / (2 * sy ** 2))
    )
    return np.clip(z, 0.0, 1.0)


def create_heatmaps(states, low, high, robot, viewpoint, target_dim=(64, 48),
                    quantize: bool = False):
    """(T, robot_dim) normalized states -> (T, h, w, 1) float32 heatmaps;
    target_dim is (w, h). Frames whose eef projects outside the image are
    zero.

    quantize=True reproduces the reference: pixel centres truncated with
    `astype(np.uint8)` (robonet_dataset.py:430) before the bounds check
    and rasterization. The default keeps subpixel centres (the truncation
    loses up to a pixel of eef position, and uint8 wraps coordinates >= 256
    back into the frame)."""
    states = np.asarray(states, np.float32).copy()
    states[:, :3] = denormalize(states[:, :3], low[:3], high[:3])
    eef = states[:, :3]
    if robot in _Z_OFFSET:
        eef[:, 2] += _Z_OFFSET[robot]
    w2c, K, odim = calib.robot_camera_info(robot, viewpoint)
    pix = project_eef(eef, w2c, K, target_dim, odim)
    if quantize:
        pix = pix.astype(np.uint8).astype(np.float32)
    w, h = target_dim
    maps = np.zeros((len(states), h, w, 1), np.float32)
    for t, (mx, my) in enumerate(pix):
        if 0 <= mx < w and 0 <= my < h:
            maps[t, :, :, 0] = gaussian_2d(w, h, mx, my)
    return maps
