"""Robot masks from projected capsules (counterpart of
`robot_aware_control_tpu/robot/mask_renderer.py`).

The arm silhouette is a union of capsules (segments with radii) given by
forward kinematics, plus static capsules for the mobile base. Each
capsule's endpoints project through the camera; the pixel-space radius
scales with 1/depth. `render` computes the per-capsule pixel parameters
here and rasterises them with `ops.kernels.capsule_mask_render` (the CUDA
kernel on the GPU, its plain version on the CPU). "Thick" masks (reference:
LocobotMaskEnv(thick=True), src/dataset/locobot/locobot_model.py:30) scale
the gripper capsule's radius.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from robot_aware_control_tpu_torch.data import calibration as calib
from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.robot import _locobot_tuned as _lt
from robot_aware_control_tpu_torch.robot import locobot_kinematics as lk

# per-segment radii (m) for [trunk, shoulder link, forearm, gripper] and
# the gripper's thick-mask scale, tuned against MuJoCo segmentation renders
LOCOBOT_RADII = np.asarray(_lt.LOCOBOT_RADII, np.float32)
THICK_SCALE = float(_lt.THICK_SCALE)

# Static base silhouette: world-frame capsules fitted to the reference
# MJCF world-body geoms (mobile base, camera-mount plates, battery column);
# the reference's segmentation masks include them.
LOCOBOT_BASE_SEGMENTS = np.array(
    [
        [[-0.14, 0.0, 0.07], [0.10, 0.0, 0.07]],      # mobile base (x)
        [[0.0, -0.10, 0.07], [0.0, 0.10, 0.07]],      # mobile base (y)
        [[0.053, -0.08, 0.15], [0.053, 0.08, 0.15]],  # camera plates
        [[-0.005, 0.0, 0.06], [-0.005, 0.0, 0.20]],   # battery column
    ],
    np.float32,
)
LOCOBOT_BASE_RADII = np.asarray(_lt.LOCOBOT_BASE_RADII, np.float32)


class CapsuleMaskRenderer:
    """Projects FK capsules (4 arm links + 4 static base capsules) into
    the locobot_c0 camera's image plane."""

    def __init__(self, image_size: Tuple[int, int] = (48, 64),  # (h, w)
                 thick: bool = False, modified: bool = False, device="cpu"):
        self.h, self.w = image_size
        dev = torch.device(device)
        w2c = calib.get_world_to_camera("locobot_c0")
        K = calib.CAM_INTRINSICS["intel_realsense_d435"]
        ow, oh = calib.CAM_RESOLUTION["intel_realsense_d435"]
        self._w2c = torch.tensor(w2c, dtype=torch.float32, device=dev)
        # fold the target-resolution rescale into the intrinsics
        S = np.diag([self.w / ow, self.h / oh, 1.0])
        self._K = (S @ K).astype(np.float32)
        r = LOCOBOT_RADII.copy()
        if thick:  # gripper-only inflation, like locobot_thick.xml
            r[-1] = r[-1] * THICK_SCALE
        self.l3 = lk.L3_MODIFIED if modified else lk.L3
        self.base_segments = torch.tensor(LOCOBOT_BASE_SEGMENTS, device=dev)
        self.radii = torch.tensor(np.concatenate([r, LOCOBOT_BASE_RADII]),
                                  device=dev)

    def _project(self, pts):
        """world (..., 3) -> (u (...,), v (...,), depth (...,))."""
        ph = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
        cam = torch.einsum("ij,...j->...i", self._w2c[:3], ph)
        z = torch.clamp(cam[..., 2], min=1e-4)
        K = self._K
        u = float(K[0, 0]) * cam[..., 0] / z + float(K[0, 2])
        v = float(K[1, 1]) * cam[..., 1] / z + float(K[1, 2])
        return u, v, z

    def _capsules(self, qpos):
        """FK + static base -> (a (..., S, 3), b (..., S, 3))."""
        pts = lk.fk_points(qpos, self.l3)  # (..., 5, 3)
        lead = pts.shape[:-2]
        nb = self.base_segments.shape[0]
        a = torch.cat([pts[..., :-1, :],
                       self.base_segments[:, 0].expand(lead + (nb, 3))], -2)
        b = torch.cat([pts[..., 1:, :],
                       self.base_segments[:, 1].expand(lead + (nb, 3))], -2)
        return a, b

    def segment_params(self, qpos):
        """FK + projection -> per-capsule pixel-space parameters
        (..., S, 6) = [au, av, bu, bv, ra, rb]."""
        pa, pb = self._capsules(qpos)
        ua, va, za = self._project(pa)
        ub, vb, zb = self._project(pb)
        f = float(self._K[0, 0])
        r_a = f * self.radii / za
        r_b = f * self.radii / zb
        return torch.stack([ua, va, ub, vb, r_a, r_b], -1)

    def render(self, qpos):
        """qpos (..., >=4) -> masks (..., h, w, 1) float32 in {0, 1}."""
        segs = self.segment_params(qpos)
        lead = segs.shape[:-2]
        flat = segs.reshape((-1,) + segs.shape[-2:]).float().contiguous()
        masks = kernels.capsule_mask_render(flat, self.h, self.w)
        return masks.reshape(lead + (self.h, self.w, 1))
