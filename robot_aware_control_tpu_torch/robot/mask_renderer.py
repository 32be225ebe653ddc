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

from typing import Optional, Tuple

import numpy as np
import torch

from robot_aware_control_tpu_torch.data import calibration as calib
from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.robot import _locobot_tuned as _lt
from robot_aware_control_tpu_torch.robot import locobot_kinematics as lk
from robot_aware_control_tpu_torch.utils.device import resolve_device

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
    """Projects FK capsules (4 arm links and, with include_base, the static
    base capsules) into the image plane of the camera registered under
    `camera_key` (data/calibration.py; a controller may register its own
    calibration there first) with the intrinsics of `cam_name`. `radii`
    replaces the arm's 4 radii (the modified robot's thicker links),
    `base_segments` (B, 2, 3) and `base_radii` (B,) the base's capsules."""

    def __init__(self, image_size: Tuple[int, int] = (48, 64),  # (h, w)
                 camera_key: str = "locobot_c0",
                 cam_name: str = "intel_realsense_d435",
                 radii: Optional[np.ndarray] = None, thick: bool = False,
                 modified: bool = False, include_base: bool = True,
                 base_segments: Optional[np.ndarray] = None,
                 base_radii: Optional[np.ndarray] = None, device="cuda"):
        self.h, self.w = image_size
        dev = resolve_device(device)
        self.device = dev
        w2c = calib.get_world_to_camera(camera_key)
        K = calib.CAM_INTRINSICS[cam_name]
        ow, oh = calib.CAM_RESOLUTION[cam_name]
        self._w2c = torch.tensor(w2c, dtype=torch.float32, device=dev)
        # fold the target-resolution rescale into the intrinsics
        S = np.diag([self.w / ow, self.h / oh, 1.0])
        self._K = (S @ K).astype(np.float32)
        r = (LOCOBOT_RADII if radii is None
             else np.asarray(radii, np.float32)).copy()
        if thick:  # gripper-only inflation, like locobot_thick.xml
            r[-1] = r[-1] * THICK_SCALE
        self.l3 = lk.L3_MODIFIED if modified else lk.L3
        if include_base:
            bs = (LOCOBOT_BASE_SEGMENTS if base_segments is None
                  else np.asarray(base_segments, np.float32))
            br = (LOCOBOT_BASE_RADII if base_radii is None
                  else np.asarray(base_radii, np.float32))
        else:
            bs, br = np.zeros((0, 2, 3), np.float32), np.zeros(0, np.float32)
        self.base_segments = torch.tensor(bs, device=dev)
        self.radii = torch.tensor(np.concatenate([r, br]), device=dev)

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

    def render_heatmaps(self, eef, sx=5.0, sy=5.0, height=100.0):
        """eef (..., 3) raw world positions -> (..., h, w, 1) float32 eef
        gaussian heatmaps on the renderer's device (JAX
        `mask_renderer.py:render_heatmaps`): the data layer's gaussian
        (data/heatmaps.py) on the renderer's pixel centres less 0.5, zero
        where the eef projects outside the image. The planner conditions
        heatmap-trained models on them, rendered from predicted states."""
        u, v, _ = self._project(eef)
        dev = u.device
        px = (torch.arange(self.w, dtype=torch.float32, device=dev) + 0.5) - 0.5
        py = (torch.arange(self.h, dtype=torch.float32, device=dev) + 0.5) - 0.5
        ue, ve = u[..., None, None], v[..., None, None]
        g = height / (2.0 * np.pi * sx * sy) * torch.exp(
            -((px - ue) ** 2 / (2 * sx ** 2)
              + (py[:, None] - ve) ** 2 / (2 * sy ** 2)))
        g = torch.clamp(g, 0.0, 1.0)
        in_frame = (u >= 0) & (u < self.w) & (v >= 0) & (v < self.h)
        return (g * in_frame[..., None, None])[..., None].float()
