"""Scene renderer of the simulated envs on the device.

Counterpart of `robot_aware_control_tpu/envs/renderer.py` (reference:
src/env/robotics/robot_env.py:20-217, per-frame `render()` and the
segmentation masks of base_mask_env.py:73-82): the table plane, coloured
blocks and the capsule-modelled arm, rasterized through the calibrated
camera of the mask renderer, batched over any leading dims. The robot mask
is the capsule-mask kernel's (`CapsuleMaskRenderer.render`: one launch for
every scene of a call), thin as the JAX scene renderer draws it.
"""

from __future__ import annotations

import numpy as np
import torch

from robot_aware_control_tpu_torch.robot import locobot_kinematics as lk
from robot_aware_control_tpu_torch.robot.mask_renderer import CapsuleMaskRenderer

ARM_COLOR = np.array([0.25, 0.25, 0.28], np.float32)
GRIPPER_COLOR = np.array([0.55, 0.55, 0.60], np.float32)
TABLE_COLOR = np.array([0.47, 0.35, 0.24], np.float32)
FLOOR_COLOR = np.array([0.62, 0.62, 0.66], np.float32)


def draw_order(z):
    """Block indices far to near for the painter's algorithm: a stable sort
    of -z, as jnp.argsort is, so that blocks at equal depth keep their
    order and the later one is drawn last."""
    return torch.argsort(-z, dim=-1, stable=True)


class SceneRenderer(CapsuleMaskRenderer):
    """RGB and robot-mask rendering of the tabletop scene."""

    def __init__(self, image_size=(48, 64), camera_key: str = "locobot_c0",
                 table_z: float = 0.1, modified: bool = False,
                 arm_color=None, radii=None, device="cuda"):
        super().__init__(image_size, camera_key, thick=False,
                         modified=modified, radii=radii, device=device)
        dev = self.device
        self.arm_color = torch.tensor(
            ARM_COLOR if arm_color is None else arm_color, dtype=torch.float32,
            device=dev)
        self.gripper_color = torch.tensor(GRIPPER_COLOR, device=dev)
        self.table_z = table_z
        self._Kt = torch.tensor(self._K, device=dev)
        self._px = torch.arange(self.w, dtype=torch.float32, device=dev) + 0.5
        self._py = (torch.arange(self.h, dtype=torch.float32, device=dev)
                    + 0.5)[:, None]
        # the background goes to the device once
        self._bg = torch.tensor(self._make_background(), device=dev)

    def _make_background(self) -> np.ndarray:
        """Floor with the table plane projected analytically: every pixel
        whose camera ray hits z = table_z inside the workspace is
        table-coloured, with a soft shading gradient (numpy, as the JAX
        renderer computes it)."""
        h, w = self.h, self.w
        K = self._K
        w2c = self._w2c.cpu().numpy()
        R, t = w2c[:3, :3], w2c[:3, 3]
        c2w_R = R.T
        cam_origin = -R.T @ t
        ys, xs = np.meshgrid(
            np.arange(h, dtype=np.float32) + 0.5,
            np.arange(w, dtype=np.float32) + 0.5,
            indexing="ij",
        )
        dirs_cam = np.stack(
            [(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
             np.ones_like(xs)], -1,
        )
        dirs_w = dirs_cam @ c2w_R.T
        denom = dirs_w[..., 2]
        tt = (self.table_z - cam_origin[2]) / np.where(
            np.abs(denom) < 1e-6, 1e-6, denom
        )
        hit = (tt > 0) & (np.abs(denom) > 1e-6)
        pts = cam_origin + tt[..., None] * dirs_w
        on_table = (
            hit
            & (pts[..., 0] > -0.05) & (pts[..., 0] < 0.75)
            & (pts[..., 1] > -0.45) & (pts[..., 1] < 0.45)
        )
        shade = 1.0 - 0.25 * np.clip(pts[..., 0], 0, 0.7)
        return np.where(
            on_table[..., None],
            TABLE_COLOR * shade[..., None],
            FLOOR_COLOR * (1.0 - 0.3 * ys[..., None] / h),
        ).astype(np.float32)

    # ------------------------------------------------------------------
    def render_objects(self, obj_pos, obj_half, obj_colors=None):
        """Blocks as squares scaled by 1/depth. obj_pos (..., K, 3);
        obj_half (K,) half-extents (m); obj_colors unused (the JAX
        signature). Returns (hit (..., K, h, w) bool,
        depth (..., K))."""
        u, v, z = self._project(obj_pos)
        r_pix = self._Kt[0, 0] * torch.as_tensor(
            obj_half, dtype=torch.float32, device=z.device) / z
        du = torch.abs(self._px - u[..., None, None])
        dv = torch.abs(self._py - v[..., None, None])
        hit = torch.maximum(du, dv) <= r_pix[..., None, None]
        return hit, z

    def render_scene(self, qpos, obj_pos, obj_half, obj_colors,
                     include_arm: bool = True):
        """Full scene RGB and robot mask. qpos (..., >=4); obj_pos
        (..., K, 3); obj_half (K,); obj_colors (K, 3). Returns (rgb (..., h,
        w, 3), mask (..., h, w, 1)). include_arm=False renders the robot-less
        scene, the "object only" goal images (reference demo types,
        src/mbrl/episode_runner.py:92-99), with a zero mask and no mask
        launch."""
        lead = qpos.shape[:-1]
        hit, z = self.render_objects(obj_pos, obj_half)
        img = self._bg.expand(lead + self._bg.shape)
        order = draw_order(z)  # the nearest block wins
        colors = torch.as_tensor(obj_colors, dtype=torch.float32,
                                 device=z.device)
        for k in range(hit.shape[-3]):
            idx = order[..., k]
            hk = torch.gather(hit, -3, idx[..., None, None, None].expand(
                idx.shape + (1,) + hit.shape[-2:]))[..., 0, :, :]
            # index_select: a 0-d index would make colors[idx] a host read
            ck = colors.index_select(0, idx.reshape(-1)).reshape(
                idx.shape + (3,))
            img = torch.where(hk[..., None], ck[..., None, None, :], img)
        if not include_arm:
            return img, img.new_zeros(lead + (self.h, self.w, 1))
        mask = self.render(qpos)  # (..., h, w, 1): one mask launch
        # the arm drawn last (closest to the camera in this workspace)
        pts = lk.fk_points(qpos, self.l3)
        u, v, zz = self._project(pts)
        arm = mask[..., 0] > 0.5
        # the gripper tip highlighted
        tip_r = self._Kt[0, 0] * 0.025 / torch.clamp(zz[..., 4], min=1e-4)
        tip = torch.sqrt((self._px - u[..., 4, None, None]) ** 2
                         + (self._py - v[..., 4, None, None]) ** 2
                         ) <= tip_r[..., None, None]
        img = torch.where(arm[..., None], self.arm_color, img)
        img = torch.where(tip[..., None], self.gripper_color, img)
        return img, mask
