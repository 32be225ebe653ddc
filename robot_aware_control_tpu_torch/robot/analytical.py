"""Analytical robot models: batched state and mask prediction on the
device (counterpart of `robot_aware_control_tpu/robot/analytical.py`;
reference: src/dataset/locobot/locobot_model.py:104-206,
src/dataset/franka/franka_model.py:14-97,
src/dataset/wx250s/wx250s_model.py:11-120).

`LocobotAnalyticalModel.predict_batch` integrates the planar eef actions,
solves the closed-form IK for every step and candidate, renders the
capsule masks (the mask kernel on the GPU) and re-normalizes the states to
the workspace bounds. The franka / wx250s models shift their eef into the
locobot frame first; `ChainAnalyticalModel` works in any chain robot's own
frame, through its measured chain's DLS IK and mask env.
"""

from __future__ import annotations

import numpy as np
import torch

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.data.norm import (
    LOCO_FRANKA_DIFF,
    LOCO_WX250S_DIFF,
    denormalize,
    normalize,
)
from robot_aware_control_tpu_torch.robot import locobot_kinematics as lk
from robot_aware_control_tpu_torch.robot.kinematic_chain import CHAINS, get_mask_env
from robot_aware_control_tpu_torch.robot.mask_renderer import CapsuleMaskRenderer
from robot_aware_control_tpu_torch.utils.device import resolve_device


class LocobotAnalyticalModel:
    """predict_batch with the reference's data contract."""

    def __init__(self, config: Config, camera_key: str = "locobot_c0",
                 push_height: float = lk.PUSH_HEIGHT,
                 default_pitch: float = lk.DEFAULT_PITCH,
                 default_roll: float = lk.DEFAULT_ROLL, device="cuda"):
        self._cfg = config
        self.device = resolve_device(device)
        self.push_height = push_height
        self.default_pitch = default_pitch
        self.default_roll = default_roll
        size = (config.image_height, config.image_width)
        self.renderer, self.renderer_thick = (
            CapsuleMaskRenderer(size, camera_key, thick=thick,
                                modified=config.modified, device=self.device)
            for thick in (False, True))

    def predict_trajectory(self, start_state_raw, start_qpos, actions, low,
                           high, thick: bool = False):
        """start_state_raw (N, 5) raw world eef; start_qpos (N, 5); actions
        (T, N, >=2); low/high (N, 5). Returns (states_norm (T+1, N, 5),
        masks (T+1, N, h, w, 1), qpos (T+1, N, 5))."""
        states_raw, qpos = lk.integrate_planar_actions(
            start_state_raw, start_qpos, actions[..., :2],
            push_height=self.push_height, pitch=self.default_pitch,
            roll=self.default_roll)
        renderer = self.renderer_thick if thick else self.renderer
        return normalize(states_raw, low, high), renderer.render(qpos), qpos

    def predict_batch(self, data, thick: bool = False):
        """(reference: locobot_model.py:104-138) data: "states" (T+1, N, 5)
        normalized (row 0 read), "qpos" (T+1, N, 5), "actions" (T, N, A),
        "low"/"high" (N, 5), arrays or tensors. Returns (pred_states
        (T+1, N, 5) normalized, pred_masks (T+1, N, h, w, 1)) on the
        model's device."""
        t = {k: torch.as_tensor(data[k], device=self.device).float()
             for k in ("states", "qpos", "actions", "low", "high")}
        start_raw = denormalize(t["states"][0], t["low"], t["high"])
        states, masks, _ = self.predict_trajectory(
            start_raw, t["qpos"][0], t["actions"], t["low"], t["high"], thick)
        return states, masks


class _ShiftedAnalyticalModel(LocobotAnalyticalModel):
    """A planar-push robot whose eef states arrive in its own frame and are
    shifted (xy) into the locobot frame before the shared kinematics
    (reference: trajectory_sampler.py:93-94)."""

    FRAME_SHIFT = np.zeros(2, np.float32)

    def to_locobot_frame(self, state):
        state = np.asarray(state, np.float32).copy()
        state[..., :2] += self.FRAME_SHIFT
        return state


class FrankaAnalyticalModel(_ShiftedAnalyticalModel):
    """Franka planar-push model (reference: franka_model.py:14-97)."""

    FRAME_SHIFT = LOCO_FRANKA_DIFF


class WX250sAnalyticalModel(_ShiftedAnalyticalModel):
    """WX250s planar-push model (reference: wx250s_model.py:11-120), with
    its measured frame shift (src/utils/camera_calibration.py)."""

    FRAME_SHIFT = LOCO_WX250S_DIFF


class ChainAnalyticalModel:
    """Native-frame analytical model of any chain robot (sawyer, baxter,
    widowx, franka, kuka, fetch, wx250s): planar eef integration in the
    robot's own frame, the chain's batched DLS IK and its capsule masks
    (the reference's per-robot PyBullet IK controllers and MuJoCo mask
    envs, src/env/robotics/controllers/*.py, masks/*_mask_env.py)."""

    def __init__(self, cfg: Config, robot: str, camera_key: str = None,
                 push_height: float = 0.15, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.chain = CHAINS[robot]
        kw = {"camera_key": camera_key} if camera_key else {}
        self.env = get_mask_env(robot, device=self.device, **kw)
        self.push_height = push_height

    def predict_trajectory(self, start_eef, start_qpos, actions):
        """start_eef (3,) raw, start_qpos (dof,), actions (T, N, >=2)
        planar metric displacements -> (states (T+1, N, 3), qpos
        (T+1, N, dof), masks (T+1, N, h, w, 1)) on the model's device."""
        dev = self.device
        actions = torch.as_tensor(actions, device=dev).float()
        T, N = actions.shape[:2]
        eef0 = torch.tensor(np.asarray(start_eef, np.float32), device=dev).expand(N, 3)
        steps = torch.cat([actions[..., :2],
                           actions.new_zeros(T, N, 1)], -1)
        eefs = eef0[None] + torch.cumsum(steps, 0)
        eefs[..., 2] = self.push_height
        eefs = torch.cat([eef0[None], eefs], 0)
        q0 = torch.tensor(np.asarray(start_qpos, np.float32), device=dev)[: self.chain.dof]
        qpos, _ = self.chain.ik(eefs, q0.expand(T + 1, N, self.chain.dof))
        return eefs, qpos, self.env.render(qpos)


def get_robot_model(cfg: Config, **kw):
    """Experiment-keyed dispatch (reference: src/cem/trajectory_sampler.py:
    26-33, src/prediction/trainer.py:123-130)."""
    if cfg.experiment == "control_franka":
        return FrankaAnalyticalModel(cfg, **kw)
    if cfg.experiment == "control_wx250s":
        return WX250sAnalyticalModel(cfg, **kw)
    return LocobotAnalyticalModel(cfg, **kw)
