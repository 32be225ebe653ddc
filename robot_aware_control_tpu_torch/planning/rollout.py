"""Batched model-rollout engine for CEM planning.

Counterpart of `robot_aware_control_tpu/planning/rollout.py:RolloutEngine`
(reference: src/cem/trajectory_sampler.py:36-199) for the locobot planar
path: eef integration, batched analytic IK, capsule mask rendering, T model
steps, compositing and cost, with the candidates as the batch axis and a
Python loop over the horizon. Semantics kept from the reference:

  * thick masks for model input and cost (predict_batch(..., thick=True)),
  * robot-pixel blackout of the model input when a dontcare loss /
    black_robot_input is active (:141-152); like the JAX package, the
    composite uses the un-blacked frame (trainer.py:406-407),
  * goal indexing goal_idx = min(t, G-1) (:154-156),
  * sparse_cost only scores the final step (:166-169),
  * prior sampling with optional sample_mean (:148).
"""

from __future__ import annotations

import numpy as np
import torch

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.data.norm import (
    LOCO_FRANKA_DIFF,
    LOCO_WX250S_DIFF,
    LOCOBOT_HIGH,
    LOCOBOT_LOW,
    denormalize,
    normalize,
)
from robot_aware_control_tpu_torch.models.common import composite
from robot_aware_control_tpu_torch.models.registry import get_model
from robot_aware_control_tpu_torch.models.svg import compute_dtype
from robot_aware_control_tpu_torch.ops.losses import zero_robot_region
from robot_aware_control_tpu_torch.planning.cost import RobotWorldCost
from robot_aware_control_tpu_torch.robot import locobot_kinematics as lk
from robot_aware_control_tpu_torch.robot.mask_renderer import CapsuleMaskRenderer
from robot_aware_control_tpu_torch.training.step import _conditioning, _model_step
from robot_aware_control_tpu_torch.utils.device import resolve_device
from robot_aware_control_tpu_torch.utils.state import DemoGoalState


def _needs_robot_model(cfg: Config) -> bool:
    """(reference: trajectory_sampler.py:28, 90)"""
    return (cfg.model_use_robot_state or cfg.model_use_mask
            or cfg.model_use_heatmap or cfg.black_robot_input
            or "dontcare" in cfg.reward_type)


def frame_shift(cfg: Config, state):
    """franka/wx250s eef states shift into the locobot frame, as numpy
    (reference: trajectory_sampler.py:95-99)."""
    state = np.asarray(state, np.float32).copy()
    if cfg.experiment == "control_franka":
        state[:2] += LOCO_FRANKA_DIFF
    elif cfg.experiment == "control_wx250s":
        state[:2] += LOCO_WX250S_DIFF
    return state


def prepare_goals(goal: DemoGoalState, T: int):
    """Per-step goal arrays with goal_idx = min(t, G-1) as numpy
    (reference: trajectory_sampler.py:154-158): goal_imgs (T, H, W, C) in
    [0, 1], goal_masks (T, H, W, 1) or None, goal_states (T, 5) or None."""
    imgs = [np.asarray(g, np.float32) for g in goal.imgs]
    imgs = [g / 255.0 if g.max() > 1.5 else g for g in imgs]
    idx = np.minimum(np.arange(T), len(imgs) - 1)
    goal_imgs = np.stack([imgs[i] for i in idx])
    goal_masks = None
    if goal.masks is not None:
        ms = [np.asarray(m, np.float32).reshape(imgs[0].shape[:2] + (1,))
              for m in goal.masks]
        goal_masks = np.stack([ms[i] for i in idx])
    goal_states = None
    if goal.states is not None:
        sts = []
        for s in goal.states:
            s = np.asarray(s, np.float32).ravel()[:5]
            sts.append(np.pad(s, (0, 5 - len(s))))
        goal_states = np.stack([sts[i] for i in idx])
    return goal_imgs, goal_masks, goal_states


class RolloutEngine:
    """Rollout + cost over N candidate action sequences on one device."""

    qpos_dim = 5  # locobot: yaw, shoulder, elbow, wrist, roll

    def __init__(self, cfg: Config, device="cuda"):
        if cfg.model_use_heatmap:
            raise NotImplementedError("heatmap conditioning is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cost = RobotWorldCost(cfg)
        self.low = torch.tensor(LOCOBOT_LOW, device=self.device)
        self.high = torch.tensor(LOCOBOT_HIGH, device=self.device)
        self.renderer_thick = CapsuleMaskRenderer(
            (cfg.image_height, cfg.image_width),
            thick=bool(cfg.cem_prediction_use_thick_mask),
            modified=cfg.modified, device=self.device)
        self.use_robot = _needs_robot_model(cfg)
        self.dtype = compute_dtype(cfg)

    def robot_trajectory(self, start_state_norm, start_qpos, actions_tna):
        """IK + mask render for all candidates and steps
        (replaces reference trajectory_sampler.py:86-107).

        start_state_norm (5,), start_qpos (>=5,), actions_tna (T, N, >=2).
        Returns (states_norm (T+1,N,rd), states_raw (T+1,N,5),
        masks (T+1,N,h,w,1))."""
        N = actions_tna.shape[1]
        start_raw = denormalize(start_state_norm, self.low, self.high)
        start_raw_n = start_raw.expand((N,) + start_raw.shape)
        qpos_n = start_qpos[:5].float().expand(N, 5)
        # env-unit actions -> metric eef displacements
        planar = actions_tna[..., :2] * self.cfg.eef_action_scale
        states_raw, qpos = lk.integrate_planar_actions(start_raw_n, qpos_n, planar)
        masks = self.renderer_thick.render(qpos)
        return self._norm_to_robot_dim(states_raw), states_raw, masks

    def _norm_to_robot_dim(self, states_raw):
        states_norm = normalize(states_raw, self.low, self.high)
        # pad/truncate to the model's robot_dim, mirroring the data layer
        # (reference: robonet_dataset.py:209-223 pads states to robot_dim)
        rd = self.cfg.robot_dim
        if states_norm.shape[-1] < rd:
            pad = states_norm.new_zeros(states_norm.shape[:-1]
                                        + (rd - states_norm.shape[-1],))
            states_norm = torch.cat([states_norm, pad], -1)
        return states_norm[..., :rd]

    @torch.inference_mode()
    def __call__(self, model, start_img, start_state_norm, start_qpos,
                 actions, goal_imgs, goal_masks, generator: torch.Generator,
                 goal_states=None):
        """actions (N, T, A>=2); start_img (H,W,C) float [0,1];
        goal_imgs (T, H, W, C) pre-indexed per step; goal_masks
        (T, H, W, 1) or None; goal_states (T, 5) raw demo eef states or
        None — with robot_cost_weight != 0 they add a per-step robot-state
        cost. All tensors on the engine's device. Returns sum_cost (N,)."""
        cfg = self.cfg
        N, T = actions.shape[0], actions.shape[1]
        dev = self.device
        actions_tna = actions.transpose(0, 1)  # (T, N, A)

        if self.use_robot:
            states, states_raw, masks = self.robot_trajectory(
                start_state_norm, start_qpos, actions_tna)
        else:
            states = torch.zeros(T + 1, N, cfg.robot_dim, device=dev)
            states_raw = torch.zeros(T + 1, N, 5, device=dev)
            masks = torch.zeros(T + 1, N, cfg.image_height, cfg.image_width,
                                1, device=dev)
        use_robot_cost = cfg.robot_cost_weight != 0 and goal_states is not None
        if goal_masks is None:
            goal_masks = torch.zeros(goal_imgs.shape[:-1] + (1,), device=dev)

        curr = start_img.expand((N,) + start_img.shape).to(self.dtype)
        carry = get_model(cfg).init_carry(cfg, N, self.dtype, dev)
        blackout = cfg.dontcare  # dontcare recon loss or black_robot_input
        rewards = []
        for t in range(T):
            model_in = zero_robot_region(masks[t], curr) if blackout else curr
            m_in, r_in, hm_in = _conditioning(
                cfg, masks[t], masks[t + 1], states[t], states[t + 1],
                None, None)
            out, carry = _model_step(
                cfg, model, carry, model_in, m_in, r_in, hm_in,
                actions_tna[t], generator, sample_mean=cfg.sample_mean)
            curr = composite(cfg, out["x_pred"], curr).to(self.dtype)
            rewards.append(self.cost(
                curr, goal_imgs[t], curr_mask=masks[t + 1],
                goal_mask=goal_masks[t],
                curr_state=states_raw[t + 1] if use_robot_cost else None,
                goal_state=goal_states[t] if use_robot_cost else None))
        rewards = torch.stack(rewards)
        return rewards[-1] if cfg.sparse_cost else rewards.sum(0)
