"""Batched model-rollout engine for CEM planning.

Counterpart of `robot_aware_control_tpu/planning/rollout.py:RolloutEngine`
(reference: src/cem/trajectory_sampler.py:36-199): eef integration,
batched IK, robot masks (and eef heatmaps for heatmap-conditioned models),
T model steps of the configured family (svg, det, svg_vec, det_vec,
cdna_det or cdna_robonet), compositing and cost,
with the candidates as the batch axis and a Python loop over the horizon.
The locobot path takes the analytic IK and the capsule renderer (its CUDA
kernel); control_franka and control_wx250s the robot's own measured chain
(robot/kinematic_chain.py): DLS IK warm-started from the previous step and
the chain's thick mask env. Semantics kept from the reference:

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
from robot_aware_control_tpu_torch.ops import quant
from robot_aware_control_tpu_torch.ops.nn import conv_rows
from robot_aware_control_tpu_torch.planning.cost import RobotWorldCost
from robot_aware_control_tpu_torch.robot import locobot_kinematics as lk
from robot_aware_control_tpu_torch.robot.kinematic_chain import ChainMaskEnv
from robot_aware_control_tpu_torch.robot.mask_renderer import CapsuleMaskRenderer
from robot_aware_control_tpu_torch.training.step import _conditioning, _model_step
from robot_aware_control_tpu_torch.utils.device import resolve_device
from robot_aware_control_tpu_torch.utils.state import DemoGoalState, State


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
    """Rollout + cost of candidate action sequences on one device, for one
    request or for several planned together (planning/cem.py).

    Per-request inputs carry a leading request axis R: start_img
    (R, H, W, C), start_state_norm (R, 5), start_qpos (R, >=5), goal_imgs
    (R, T, H, W, C), goal_masks (R, T, H, W, 1) or None, goal_states
    (R, T, 5) or None; actions (R * n, T, A) hold each request's n
    candidates in turn. Without the axis (start_img (H, W, C), as the JAX
    engine takes them) they are one request.

    A request's costs must be the same bits whatever else is planned with
    it. The model steps run once over all R * n rows, where every kernel
    but the convolutions gives each row a result of its own inputs alone
    (elementwise work, the mask and cell kernels). The convolutions take
    each request's n rows apart (ops/nn.py:conv_rows): cuDNN chooses its
    algorithm by the batch, and on the H100 five of the encoder's
    convolutions summed in another order at B = 400 than at B = 100. The
    costs run per request too (a reduction's order depends on how many
    rows it reduces). Under --plan_quantize int8 each request's rows take
    an activation scale of their own in every conv (ops/quant.py:
    amax_rows), as the JAX package's vmap over requests takes its max per
    request."""

    def __init__(self, cfg: Config, camera_key: str = "locobot_c0",
                 push_height: float = lk.PUSH_HEIGHT,
                 default_pitch: float = lk.DEFAULT_PITCH,
                 default_roll: float = lk.DEFAULT_ROLL,
                 pick: bool = False, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        # pick rollouts integrate 3-D eef motion (reference: the pick
        # sampler steps MuJoCo, src/cem/pick/trajectory_sampler.py:253-266)
        self.pick = pick
        self.push_height = push_height
        self.default_pitch = default_pitch
        self.default_roll = default_roll
        self.cost = RobotWorldCost(cfg)
        self.low = torch.tensor(LOCOBOT_LOW, device=self.device)
        self.high = torch.tensor(LOCOBOT_HIGH, device=self.device)
        self.renderer_thick = CapsuleMaskRenderer(
            (cfg.image_height, cfg.image_width), camera_key,
            thick=bool(cfg.cem_prediction_use_thick_mask),
            modified=cfg.modified, device=self.device)
        self.use_robot = _needs_robot_model(cfg)
        self.dtype = compute_dtype(cfg)
        # control_franka / control_wx250s plan with the robot's own measured
        # chain and mask env (reference: trajectory_sampler.py:27-33 picks
        # FrankaAnalyticalModel / WX250sAnalyticalModel, whose mask envs
        # load the franka / wx250s MJCFs); states stay in the locobot frame
        # for normalization (trajectory_sampler.py:94-98)
        self.qpos_dim = 5  # locobot: yaw, shoulder, elbow, wrist, roll
        self.chain_robot = None if pick else {
            "control_franka": "franka", "control_wx250s": "wx250s"
        }.get(cfg.experiment)
        if self.chain_robot is not None:
            self.chain_env = ChainMaskEnv(
                self.chain_robot, (cfg.image_height, cfg.image_width),
                thick=bool(cfg.cem_prediction_use_thick_mask), device=self.device)
            self.chain = self.chain_env.chain
            shift = (LOCO_FRANKA_DIFF if self.chain_robot == "franka"
                     else LOCO_WX250S_DIFF)
            self.chain_shift = torch.tensor(shift, device=self.device)
            self.qpos_dim = self.chain.dof

    def robot_trajectory(self, start_state_norm, start_qpos, actions_tna):
        """IK + mask render for all candidates and steps
        (replaces reference trajectory_sampler.py:86-107).

        start_state_norm (B, 5), start_qpos (B, >=5), actions_tna
        (T, B, >=2), one row per candidate. Returns (states_norm
        (T+1,B,rd), states_raw (T+1,B,5), masks (T+1,B,h,w,1))."""
        start_raw = denormalize(start_state_norm, self.low, self.high)
        if self.chain_robot is not None:
            return self._chain_trajectory(start_raw, start_qpos, actions_tna)
        qpos = start_qpos[..., :5].float()
        if self.pick:
            # pick actions are env-unit eef deltas (x0.05 inside)
            states_raw, qpos = lk.integrate_pick_actions(
                start_raw, qpos, actions_tna, pitch=self.default_pitch,
                roll=self.default_roll)
        else:
            # env-unit actions -> metric eef displacements
            planar = actions_tna[..., :2] * self.cfg.eef_action_scale
            states_raw, qpos = lk.integrate_planar_actions(
                start_raw, qpos, planar, push_height=self.push_height,
                pitch=self.default_pitch, roll=self.default_roll)
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

    def _chain_trajectory(self, start_raw, start_qpos, actions_tna):
        """franka / wx250s (JAX `rollout.py:177-211`): planar eef
        integration in the locobot frame (the model's normalization frame),
        then per step the chain's DLS IK (20 iterations) warm-started from
        the previous step's solution and the thick chain mask env, in the
        robot's native frame (the shift LOCO_*_DIFF is xy only)."""
        xy, qpos = self.chain_joints(start_raw, start_qpos, actions_tna)
        z = torch.full(xy.shape[:-1] + (1,), self.push_height, device=xy.device)
        states_raw = torch.cat([xy, z, torch.zeros_like(xy)], -1)
        return (self._norm_to_robot_dim(states_raw), states_raw,
                self.chain_env.render(qpos))

    def chain_joints(self, start_raw, start_qpos, actions_tna):
        """The chain path's eef xy in the locobot frame (T+1, B, 2) and
        joints (T+1, B, dof): each step's IK starts from the previous
        step's joints (and the chain's three seeds)."""
        planar = actions_tna[..., :2] * self.cfg.eef_action_scale
        xy0 = start_raw[..., :2][None]
        xy = torch.cat([xy0, xy0 + torch.cumsum(planar, 0)], 0)
        z = torch.full(xy.shape[:-1] + (1,), self.push_height, device=xy.device)
        q = start_qpos[..., : self.chain.dof].float()
        qs = []
        for target in torch.cat([xy - self.chain_shift, z], -1):
            q, _ = self.chain.ik(target, q, iters=20)
            qs.append(q)
        return xy, torch.stack(qs)

    @torch.inference_mode()
    def __call__(self, model, start_img, start_state_norm, start_qpos,
                 actions, goal_imgs, goal_masks, generator=None,
                 goal_states=None, ret_obs: bool = False, eps_prior=None):
        """Inputs as in the class docstring, all on the engine's device;
        goal_imgs etc. are pre-indexed per step (goal_idx = min(t, G-1)).
        With robot_cost_weight != 0, goal_states add a per-step robot-state
        cost. `eps_prior` (T, R * n, fh, fw, z_dim) float32 ((T, R * n,
        z_dim) for svg_vec: training/step.py:prior_shape) replaces the
        prior's draws from `generator`. CDNA warps each step's own input
        image (no context frame), as the JAX rollout steps it. Returns sum_cost (R * n,) [and obs
        (T, R * n, H, W, C) when ret_obs]."""
        cfg = self.cfg
        if start_img.dim() == 3:  # one request
            start_img, start_state_norm, start_qpos, goal_imgs = (
                t[None] for t in (start_img, start_state_norm, start_qpos,
                                  goal_imgs))
            goal_masks = None if goal_masks is None else goal_masks[None]
            goal_states = None if goal_states is None else goal_states[None]
        R = start_img.shape[0]
        B, T = actions.shape[0], actions.shape[1]
        n = B // R
        dev = self.device
        actions_tna = actions.transpose(0, 1)  # (T, B, A)
        per_row = lambda t: t.repeat_interleave(n, 0)  # (R, ...) -> (B, ...)

        if self.use_robot:
            states, states_raw, masks = self.robot_trajectory(
                per_row(start_state_norm), per_row(start_qpos), actions_tna)
        else:
            states = torch.zeros(T + 1, B, cfg.robot_dim, device=dev)
            states_raw = torch.zeros(T + 1, B, 5, device=dev)
            masks = torch.zeros(T + 1, B, cfg.image_height, cfg.image_width,
                                1, device=dev)
        use_robot_cost = cfg.robot_cost_weight != 0 and goal_states is not None
        if goal_masks is None:
            goal_masks = torch.zeros(goal_imgs.shape[:-1] + (1,), device=dev)
        # heatmap conditioning from the predicted states (the reference
        # plans with heatmap=None, trajectory_sampler.py:135)
        heatmaps = (self.renderer_thick.render_heatmaps(states_raw[..., :3])
                    if cfg.model_use_heatmap else [None] * (T + 1))

        curr = per_row(start_img).to(self.dtype)
        carry = get_model(cfg).init_carry(cfg, B, self.dtype, dev)
        blackout = cfg.dontcare  # dontcare recon loss or black_robot_input
        rewards, obs = [], []
        for t in range(T):
            model_in = zero_robot_region(masks[t], curr) if blackout else curr
            m_in, r_in, hm_in = _conditioning(
                cfg, masks[t], masks[t + 1], states[t], states[t + 1],
                heatmaps[t], heatmaps[t + 1])
            with conv_rows(n if R > 1 else None), quant.amax_rows(n):
                out, carry = _model_step(
                    cfg, model, carry, model_in, m_in, r_in, hm_in,
                    actions_tna[t], generator, sample_mean=cfg.sample_mean,
                    noise=None if eps_prior is None else (eps_prior[t], None))
            curr = composite(cfg, out["x_pred"], curr).to(self.dtype)
            # inpaint-blur: the last unblur_timestep steps score unblurred
            # (the switch the reference documents, config/__init__.py:66)
            blur = t < T - cfg.unblur_timestep
            rewards.append(torch.cat([self.cost(
                curr[r * n:(r + 1) * n], goal_imgs[r, t],
                curr_mask=masks[t + 1, r * n:(r + 1) * n],
                goal_mask=goal_masks[r, t],
                curr_state=(states_raw[t + 1, r * n:(r + 1) * n]
                            if use_robot_cost else None),
                goal_state=goal_states[r, t] if use_robot_cost else None,
                blur=blur)
                for r in range(R)]))
            if ret_obs:
                obs.append(curr)
        rewards = torch.stack(rewards)
        sum_cost = rewards[-1] if cfg.sparse_cost else rewards.sum(0)
        return (sum_cost, torch.stack(obs)) if ret_obs else sum_cost


def request_inputs(cfg: Config, start: State, goal: DemoGoalState, T: int,
                   qpos_dim: int = 5):
    """Normalization, frame shift and goal indexing of one request as numpy
    (reference: trajectory_sampler.py:86-158): start_img (H, W, C) in
    [0, 1], start_state_norm (5,), start_qpos (qpos_dim,), goal_imgs
    (T, H, W, C), goal_masks (T, H, W, 1) or None, goal_states (T, 5) or
    None."""
    img = np.asarray(start.img, np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    state_raw = frame_shift(cfg, start.state)
    state_norm = normalize(state_raw, LOCOBOT_LOW[: len(state_raw)],
                           LOCOBOT_HIGH[: len(state_raw)])
    qpos = np.zeros(qpos_dim, np.float32)
    if start.qpos is not None:
        q = np.asarray(start.qpos, np.float32).ravel()[:qpos_dim]
        qpos[: len(q)] = q
    return (img, state_norm, qpos) + prepare_goals(goal, T)


class TrajectorySampler:
    """Host-facing API with the reference's contract
    (reference: src/cem/trajectory_sampler.py:15-199).

    generate_model_rollouts(action_sequences, start, goal) -> dict with
    "sum_cost" (N,), "optimal_sum_cost" with opt_traj, and "topk_idx"/"obs"
    (and "optimal_obs") when ret_obs."""

    def __init__(self, cfg: Config, model, device="cuda", engine=None,
                 **engine_kw):
        self.cfg = cfg
        # --plan_quantize int8 (ops/quant.py; a model already quantized,
        # e.g. by CEMPolicy, comes back as it is)
        self.model = quant.maybe_quantize_plan_model(cfg, model)
        self.engine = engine or RolloutEngine(cfg, device=device, **engine_kw)
        self.device = self.engine.device

    def generate_model_rollouts(self, action_sequences, start: State,
                                goal: DemoGoalState, opt_traj=None,
                                ret_obs: bool = False,
                                suppress_print: bool = True, rng=None):
        """action_sequences (N, T, A); opt_traj (T, <=A) is rolled out as
        one more candidate. `rng`, a torch.Generator on the device, draws
        the prior's noise (default: seeded with cfg.seed)."""
        cfg, dev = self.cfg, self.device
        acts = np.asarray(action_sequences, np.float32)
        if opt_traj is not None:
            opt = np.asarray(opt_traj, np.float32)
            if opt.shape[-1] < acts.shape[-1]:
                opt = np.pad(opt, ((0, 0), (0, acts.shape[-1] - opt.shape[-1])))
            acts = np.concatenate([acts, opt[None]], 0)
        T = acts.shape[1]
        if rng is None:
            rng = torch.Generator(device=dev).manual_seed(cfg.seed)
        t = lambda a: None if a is None else torch.as_tensor(a, device=dev)[None]
        inputs = request_inputs(cfg, start, goal, T, self.engine.qpos_dim)
        result = self.engine(self.model, *map(t, inputs[:3]),
                             torch.as_tensor(acts, device=dev),
                             *map(t, inputs[3:5]), rng,
                             goal_states=t(inputs[5]), ret_obs=ret_obs)
        rollouts = {}
        if ret_obs:
            sum_cost, obs = result
            obs = obs.transpose(0, 1).float().cpu().numpy()  # (N, T, H, W, C)
        else:
            sum_cost = result
        sum_cost = sum_cost.float().cpu().numpy()
        if opt_traj is not None:
            rollouts["optimal_sum_cost"] = sum_cost[-1]
            if ret_obs:
                rollouts["optimal_obs"] = obs[-1]
            sum_cost = sum_cost[:-1]
        rollouts["sum_cost"] = sum_cost
        if ret_obs:
            topk_idx = np.argsort(sum_cost)[-cfg.topk:]
            rollouts["topk_idx"] = topk_idx
            rollouts["obs"] = obs[topk_idx]
        return rollouts
