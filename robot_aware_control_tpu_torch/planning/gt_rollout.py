"""Ground-truth-physics CEM: the simulator as the planner's model.

Counterpart of `robot_aware_control_tpu/planning/gt_rollout.py` (reference:
src/cem/pick/trajectory_sampler.py:61-167, src/cem/mujoco/
trajectory_sampler.py:132-316, which step the simulator per candidate). The
env's physics is a function on batched tensors (envs/base.py:physics_step),
so each CEM iteration steps all N candidates together, horizon - 1 times,
renders all N x (horizon - 1) scenes in one `render_scene` call (one
capsule-mask launch an iteration) and scores them with the robot-aware cost.
No host sync happens inside the loop. `DemoCEMPolicy`'s env-vs-model
`compare_optimal_actions` (reference: src/cem/mujoco/demo_cem.py:46-99) is
kept.
"""

from __future__ import annotations

import numpy as np
import torch

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.envs.base import SimState, physics_step
from robot_aware_control_tpu_torch.planning.cem import (
    CEMPolicy,
    PickCEMPolicy,
    PushCEMPolicy,
)
from robot_aware_control_tpu_torch.planning.cost import RobotWorldCost
from robot_aware_control_tpu_torch.planning.rollout import (
    TrajectorySampler,
    prepare_goals,
)
from robot_aware_control_tpu_torch.training.plot import save_gif
from robot_aware_control_tpu_torch.utils.state import DemoGoalState, State


class GTRolloutEngine:
    """The ground-truth rollout and cost of candidate actions in an env."""

    def __init__(self, cfg: Config, env):
        self.cfg = cfg
        self.env = env
        self.cost = RobotWorldCost(cfg)

    def _render(self, state: SimState):
        env = self.env
        return env.renderer.render_scene(state.qpos, state.obj_pos,
                                         env._halfs_t, env._colors_t)

    def __call__(self, state0: SimState, actions, goal_imgs, goal_masks,
                 goal_states=None, ret_obs: bool = False):
        """state0: an unbatched SimState; actions (N, T, A); goal_imgs (T,
        H, W, 3); goal_masks (T, H, W, 1) or None; goal_states (T, 5) raw
        demo eef states or None: with robot_cost_weight != 0 a per-step eef
        cost is added as the reference's pick sampler adds it
        (pick/trajectory_sampler.py:104-126). Returns sum_cost (N,) [and obs
        (T, N, H, W, 3)]."""
        cfg, env = self.cfg, self.env
        N, T = actions.shape[0], actions.shape[1]
        state = SimState(*(x.expand((N,) + x.shape) for x in state0))
        traj = []
        for t in range(T):
            state = physics_step(state, actions[:, t], pick=env.pick,
                                 obj_half=env.obj_half)
            traj.append(state)
        # all N x T scenes in one render call: one mask launch
        flat = SimState(*(torch.stack(xs, 1).reshape((N * T,) + xs[0].shape[1:])
                          for xs in zip(*traj)))
        imgs, masks = self._render(flat)
        imgs = imgs.reshape((N, T) + imgs.shape[1:])
        masks = masks.reshape((N, T) + masks.shape[1:])
        use_robot_cost = cfg.robot_cost_weight != 0 and goal_states is not None
        if use_robot_cost:
            eef = torch.stack([s.eef for s in traj], 1)  # (N, T, 3) raw
            states_raw = torch.cat([eef, eef.new_zeros((N, T, 2))], -1)
        no_mask = masks.new_zeros(masks.shape[2:])
        rewards = []
        for t in range(T):
            rewards.append(self.cost(
                imgs[:, t], goal_imgs[t], curr_mask=masks[:, t],
                goal_mask=goal_masks[t] if goal_masks is not None else no_mask,
                curr_state=states_raw[:, t] if use_robot_cost else None,
                goal_state=goal_states[t] if use_robot_cost else None,
                # --unblur_timestep: the last steps score unblurred
                blur=bool(t < T - cfg.unblur_timestep)))
        rewards = torch.stack(rewards)  # (T, N)
        sum_cost = rewards[-1] if cfg.sparse_cost else rewards.sum(0)
        if ret_obs:
            return sum_cost, imgs.transpose(0, 1)
        return sum_cost


class _GTMixin:
    """Plans with the env's physics in place of the learned model, from the
    env's current state. Random draws and the refit are the learned
    planner's (planning/cem.py): action noise from a torch.Generator seeded
    with cfg.seed + 7919 * ep_num + step, or injected as `noise`; top-k by a
    stable sort; the unbiased std floored at 1e-3."""

    def _init_gt(self, cfg, env):
        self.env = env
        self.gt_engine = GTRolloutEngine(cfg, env)

    @torch.inference_mode()
    def _plan_gt(self, state0, goal_imgs, goal_masks, goal_states, gen,
                 mean, std, noise=None):
        N, K = self.num_candidates, self.topk
        for i in range(self.opt_iter):
            eps = noise[i] if noise is not None else torch.randn(
                (N,) + tuple(mean.shape), generator=gen, device=self.device)
            acts = mean[None] + std[None] * eps
            if self.zero_candidate and i == 0:
                acts[-1] = 0.0  # "do nothing" candidate (cem.py:82-83)
            acts = self.clamp(acts)
            sum_cost = self.gt_engine(state0, self.pad(acts), goal_imgs,
                                      goal_masks, goal_states=goal_states)
            # equal costs rank the lower index first, as jax.lax.top_k
            top = torch.sort(sum_cost, descending=True, stable=True)
            top_act = acts[top.indices[:K]]
            mean = top_act.mean(0)
            std = torch.clamp(top_act.std(0, unbiased=True), min=1e-3)
        return mean

    def get_action(self, start: State, goal: DemoGoalState, ep_num=0, step=0,
                   opt_traj=None, rng=None, noise=None):
        """The mean plan (horizon-1, action_dim) as numpy, planned from the
        env's current state (`start` is not read: the simulator is the
        model). `rng` replaces the seeded generator; `noise` (opt_iter, N,
        horizon-1, action_dim) replaces the sampled action noise."""
        T = self.horizon
        t = lambda a: None if a is None else torch.as_tensor(a,
                                                             device=self.device)
        goal_imgs, goal_masks, goal_states = map(t, prepare_goals(goal, T - 1))
        mean0, std0 = self.init_mean_std(T, opt_traj)
        mean = self._plan_gt(self.env.state, goal_imgs, goal_masks,
                             goal_states, rng or self._generator(ep_num, step),
                             mean0, std0, self._noise(noise))
        return mean.cpu().numpy()


class GTCEMPolicy(_GTMixin, CEMPolicy):
    def __init__(self, cfg, env, model=None, **kw):
        super().__init__(cfg, model, device=env.device, **kw)
        self._init_gt(cfg, env)


class GTPushCEMPolicy(_GTMixin, PushCEMPolicy):
    def __init__(self, cfg, env, model=None, **kw):
        super().__init__(cfg, model, device=env.device, **kw)
        self._init_gt(cfg, env)


class GTPickCEMPolicy(_GTMixin, PickCEMPolicy):
    def __init__(self, cfg, env, model=None, **kw):
        super().__init__(cfg, model, device=env.device, **kw)
        self._init_gt(cfg, env)


class DemoCEMPolicy:
    """Env-or-model physics dispatch and env-vs-model debugging
    (reference: src/cem/mujoco/demo_cem.py:16-139). The learned route plans
    with `model` on the env's device."""

    def __init__(self, cfg: Config, env, model=None, policy_cls=CEMPolicy,
                 gt_policy_cls=GTCEMPolicy):
        self.cfg = cfg
        self.env = env
        self.use_env = cfg.use_env_dynamics
        if self.use_env:
            self.policy = gt_policy_cls(cfg, env, model)
        else:
            if model is None:
                raise ValueError("planning with the learned model "
                                 "(use_env_dynamics false) needs a model")
            self.policy = policy_cls(cfg, model, device=env.device)

    def get_action(self, start, goal, ep_num=0, step=0, opt_traj=None):
        return self.policy.get_action(start, goal, ep_num, step, opt_traj)

    def compare_optimal_actions(self, actions, start: State,
                                goal: DemoGoalState, gif_path: str):
        """Rolls the same actions through the env and (with a learned
        model) the model; saves them side by side as a gif
        (reference: demo_cem.py:46-99). Returns the env's frames."""
        env = self.env
        saved = env.get_flattened_state()
        env_frames = []
        acts = np.asarray(actions, np.float32)
        for a in acts:
            obs, _, _, _ = env.step(a)
            env_frames.append(obs["observation"])
        env.set_flattened_state(saved)

        rows = [np.concatenate(env_frames, 1)]
        if getattr(self.policy, "model", None) is not None and not self.use_env:
            sampler = TrajectorySampler(self.cfg, self.policy.model,
                                        engine=self.policy.engine)
            out = sampler.generate_model_rollouts(acts[None], start, goal,
                                                  ret_obs=True)
            rows.append(np.concatenate(list(out["obs"][0]), 1))
        goal_img = np.asarray(goal.imgs[-1], np.float32)
        if goal_img.max() > 1.5:
            goal_img = goal_img / 255.0
        rows.append(np.concatenate([goal_img] * len(env_frames), 1))
        save_gif(gif_path, [np.concatenate(rows, 0)], fps=1)
        return env_frames
