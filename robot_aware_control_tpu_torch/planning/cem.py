"""CEM action optimization on one GPU.

Counterpart of `robot_aware_control_tpu/planning/cem.py:CEMPolicy`
(reference: src/cem/cem.py:56-111). Each of `opt_iter` iterations samples
N action sequences, rolls them out through the model on the device, keeps
the top-K by reward and refits. Preserved semantics:

  * mean/std over (horizon-1, A); init std = cem_init_std (cem.py:74-75),
  * a "do nothing" candidate injected at iteration 0 (cem.py:82-83),
  * clamp to +-0.05 then zero-pad to the model's action_dim (cem.py:85-86),
  * candidates evaluated in chunks of candidates_batch_size
    (trajectory_sampler.py:72,123-127),
  * refit: mean/std of the top-K rewards, unbiased std floored at 1e-3
    (cem.py:96-104),
  * returns the final mean plan (cem.py:111).

Random draws come from a `torch.Generator` on the device seeded with
cfg.seed + 7919 * ep_num + step, as the JAX package seeds its key.
"""

from __future__ import annotations

import numpy as np
import torch

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.data.norm import LOCOBOT_HIGH, LOCOBOT_LOW, normalize
from robot_aware_control_tpu_torch.planning.rollout import (
    RolloutEngine,
    frame_shift,
    prepare_goals,
)
from robot_aware_control_tpu_torch.utils.device import resolve_device
from robot_aware_control_tpu_torch.utils.state import DemoGoalState, State


class CEMPolicy:
    """Locobot/real-robot planar CEM (reference: src/cem/cem.py:14-111)."""

    action_dim = 2

    def __init__(self, cfg: Config, model, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model
        self.engine = RolloutEngine(cfg, device=self.device)

    def pad(self, acts):
        """Zero-pad sampled planar actions to the model's action space
        (reference: cem.py:86 pads 2-D planar actions to 5-D robonet
        actions)."""
        N, Tm1, A = acts.shape
        if A >= self.cfg.action_dim:
            return acts
        return torch.cat(
            [acts, acts.new_zeros(N, Tm1, self.cfg.action_dim - A)], -1)

    def _host_prep(self, start: State, goal: DemoGoalState, ep_num=0, step=0):
        """Normalization, frame shift, goal padding and seeding of one
        request; returns the plan's inputs on the device."""
        cfg, dev = self.cfg, self.device
        T = cfg.horizon
        img = np.asarray(start.img, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        state_raw = frame_shift(cfg, start.state)
        state_norm = normalize(state_raw, LOCOBOT_LOW[: len(state_raw)],
                               LOCOBOT_HIGH[: len(state_raw)])
        qpos = np.zeros(self.engine.qpos_dim, np.float32)
        if start.qpos is not None:
            q = np.asarray(start.qpos, np.float32).ravel()[: len(qpos)]
            qpos[: len(q)] = q
        goal_imgs, goal_masks, goal_states = prepare_goals(goal, T - 1)
        t = lambda a: None if a is None else torch.as_tensor(a, device=dev)
        generator = torch.Generator(device=dev)
        generator.manual_seed(cfg.seed + 7919 * ep_num + step)
        # (reference: cem.py:74-75)
        mean0 = torch.zeros(T - 1, self.action_dim, device=dev)
        std0 = torch.full((T - 1, self.action_dim), float(cfg.cem_init_std),
                          device=dev)
        return (t(img), t(state_norm), t(qpos), t(goal_imgs), t(goal_masks),
                t(goal_states), generator, mean0, std0)

    @torch.inference_mode()
    def _plan(self, start_img, start_state_norm, start_qpos, goal_imgs,
              goal_masks, goal_states, generator, mean, std, noise=None):
        N, K = self.cfg.action_candidates, self.cfg.topk
        chunk = min(int(self.cfg.candidates_batch_size or N), N)
        while N % chunk:
            chunk -= 1
        for i in range(self.cfg.opt_iter):
            eps = (noise[i] if noise is not None else torch.randn(
                (N,) + tuple(mean.shape), generator=generator,
                device=self.device))
            acts = mean[None] + std[None] * eps
            if i == 0:
                acts[-1] = 0.0  # "do nothing" candidate (cem.py:82-83)
            acts = torch.clamp(acts, -0.05, 0.05)  # (cem.py:85)
            padded = self.pad(acts)
            sum_cost = torch.cat([
                self.engine(self.model, start_img, start_state_norm,
                            start_qpos, padded[s:s + chunk], goal_imgs,
                            goal_masks, generator, goal_states=goal_states)
                for s in range(0, N, chunk)
            ])
            top_act = acts[torch.topk(sum_cost, K).indices]
            mean = top_act.mean(0)
            std = torch.clamp(top_act.std(0, unbiased=True), min=1e-3)
        return mean

    def get_action(self, start: State, goal: DemoGoalState, ep_num=0, step=0,
                   noise=None):
        """Returns the mean plan (horizon-1, action_dim) as numpy
        (reference: cem.py:56-111). `noise`, shaped (opt_iter, N, horizon-1,
        action_dim), replaces the sampled action noise (for tests)."""
        cfg = self.cfg
        prep = self._host_prep(start, goal, ep_num, step)
        if noise is not None:
            noise = torch.tensor(np.asarray(noise), dtype=torch.float32,
                                 device=self.device)
            want = (cfg.opt_iter, cfg.action_candidates, cfg.horizon - 1,
                    self.action_dim)
            if tuple(noise.shape) != want:
                raise ValueError(f"noise must be {want}, got {tuple(noise.shape)}")
        return self._plan(*prep, noise=noise).cpu().numpy()
