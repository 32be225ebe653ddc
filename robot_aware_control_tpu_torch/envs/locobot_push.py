"""Locobot planar-push environment (counterpart of
`robot_aware_control_tpu/envs/locobot_push.py`).

Reference parity: `LocobotPushEnv` (reference:
src/env/robotics/locobot_push_env.py) — planar 2-D actions at a fixed push
height, single pushable block, same obs contract as the table env. The
planner-side action padding (2-D -> 5-D) matches src/cem/push/cem.py:80-81.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from robot_aware_control_tpu_torch.envs.base import ACTION_SCALE, RobotEnv


class LocobotPushEnv(RobotEnv):
    action_dim = 2
    num_objects = 1

    def step(self, action):
        a = np.zeros(5, np.float32)
        a[:2] = np.clip(np.asarray(action, np.float32).ravel()[:2], -1, 1)
        return super().step(a)

    def generate_demo(self, behavior: str = "straight_push"):
        """Scripted straight push through the block toward a random
        direction (reference push demo collection:
        src/dataset/collect_push_data.py)."""
        obs = self.reset()
        history = defaultdict(list)
        history["obs"].append(obs)
        # start sim state so runners can replay from the demo's
        # initial conditions (reference: episode_runner.py:121-139)
        history["sim_start"] = self.get_flattened_state()
        cfg = self._config
        ep_len = getattr(cfg, "demo_length", 12) if cfg else 12

        block = self._host("obj_pos")[0]
        theta = self.rng.uniform(-np.pi / 4, np.pi / 4)
        push_dir = np.array([np.cos(theta), np.sin(theta)], np.float32)
        # approach from behind the block until close, then push through it
        approaching = True
        for t in range(ep_len - 1):
            eef = self._host("eef")
            behind = block[:2] - 0.055 * push_dir
            if approaching and np.linalg.norm(eef[:2] - behind) > 0.015:
                delta = behind - eef[:2]
            else:
                approaching = False
                delta = push_dir * 0.035
            a = np.clip(delta / ACTION_SCALE, -1, 1).astype(np.float32)[:2]
            obs, _, _, _ = self.step(a)
            history["obs"].append(obs)
            history["ac"].append(np.pad(a, (0, 3)))
        return history
