"""Locobot tabletop environment and scripted demo behaviours (counterpart
of `robot_aware_control_tpu/envs/locobot_table.py`).

Behaviour parity with the reference `LocobotTableEnv` (reference:
src/env/robotics/locobot_table_env.py:186-256): eef position control with
action[:3] x 0.05 clipped to the workspace, fixed gripper orientation, obs
dict {observation (48x64 rgb), masks, states (eef xyz + 0,0), qpos}, and
the `temporal_random_robot` scripted demo (move behind a random object
along the spawn->object direction, then beta-temporally-correlated random
actions; reference :361-410).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from robot_aware_control_tpu_torch.envs.base import ACTION_SCALE, RobotEnv


class LocobotTableEnv(RobotEnv):
    action_dim = 5
    num_objects = 3
    SPAWN = np.array([0.25, 0.0], np.float32)

    # ------------------------------------------------------------------
    def _move(self, target, history, max_steps=8, tol=0.015):
        """Proportional eef moves toward a world target, recording actions."""
        for _ in range(max_steps):
            eef = self._host("eef")
            delta = target - eef
            if np.linalg.norm(delta) < tol:
                break
            a = np.zeros(self.action_dim, np.float32)
            a[:3] = np.clip(delta / ACTION_SCALE, -1, 1)
            a = self.envelope_action(a)
            obs, _, _, info = self.step(a)
            history["obs"].append(obs)
            history["ac"].append(a)

    def generate_demo(self, behavior: str = "temporal_random_robot"):
        """(reference: locobot_table_env.py:361-410)"""
        obs = self.reset()
        history = defaultdict(list)
        history["obs"].append(obs)
        # start sim state so runners can replay from the demo's
        # initial conditions (reference: episode_runner.py:121-139)
        history["sim_start"] = self.get_flattened_state()
        cfg = self._config
        ep_len = getattr(cfg, "demo_length", 12) if cfg else 12
        beta = getattr(cfg, "temporal_beta", 1.0) if cfg else 1.0
        if behavior != "temporal_random_robot":
            raise ValueError(behavior)

        obj_i = self.rng.randint(self.num_objects)
        history["pushed_obj"] = obj_i
        block = self._host("obj_pos")[obj_i]
        goal_dir = block[:2] - self.SPAWN
        goal_dir = goal_dir / (np.linalg.norm(goal_dir) + 1e-8)
        target = block.copy()
        target[:2] -= 0.05 * goal_dir
        self._move(target, history)
        past = len(history["ac"])

        actions = np.zeros((ep_len - 1, self.action_dim), np.float32)
        if past > 0:
            actions[:past] = np.stack(history["ac"])[: ep_len - 1]
        for i in range(past, ep_len - 1):
            u = self.rng.uniform(-1, 1, self.action_dim).astype(np.float32)
            u[3:] = 0.0
            actions[i] = beta * u + (1 - beta) * actions[i - 1]
        for i in range(past, ep_len - 1):
            # envelope guard must see the CURRENT sim state, so adjust at
            # execution time and store what was actually stepped
            actions[i] = self.envelope_action(actions[i])
            obs, _, _, info = self.step(actions[i])
            history["obs"].append(obs)
        history["ac"] = list(actions)
        # truncate/pad obs to demo length
        history["obs"] = history["obs"][:ep_len]
        history["ac"] = history["ac"][: ep_len - 1]
        return history
