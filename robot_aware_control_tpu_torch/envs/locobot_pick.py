"""Locobot pick-and-place environment and scripted demos (counterpart of
`robot_aware_control_tpu/envs/locobot_pick.py`).

Reference parity: `LocobotPickEnv` (reference:
src/env/robotics/locobot_pick_env.py:163-238): 4-D action (xyz + gripper in
[-0.01, 0]), obs adds `obj_qpos` (block pose, position + identity
quaternion), scripted pick-place demos (:346-555).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from robot_aware_control_tpu_torch.envs.base import ACTION_SCALE, TABLE_Z, RobotEnv


class LocobotPickEnv(RobotEnv):
    action_dim = 4
    pick = True
    num_objects = 1

    def _get_obs(self):
        obs = super()._get_obs()
        K = self.num_objects
        quat = np.tile(np.array([1.0, 0, 0, 0], np.float32), (K, 1))
        obs["obj_qpos"] = np.concatenate([obs["obj_poses"], quat], -1).ravel()
        return obs

    def generate_demo(self, behavior: str = "pick_place"):
        """Scripted pick & place (reference: locobot_pick_env.py:346-555):
        hover above the block, descend, close, lift, carry to a random goal,
        open."""
        obs = self.reset()
        history = defaultdict(list)
        history["obs"].append(obs)
        # start sim state so runners can replay from the demo's
        # initial conditions (reference: episode_runner.py:121-139)
        history["sim_start"] = self.get_flattened_state()
        cfg = self._config
        ep_len = getattr(cfg, "demo_length", 14) if cfg else 14

        block = self._host("obj_pos")[0]
        goal = np.array([
            self.rng.uniform(0.25, 0.45), self.rng.uniform(-0.18, 0.18),
        ], np.float32)
        history["goal"] = goal
        hover_z = TABLE_Z + 0.10
        grasp_z = TABLE_Z + 0.035

        def act_towards(target, grip, tol=0.012):
            eef = self._host("eef")
            delta = np.clip((target - eef) / ACTION_SCALE, -1, 1)
            a = np.array([*delta, grip], np.float32)
            return a, np.linalg.norm(target - eef) < tol

        phase = 0
        targets = [
            np.array([block[0], block[1], hover_z], np.float32),   # hover
            np.array([block[0], block[1], grasp_z], np.float32),   # descend
            np.array([block[0], block[1], grasp_z], np.float32),   # close
            np.array([block[0], block[1], hover_z], np.float32),   # lift
            np.array([goal[0], goal[1], hover_z], np.float32),     # carry
            np.array([goal[0], goal[1], hover_z], np.float32),     # open
        ]
        grips = [0.0, 0.0, -0.01, -0.01, -0.01, 0.0]
        for _ in range(ep_len - 1):
            a, reached = act_towards(targets[phase], grips[phase])
            if reached and phase < len(targets) - 1:
                phase += 1
            obs, _, _, _ = self.step(a)
            history["obs"].append(obs)
            history["ac"].append(a)
        return history
