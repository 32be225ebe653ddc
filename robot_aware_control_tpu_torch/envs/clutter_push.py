"""Clutter-push / Fetch-push environments (counterpart of
`robot_aware_control_tpu/envs/clutter_push.py`).

Reference parity: `ClutterPushEnv` (reference:
src/env/robotics/clutter_push.py, Fetch-based, multiple pushable blocks,
demo generation, pure `robot_kinematics()` FK+mask query :96-117) and
`FetchPushEnv` (reference: src/env/robotics/fetch_push.py:19-101). The
JAX package models both with the same capsule-arm + block physics on the
locobot workspace; the Fetch arm geometry difference only affects the
rendered silhouette and is absorbed by the capsule radii.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from robot_aware_control_tpu_torch.envs.base import ACTION_SCALE, RobotEnv


class ClutterPushEnv(RobotEnv):
    action_dim = 2
    num_objects = 3

    def step(self, action):
        a = np.zeros(5, np.float32)
        a[:2] = np.clip(np.asarray(action, np.float32).ravel()[:2], -1, 1)
        return super().step(a)

    def generate_demo(self, behavior: str = "push_one"):
        """Push a random block a random planar direction (reference demo
        generation: clutter_push.py demo scripts + collect_clutter_data.py).

        Consumed flags: --push_dist (target block displacement, the demo
        switches from pushing to the robot-goal move once reached),
        --action_noise (gaussian perturbation of scripted actions,
        collect_clutter_data.py:221), --robot_goal_distribution
        random|behind_block (where the robot ends up in the goal frame,
        fetch_push.py:216-221), --invisible_demo (demo frames rendered
        robot-free, the inpaint-style demo variant)."""
        obs = self.reset()
        cfg = self._config
        g = lambda name, d: getattr(cfg, name, d) if cfg else d
        self._force_norobot = bool(g("invisible_demo", False))
        try:
            history = defaultdict(list)
            if self._force_norobot:
                obs = self._get_obs()  # re-render robot-free
            history["obs"].append(obs)
            history["obj_observations"].append(self.render_object_only())
            # start sim state so runners can replay from the demo's
            # initial conditions (reference: episode_runner.py:121-139)
            history["sim_start"] = self.get_flattened_state()
            ep_len = g("demo_length", 12)
            push_dist = float(g("push_dist", 0.2))
            goal_dist = g("robot_goal_distribution", "random")
            obj_i = self.rng.randint(self.num_objects)
            history["pushed_obj"] = obj_i
            start_block = self._host("obj_pos")[obj_i][:2].copy()
            theta = self.rng.uniform(-np.pi, np.pi)
            push_dir = np.array([np.cos(theta), np.sin(theta)], np.float32)
            robot_goal = None
            for t in range(ep_len - 1):
                eef = self._host("eef")
                block = self._host("obj_pos")[obj_i]
                pushed = float(np.linalg.norm(block[:2] - start_block))
                behind = block[:2] - 0.05 * push_dir
                if pushed >= push_dist:
                    # push target reached: move the robot to its goal pose
                    if robot_goal is None:
                        if goal_dist == "behind_block":
                            robot_goal = block[:2] - 0.06 * push_dir
                        else:  # "random"
                            robot_goal = np.array([
                                self.rng.uniform(0.18, 0.4),
                                self.rng.uniform(-0.2, 0.2),
                            ], np.float32)
                    delta = robot_goal - eef[:2]
                elif t < 4 and np.linalg.norm(eef[:2] - behind) > 0.02:
                    delta = behind - eef[:2]
                else:
                    delta = push_dir * 0.03
                a = np.clip(delta / ACTION_SCALE, -1, 1).astype(np.float32)
                a = self._noised(a)
                a = self.envelope_action(np.pad(a, (0, 3)))[:2]
                obs, _, _, _ = self.step(a)
                history["obs"].append(obs)
                history["obj_observations"].append(self.render_object_only())
                history["ac"].append(np.pad(a, (0, 3)))
            history["goal_robot_pose"] = self._host("eef").copy()
        finally:
            self._force_norobot = False
        return history


class FetchPushEnv(ClutterPushEnv):
    """Single-block Fetch push (reference: fetch_push.py:19-101)."""

    num_objects = 1
