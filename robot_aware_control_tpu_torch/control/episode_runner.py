"""Demo-following visual-MPC episode runners.

Counterpart of `robot_aware_control_tpu/control/episode_runner.py`
(reference: src/mbrl/episode_runner.py:25-296 and the push/pick variants,
push_episode_runner.py:20-458, pick_episode_runner.py:20-446): follow a
demonstration, looping

  CEM plan -> execute `replan_every` actions -> cost-thresholded subgoal
  advance -> episode stats (goal_progress, push_progress, final_obj_dist)

until the demo is consumed or max_episode_length is hit. The plan runs on
the env's device: with --use_env_dynamics through the simulator
(planning/gt_rollout.py), else through the learned model
(planning/cem.py), whose ConvLSTM cells take the hand-written cell kernel.
The runner is the thin host shell around them.

A demo is the dict that `data/demo_io.load_demo` returns, read from an
HDF5 path, or the same dict made in memory by `demo_io.demo_from_history`.
Taking the dict is an input seam for machines without h5py, not a
feature: both routes follow the same demo.

    python -m robot_aware_control_tpu_torch.control.episode_runner \\
        --env LocobotPush --use_env_dynamics true --demo_dir <demos> \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import pickle
from collections import defaultdict
from typing import List, Optional

import numpy as np
import torch

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.data import demo_io
from robot_aware_control_tpu_torch.envs import (
    ClutterPushEnv,
    LocobotPickEnv,
    LocobotPushEnv,
)
from robot_aware_control_tpu_torch.planning.cem import (
    CEMPolicy,
    PickCEMPolicy,
    PushCEMPolicy,
)
from robot_aware_control_tpu_torch.planning.cost import (
    RobotWorldCost,
    robot_l2_cost,
)
from robot_aware_control_tpu_torch.planning.gt_rollout import (
    DemoCEMPolicy,
    GTCEMPolicy,
    GTPickCEMPolicy,
    GTPushCEMPolicy,
)
from robot_aware_control_tpu_torch.training.logger import RunLogger, make_log_folder
from robot_aware_control_tpu_torch.training.plot import save_gif
from robot_aware_control_tpu_torch.utils.device import resolve_device
from robot_aware_control_tpu_torch.utils.state import DemoGoalState, State


class EpisodeRunner:
    """Clutter-push runner (reference: episode_runner.py:25-296). `model`
    is the learned model the non-GT route plans with; `translator` maps an
    observation before planning (the reference's CycleGAN,
    push_episode_runner.py:264-283), by default under --cyclegan the
    CycleGAN of baselines/cyclegan.py with --cyclegan_ckpt's weights."""

    env_cls = ClutterPushEnv
    policy_cls = CEMPolicy
    gt_policy_cls = GTCEMPolicy

    def __init__(self, cfg: Config, model=None, translator=None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if translator is None and cfg.cyclegan:
            # CycleGAN observation translation for cross-domain transfer
            # (reference: push_episode_runner.py:264-283, --cyclegan): a
            # CycleGAN of cfg.seed, its weights from --cyclegan_ckpt
            from robot_aware_control_tpu_torch.baselines.cyclegan import (
                CycleGANTranslator,
                init,
                load_cyclegan_checkpoint,
            )

            nets = init(cfg.seed, device=self.device)
            if cfg.cyclegan_ckpt:
                load_cyclegan_checkpoint(nets, cfg.cyclegan_ckpt)
            translator = CycleGANTranslator(nets, "ab")
        self.log_dir = make_log_folder(cfg)
        self.logger = RunLogger(cfg, self.log_dir)
        self.env = self.env_cls(cfg, seed=cfg.seed, device=self.device)
        self.policy = DemoCEMPolicy(
            cfg, self.env, model,
            policy_cls=self.policy_cls, gt_policy_cls=self.gt_policy_cls)
        self.cost = RobotWorldCost(cfg)
        self._stats = defaultdict(list)
        self.translator = translator

    # ------------------------------------------------------------------
    def _world_cost_scalar(self, curr_img, goal_img, curr_mask, goal_mask):
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=self.device)
        g = np.asarray(goal_img, np.float32)
        if g.max() > 1.5:
            g = g / 255.0
        cm = None if curr_mask is None else t(curr_mask)[None]
        gm = None if goal_mask is None else t(goal_mask)
        v = self.cost.world_cost(t(curr_img)[None], t(g), cm, gm)
        return float(v[0])

    def _pick_next_goal(self, curr: State, goal: State) -> bool:
        """Advances the subgoal when the robot and world costs pass their
        success thresholds (reference: episode_runner.py:46-82); costs are
        negated distances, thresholds are on distances. With
        sequential_subgoal false, jumps past the most future remaining goal
        whose world cost is already under its threshold (the semantics of
        the reference's commented legacy code, episode_runner.py:67-82,
        with the configured world cost)."""
        cfg = self.cfg
        if not cfg.sequential_subgoal:
            prev = self._g_i
            min_idx, new_goal = 0, False
            for j in range(len(self._goal_imgs) - self._g_i):
                g_idx = self._g_i + j
                d = -self._world_cost_scalar(
                    curr.img, self._goal_imgs[g_idx], curr.mask,
                    self._goal_masks[g_idx])
                if d <= cfg.world_cost_success:
                    new_goal = True
                    min_idx = j + 1
            self._g_i += min_idx
            if new_goal:
                self._g_i += 1
            return self._g_i != prev
        robot_ok = True
        if cfg.robot_cost_weight != 0 and curr.state is not None:
            d = -float(robot_l2_cost(
                torch.as_tensor(np.asarray(curr.state, np.float32))[None],
                torch.as_tensor(np.asarray(goal.state, np.float32)))[0])
            robot_ok = d < cfg.robot_cost_success
        world_ok = True
        if cfg.world_cost_weight != 0:
            d = -self._world_cost_scalar(curr.img, goal.img, curr.mask,
                                         goal.mask)
            world_ok = d < cfg.world_cost_success
        if robot_ok and world_ok:
            self._g_i += 1
            return True
        return False

    # ------------------------------------------------------------------
    def run_episode(self, ep_num: int, demo):
        """Follows one demo: an HDF5 path (read by demo_io.load_demo) or
        the dict load_demo returns. Returns the episode's stats."""
        cfg = self.cfg
        env = self.env
        if isinstance(demo, (str, os.PathLike)):
            demo = demo_io.load_demo(demo)
        ts = cfg.demo_timescale
        goal_key = cfg.demo_type if cfg.demo_type in demo else "observations"
        # --goal_image_type object_only: goals from the robot-free demo
        # stream with blank goal masks (reference:
        # push_episode_runner.py:114-119, pick_episode_runner.py:109-114)
        if cfg.goal_image_type == "object_only":
            for k in ("obj_observations", "object_only_demo"):
                if k in demo:
                    goal_key = k
                    break
        goal_imgs = demo[goal_key][::ts]
        goal_masks = demo["masks"][::ts]
        if cfg.goal_image_type == "object_only":
            goal_masks = np.zeros_like(goal_masks)
        goal_robots = demo["robot_state"][::ts]
        goal_obj_poses = demo.get("obj_poses")
        if goal_obj_poses is not None:
            goal_obj_poses = goal_obj_poses[::ts]
        pushed_obj = int(demo.get("pushed_obj", 0))
        num_goals = len(goal_imgs)
        self._goal_imgs, self._goal_masks = goal_imgs, goal_masks
        self._g_i = max(cfg.subgoal_start, 1)
        self._step = 0
        self._since_subgoal = 0

        obs = env.reset()
        if "sim_start" in demo:
            # replay from the demo's initial conditions
            # (reference: episode_runner.py:121-139)
            env.set_flattened_state(demo["sim_start"])
            obs = env._get_obs()
        gif = []
        # --record_trajectory: obs/action/state pickle per episode
        # (reference: episode_runner.py:131-134, 188-205)
        trajectory = defaultdict(list)
        episode_reward = 0.0
        if cfg.record_trajectory:
            trajectory["obs"].append(obs)
            trajectory["state"].append(env.get_flattened_state())
        opt_actions = demo.get("actions")
        push_length = 0.2
        if goal_obj_poses is not None:
            push_length = max(float(np.linalg.norm(
                goal_obj_poses[-1][pushed_obj][:2]
                - goal_obj_poses[0][pushed_obj][:2])), 1e-3)

        finish_demo = False
        while True:
            goals = DemoGoalState(
                imgs=list(goal_imgs[self._g_i:]),
                states=list(goal_robots[self._g_i:]),
                masks=list(goal_masks[self._g_i:]),
            )
            curr_img = obs["observation"]
            if self.translator is not None:
                curr_img = self.translator(curr_img)
            curr = State(img=curr_img, state=obs["states"], mask=obs["masks"],
                         qpos=obs["qpos"])
            opt = None
            if cfg.demo_cost and opt_actions is not None:
                # demo actions are at full rate, subgoals every ts frames:
                # the seed window advances by the steps executed since the
                # last subgoal advance (reference: goal_timestep indexing,
                # pick_episode_runner.py:117)
                start_idx = min(
                    (self._g_i - 1) * ts + self._since_subgoal,
                    max(len(opt_actions) - 1, 0))
                opt = opt_actions[start_idx:]
            actions = self.policy.get_action(curr, goals, ep_num, self._step,
                                             opt_traj=opt)
            terminate = False
            for action in actions[: cfg.replan_every]:
                obs, _, _, _ = env.step(action)
                if cfg.record_trajectory:
                    trajectory["obs"].append(obs)
                    trajectory["ac"].append(np.asarray(action))
                    trajectory["state"].append(env.get_flattened_state())
                curr = State(img=obs["observation"], state=obs["states"],
                             mask=obs["masks"], qpos=obs["qpos"])
                g_idx = min(self._g_i, num_goals - 1)
                g_state = State(img=goal_imgs[g_idx], state=goal_robots[g_idx],
                                mask=goal_masks[g_idx])
                self._step += 1
                gif.append(np.concatenate(
                    [obs["observation"],
                     np.asarray(goal_imgs[g_idx], np.float32)
                     / (255.0 if goal_imgs.dtype == np.uint8 else 1.0)],
                    axis=1))
                g_before = self._g_i
                self._pick_next_goal(curr, g_state)
                if self._g_i != g_before:
                    # --subgoal_completion_bonus: shaping reward on subgoal
                    # advance (reference: locobot_pick_env_gym.py:245)
                    episode_reward += cfg.subgoal_completion_bonus
                g_now = min(self._g_i, num_goals - 1)
                episode_reward += self._world_cost_scalar(
                    curr.img, goal_imgs[g_now], curr.mask, goal_masks[g_now])
                if (self._g_i == g_before and cfg.subgoal_step_limit
                        and self._since_subgoal + 1 >= cfg.subgoal_step_limit
                        and self._g_i < num_goals):
                    # timeout advance: hold the demo's cadence when a cost
                    # threshold stalls
                    self._g_i += 1
                self._since_subgoal = (
                    0 if self._g_i != g_before else self._since_subgoal + 1)
                finish_demo = self._g_i >= num_goals
                if finish_demo or self._step >= cfg.max_episode_length - 1:
                    terminate = True
                    break
            if terminate:
                break

        # stats (reference: episode_runner.py:196-219)
        final_obj_dist = 0.0
        eef, obj_pos = (env._host(k) for k in ("eef", "obj_pos"))
        if goal_obj_poses is not None:
            final_obj_dist = float(np.linalg.norm(
                obj_pos[pushed_obj][:2] - goal_obj_poses[-1][pushed_obj][:2]))
        goal_progress = (self._g_i - cfg.subgoal_start) / max(
            num_goals - cfg.subgoal_start, 1)
        self._stats["goal_progress"].append(goal_progress)
        self._stats["push_progress"].append(
            (push_length - final_obj_dist) / push_length)
        self._stats["final_obj_dist"].append(final_obj_dist)
        self._stats["success"].append(float(finish_demo))
        # threshold successes (reference: fetch/pick env success checks,
        # --object_dist_threshold / --gripper_dist_threshold)
        self._stats["object_success"].append(
            float(goal_obj_poses is not None
                  and final_obj_dist < cfg.object_dist_threshold))
        grip_dist = float(np.linalg.norm(
            eef[:2] - np.asarray(goal_robots[-1][:2], np.float32)))
        self._stats["gripper_success"].append(
            float(grip_dist < cfg.gripper_dist_threshold))
        self._stats["episode_reward"].append(episode_reward)
        if cfg.record_trajectory and (
                ep_num % max(cfg.record_trajectory_interval, 1) == 0):
            traj_dir = os.path.join(self.log_dir, "trajectory")
            os.makedirs(traj_dir, exist_ok=True)
            with open(os.path.join(traj_dir, f"ep_s{self._g_i}_{ep_num}.pkl"),
                      "wb") as f:
                pickle.dump(dict(trajectory), f)
        if cfg.record_video_interval and ep_num % cfg.record_video_interval == 0:
            save_gif(os.path.join(
                self.log_dir, f"ep_{ep_num}_{'s' if finish_demo else 'f'}.gif"
            ), gif)
        return {k: v[-1] for k, v in self._stats.items()}

    def run(self, demos: Optional[List] = None):
        """Runs min(num_episodes, len(demos)) episodes (reference:
        episode_runner.py:226-296); `demos` holds paths or demo dicts, by
        default the HDF5 files of --object_demo_dir or --demo_dir. Returns
        the mean of each stat."""
        cfg = self.cfg
        if demos is None:
            demos = demo_io.list_demos(cfg.object_demo_dir or cfg.demo_dir)
        if not demos:
            raise FileNotFoundError("no demos found; run demo collection")
        n = min(cfg.num_episodes, len(demos))
        for i in range(n):
            stats = self.run_episode(i, demos[i % len(demos)])
            self.logger.scalars(stats, i, prefix="episode/")
            self.logger.info(f"episode {i}: " + " ".join(
                f"{k}={v:.3f}" for k, v in stats.items()))
        summary = {k: float(np.mean(v)) for k, v in self._stats.items()}
        self.logger.scalars(summary, n, prefix="summary/")
        self.logger.info("summary: " + " ".join(
            f"{k}={v:.3f}" for k, v in summary.items()))
        return summary


class PushEpisodeRunner(EpisodeRunner):
    """(reference: src/mbrl/push_episode_runner.py:20-458)"""

    env_cls = LocobotPushEnv
    policy_cls = PushCEMPolicy
    gt_policy_cls = GTPushCEMPolicy


class PickEpisodeRunner(EpisodeRunner):
    """(reference: src/mbrl/pick_episode_runner.py:20-446)"""

    env_cls = LocobotPickEnv
    policy_cls = PickCEMPolicy
    gt_policy_cls = GTPickCEMPolicy


RUNNERS = {"FetchPush": EpisodeRunner, "LocobotTable": PushEpisodeRunner,
           "LocobotPush": PushEpisodeRunner, "LocobotPick": PickEpisodeRunner}


def main(argv=None):
    from robot_aware_control_tpu_torch.config import argparser
    from robot_aware_control_tpu_torch.models.registry import load_model

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="cuda (default) or cpu; there is no fallback")
    args, rest = pre.parse_known_args(argv)
    cfg, _ = argparser(rest)
    if cfg.mbrl_algo != "cem":
        # the reference registers one algorithm (src/config/__init__.py)
        raise ValueError(f"unknown --mbrl_algo {cfg.mbrl_algo!r}; only 'cem'")
    runner_cls = RUNNERS.get(cfg.env, EpisodeRunner)
    model = None
    if cfg.dynamics_model_ckpt and not cfg.use_env_dynamics:
        model = load_model(cfg, cfg.dynamics_model_ckpt, device=args.device)
    runner = runner_cls(cfg, model, device=args.device)
    try:
        return runner.run()
    finally:
        runner.logger.close()


if __name__ == "__main__":
    main()
