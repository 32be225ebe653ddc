"""End-to-end CEM planning demo in the push env (counterpart of
`robot_aware_control_tpu/planning/cem_demo.py`).

Reference parity: the `__main__` smoke block of src/cem/cem.py:182-250,
which plans actions from a real start/goal pair. The goal is a scripted
push of the env (or the demo HDF5 of --debug_trajectory_path, which needs
h5py), the start a fresh reset; the model has random weights from --seed
or those of --dynamics_model_ckpt. The plan runs in the env and a
start|rollout|goal gif is written to the log dir (nothing without
imageio). Everything runs on --device (cuda by default; there is no
fallback).

    python -m robot_aware_control_tpu_torch.planning.cem_demo \\
        --action_candidates 100 --horizon 5 --opt_iter 10 [--device cpu] ...
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from robot_aware_control_tpu_torch.config import argparser
from robot_aware_control_tpu_torch.data import demo_io
from robot_aware_control_tpu_torch.envs import LocobotPushEnv
from robot_aware_control_tpu_torch.models.registry import load_model
from robot_aware_control_tpu_torch.planning.cem import CEMPolicy
from robot_aware_control_tpu_torch.training.logger import make_log_folder
from robot_aware_control_tpu_torch.training.plot import save_gif
from robot_aware_control_tpu_torch.utils.state import DemoGoalState, State


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="cuda (default) or cpu; there is no fallback")
    args, rest = pre.parse_known_args(argv)
    cfg, _ = argparser(rest)
    cfg = cfg.replace(
        model_use_mask=True, model_use_robot_state=True,
        reconstruction_loss="dontcare_l1", reward_type="dontcare",
        action_dim=max(cfg.action_dim, 5), robot_dim=5, robot_joint_dim=5,
    )
    log_dir = make_log_folder(cfg)
    model = load_model(cfg, cfg.dynamics_model_ckpt, device=args.device)

    env = LocobotPushEnv(cfg, seed=cfg.seed, device=args.device)
    if cfg.debug_trajectory_path:
        demo = demo_io.load_demo(cfg.debug_trajectory_path)
        goal_imgs = [g for g in demo.get("object_only_demo",
                                         demo["observations"])[1:]]
        goal_masks = [m[..., 0] for m in demo["masks"][1:]]
        env.reset()
    else:
        # goal: a scripted push's outcome; start: a fresh reset
        hist = env.generate_demo("straight_push")
        goal_imgs = [o["observation"] for o in hist["obs"][1:]]
        goal_masks = [o["masks"][..., 0] for o in hist["obs"][1:]]
        env.reset()

    start = State(
        img=env.render(),
        state=np.array([*env._host("eef"), 0, 0], np.float32),
        qpos=env._host("qpos"),
    )
    goal = DemoGoalState(imgs=goal_imgs, masks=goal_masks)
    policy = CEMPolicy(cfg, model, device=args.device)
    plan = policy.get_action(start, goal, ep_num=0, step=0)
    print("plan:", np.round(plan, 4).tolist())

    frames = [start.img]
    for a in plan:
        obs, _, _, _ = env.step(a)
        frames.append(obs["observation"])
    strip = [np.concatenate([f, goal_imgs[-1]], axis=1) for f in frames]
    path = os.path.join(log_dir, "cem_demo.gif")
    print("wrote", save_gif(path, strip, fps=2))
    return plan


if __name__ == "__main__":
    main()
