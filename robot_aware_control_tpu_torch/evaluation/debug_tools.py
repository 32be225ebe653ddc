"""Offline model-debugging tools (counterpart of
`robot_aware_control_tpu/evaluation/debug_tools.py`).

  * `action_rollout` (reference: src/prediction/test_action_rollout.py:
    20-243): sweep synthetic action sequences (straight lines in each
    direction, arcs) through a trained model from a real start frame and
    save a gif of the imagined futures.
  * `debug_models` (reference: src/prediction/debug_models.py:46): the
    same sweep through two checkpoints side by side.

The models run on `device` (the GPU unless the caller asks for the CPU),
their ConvLSTM cells through the hand-written cell kernel. Gifs and strips
go through training/plot.py, which writes nothing and returns None where
imageio or PIL is missing.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models.registry import load_model
from robot_aware_control_tpu_torch.planning.rollout import TrajectorySampler
from robot_aware_control_tpu_torch.training.plot import image_strip, save_gif
from robot_aware_control_tpu_torch.utils.state import DemoGoalState, State


def synthetic_action_sweeps(horizon: int, action_dim: int = 5,
                            magnitude: float = 0.6) -> np.ndarray:
    """Straight pushes in 8 compass directions + 2 arcs
    (reference: test_action_rollout.py:20-80)."""
    seqs = []
    for th in np.linspace(0, 2 * np.pi, 8, endpoint=False):
        a = np.zeros((horizon, action_dim), np.float32)
        a[:, :2] = np.asarray([np.cos(th), np.sin(th)], np.float32) * magnitude
        seqs.append(a)
    for sign in (1, -1):
        a = np.zeros((horizon, action_dim), np.float32)
        ths = np.linspace(0, sign * np.pi, horizon)
        a[:, 0] = np.cos(ths) * magnitude
        a[:, 1] = np.sin(ths) * magnitude
        seqs.append(a)
    return np.stack(seqs) * 0.05  # env action scale


def _start_goal(start: State) -> DemoGoalState:
    img = np.asarray(start.img, np.float32)
    return DemoGoalState(imgs=[img], masks=[np.zeros(img.shape[:2], np.float32)])


def action_rollout(cfg: Config, ckpt_path: str, start: State, out_dir: str,
                   horizon: Optional[int] = None, device="cuda"):
    """Rolls the sweeps through the checkpointed model and saves the top-k
    rollouts side by side, a frame a step, as <out_dir>/action_rollout.gif.
    Returns the gif's path (None without imageio)."""
    horizon = horizon or cfg.horizon
    sampler = TrajectorySampler(cfg, load_model(cfg, ckpt_path, device),
                                device=device)
    acts = synthetic_action_sweeps(horizon, cfg.action_dim)
    out = sampler.generate_model_rollouts(acts, start, _start_goal(start),
                                          ret_obs=True)
    obs = out["obs"]  # (topk, T, H, W, 3)
    frames = [np.concatenate(list(obs[:, t]), axis=1)
              for t in range(obs.shape[1])]
    os.makedirs(out_dir, exist_ok=True)
    return save_gif(os.path.join(out_dir, "action_rollout.gif"), frames, fps=2)


def debug_models(cfg: Config, ckpt_a: str, ckpt_b: str, start: State,
                 out_dir: str, device="cuda"):
    """The first sweep through two checkpoints, one row each, as
    <out_dir>/debug_models.png (reference: debug_models.py:46). Returns its
    path (None without PIL)."""
    acts = synthetic_action_sweeps(cfg.horizon, cfg.action_dim)[:1]
    rows = []
    for path in (ckpt_a, ckpt_b):
        sampler = TrajectorySampler(cfg, load_model(cfg, path, device),
                                    device=device)
        out = sampler.generate_model_rollouts(acts, start, _start_goal(start),
                                              ret_obs=True)
        rows.append(np.concatenate(list(out["obs"][0]), axis=1))
    os.makedirs(out_dir, exist_ok=True)
    return image_strip(os.path.join(out_dir, "debug_models.png"),
                       [np.concatenate(rows, axis=0)])
