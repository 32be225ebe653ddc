"""Learned-model pick-and-place experiment, end to end (counterpart of
`robot_aware_control_tpu/experiments/pick.py`; reference:
src/mbrl/pick_episode_runner.py:20-446 with src/cem/pick/cem.py and
pick/trajectory_sampler.py). Pipeline:

  1. collect scripted pick-place training episodes
     (envs/locobot_pick.py generate_demo; reference:
     src/env/robotics/locobot_pick_env.py:346-555),
  2. train a robot-aware SVG model on them (dontcare_l1, mask and state
     conditioning),
  3. make held-out demos and run PickEpisodeRunner with the learned
     model: demo-seeded CEM mean (--demo_cost), per-step robot-state cost
     (robot_cost_weight, pick/trajectory_sampler.py:267-285), and 3-D
     eef and mask rollouts (planning/rollout.py pick mode).

Everything runs on --device (the GPU unless --device cpu). Where h5py is
installed the data goes through HDF5 files as in the JAX experiment;
without it (the H100 machine) the episodes go to record shards
(data/collect.py:write_training_records) that the trainer reads with the
experiment's split, and the eval demos stay in memory
(data/demo_io.make_demo). Both routes carry the same episodes: a pick
episode is demo_length frames and the training window is clamped to the
shortest episode, so the shards' one window an episode is the whole
episode, as the HDF5 loaders read it. The route is chosen by whether h5py
is installed and printed; it is an input seam, not a fallback.

    python -m robot_aware_control_tpu_torch.experiments.pick \\
        --log_dir /tmp/pick_exp --num_episodes 300 --niter 30 [--device cpu]

Writes <log_dir>/pick_results.json with per-episode and summary stats.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from robot_aware_control_tpu_torch.config import Config, argparser
from robot_aware_control_tpu_torch.control.episode_runner import PickEpisodeRunner
from robot_aware_control_tpu_torch.data import demo_io
from robot_aware_control_tpu_torch.data.collect import (
    collect_training_data,
    training_episodes,
    write_training_records,
)
from robot_aware_control_tpu_torch.data.records import RecordDataset
from robot_aware_control_tpu_torch.envs.locobot_pick import LocobotPickEnv
from robot_aware_control_tpu_torch.models.registry import load_model
from robot_aware_control_tpu_torch.training import checkpoint as ckpt
from robot_aware_control_tpu_torch.training.trainer import PredictionTrainer
from robot_aware_control_tpu_torch.utils.device import resolve_device


def train_cfg(cfg: Config, data_root: str) -> Config:
    return cfg.replace(
        model="svg", experiment="train_locobot_pick", jobname="pick_model",
        data_root=data_root,
        action_dim=5, robot_dim=5, robot_joint_dim=5,
        model_use_mask=True, model_use_future_mask=True,
        model_use_robot_state=True,
        reconstruction_loss="dontcare_l1",
        impute_autograsp_action=False,
        scheduled_sampling=True, remat=True,
        n_past=1, n_future=5,
        checkpoint_interval=max(cfg.niter // 2, 1),
        eval_interval=10 ** 6,
    )


def plan_cfg(cfg: Config, tcfg: Config, demo_dir: str) -> Config:
    return tcfg.replace(
        jobname="pick_eval", env="LocobotPick",
        use_env_dynamics=False, demo_dir=demo_dir,
        demo_cost=True, demo_timescale=cfg.demo_timescale,
        horizon=cfg.horizon, replan_every=cfg.replan_every,
        opt_iter=cfg.opt_iter, action_candidates=cfg.action_candidates,
        topk=cfg.topk,
        reward_type="dontcare",
        robot_cost_weight=(cfg.robot_cost_weight or 1.0),
        world_cost_weight=cfg.world_cost_weight,
        sequential_subgoal=True,
        max_episode_length=cfg.max_episode_length,
        record_video_interval=1,
        num_episodes=min(cfg.num_episodes, 6),
    )


def _hdf5_trainer(cfg: Config, data_root: str, device) -> PredictionTrainer:
    """The JAX experiment's route: HDF5 files under data_root (collected
    unless there), the window clamped to the shortest episode."""
    import h5py

    pattern = os.path.join(data_root, "**", "*.hdf5")
    files = glob.glob(pattern, recursive=True)
    if not files:
        collect_training_data("LocobotPick", cfg.num_episodes, data_root, cfg,
                              seed=cfg.seed, device=device)
        files = glob.glob(pattern, recursive=True)
    ep_len = min(_frames(h5py, f) for f in files)
    tcfg = train_cfg(cfg, data_root).replace(
        video_length=min(cfg.video_length, ep_len))
    return PredictionTrainer(tcfg, device=device)


def _frames(h5py, path: str) -> int:
    with h5py.File(path, "r") as hf:
        return hf["observations"].shape[0]


def _record_trainer(cfg: Config, data_root: str, device) -> PredictionTrainer:
    """The route without h5py: the same episodes, collected in memory,
    preprocessed once into record shards under <data_root>/records (kept
    and read again if there), the window clamped as on the HDF5 route."""
    record_dir = os.path.join(data_root, "records")
    if glob.glob(os.path.join(record_dir, "shard_*.npz")):
        ep_len = RecordDataset(record_dir)[0]["images"].shape[0]
        tcfg = train_cfg(cfg, data_root).replace(
            video_length=min(cfg.video_length, ep_len))
    else:
        episodes = list(training_episodes("LocobotPick", cfg.num_episodes,
                                          data_root, cfg, seed=cfg.seed,
                                          device=device))
        ep_len = min(len(ep["observations"]) for _, ep in episodes)
        tcfg = train_cfg(cfg, data_root).replace(
            video_length=min(cfg.video_length, ep_len))
        write_training_records(episodes, record_dir, tcfg)
    return PredictionTrainer(tcfg, device=device, record_dir=record_dir)


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="cuda (default) or cpu; there is no fallback")
    args, rest = pre.parse_known_args(argv)
    device = resolve_device(args.device)
    cfg, _ = argparser(rest)
    os.makedirs(cfg.log_dir, exist_ok=True)

    data_root = os.path.join(cfg.log_dir, "data_pick")
    demo_dir = os.path.join(cfg.log_dir, "demos_eval")
    hdf5 = demo_io.has_h5py()
    print(f"[pick] data route: {'HDF5 files' if hdf5 else 'record shards'}"
          f" (h5py {'installed' if hdf5 else 'not installed'})", flush=True)
    trainer = (_hdf5_trainer if hdf5 else _record_trainer)(cfg, data_root,
                                                           device)
    try:
        trainer.train()
    finally:
        trainer.logger.close()
    ckpt_path = ckpt.latest_checkpoint(trainer.log_dir)
    print(f"[pick] trained; ckpt={ckpt_path}", flush=True)

    n_eval = min(cfg.num_episodes, 6)
    env = LocobotPickEnv(cfg, seed=cfg.seed + 123, device=device)
    demos = None
    if hdf5:
        if len(demo_io.list_demos(demo_dir)) < n_eval:
            demo_io.collect_demos(env, "pick_place", n_eval, demo_dir)
        print(f"[pick] eval demos ready in {demo_dir}", flush=True)
    else:
        demos = [demo_io.make_demo(env, "pick_place") for _ in range(n_eval)]
        print(f"[pick] {n_eval} eval demos made in memory", flush=True)

    pcfg = plan_cfg(cfg, trainer.cfg, demo_dir)
    runner = PickEpisodeRunner(pcfg, load_model(pcfg, ckpt_path, device),
                               device=device)
    try:
        summary = runner.run(demos)
    finally:
        runner.logger.close()

    result = {
        "ckpt": ckpt_path,
        "episodes": {k: [float(x) for x in v]
                     for k, v in runner._stats.items() if k != "demo_name"},
        "summary": {k: float(v) for k, v in summary.items()},
    }
    out = os.path.join(cfg.log_dir, "pick_results.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result["summary"], indent=2))
    return result


if __name__ == "__main__":
    main()
