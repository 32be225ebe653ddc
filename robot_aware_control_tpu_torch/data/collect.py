"""Training-data collection: scripted env episodes -> RoboNet-format HDF5
(counterpart of `robot_aware_control_tpu/data/collect.py`).

Reference parity: the data-collection scripts
(reference: src/dataset/collect_locobot_table_data.py:15-60,
collect_clutter_data.py, collect_pick_data.py, collect_push_data.py,
collect_mask_data.py): run scripted behaviors in the simulator and store
observations/states/actions/masks/qpos trajectories that the training
dataloader reads back (data/robonet_hdf5.py). The envs run on `device`
(the GPU unless the caller asks for the CPU). Every HDF5 writer needs h5py;
where it is missing they raise ImportError naming it before any episode
runs. Without h5py, `training_episodes` and `write_training_records` take
the same episodes to record shards (data/records.py), which the trainer
reads with the experiment's split (`PredictionTrainer(record_dir=)`);
`write_training_records` takes public RoboNet raw trajectories held in
memory as well (data/raw_robonet.py: `raw_robonet_tree`).

    python -m robot_aware_control_tpu_torch.data.collect --env LocobotPush \
        --collect_target demos --demo_dir <dir> --num_episodes 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from robot_aware_control_tpu_torch.config import Config, argparser
from robot_aware_control_tpu_torch.data.demo_io import require_h5py
from robot_aware_control_tpu_torch.data.records import convert_to_records
from robot_aware_control_tpu_torch.data.robonet_hdf5 import (
    episode_arrays,
    write_trajectory_hdf5,
)


_BEHAVIORS = {
    "LocobotTable": ("temporal_random_robot", "locobot"),
    "LocobotPush": ("straight_push", "locobot"),
    "LocobotPick": ("pick_place", "locobot"),
    "ClutterPush": ("push_one", "fetch"),
}


def _make_env(env_name: str, cfg: Optional[Config], seed: int, device):
    from robot_aware_control_tpu_torch.envs.variants import make

    return make(env_name, cfg, seed=seed, device=device)


def training_episodes(env_name: str, n_episodes: int, out_dir: str,
                      cfg: Optional[Config] = None, seed: int = 0,
                      viewpoint: str = "locobot_c0",
                      device="cuda") -> Iterator[Tuple[str, dict]]:
    """The episodes `collect_training_data` writes, one at a time, in
    memory: (the file path it would write, the episode as the file would
    hold it: images quantized to uint8, masks cast to bool;
    robonet_hdf5.episode_arrays)."""
    env = _make_env(env_name, cfg, seed, device)
    behavior, robot = _BEHAVIORS.get(env_name, ("straight_push", "locobot"))
    folder = os.path.join(out_dir, viewpoint)
    for i in range(n_episodes):
        hist = env.generate_demo(behavior)
        obs = hist["obs"]
        T = len(obs)
        images = np.stack([
            (np.clip(o["observation"], 0, 1) * 255).astype(np.uint8)
            for o in obs
        ])
        states = np.stack([o["states"] for o in obs])
        masks = np.stack([o["masks"] for o in obs]).astype(bool)
        qpos = np.stack([o["qpos"] for o in obs])
        acs = np.stack(hist["ac"])[: T - 1]
        yield (os.path.join(folder, f"traj_{seed}_{i}.hdf5"),
               episode_arrays(images, states, acs, masks, qpos, robot=robot))


def collect_training_data(env_name: str, n_episodes: int, out_dir: str,
                          cfg: Optional[Config] = None, seed: int = 0,
                          viewpoint: str = "locobot_c0", device="cuda"):
    """Writes `<out_dir>/<viewpoint>/traj_<seed>_<i>.hdf5` episodes."""
    require_h5py()
    os.makedirs(os.path.join(out_dir, viewpoint), exist_ok=True)
    paths = []
    for path, ep in training_episodes(env_name, n_episodes, out_dir, cfg,
                                      seed, viewpoint, device):
        write_trajectory_hdf5(path, ep["observations"], ep["states"],
                              ep["actions"], ep["masks"], ep["qpos"],
                              robot=ep["robot"])
        paths.append(path)
    return paths


def write_training_records(episodes: Sequence[Tuple[str, dict]],
                           record_dir: str, cfg: Config,
                           viewpoint: Union[str, Sequence[str]] = "locobot_c0",
                           episodes_per_shard: int = 64,
                           device="cuda") -> List[str]:
    """Record shards (data/records.py) of episodes in memory, preprocessed
    by the HDF5 reader under `cfg` (its RandomState seeded with cfg.seed)
    and cut to cfg.video_length frames, each under the file path the HDF5
    route would have written: the shards `convert_to_records` makes of
    those files, bit for bit. An episode is a mapping of the preprocessed
    layout (`training_episodes`) or a raw public-RoboNet tree
    (raw_robonet.raw_robonet_tree), whose masks render on `device`;
    `viewpoint` is one for all or one an episode. Returns the shard paths.

    This is the route to training of a machine without h5py, a seam and
    not a feature. Like `convert_to_records`, it freezes one window an
    episode: an episode longer than cfg.video_length gets one start drawn
    here, where the HDF5 loaders draw a start at every read
    (robonet_hdf5.py's __getitem__); episodes of cfg.video_length frames
    read the same on both routes."""
    paths = [p for p, _ in episodes]
    views = ([viewpoint] * len(paths) if isinstance(viewpoint, str)
             else list(viewpoint))
    return convert_to_records(cfg, paths, views, record_dir,
                              episodes_per_shard,
                              episodes=[ep for _, ep in episodes],
                              device=device)


def collect_mask_data(env_name: str, n_samples: int, out_dir: str,
                      cfg: Optional[Config] = None, seed: int = 0,
                      device="cuda"):
    """Random qpos -> mask pairs for mask-model verification
    (reference: src/dataset/collect_mask_data.py)."""
    h5py = require_h5py()
    env = _make_env(env_name, cfg, seed, device)
    os.makedirs(out_dir, exist_ok=True)
    qs, ms = [], []
    for _ in range(n_samples):
        env.reset()
        q = env._host("qpos")
        qs.append(q)
        ms.append(env.get_robot_mask())
    path = os.path.join(out_dir, f"mask_data_{seed}.hdf5")
    with h5py.File(path, "w") as hf:
        hf.create_dataset("qpos", data=np.stack(qs))
        hf.create_dataset("masks", data=np.stack(ms).astype(bool))
    return path


def collect_runner_demos(env_name: str, n_episodes: int, demo_dir: str,
                         cfg: Optional[Config] = None, seed: int = 0,
                         device="cuda"):
    """Scripted demos in the episode-runner format (demo_io) — what
    `control/episode_runner.py` follows (reference: the collect scripts
    double as demo generators for src/mbrl/, e.g. collect_pick_data.py)."""
    from robot_aware_control_tpu_torch.data import demo_io

    env = _make_env(env_name, cfg, seed, device)
    behavior, _ = _BEHAVIORS.get(env_name, ("straight_push", "locobot"))
    return demo_io.collect_demos(env, behavior, n_episodes, demo_dir)


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="cuda (default) or cpu; there is no fallback")
    args, rest = pre.parse_known_args(argv)
    cfg, _ = argparser(rest)
    if cfg.collect_target in ("train", "both"):
        collect_training_data(cfg.env, cfg.num_episodes, cfg.data_root, cfg,
                              seed=cfg.seed, device=args.device)
    if cfg.collect_target in ("demos", "both"):
        collect_runner_demos(cfg.env, cfg.num_episodes, cfg.demo_dir, cfg,
                             seed=cfg.seed, device=args.device)


if __name__ == "__main__":
    main()
