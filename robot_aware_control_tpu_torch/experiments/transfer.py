"""Zero-shot robot-transfer experiment (counterpart of
`robot_aware_control_tpu/experiments/transfer.py`).

Reproduces the reference's headline claim (reference: README.md:15, the
paper's Sawyer -> WidowX/Baxter transfer): a video-prediction model
trained with robot-awareness (mask conditioning and the don't-care loss)
on one robot predicts the world on an unseen robot better than a
conventional model, because its world module never learned robot pixels.

  1. collect scripted push episodes with the standard locobot,
  2. train (a) robot-aware SVG (masks, state, dontcare_l1) and
           (b) vanilla SVG (no conditioning, l1),
  3. collect episodes with the visually different "modified" robot,
  4. evaluate both checkpoints autoregressively on the transfer episodes,
     scoring world-region MSE/PSNR against the true masks.

Everything runs on --device (the GPU unless --device cpu). Where h5py is
installed the episodes go through HDF5 files as in the JAX experiment;
without it (the H100 machine) the training episodes go to record shards
(data/collect.py:write_training_records), which both models read with the
experiment's split, and the transfer episodes stay in memory, read by the
same HDF5 reader (`RoboNetHDF5Dataset(episodes=)`). An episode longer than
--video_length would be read at one start drawn at write time on the
record route and at a start drawn each epoch on the HDF5 route; at
--video_length equal to the episodes' --demo_length the routes read the
same frames. The route is chosen by whether h5py is installed and
printed; it is an input seam, not a fallback.

    python -m robot_aware_control_tpu_torch.experiments.transfer \\
        [--niter 12 --epoch_size 8 --num_episodes 120 ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from robot_aware_control_tpu_torch.config import Config, argparser
from robot_aware_control_tpu_torch.data import demo_io
from robot_aware_control_tpu_torch.data.collect import (
    collect_training_data,
    training_episodes,
    write_training_records,
)
from robot_aware_control_tpu_torch.data.loader import DataLoader, device_batch
from robot_aware_control_tpu_torch.data.robonet_hdf5 import RoboNetHDF5Dataset
from robot_aware_control_tpu_torch.models.registry import load_model
from robot_aware_control_tpu_torch.training import checkpoint as ckpt
from robot_aware_control_tpu_torch.training.step import make_eval_step
from robot_aware_control_tpu_torch.training.trainer import PredictionTrainer
from robot_aware_control_tpu_torch.utils.device import resolve_device


def _base_cfg(cfg: Config, **kw) -> Config:
    return cfg.replace(
        model="svg", experiment="train_locobot_singleview",
        robot_dim=5, action_dim=5, robot_joint_dim=5,
        n_eval=min(cfg.n_eval, cfg.video_length),
        impute_autograsp_action=False,
        scheduled_sampling=True, remat=True, **kw,
    )


def pair_cfgs(cfg: Config):
    """The robot-aware and the vanilla model's training configs, over the
    standard robot's data under <log_dir>/data_standard."""
    data_root = os.path.join(cfg.log_dir, "data_standard")
    ra = _base_cfg(cfg, jobname="transfer_ra", data_root=data_root,
                   model_use_mask=True, model_use_future_mask=True,
                   model_use_robot_state=True,
                   reconstruction_loss="dontcare_l1",
                   checkpoint_interval=cfg.niter, eval_interval=10 ** 6)
    va = _base_cfg(cfg, jobname="transfer_vanilla", data_root=data_root,
                   model_use_mask=False, model_use_robot_state=False,
                   reconstruction_loss="l1",
                   checkpoint_interval=cfg.niter, eval_interval=10 ** 6)
    return ra, va


def train_pair(cfg: Config, device="cuda"):
    """Train the robot-aware and the vanilla model on the standard robot's
    data. Returns (ra config, vanilla config, {jobname: checkpoint}); the
    record route's shards are under <data_root>/records."""
    ra, va = pair_cfgs(cfg)
    data_root = ra.data_root
    record_dir = None
    if demo_io.has_h5py():
        collect_training_data("LocobotPush", cfg.num_episodes, data_root, cfg,
                              seed=cfg.seed, device=device)
    else:
        # the two models read the same preprocessing fields, so one set of
        # shards serves both
        record_dir = os.path.join(data_root, "records")
        write_training_records(
            list(training_episodes("LocobotPush", cfg.num_episodes,
                                   data_root, cfg, seed=cfg.seed,
                                   device=device)), record_dir, ra)
    paths = {}
    for c in (ra, va):
        tr = PredictionTrainer(c, device=device, record_dir=record_dir)
        try:
            tr.train()
        finally:
            tr.logger.close()
        paths[c.jobname] = ckpt.latest_checkpoint(tr.log_dir)
    return ra, va, paths


@torch.no_grad()
def eval_transfer(cfg_model: Config, ckpt_path: str, files: Sequence[str],
                  device="cuda", episodes: Optional[Sequence[dict]] = None):
    """World-region metrics of the checkpoint's autoregressive predictions
    (the prior's mean) over the transfer episodes, batch means averaged.
    `files` are the episodes' HDF5 paths; `episodes`, where given, the
    same episodes in memory, read in place of the files."""
    device = resolve_device(device)
    model = load_model(cfg_model, ckpt_path, device)
    ds = RoboNetHDF5Dataset(files, ["locobot_c0"] * len(files),
                            cfg_model.replace(experiment="eval"), seed=0,
                            episodes=episodes)
    loader = DataLoader(ds, cfg_model.test_batch_size, shuffle=False,
                        num_workers=2, seed=0)
    estep = make_eval_step(cfg_model.replace(sample_mean=True), model,
                           autoregressive=True)
    gen = torch.Generator(device).manual_seed(1)
    n_eval = cfg_model.n_eval
    aggs, n = {}, 0
    for batch in loader:
        batch = device_batch(batch, device)
        w = {k: batch[k][:n_eval] for k in ("images", "masks", "states")}
        w["actions"] = batch["actions"][:n_eval - 1]
        per_step, _ = estep(w, gen)
        for k, v in per_step.items():
            aggs[k] = aggs.get(k, 0.0) + v.mean()
        n += 1
    out = {k: float(v) / n for k, v in aggs.items()}
    out["world_psnr"] = float(10 * np.log10(1.0 / max(out["world_loss"], 1e-12)))
    return out


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="cuda (default) or cpu; there is no fallback")
    args, rest = pre.parse_known_args(argv)
    device = resolve_device(args.device)
    cfg, _ = argparser(rest)
    if cfg.num_episodes == 100:  # default -> experiment-sized
        cfg = cfg.replace(num_episodes=120)
    hdf5 = demo_io.has_h5py()
    print(f"[transfer] data route: {'HDF5 files' if hdf5 else 'record shards'}"
          f" (h5py {'installed' if hdf5 else 'not installed'})", flush=True)
    ra, va, paths = train_pair(cfg, device)

    transfer_root = os.path.join(cfg.log_dir, "data_modified")
    episodes = None
    if hdf5:
        collect_training_data("ModifiedLocobotPush", 24, transfer_root, cfg,
                              seed=cfg.seed + 5, device=device)
        files = sorted(glob.glob(os.path.join(transfer_root, "**", "*.hdf5"),
                                 recursive=True))
    else:
        pairs = sorted(training_episodes("ModifiedLocobotPush", 24,
                                         transfer_root, cfg, seed=cfg.seed + 5,
                                         device=device), key=lambda p: p[0])
        files, episodes = [p for p, _ in pairs], [e for _, e in pairs]

    m_ra = eval_transfer(ra, paths["transfer_ra"], files, device, episodes)
    m_va = eval_transfer(va, paths["transfer_vanilla"], files, device,
                         episodes)
    result = {
        "robot_aware": {k: round(v, 6) for k, v in m_ra.items()},
        "vanilla": {k: round(v, 6) for k, v in m_va.items()},
        "world_mse_ratio_vanilla_over_ra": round(
            m_va["world_loss"] / m_ra["world_loss"], 2
        ),
    }
    out_path = os.path.join(cfg.log_dir, "transfer_results.json")
    os.makedirs(cfg.log_dir, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
