"""Checkpoint evaluation (counterpart of
`robot_aware_control_tpu/evaluation/evaluate_checkpoint.py`; reference:
src/prediction/evaluation/evaluate_checkpoint.py:16-80, PSNR/SSIM/world
loss on the transfer set, and evaluation/evaluate_fvd.py:14, FVD over
autoregressively predicted videos).

A checkpoint of either package's trainer loads into the port's trainer on
`device` (the GPU unless the caller asks for the CPU), whose eval step
runs the ConvLSTM cells through the hand-written cell kernel. The data
comes from the experiment's loaders, or, where `record_dir` is given, from
the record shards of a machine without h5py (PredictionTrainer's seam).

    python -m robot_aware_control_tpu_torch.evaluation.evaluate_checkpoint \\
        --dynamics_model_ckpt ckpt_N.npz [--record_dir <shards>] \\
        [--device cpu] [--flags of config.py]
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np

from robot_aware_control_tpu_torch.config import Config, argparser
from robot_aware_control_tpu_torch.data.loader import device_batch
from robot_aware_control_tpu_torch.evaluation.fvd import embedder_caveat, fvd
from robot_aware_control_tpu_torch.training.trainer import PredictionTrainer


def _trainer(cfg: Config, ckpt_path: str, device, record_dir):
    trainer = PredictionTrainer(cfg, device=device, record_dir=record_dir)
    trainer.load_checkpoint(ckpt_path, finetune=False)
    return trainer


def evaluate_checkpoint(cfg: Config, ckpt_path: str, loader=None,
                        device="cuda", record_dir: Optional[str] = None):
    """The eval metrics (1-step and autoregressive PSNR, SSIM, world loss)
    on the transfer set, or the test set where the experiment has none,
    capped at --eval_batches batches (0: all of them) (reference:
    evaluate_checkpoint.py:16-34)."""
    trainer = _trainer(cfg, ckpt_path, device, record_dir)
    try:
        if loader is None:
            if cfg.experiment == "eval_franka":
                # zero-shot franka eval loads the franka_views/c0 transfer
                # set directly (reference: evaluate_checkpoint.py:8,44-58)
                from robot_aware_control_tpu_torch.data.loader import (
                    create_franka_transfer_loader,
                )

                loader = create_franka_transfer_loader(cfg, device=device)
            else:
                _, loader = trainer._setup_data()
                if trainer.transfer_loader is not None:
                    loader = trainer.transfer_loader
        metrics, _ = trainer._eval_epoch(loader, cfg.eval_batches or None)
    finally:
        trainer.logger.close()
    # world-PSNR derived from the world MSE (reference :24-29)
    wl = metrics.get("autoreg_world_loss")
    if wl and wl > 0:
        metrics["autoreg_world_psnr"] = float(10 * np.log10(1.0 / wl))
    return metrics


def evaluate_obj_movement(cfg: Config, ckpt_path: str, device="cuda"):
    """The eval metrics on the high-movement videos (reference:
    evaluation/evaluate_obj_movement.py:13-24, through the
    movement-filtered loader, robonet_dataloaders.py:295)."""
    from robot_aware_control_tpu_torch.data.loader import create_movement_loaders

    _, test_loader = create_movement_loaders(cfg, device=device)
    trainer = _trainer(cfg, ckpt_path, device, None)
    try:
        metrics, _ = trainer._eval_epoch(test_loader, cfg.eval_batches or None)
    finally:
        trainer.logger.close()
    return metrics


def predict_videos(trainer: PredictionTrainer, loader, num_batches=2):
    """Autoregressive predicted videos and the truth, each (B, n_eval - 1,
    H, W, 3) numpy, over the loader's first batches (reference:
    trainer.predict_video, trainer.py:1149-1224)."""
    n_eval = trainer.cfg.n_eval
    real, fake = [], []
    for n, batch in enumerate(loader):
        if n >= num_batches:
            break
        video = trainer._video(device_batch(batch, trainer.device))
        w = trainer._window(video, 0, n_eval)
        w.pop("qpos", None)
        _, preds = trainer.eval_step_ar(w, trainer._generator)
        real.append(np.moveaxis(np.asarray(batch["images"][1:n_eval]), 0, 1))
        fake.append(np.moveaxis(preds.float().cpu().numpy(), 0, 1))
    return np.concatenate(real), np.concatenate(fake)


def evaluate_fvd(cfg: Config, ckpt_path: str, loader=None, embed_fn=None,
                 device="cuda"):
    """FVD of the checkpoint's predicted videos against the truth
    (reference: evaluation/evaluate_fvd.py:14), with the embedder's caveat
    beside the number wherever it is not reference-comparable (no
    converted I3D weights)."""
    trainer = _trainer(cfg, ckpt_path, device, None)
    try:
        if loader is None:
            _, loader = trainer._setup_data()
        real, fake = predict_videos(trainer, loader)
    finally:
        trainer.logger.close()
    out = {"fvd": fvd(real, fake, embed_fn, device=device)}
    caveat = embedder_caveat(embed_fn)
    if caveat:
        out["fvd_caveat"] = caveat
    return out


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="cuda (default) or cpu; there is no fallback")
    pre.add_argument("--record_dir", default=None,
                     help="record shards to read in place of --data_root's "
                          "HDF5 files (a machine without h5py)")
    args, rest = pre.parse_known_args(argv)
    cfg, _ = argparser(rest)
    if cfg.dynamics_model_ckpt is None:
        raise ValueError("--dynamics_model_ckpt required")
    metrics = evaluate_checkpoint(cfg, cfg.dynamics_model_ckpt,
                                  device=args.device,
                                  record_dir=args.record_dir)
    print(json.dumps({k: round(float(v), 5) for k, v in metrics.items()}))
    return metrics


if __name__ == "__main__":
    main()
