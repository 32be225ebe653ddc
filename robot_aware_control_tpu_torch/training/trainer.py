"""Training runtime: the `PredictionTrainer` loop and CLI (counterpart of
`robot_aware_control_tpu/training/trainer.py`; reference:
src/prediction/trainer.py:53-1471).

    python -m robot_aware_control_tpu_torch.training.trainer \\
        --experiment synthetic --device cuda [--flags of config.py]

The loop of the JAX trainer, for svg on the synthetic experiment:
  * niter epochs x epoch_size batches (trainer.py:753-768), each batch a
    video of video_length frames sliced into floor(T / window) train
    windows, at random offsets with random_snippet (trainer.py:259-283);
    one whole-window train step each (training/step.py);
  * the scheduled-sampling probability k / (k + e^(step/k)) per optimizer
    step (trainer.py:132-147);
  * epoch metrics kept on the device and synced once per epoch, with
    frames_per_sec = epoch_size x B x window x windows per video / seconds;
  * a checkpoint every checkpoint_interval epochs and auto-resume from the
    newest one (trainer.py:770-772, 829-897);
  * an eval epoch every eval_interval epochs: 1-step and autoregressive
    passes over n_eval windows (trainer.py:491-563), whose cells run the
    hand kernel.

Not ported yet, and raising where they are read: the HDF5/RoboNet loaders
(experiments other than synthetic), the finetune_* experiments and their
robot models, models other than svg, sharded checkpoints. Not ported:
mesh sharding, transfer loaders, eval gifs, wandb and the copy baseline.
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch

from robot_aware_control_tpu_torch import convert
from robot_aware_control_tpu_torch.config import Config, argparser
from robot_aware_control_tpu_torch.data.synthetic import SyntheticDataset
from robot_aware_control_tpu_torch.models.registry import get_model
from robot_aware_control_tpu_torch.training import checkpoint as ckpt
from robot_aware_control_tpu_torch.training.logger import RunLogger, make_log_folder
from robot_aware_control_tpu_torch.training.step import make_eval_step, make_train_step
from robot_aware_control_tpu_torch.utils.device import resolve_device

_WINDOW_KEYS = ("images", "masks", "states")


class PredictionTrainer:
    def __init__(self, cfg: Config, device="cuda"):
        get_model(cfg)  # raises for a model the port does not have
        if "finetune" in cfg.experiment:
            raise NotImplementedError(
                f"experiment {cfg.experiment!r}: the finetune experiments "
                "and their robot models are not ported yet")
        if cfg.sharded_checkpoint:
            raise NotImplementedError(
                "sharded_checkpoint: orbax checkpoints are not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = get_model(cfg).init(cfg, cfg.seed, self.device,
                                         train=True)
        self.log_dir = make_log_folder(cfg)
        self.logger = RunLogger(cfg, self.log_dir)
        self._step = 0
        self._start_epoch = 0
        self._video_rng = np.random.RandomState(cfg.seed)
        self._generator = torch.Generator(self.device).manual_seed(cfg.seed)
        self.train_step, self.optimizer = make_train_step(cfg, self.model)
        self.eval_step_ar = make_eval_step(cfg, self.model, autoregressive=True)
        self.eval_step_1 = make_eval_step(cfg, self.model, autoregressive=False)

    # ------------------------------------------------------------------
    def _setup_data(self):
        """The experiment's loaders (trainer.py:899-947); the port has the
        synthetic experiment."""
        cfg = self.cfg
        if cfg.experiment == "synthetic" or cfg.dataset == "synthetic":
            train = SyntheticDataset(cfg, cfg.batch_size, seed=cfg.seed,
                                     num_batches=max(cfg.epoch_size, 1))
            test = SyntheticDataset(cfg, cfg.test_batch_size,
                                    seed=cfg.seed + 1, num_batches=2)
            return train, test
        raise NotImplementedError(
            f"experiment {cfg.experiment!r}: the HDF5/RoboNet loaders are "
            "not ported yet (use --experiment synthetic)")

    def _sched_prob(self) -> float:
        """Probability of feeding ground truth (trainer.py:132-139)."""
        if not self.cfg.scheduled_sampling:
            return 1.0
        k = float(self.cfg.scheduled_sampling_k)
        return k / (k + float(np.exp(min(self._step / k, 50.0))))

    def _device_video(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The video's arrays on the device, uploaded once for all its
        windows."""
        out = {k: torch.as_tensor(batch[k]) for k in _WINDOW_KEYS + ("actions",)}
        if "high_movement" in batch:
            out["batch_weight"] = torch.as_tensor(np.where(
                np.asarray(batch["high_movement"]), self.cfg.movement_weight,
                1.0).astype(np.float32))
        return {k: v.to(self.device, non_blocking=True) for k, v in out.items()}

    @staticmethod
    def _window(video: Dict, s: int, e: int) -> Dict[str, torch.Tensor]:
        out = {k: (video[k][s:e] if k in _WINDOW_KEYS
                   else video[k][s:e - 1] if k == "actions" else video[k])
               for k in video}
        return out

    # ------------------------------------------------------------------
    def _train_video(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """Slice a video batch into train windows and take one step each
        (trainer.py:259-324). Metrics stay on the device."""
        cfg = self.cfg
        T = len(batch["images"])
        window = cfg.n_past + cfg.n_future
        num = max(T // window, 1)
        video = self._device_video(batch)
        agg = {}
        for i in range(num):
            if cfg.random_snippet and T > window:
                s = self._video_rng.randint(0, T - window + 1)
            else:
                s = i * window
            metrics = self.train_step(self._window(video, s, s + window),
                                      self._sched_prob(), self._generator)
            self._step += 1
            for k, v in metrics.items():
                agg[k] = agg[k] + v / num if k in agg else v / num
        return agg

    def _eval_video(self, batch: Dict, autoregressive=True) -> Dict[str, float]:
        """Eval over n_eval windows (trainer.py:491-563), synced once."""
        T = len(batch["images"])
        window = self.cfg.n_eval
        num = max(T // window, 1)
        step_fn = self.eval_step_ar if autoregressive else self.eval_step_1
        video = self._device_video(batch)
        agg = {}
        for i in range(num):
            s = i * window
            if s + window > T:
                break
            per_step, _ = step_fn(self._window(video, s, s + window),
                                  self._generator)
            for k, v in per_step.items():
                agg[k] = agg.get(k, 0.0) + v.mean() / num
        return {k: float(v) for k, v in agg.items()}

    def _eval_epoch(self, test_iter):
        """Epoch metrics over the eval iterator, capped at cfg.eval_batches
        batches (0 = the full set, as the reference, trainer.py:467-489)."""
        cap = self.cfg.eval_batches
        agg = defaultdict(float)
        n = 0
        for batch in test_iter:
            for mode, tag in ((False, "1step_"), (True, "autoreg_")):
                for k, v in self._eval_video(batch, autoregressive=mode).items():
                    agg[f"{tag}{k}"] += v
            n += 1
            if cap and n >= cap:
                break
        return {k: v / max(n, 1) for k, v in agg.items()}, n

    # ------------------------------------------------------------------
    def _trees(self) -> Dict[str, dict]:
        """Model and optimizer state as the JAX package's flat trees."""
        params, bn = convert.jax_flat_trees(self.model)
        return {"params": params, "bn": bn,
                "opt": convert.optimizer_to_jax(self.cfg, self.model,
                                                self.optimizer)}

    def _save(self, epoch: int):
        path = ckpt.save_checkpoint(self.log_dir, self._step, self._trees(),
                                    background=self.cfg.async_checkpoint)
        self.logger.info(f"saved checkpoint {path} (epoch {epoch})")

    def _resume(self):
        path = ckpt.latest_checkpoint(self.log_dir)
        if path is None:
            return
        trees, step = ckpt.load_checkpoint(path, self._trees())
        self.model.load_state_dict(
            convert.state_dict_from_flat(trees["params"], trees["bn"]),
            strict=True)
        convert.optimizer_from_jax(self.cfg, self.model, self.optimizer,
                                   trees["opt"])
        self._step = step
        spv = max(self.cfg.video_length // (self.cfg.n_past + self.cfg.n_future), 1)
        self._start_epoch = step // max(self.cfg.epoch_size * spv, 1)
        self.logger.info(f"auto-resumed from {path} at step {step}")

    # ------------------------------------------------------------------
    def train(self):
        cfg = self.cfg
        train_loader, test_loader = self._setup_data()
        self._resume()
        train_iter = train_loader.infinite()
        window = cfg.n_past + cfg.n_future
        for epoch in range(self._start_epoch, cfg.niter):
            device_agg = {}
            t_epoch = time.perf_counter()
            for _ in range(cfg.epoch_size):
                batch = next(train_iter)
                for k, v in self._train_video(batch).items():
                    device_agg[k] = device_agg[k] + v if k in device_agg else v
            # one host sync per epoch
            epoch_metrics = {k: float(v) / cfg.epoch_size
                             for k, v in device_agg.items()}
            dt = time.perf_counter() - t_epoch
            B = batch["images"].shape[1]
            spv = max(len(batch["images"]) // window, 1)
            epoch_metrics["frames_per_sec"] = cfg.epoch_size * B * window * spv / dt
            self.logger.scalars(epoch_metrics, self._step, prefix="train/")
            self.logger.info(
                f"epoch {epoch} step {self._step} "
                + " ".join(f"{k}={v:.4f}" for k, v in epoch_metrics.items()))
            if (epoch + 1) % cfg.checkpoint_interval == 0:
                self._save(epoch)
            if (epoch + 1) % cfg.eval_interval == 0:
                ev, _ = self._eval_epoch(iter(test_loader))
                self.logger.scalars(ev, self._step, prefix="eval/")
                self.logger.info(
                    "eval " + " ".join(f"{k}={v:.4f}" for k, v in ev.items()))
        self._save(cfg.niter - 1)
        ckpt.wait_for_checkpoints()  # join background npz writers
        return self.model


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="cuda (default) or cpu; there is no fallback")
    args, rest = pre.parse_known_args(argv)
    cfg, unparsed = argparser(rest)
    if unparsed:
        raise ValueError(f"unknown flags: {unparsed}")
    trainer = PredictionTrainer(cfg, device=args.device)
    try:
        trainer.train()
    finally:
        trainer.logger.close()


if __name__ == "__main__":
    main()
