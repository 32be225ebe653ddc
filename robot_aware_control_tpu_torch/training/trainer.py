"""Training runtime: the `PredictionTrainer` loop and CLI (counterpart of
`robot_aware_control_tpu/training/trainer.py`; reference:
src/prediction/trainer.py:53-1471).

    python -m robot_aware_control_tpu_torch.training.trainer \\
        --experiment synthetic --device cuda [--flags of config.py]
    torchrun --nproc_per_node 2 -m robot_aware_control_tpu_torch.training.trainer \\
        --device cpu --param_sharding data [--flags]

The loop of the JAX trainer, for every model family (svg, det,
svg_vec, det_vec, cdna_det, cdna_robonet):
  * the experiment's loaders (trainer.py:178-238): `synthetic`, the
    RoboNet, sawyer and locobot view-directory experiments, and any other
    name over every HDF5 under --data_root (data/loader.py), with the
    zero-shot transfer loaders of train_robonet, train_sawyer_multiview
    and the default experiment;
  * niter epochs x epoch_size batches (trainer.py:753-768), each batch a
    video of video_length frames sliced into floor(T / window) train
    windows, at random offsets with random_snippet (trainer.py:259-283);
    one whole-window train step each (training/step.py); the batches come
    through `device_prefetch`, copied to the GPU while the previous one
    computes, and --load_movement_info's labels weight the loss by
    --movement_weight;
  * the scheduled-sampling probability k / (k + e^(step/k)) per optimizer
    step (trainer.py:132-147);
  * epoch metrics kept on the device and synced once per epoch, with
    frames_per_sec = epoch_size x B x window x windows per video / seconds;
  * a checkpoint every checkpoint_interval epochs and auto-resume from the
    newest one (trainer.py:770-772, 829-897);
  * an eval epoch every eval_interval epochs: 1-step and autoregressive
    passes over n_eval windows (trainer.py:491-563), whose cells run the
    hand kernel, then one over the transfer loader (logged under
    transfer/), then an autoregressive rollout of the first test batch
    written as `eval_<epoch>.gif` (trainer.py:437-453, 557-563);
  * --dynamics_model_ckpt loaded before auto-resume (trainer.py:502-505),
    as a finetune (step 0, a fresh optimizer) for the finetune_*
    experiments;
  * the finetune_* experiments' robot model (trainer.py:127-139, 263-303):
    for finetune_locobot the analytical model (robot/analytical.py: IK and
    the capsule-mask kernel), for any finetune with --learned_robot_model
    the robot MLPs of --robot_model_ckpt (training/robot_trainer.py), in
    either case only where the model reads masks or robot states. It
    replaces each train and eval window's states and model-input masks
    (eef heatmaps re-derived from the predicted states); eval metrics keep
    the true masks, and an svg finetune's autoregressive eval keeps the
    best of 3 prior samples by PSNR (trainer.py:384-416);
  * --model copy: the parameter-free copy baseline's metrics over full
    train, test and transfer epochs instead of training, with a rollout
    gif of each split (trainer.py:569-598);
  * the parallel layouts (trainer.py:92-123; parallel/mesh.py:Layout):
    inside an initialised process group (torchrun, or workers that call
    init_process_group themselves) the trainer runs on a (data, model)
    mesh of its ranks, --param_sharding replicated (DDP), data (FSDP2) or
    model (channel-sharded DTensors over --model_axis_size ranks), named
    by --mesh_axes. Batch sizes are global; each rank reads its data
    index's share (synthetic data seeded cfg.seed + 1000 * index, files
    and record shards through host_shard_files), BatchNorm's statistics,
    the draws, the gradients and the metrics are the global batch's, and
    rank 0 logs to the run's dir (rank r to <dir>/rank<r>). Checkpoints
    are sharded `ckpt_<step>/` directories (training/checkpoint.py, DCP)
    with --sharded_checkpoint or more than one rank (trainer.py:459-460),
    and load into any layout.

The synthetic data carries no heatmaps, so heatmap-conditioned models
raise on it, as the JAX trainer fails. Not ported: wandb.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from robot_aware_control_tpu_torch import convert
from robot_aware_control_tpu_torch.config import Config, argparser
from robot_aware_control_tpu_torch.data import loader as data_loader
from robot_aware_control_tpu_torch.data.loader import device_batch, device_prefetch
from robot_aware_control_tpu_torch.data.heatmaps import create_heatmaps
from robot_aware_control_tpu_torch.data.records import (
    create_record_loaders,
    create_record_transfer_loader,
)
from robot_aware_control_tpu_torch.data.synthetic import SyntheticDataset
from robot_aware_control_tpu_torch.models.registry import get_model
from robot_aware_control_tpu_torch.parallel.mesh import Layout, process_info
from robot_aware_control_tpu_torch.models.robot_mlp import (
    GripperStatePredictor,
    JointPosPredictor,
)
from robot_aware_control_tpu_torch.robot.analytical import get_robot_model
from robot_aware_control_tpu_torch.robot.mask_renderer import CapsuleMaskRenderer
from robot_aware_control_tpu_torch.training import checkpoint as ckpt
from robot_aware_control_tpu_torch.training.logger import RunLogger, make_log_folder
from robot_aware_control_tpu_torch.training.plot import eval_gif
from robot_aware_control_tpu_torch.training.robot_trainer import (
    load_robot_models,
    rollout,
)
from robot_aware_control_tpu_torch.training.step import (
    make_copy_eval_step,
    make_eval_step,
    make_train_step,
)
from robot_aware_control_tpu_torch.utils.device import resolve_device

_WINDOW_KEYS = ("images", "masks", "states", "qpos", "heatmaps")


class PredictionTrainer:
    """`record_dir`, where given, holds record shards of the experiment's
    episodes (data/collect.py:write_training_records), read in place of the
    HDF5 files under --data_root with the same split
    (data/records.py:create_record_loaders): the input seam of a machine
    without h5py, not a feature."""

    def __init__(self, cfg: Config, device="cuda",
                 record_dir: Optional[str] = None):
        family = get_model(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.log_dir = make_log_folder(cfg)
        # a process group: the (data, model) mesh of its ranks
        self.layout = Layout(cfg) if dist.is_initialized() else None
        self.rank, self.world = process_info()
        own_dir = self.log_dir
        if self.rank:
            own_dir = os.path.join(self.log_dir, f"rank{self.rank}")
            os.makedirs(own_dir, exist_ok=True)
        self.logger = RunLogger(cfg, own_dir)
        self._step = 0
        self._start_epoch = 0
        self._video_rng = np.random.RandomState(cfg.seed)
        self._generator = torch.Generator(self.device).manual_seed(cfg.seed)
        self.transfer_loader = None
        self.record_dir = record_dir
        # the last epoch's seconds and the seconds it waited for batches
        self.last_epoch = None
        # the finetune experiments' robot model (trainer.py:127-139): the
        # analytical model is locobot's; the other finetunes keep the
        # dataset's masks unless --learned_robot_model
        self.robot_model = self.learned_robot = None
        if "finetune" in cfg.experiment and (cfg.model_use_mask
                                             or cfg.model_use_robot_state):
            if cfg.learned_robot_model:
                self.learned_robot = self._load_learned_robot_model()
            elif cfg.experiment == "finetune_locobot":
                self.robot_model = get_robot_model(cfg, device=self.device)
        if cfg.model == "copy":
            # no parameters: eval steps with the learned models' metric keys
            self.model = self.optimizer = self.train_step = self.window = None
            self.eval_step_ar = make_copy_eval_step(cfg, autoregressive=True)
            self.eval_step_1 = make_copy_eval_step(cfg, autoregressive=False)
            return
        self.model = family.init(cfg, cfg.seed, self.device, train=True)
        self.train_step, self.optimizer = make_train_step(cfg, self.model,
                                                          self.layout)
        # the window module that holds the layout's parameters
        self.window = self.train_step.window
        self.eval_step_ar = make_eval_step(cfg, self.model, True, self.layout)
        self.eval_step_1 = make_eval_step(cfg, self.model, False, self.layout)

    # ------------------------------------------------------------------
    def _load_learned_robot_model(self) -> dict:
        """The robot MLPs of --robot_model_ckpt (a {joint_model,
        gripper_model} checkpoint of either package; without one, as
        initialised) and the thin capsule renderer of their masks
        (trainer.py:141-176)."""
        cfg, dev = self.cfg, self.device
        joint = JointPosPredictor(cfg, seed=0, device=dev)
        grip = GripperStatePredictor(cfg, seed=1, device=dev)
        if cfg.robot_model_ckpt:
            load_robot_models(cfg.robot_model_ckpt, joint, grip)
        for m in (joint, grip):
            m.eval().requires_grad_(False)
        renderer = CapsuleMaskRenderer((cfg.image_height, cfg.image_width),
                                       thick=False, modified=cfg.modified,
                                       device=dev)
        return {"joint": joint, "grip": grip, "renderer": renderer}

    # ------------------------------------------------------------------
    def _setup_data(self):
        """The experiment's train and test loaders, and its transfer loader
        in self.transfer_loader (trainer.py:178-238)."""
        cfg = self.cfg
        self.transfer_loader = None
        if cfg.experiment == "synthetic" or cfg.dataset == "synthetic":
            if cfg.model_use_heatmap:
                # the JAX step fails on such batches (svg.py:341-348 would
                # concatenate a missing heatmap)
                raise ValueError(
                    "model_use_heatmap: the synthetic data carries no "
                    "heatmaps; train heatmap models on an experiment whose "
                    "loader makes them")
            # batch sizes are global: each data index generates its share
            # (trainer.py:182-191)
            index = 0 if self.layout is None else self.layout.data_index
            train = SyntheticDataset(
                cfg, data_loader._host_batch(cfg.batch_size, cfg),
                seed=cfg.seed + 1000 * index,
                num_batches=max(cfg.epoch_size, 1))
            test = SyntheticDataset(
                cfg, data_loader._host_batch(cfg.test_batch_size, cfg),
                seed=cfg.seed + 1 + 1000 * index, num_batches=2)
            return train, test
        dev = self.device
        if self.record_dir is not None:
            self.transfer_loader = self._try_transfer(
                create_record_transfer_loader, record_dir=self.record_dir)
            return create_record_loaders(cfg, self.record_dir)
        exp = cfg.experiment
        if exp == "train_robonet":
            # zero-shot transfer measured on locobot, a robot absent from
            # the robonet training mix (trainer.py:903-913)
            self.transfer_loader = self._try_transfer(
                data_loader.create_locobot_transfer_loader, device=dev)
            return data_loader.create_robonet_loaders(cfg, device=dev)
        if exp == "train_sawyer_multiview":
            # zero-shot transfer on the held-out sudri2_c1 viewpoint
            # (trainer.py:915-925)
            self.transfer_loader = self._try_transfer(
                data_loader.create_sawyer_transfer_loader, device=dev)
            return data_loader.create_sawyer_loaders(cfg, device=dev)
        factory = {
            "finetune_sawyer_view": data_loader.create_sawyer_finetune_loaders,
            "finetune_widowx": data_loader.create_widowx_finetune_loaders,
            "train_locobot_singleview": data_loader.create_locobot_loaders,
            "finetune_locobot": data_loader.create_locobot_finetune_loaders,
            "train_locobot_table": data_loader.create_locobot_table_loaders,
            "train_locobot_pick": data_loader.create_locobot_pick_loaders,
        }.get(exp)
        if factory is not None:
            return factory(cfg, device=dev)
        if "finetune" in exp:
            return data_loader.create_finetune_loaders(cfg, device=dev)
        train, test = data_loader.create_loaders(cfg, device=dev)
        self.transfer_loader = self._try_transfer(
            data_loader.create_transfer_loader, device=dev)
        return train, test

    def _try_transfer(self, factory, **kw):
        try:
            return factory(self.cfg, **kw)
        except FileNotFoundError:
            self.logger.info(f"no transfer data for {factory.__name__}; "
                             "skipping transfer eval")
            return None

    def _sched_prob(self) -> float:
        """Probability of feeding ground truth (trainer.py:132-139)."""
        if not self.cfg.scheduled_sampling:
            return 1.0
        k = float(self.cfg.scheduled_sampling_k)
        return k / (k + float(np.exp(min(self._step / k, 50.0))))

    @property
    def _robot_windows(self) -> bool:
        """Whether a robot model replaces each window's states and masks."""
        return self.robot_model is not None or self.learned_robot is not None

    def _video(self, batch: Dict, qpos: bool = False) -> Dict[str, torch.Tensor]:
        """The tensors of a device batch that the steps read: the frames,
        masks, states, heatmaps and actions (qpos only with `qpos`: the
        robot model reads it, no step does), and the movement labels as
        loss weights (trainer.py:336-352)."""
        out = {k: batch[k] for k in _WINDOW_KEYS + ("actions",)
               if k in batch and (qpos or k != "qpos")}
        if "high_movement" in batch:
            out["batch_weight"] = torch.where(
                batch["high_movement"], self.cfg.movement_weight, 1.0
            ).to(torch.float32)
        return out

    @staticmethod
    def _window(video: Dict, s: int, e: int) -> Dict[str, torch.Tensor]:
        return {k: (video[k][s:e] if k in _WINDOW_KEYS
                    else video[k][s:e - 1] if k == "actions" else video[k])
                for k in video}

    def _apply_robot_model(self, window: Dict, batch: Dict) -> Dict:
        """The window with the robot model's states and masks
        (trainer.py:263-303): "states" predicted, "pred_masks" and
        "masks_model_input" the predicted masks, "masks" still the true
        ones; with heatmap conditioning, heatmaps re-derived from the
        predicted states on the host (data/heatmaps.py:create_heatmaps)."""
        cfg = self.cfg
        if self.learned_robot is not None:
            lr = self.learned_robot
            ss, qq = rollout(lr["joint"], lr["grip"], window["states"][0],
                             window["qpos"][0], window["actions"])
            qq = torch.cat([window["qpos"][:1], qq])
            states = torch.cat([window["states"][:1], ss])
            masks = lr["renderer"].render(qq)
        else:
            states, masks = self.robot_model.predict_batch(
                {"states": window["states"], "qpos": window["qpos"],
                 "actions": window["actions"], "low": batch["low"],
                 "high": batch["high"]})
        out = dict(window, states=states, pred_masks=masks,
                   masks_model_input=masks)
        if cfg.model_use_heatmap:
            s = states.cpu().numpy()
            low = np.asarray(torch.as_tensor(batch["low"]).cpu())
            high = np.asarray(torch.as_tensor(batch["high"]).cpu())
            B = s.shape[1]
            robots = batch.get("robot", ["locobot"] * B)
            folders = batch.get("folder", ["c0"] * B)
            hms = np.stack([create_heatmaps(
                s[:, b], low[b], high[b], robots[b], folders[b],
                (cfg.image_width, cfg.image_height)) for b in range(B)], 1)
            out["heatmaps"] = torch.from_numpy(hms).to(states.device)
        return out

    # ------------------------------------------------------------------
    def _train_video(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """Slice a device batch into train windows and take one step each
        (trainer.py:259-324). Metrics stay on the device."""
        cfg = self.cfg
        T = len(batch["images"])
        window = cfg.n_past + cfg.n_future
        num = max(T // window, 1)
        video = self._video(batch, qpos=self._robot_windows)
        agg = {}
        for i in range(num):
            if cfg.random_snippet and T > window:
                s = self._video_rng.randint(0, T - window + 1)
            else:
                s = i * window
            w = self._window(video, s, s + window)
            if self._robot_windows:
                w = self._apply_robot_model(w, batch)
                w["masks"] = w.pop("masks_model_input")
                del w["pred_masks"], w["qpos"]
            metrics = self.train_step(w, self._sched_prob(), self._generator)
            self._step += 1
            for k, v in metrics.items():
                agg[k] = agg[k] + v / num if k in agg else v / num
        return agg

    def _eval_video(self, batch: Dict, autoregressive=True) -> Dict[str, float]:
        """Eval of a device batch over n_eval windows (trainer.py:384-416),
        synced once: an svg finetune's autoregressive pass draws 3 prior
        samples a window and keeps the sample whose PSNR over the video is
        best."""
        cfg = self.cfg
        T = len(batch["images"])
        window = cfg.n_eval
        num = max(T // window, 1)
        num_samples = 3 if (autoregressive and cfg.model == "svg"
                            and "finetune" in cfg.experiment) else 1
        step_fn = self.eval_step_ar if autoregressive else self.eval_step_1
        video = self._video(batch, qpos=self._robot_windows)
        samples = [{} for _ in range(num_samples)]
        for i in range(num):
            s = i * window
            if s + window > T:
                break
            w = self._window(video, s, s + window)
            if self._robot_windows:
                w = self._apply_robot_model(w, batch)
                del w["masks_model_input"], w["qpos"]
            for agg in samples:
                per_step, _ = step_fn(w, self._generator)
                for k, v in per_step.items():
                    agg[k] = agg.get(k, 0.0) + v.mean() / num
        if self.layout is not None:  # the global batch's metrics
            samples = [self.layout.mean(agg) for agg in samples]
        synced = [{k: float(v) for k, v in agg.items()} for agg in samples]
        synced.sort(key=lambda d: d.get("psnr", 0.0), reverse=True)
        return synced[0]

    def _eval_epoch(self, loader, cap: Optional[int]):
        """Epoch metrics over the loader's batches, capped at `cap` batches
        (None: the full set)."""
        agg = defaultdict(float)
        n = 0
        batches = device_prefetch(iter(loader), self.device)
        try:
            for batch in self._in_step(batches):
                for mode, tag in ((False, "1step_"), (True, "autoreg_")):
                    for k, v in self._eval_video(batch, autoregressive=mode).items():
                        agg[f"{tag}{k}"] += v
                n += 1
                if cap is not None and n >= cap:
                    break
        finally:
            batches.close()
        return {k: v / max(n, 1) for k, v in agg.items()}, n

    def _in_step(self, batches):
        """The batches while every rank of the data axis still has one (the
        ranks' eval steps run their collectives in step; their shares of
        the files may give them different counts)."""
        for batch in batches:
            if self.layout is not None and not self._all_ranks(True):
                return
            yield batch
        if self.layout is not None:
            self._all_ranks(False)  # the ranks that still had one stop too

    def _all_ranks(self, has: bool) -> bool:
        flag = torch.tensor([float(has)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN,
                        group=self.layout.data_group)
        return bool(flag.item())

    def _full_params(self):
        """The model's whole parameters (the eval steps and the npz trees
        read them): FSDP2's unshard or the gathered DTensors."""
        if self.layout is None or self.window is None:
            return contextlib.nullcontext()
        return self.layout.full_params(self.window, self.model)

    def _plot_eval(self, loader, epoch: int, tag: str = "eval"):
        """The autoregressive rollout of the loader's first batch over its
        first n_eval frames as `<tag>_<epoch>.gif`: truth with the robot
        masks in red above the prediction (trainer.py:437-453)."""
        n = self.cfg.n_eval
        batch = next(iter(loader), None)
        if batch is None or len(batch["images"]) < n:
            return
        video = self._video(device_batch(batch, self.device))
        _, preds = self.eval_step_ar(self._window(video, 0, n), self._generator)
        path = eval_gif(
            os.path.join(self.logger.dir, f"{tag}_{epoch}.gif"),
            batch["images"][1:n], preds.float().cpu().numpy(),
            masks=batch["masks"][1:n])
        if path:
            self.logger.video(path, self._step, key=f"{tag}/rollout")

    # ------------------------------------------------------------------
    def _trees(self) -> Dict[str, dict]:
        """Model and optimizer state as the JAX package's flat trees (a
        sharded layout's gathered whole on every rank)."""
        params, bn = convert.jax_flat_trees(self.model)
        return {"params": params, "bn": bn,
                "opt": convert.optimizer_to_jax(self.cfg, self.model,
                                                self.optimizer)}

    @property
    def _sharded_checkpoints(self) -> bool:
        """Sharded checkpoints with --sharded_checkpoint or more than one
        rank (trainer.py:459-460)."""
        return self.cfg.sharded_checkpoint or self.world > 1

    def _save(self, epoch: int):
        if self._sharded_checkpoints:
            path = ckpt.save_checkpoint_sharded(self.log_dir, self._step,
                                                self.model, self.optimizer)
        else:
            path = ckpt.save_checkpoint(self.log_dir, self._step,
                                        self._trees(),
                                        background=self.cfg.async_checkpoint)
        self.logger.info(f"saved checkpoint {path} (epoch {epoch})")

    def load_checkpoint(self, path: str, finetune: bool = False):
        """Loads a ckpt_<step>.npz of either package, or a sharded
        ckpt_<step>/ directory saved by the port under any layout: the
        parameters, the BatchNorm statistics and, unless `finetune`, the
        optimizer's state and the step (trainer.py:484-494)."""
        if os.path.isdir(path):
            step = ckpt.load_checkpoint_sharded(
                path, self.model, None if finetune else self.optimizer)
            if not finetune:
                self._step = step
            return
        templates = self._trees()
        if finetune:
            del templates["opt"]
        trees, step = ckpt.load_checkpoint(path, templates)
        sd = convert.state_dict_from_flat(trees["params"], trees["bn"])
        if self.layout is None or self.layout.kind == "replicated":
            self.model.load_state_dict(sd, strict=True)
        else:  # whole tensors into the layout's shards
            from torch.distributed.checkpoint.state_dict import (
                StateDictOptions,
                set_model_state_dict,
            )

            set_model_state_dict(self.model, sd, options=StateDictOptions(
                full_state_dict=True, strict=True))
        if not finetune:
            convert.optimizer_from_jax(self.cfg, self.model, self.optimizer,
                                       trees["opt"])
            self._step = step

    def _resume(self):
        path = ckpt.latest_checkpoint(self.log_dir)
        if path is None:
            return
        self.load_checkpoint(path)
        spv = max(self.cfg.video_length // (self.cfg.n_past + self.cfg.n_future), 1)
        self._start_epoch = self._step // max(self.cfg.epoch_size * spv, 1)
        self.logger.info(f"auto-resumed from {path} at step {self._step}")

    # ------------------------------------------------------------------
    def train(self):
        cfg = self.cfg
        if cfg.model == "copy":
            return self.copy_baseline()
        train_loader, test_loader = self._setup_data()
        if cfg.dynamics_model_ckpt:
            self.load_checkpoint(cfg.dynamics_model_ckpt,
                                 finetune="finetune" in cfg.experiment)
            self.logger.info(f"loaded {cfg.dynamics_model_ckpt} at step "
                             f"{self._step}")
        self._resume()
        # one batch at a time: the launches run ahead of the device, so a
        # batch's copy already overlaps the steps queued before it; staging
        # further ahead on this thread would only put the next batch's
        # generation or collation before this batch's launches
        train_iter = device_prefetch(train_loader.infinite(), self.device,
                                     size=1)
        try:
            self._train_epochs(train_iter, test_loader)
        finally:
            train_iter.close()
        self._save(cfg.niter - 1)
        ckpt.wait_for_checkpoints()  # join background npz writers
        return self.model

    def _train_epochs(self, train_iter, test_loader):
        cfg = self.cfg
        window = cfg.n_past + cfg.n_future
        eval_cap = cfg.eval_batches or None  # 0: the full set (trainer.py:467-489)
        for epoch in range(self._start_epoch, cfg.niter):
            device_agg = {}
            wait = 0.0
            t_epoch = time.perf_counter()
            for _ in range(cfg.epoch_size):
                t = time.perf_counter()
                batch = next(train_iter)
                wait += time.perf_counter() - t
                for k, v in self._train_video(batch).items():
                    device_agg[k] = device_agg[k] + v if k in device_agg else v
            # one host sync per epoch
            epoch_metrics = {k: float(v) / cfg.epoch_size
                             for k, v in device_agg.items()}
            dt = time.perf_counter() - t_epoch
            self.last_epoch = {"seconds": dt, "data_wait_s": wait}
            # the global batch (this rank's times the data axis)
            B = batch["images"].shape[1] * (
                1 if self.layout is None else self.layout.data_size)
            spv = max(len(batch["images"]) // window, 1)
            epoch_metrics["frames_per_sec"] = cfg.epoch_size * B * window * spv / dt
            self.logger.scalars(epoch_metrics, self._step, prefix="train/")
            self.logger.info(
                f"epoch {epoch} step {self._step} "
                + " ".join(f"{k}={v:.4f}" for k, v in epoch_metrics.items())
                + f" (waited {wait:.3f} s of {dt:.3f} s for data)")
            if (epoch + 1) % cfg.checkpoint_interval == 0:
                self._save(epoch)
            if (epoch + 1) % cfg.eval_interval == 0:
                with self._full_params():
                    self._eval_and_plot(test_loader, eval_cap, epoch)

    def _eval_and_plot(self, test_loader, eval_cap, epoch):
        ev, _ = self._eval_epoch(test_loader, eval_cap)
        self.logger.scalars(ev, self._step, prefix="eval/")
        self.logger.info(
            "eval " + " ".join(f"{k}={v:.4f}" for k, v in ev.items()))
        if self.transfer_loader is not None:
            tv, _ = self._eval_epoch(self.transfer_loader, eval_cap)
            self.logger.scalars(tv, self._step, prefix="transfer/")
        self._plot_eval(test_loader, epoch)

    def copy_baseline(self):
        """The copy baseline's world-error floor (trainer.py:569-598): the
        1step_/autoreg_ metrics of the learned models' eval over full train,
        test and (where the experiment has one) transfer epochs, each split's
        logged at step 0 and at 500000 so that dashboards draw a horizontal
        line, and a rollout gif of each split. Returns {split: metrics}."""
        train_loader, test_loader = self._setup_data()
        splits = [("train", train_loader), ("test", test_loader)]
        if self.transfer_loader is not None:
            splits.append(("transfer", self.transfer_loader))
        results = {}
        for name, loader in splits:
            metrics, n = self._eval_epoch(loader, None)
            self.logger.scalars(metrics, 0, prefix=f"{name}/")
            self.logger.scalars(metrics, 500000, prefix=f"{name}/")
            self.logger.info(
                f"copy baseline [{name}] ({n} batches) "
                + " ".join(f"{k}={v:.5f}" for k, v in sorted(metrics.items())))
            self._plot_eval(loader, 0, tag=name)
            results[name] = metrics
        return results


def init_from_env(device: str) -> bool:
    """Joins the process group that torchrun describes in the environment
    (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT): NCCL on the GPU of
    LOCAL_RANK, gloo on the CPU. Returns whether it did."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return True


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="cuda (default) or cpu; there is no fallback")
    args, rest = pre.parse_known_args(argv)
    cfg, unparsed = argparser(rest)
    if unparsed:
        raise ValueError(f"unknown flags: {unparsed}")
    joined = init_from_env(args.device)
    trainer = PredictionTrainer(cfg, device=args.device)
    try:
        trainer.train()
    finally:
        trainer.logger.close()
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
