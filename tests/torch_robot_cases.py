"""The robot models' checks that run on the card as well as on the CPU (not
a test module; imports no JAX): the robot trainer at its defaults, one of
its train steps on a device against the CPU's, and a finetune trainer fed
by record shards, which carry no workspace bounds, with the locobot's
attached to each batch, and the mask kernel held to its plain version on
the joints a finetune trainer rendered. Shared by chip_smoke.py and
tests/test_torch_port_gpu.py."""

from __future__ import annotations

import numpy as np
import torch

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.data.norm import LOCOBOT_HIGH, LOCOBOT_LOW
from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.training.robot_trainer import (
    JointPosDataset,
    RobotPredictionTrainer,
)
from torch_data_cases import RecordTrainer

# the robot trainer at its defaults (hidden 512, 256 sequences of 8 steps,
# batch 32), locobot dims
ROBOT = dict(robot_dim=5, robot_joint_dim=5, action_dim=5, batch_size=32,
             image_height=48, image_width=64, niter=3, eval_interval=1,
             jobname="robot")
# a train step's losses, device against CPU (float32, TF32 off)
ROBOT_LOSS_RTOL = 1e-5
# Adam's first step moves each weight by about lr times the sign of its
# gradient, so a gradient within rounding of 0 may move it either way:
# parameters past 1e-5 of the CPU's must be rare and within 2 lr
ROBOT_PARAM_ATOL = 1e-5
ROBOT_PARAM_RARE = 1e-3


def robot_step_parity(dev, log_dir: str) -> dict:
    """One RobotPredictionTrainer train step on `dev` against the CPU's from
    the same weights and batch. Returns {"loss_rel", "param_max",
    "param_share_past_atol"}; raises past the tolerances."""
    cfg = Config(**dict(ROBOT, log_dir=log_dir))
    trs = {d: RobotPredictionTrainer(cfg, device=d) for d in ("cpu", dev)}
    for m in ("joint", "grip"):
        getattr(trs[dev], m).load_state_dict(getattr(trs["cpu"], m).state_dict())
    batch = next(JointPosDataset(cfg, seed=cfg.seed).batches(cfg.batch_size))
    losses = {d: {k: float(v) for k, v in tr.train_step(batch).items()}
              for d, tr in trs.items()}
    loss_rel = max(abs(losses[dev][k] - v) / abs(v) for k, v in losses["cpu"].items())
    diffs = torch.cat([(a.detach().cpu() - b.detach()).abs().ravel() for m in (
        "joint", "grip") for a, b in zip(getattr(trs[dev], m).parameters(),
                                         getattr(trs["cpu"], m).parameters())])
    out = dict(loss_rel=loss_rel, param_max=float(diffs.max()),
               param_share_past_atol=float((diffs > ROBOT_PARAM_ATOL).float().mean()))
    for tr in trs.values():
        tr.logger.close()
    if (loss_rel > ROBOT_LOSS_RTOL or out["param_max"] > 2.01 * cfg.lr
            or out["param_share_past_atol"] > ROBOT_PARAM_RARE):
        raise AssertionError(f"robot train step, {dev} vs CPU: {out}")
    return out


class _WithBounds:
    """A loader whose batches carry the locobot workspace bounds per
    element, as the HDF5 reader's do ("low", "high")."""

    def __init__(self, loader):
        self.loader = loader

    def _add(self, batch):
        B = batch["images"].shape[1]
        return dict(batch, low=np.tile(LOCOBOT_LOW, (B, 1)),
                    high=np.tile(LOCOBOT_HIGH, (B, 1)))

    def __iter__(self):
        return map(self._add, iter(self.loader))

    def infinite(self):
        return map(self._add, self.loader.infinite())


class FinetuneRecordTrainer(RecordTrainer):
    """A finetune PredictionTrainer fed by record shards, the locobot
    bounds attached to each batch."""

    def _setup_data(self):
        train, test = super()._setup_data()
        return _WithBounds(train), _WithBounds(test)


def finetune_launches(cfg, train_videos: int, test_batches: int) -> dict:
    """Kernel launches of a finetune trainer run with a robot model: one
    mask render a train window and a window of each eval pass; cells (6 a
    model step, all sm90 in bf16) in the eval passes, the autoregressive
    one taking 3 prior samples a window, and the eval gif's rollout."""
    train_windows = train_videos * (cfg.video_length // (cfg.n_past + cfg.n_future))
    eval_windows = cfg.video_length // cfg.n_eval * test_batches
    cells = 6 * (cfg.n_eval - 1) * ((1 + 3) * eval_windows + 1)
    return {"capsule_mask_render": train_windows + 2 * eval_windows,
            "conv_lstm_cell": cells, "conv_lstm_cell_sm90": cells,
            "conv_lstm_cell_f32": 0}


def record_renders(trainer) -> dict:
    """Make each capsule renderer of a finetune trainer's robot model (the
    learned model's, or the analytical model's thin and thick) keep a copy
    of the first and the last joints it renders: in a run of one epoch,
    the first train window's and the last eval window's. Returns the dict
    it fills: {(renderer's index, "first" or "last"): (renderer, qpos)}."""
    if trainer.learned_robot is not None:
        renderers = [trainer.learned_robot["renderer"]]
    else:
        renderers = [trainer.robot_model.renderer, trainer.robot_model.renderer_thick]
    seen = {}
    for i, r in enumerate(renderers):
        def render(qpos, i=i, r=r, render=r.render):
            seen[i, "last"] = (r, qpos.detach().clone())
            seen.setdefault((i, "first"), seen[i, "last"])
            return render(qpos)

        r.render = render
    return seen


@torch.no_grad()
def recorded_kernel_vs_plain(seen: dict) -> dict:
    """The mask kernel against its plain version on the segments of every
    joints record_renders kept, flattened as the renderer flattens them.
    Returns {"masks_checked", "differ" (pixels), "shapes"}; the pixels must
    be equal bit for bit."""
    masks = differ = 0
    shapes = []
    for r, qpos in seen.values():
        shapes.append(list(qpos.shape))
        segs = r.segment_params(qpos)
        flat = segs.reshape((-1,) + segs.shape[-2:]).float().contiguous()
        got = kernels.capsule_mask_render(flat, r.h, r.w)
        differ += int((got != kernels.capsule_mask_render_plain(flat, r.h, r.w)).sum())
        masks += flat.shape[0]
    out = dict(masks_checked=masks, differ=differ,
               shapes=shapes)
    if differ or not masks:
        raise AssertionError(f"mask kernel vs plain on a finetune's windows: {out}")
    return out
