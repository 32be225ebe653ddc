"""Learned robot-model training: `JointPosPredictor` and
`GripperStatePredictor` (counterpart of
`robot_aware_control_tpu/training/robot_trainer.py`; reference:
src/prediction/joint_pos_trainer.py:36-633).

    python -m robot_aware_control_tpu_torch.training.robot_trainer \\
        --device cuda --robot_dim 5 --robot_joint_dim 5 --action_dim 5 \\
        [--niter N --batch_size B --lr LR --log_dir D --jobname J]

Trains the two delta MLPs on (qpos, eef state, action) sequences with the
MSE of both deltas and one Adam update a batch, evaluates them by an
autoregressive state rollout, and scores the masks of the predicted joints
against those of the true joints by IoU (the capsule renderer: its CUDA
kernel on the GPU). Writes the `{joint_model, gripper_model}` checkpoint
(reference: trainer.py:839-844) in the JAX package's layout, which the
finetune trainer's --robot_model_ckpt reads in either package.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from robot_aware_control_tpu_torch import convert
from robot_aware_control_tpu_torch.config import Config, argparser
from robot_aware_control_tpu_torch.models.robot_mlp import (
    GripperStatePredictor,
    JointPosPredictor,
)
from robot_aware_control_tpu_torch.robot import locobot_kinematics as lk
from robot_aware_control_tpu_torch.robot.mask_renderer import CapsuleMaskRenderer
from robot_aware_control_tpu_torch.training import checkpoint as ckpt
from robot_aware_control_tpu_torch.training.logger import RunLogger, make_log_folder
from robot_aware_control_tpu_torch.utils.device import resolve_device

ROBOT_TREES = ("joint_model", "gripper_model")


class JointPosDataset:
    """(qpos, eef state, action) sequences (reference:
    src/dataset/joint_pos_dataset.py:20-218): planar-push trajectories
    through the locobot's analytic kinematics, drawn from a numpy
    RandomState in the JAX dataset's order."""

    def __init__(self, cfg: Config, num: int = 256, T: int = 8, seed: int = 0):
        rng = np.random.RandomState(seed)
        starts = np.stack([
            rng.uniform(0.1, 0.4, num), rng.uniform(-0.2, 0.2, num),
            np.full(num, lk.PUSH_HEIGHT)], -1).astype(np.float32)
        actions = rng.uniform(-0.04, 0.04, (T - 1, num, 2)).astype(np.float32)
        states, qpos = lk.integrate_planar_actions(
            torch.from_numpy(starts), torch.zeros(num, 5), torch.from_numpy(actions))
        self.states = states.numpy()[:, :, : cfg.robot_dim]
        self.qpos = qpos.numpy()[:, :, : cfg.robot_joint_dim]
        self.actions = np.pad(actions, [(0, 0), (0, 0), (0, cfg.action_dim - 2)])
        self.num = num

    def batches(self, batch_size: int, seed: int = 0):
        """Time-first numpy batches of a seeded permutation; a last partial
        batch is dropped."""
        idx = np.random.RandomState(seed).permutation(self.num)
        for i in range(0, self.num - batch_size + 1, batch_size):
            j = idx[i:i + batch_size]
            yield {"states": self.states[:, j], "qpos": self.qpos[:, j],
                   "actions": self.actions[:, j]}


def robot_trees(joint, grip) -> dict:
    """The two MLPs as the checkpoint's named flat trees (JAX layout)."""
    return {"joint_model": convert.robot_mlp_tree(joint),
            "gripper_model": convert.robot_mlp_tree(grip)}


def load_robot_models(path: str, joint, grip):
    """Loads a {joint_model, gripper_model} checkpoint of either package
    into the two MLPs (strict: every leaf, with its shape)."""
    trees, _ = ckpt.load_checkpoint(path, robot_trees(joint, grip))
    for module, name in ((joint, "joint_model"), (grip, "gripper_model")):
        module.load_state_dict(convert.robot_mlp_state_dict(trees[name]),
                               strict=True)


def rollout(joint, grip, states0, qpos0, actions):
    """Autoregressive delta rollout: states0 (B, rd), qpos0 (B, jd),
    actions (T-1, B, A) -> (states (T-1, B, rd), qpos (T-1, B, jd)), the
    predicted steps after the first."""
    s, q = states0, qpos0
    ss, qs = [], []
    for a in actions:
        s = s + grip(s, a)
        q = q + joint(q, a)
        ss.append(s)
        qs.append(q)
    return torch.stack(ss), torch.stack(qs)


class RobotPredictionTrainer:
    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.log_dir = make_log_folder(cfg)
        self.logger = RunLogger(cfg, self.log_dir)
        self.joint = JointPosPredictor(cfg, seed=cfg.seed, device=self.device)
        self.grip = GripperStatePredictor(cfg, seed=cfg.seed + 1,
                                          device=self.device)
        # optax.adam(lr, b1=beta1): b2 0.999, eps 1e-8
        self.optimizer = torch.optim.Adam(
            list(self.joint.parameters()) + list(self.grip.parameters()),
            lr=cfg.lr, betas=(cfg.beta1, 0.999), eps=1e-8)
        self._step = 0
        self.renderer = CapsuleMaskRenderer((cfg.image_height, cfg.image_width),
                                            modified=cfg.modified,
                                            device=self.device)

    def _tensors(self, batch):
        return {k: torch.as_tensor(v, device=self.device).float()
                for k, v in batch.items()}

    def train_step(self, batch) -> dict:
        """The MSE of both MLPs' deltas and one Adam update; metrics stay
        on the device."""
        b = self._tensors(batch)
        q, s, a = b["qpos"], b["states"], b["actions"]
        jl = ((self.joint(q[:-1], a) - (q[1:] - q[:-1])) ** 2).mean()
        gl = ((self.grip(s[:-1], a) - (s[1:] - s[:-1])) ** 2).mean()
        self.optimizer.zero_grad(set_to_none=True)
        (jl + gl).backward()
        self.optimizer.step()
        self._step += 1
        return {"joint_loss": jl.detach(), "gripper_loss": gl.detach()}

    @torch.no_grad()
    def eval_rollout(self, batch) -> dict:
        """Autoregressive rollout from the first step, its MSE against the
        true states and joints, and the IoU of the masks of the predicted
        and the true joints (reference: joint_pos_trainer.py:245-326)."""
        b = self._tensors(batch)
        q, s, a = b["qpos"], b["states"], b["actions"]
        ss, qq = rollout(self.joint, self.grip, s[0], q[0], a)
        pred = self.renderer.render(qq) > 0.5
        true = self.renderer.render(q[1:]) > 0.5
        inter = (pred & true).sum((-3, -2, -1))
        union = (pred | true).sum((-3, -2, -1))
        return {"qpos_rollout_mse": ((qq - q[1:]) ** 2).mean(),
                "state_rollout_mse": ((ss - s[1:]) ** 2).mean(),
                "mask_iou": (inter / union.clamp(min=1)).mean()}

    def train(self, train_data: Optional[JointPosDataset] = None,
              test_data: Optional[JointPosDataset] = None):
        cfg = self.cfg
        train_data = train_data or JointPosDataset(cfg, seed=cfg.seed)
        test_data = test_data or JointPosDataset(cfg, num=64, seed=cfg.seed + 1)
        for epoch in range(cfg.niter):
            agg, n = {}, 0
            for batch in train_data.batches(cfg.batch_size, seed=epoch):
                for k, v in self.train_step(batch).items():
                    agg[k] = agg[k] + v if k in agg else v
                n += 1
            # one host sync an epoch
            self.logger.scalars({k: float(v) / max(n, 1) for k, v in agg.items()},
                                self._step, prefix="robot/")
            if (epoch + 1) % cfg.eval_interval == 0:
                ev = self.evaluate(test_data)
                self.logger.scalars(ev, self._step, prefix="robot_eval/")
                self.logger.info(f"robot epoch {epoch}: " + " ".join(
                    f"{k}={v:.5f}" for k, v in ev.items()))
        self.save()
        return self.joint, self.grip

    def evaluate(self, test_data: JointPosDataset) -> dict:
        agg, n = {}, 0
        for batch in test_data.batches(min(self.cfg.test_batch_size, 64)):
            for k, v in self.eval_rollout(batch).items():
                agg[k] = agg[k] + v if k in agg else v
            n += 1
        return {k: float(v) / max(n, 1) for k, v in agg.items()}

    def save(self) -> str:
        """The {joint_model, gripper_model} checkpoint (reference contract:
        trainer.py:839-844) as ckpt_<step>.npz in the log dir."""
        path = ckpt.save_checkpoint(self.log_dir, self._step,
                                    robot_trees(self.joint, self.grip))
        self.logger.info(f"saved robot model {path}")
        return path


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="cuda (default) or cpu; there is no fallback")
    args, rest = pre.parse_known_args(argv)
    cfg, unparsed = argparser(rest)
    if unparsed:
        raise ValueError(f"unknown flags: {unparsed}")
    trainer = RobotPredictionTrainer(cfg, device=args.device)
    try:
        trainer.train()
    finally:
        trainer.logger.close()


if __name__ == "__main__":
    main()
