"""Learned robot dynamics MLPs (counterpart of
`robot_aware_control_tpu/models/robot_mlp.py`; reference:
src/prediction/models/dynamics.py:269-338 `JointPosPredictor`,
`GripperStatePredictor`): three hidden layers of 512 with ReLU, predicting
the delta of the joint positions or of the eef state from the current
value and the action. The learned-robot finetune path renders their
predicted joints into masks (reference: trainer.py:205-231).

Parameters map to the JAX trees {"l1", "l2", "l3", "out"} x {"w", "b"}
through `convert.robot_mlp_state_dict` / `convert.robot_mlp_tree`.
"""

from __future__ import annotations

import torch
from torch import nn

from robot_aware_control_tpu_torch.config import Config

HIDDEN = 512
LAYERS = ("l1", "l2", "l3", "out")


class RobotMLP(nn.Module):
    """x -> delta: three ReLU hidden layers and a linear output, weights
    N(0, 0.02) and biases 0 (JAX `nn.linear_init`) drawn from `seed`."""

    def __init__(self, din: int, dout: int, hidden: int = HIDDEN, seed: int = 0,
                 device="cpu"):
        super().__init__()
        dims = (din, hidden, hidden, hidden, dout)
        for name, (i, o) in zip(LAYERS, zip(dims[:-1], dims[1:])):
            setattr(self, name, nn.Linear(i, o, device=device))
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name in LAYERS:
                layer = getattr(self, name)
                layer.weight.copy_(0.02 * torch.randn(layer.weight.shape,
                                                      generator=gen))
                layer.bias.zero_()

    def forward(self, x):
        h = torch.relu(self.l1(x))
        h = torch.relu(self.l2(h))
        h = torch.relu(self.l3(h))
        return self.out(h)


class JointPosPredictor(RobotMLP):
    """qpos x action -> delta qpos (reference: dynamics.py:269-302)."""

    def __init__(self, cfg: Config, seed: int = 0, device="cpu"):
        super().__init__(cfg.robot_joint_dim + cfg.action_dim,
                         cfg.robot_joint_dim, seed=seed, device=device)

    def forward(self, joints, action):
        return super().forward(torch.cat([joints, action], -1))


class GripperStatePredictor(RobotMLP):
    """eef state x action -> delta eef state (reference: dynamics.py:305-338)."""

    def __init__(self, cfg: Config, seed: int = 0, device="cpu"):
        super().__init__(cfg.robot_dim + cfg.action_dim, cfg.robot_dim,
                         seed=seed, device=device)

    def forward(self, eef_pose, action):
        return super().forward(torch.cat([eef_pose, action], -1))
