"""Inverse models: (start image, goal image) -> action sequence.

Counterpart of `robot_aware_control_tpu/models/inverse_model.py`
(reference: robonet/robonet/inverse_model/models/
deterministic_inverse_model.py:12-59 and discretized_inverse_model.py):
a conv stack encodes the start and goal frames, their embeddings are
concatenated, and an MLP regresses the T actions, either as a continuous
MSE head or as per-dimension classification over `bins` bins.

    model = init(cfg, horizon, device="cuda")
    step, optimizer = make_inverse_train_step(cfg, horizon, model)
    loss = step(start, goal, actions)   # one Adam step, loss on the device
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models.common import init_weights
from robot_aware_control_tpu_torch.ops.nn import Conv2d, Linear
from robot_aware_control_tpu_torch.utils.device import resolve_device


class _ConvStack(nn.Module):
    """Three stride-2 SAME convolutions (5x5, 3x3, 3x3) with ReLU, then a
    global average pool (JAX `inverse_model._encode`)."""

    def __init__(self, in_ch: int, width: int, device=None):
        super().__init__()
        self.c1 = Conv2d(in_ch, width, 5, device=device, stride=2)
        self.c2 = Conv2d(width, width * 2, 3, device=device, stride=2)
        self.c3 = Conv2d(width * 2, width * 4, 3, device=device, stride=2)

    def forward(self, x):
        h = torch.relu(self.c1(x))
        h = torch.relu(self.c2(h))
        h = torch.relu(self.c3(h))
        return h.mean((1, 2))


class InverseModel(nn.Module):
    """encoder (shared by both frames) -> fc1 -> fc2 -> out, float32."""

    def __init__(self, cfg: Config, horizon: int, width: int = 32,
                 discretized: bool = False, bins: int = 0, device=None):
        super().__init__()
        self.cfg, self.horizon = cfg, horizon
        self.discretized, self.bins = discretized, bins
        out_dim = horizon * cfg.action_dim * (bins if discretized else 1)
        self.encoder = _ConvStack(cfg.channels, width, device)
        self.fc1 = Linear(width * 8, 256, device=device)
        self.fc2 = Linear(256, 256, device=device)
        self.out = Linear(256, out_dim, device=device)

    def forward(self, start_img, goal_img):
        """(B, H, W, C) frames -> (B, T, A) actions, or (B, T, A, bins)
        logits if discretized."""
        h = torch.cat([self.encoder(start_img), self.encoder(goal_img)], -1)
        h = torch.relu(self.fc1(h))
        h = torch.relu(self.fc2(h))
        out = self.out(h)
        shape = (start_img.shape[0], self.horizon, self.cfg.action_dim)
        return out.reshape(shape + ((self.bins,) if self.discretized else ()))


def init(cfg: Config, horizon: int, width: int = 32, discretized: bool = False,
         bins: int = 0, seed: int = 0, device="cuda") -> InverseModel:
    """A randomly initialised inverse model (models/common.py:
    `init_weights`) in train mode; bins > 0 with `discretized`."""
    model = InverseModel(cfg, horizon, width, discretized, bins,
                         resolve_device(device))
    return init_weights(model, seed, train=True)


def apply(model: InverseModel, start_img, goal_img):
    """(JAX `inverse_model.apply`)"""
    return model(start_img, goal_img)


def make_inverse_train_step(cfg: Config, horizon: int, model: InverseModel,
                            lr: float = 1e-3, discretized: bool = False,
                            bins: int = 11, action_low: float = -1.0,
                            action_high: float = 1.0):
    """One Adam step (optax.adam(lr)'s defaults: betas 0.9, 0.999, eps
    1e-8) on the MSE of the regressed actions or, discretized, the mean
    cross-entropy of the bins the actions fall in: (a - low) / (high - low)
    x bins truncated toward zero, as `astype(int32)` truncates, then
    clipped to [0, bins - 1]. `model` must have been built with the same
    head. Returns (step(start, goal, actions) -> loss, the optimizer)."""
    if model.discretized != discretized or (discretized and model.bins != bins):
        raise ValueError("the model's head differs from the train step's")
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8)

    def loss_fn(start, goal, actions):
        out = model(start, goal)
        if discretized:
            a01 = (actions - action_low) / (action_high - action_low)
            labels = (a01 * bins).to(torch.int64).clamp(0, bins - 1)
            return F.cross_entropy(out.reshape(-1, bins), labels.reshape(-1))
        return ((out - actions) ** 2).mean()

    def step(start, goal, actions):
        loss = loss_fn(start, goal, actions)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step, optimizer
