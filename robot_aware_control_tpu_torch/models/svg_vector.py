"""Vector-latent SVG and deterministic models (fc-LSTM bottleneck).

Counterpart of `robot_aware_control_tpu/models/svg_vector.py` (reference:
src/prediction/models/dynamics.py:75-266): the VGG encoder bottlenecks each
frame to a g_dim vector; MLP encoders embed the action and the robot state;
fc-LSTM stacks predict the next latent; Gaussian fc-LSTMs give the learned
prior p(z | h, a, r) and the posterior q(z | h_next, r_next); the VGG
decoder reconstructs the frame from the predicted latent and the skips. The
output is the frame itself (no attention channel to composite).

`SVGVec` (--model svg_vec) and `DetVec` (--model det_vec) step as the conv
models do: `forward(carry, ...) -> (out, new_carry)`, with the prior's and
posterior's N(0, 1) draws from a `torch.Generator` or passed in (`noise`,
each (B, z_dim) float32), and the encoder's channel dropout (cfg.dropout,
train mode only) from keep masks passed in (`drop`,
training/step.py:draw_noise): the current frame's four masks, and for
SVGVec the next frame's own four (the JAX step folds salt 101 into its
dropout key for it). Without masks no dropout is applied. Their LSTMs are
products outside any hand kernel, as in the JAX package, whose Pallas cell
is the conv cell alone.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models.common import init_weights
from robot_aware_control_tpu_torch.models.svg import compute_dtype
from robot_aware_control_tpu_torch.ops import lstm as L
from robot_aware_control_tpu_torch.ops.encoders import Decoder, Encoder
from robot_aware_control_tpu_torch.ops.nn import Linear, MLPEncoder
from robot_aware_control_tpu_torch.utils.device import resolve_device


class Carry(NamedTuple):
    frame: tuple
    prior: tuple
    posterior: tuple


class DetCarry(NamedTuple):
    frame: tuple


def _feat_hw(cfg: Config):
    return (cfg.image_height // 16, cfg.image_width // 16)


def _enc_channels(cfg: Config) -> int:
    c = cfg.channels
    if cfg.model_use_mask:
        c += 1
        if cfg.model_use_future_mask:
            c += 1
    return c


def _frame_in_dim(cfg: Config, stochastic: bool) -> int:
    d = cfg.action_enc_dim + cfg.g_dim
    if stochastic:
        d += cfg.z_dim
    if cfg.model_use_robot_state:
        d += cfg.robot_enc_dim
    return d


class Attention(nn.Module):
    """The background-attention module (JAX `svg_vector.py:attention`;
    reference: src/prediction/models/base.py:34-62): present but unused by
    the reference trainer, kept as the JAX module keeps it. Scores each
    feature vector against a learned query: feats (B, T, D) -> (B, D)."""

    def __init__(self, dim: int, hidden: int = 32, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.q = Linear(dim, hidden, dtype, device)
        self.k = Linear(dim, hidden, dtype, device)

    def forward(self, feats):
        q = self.q(feats.mean(1))
        k = self.k(feats)
        scores = torch.softmax(
            torch.einsum("bh,bth->bt", q, k) / math.sqrt(q.shape[-1]), -1)
        return torch.einsum("bt,btd->bd", scores, feats)


def _select_skip(skip, curr_skip, use_curr_skip, last_frame_skip):
    """(JAX `svg_vector.py:_select_skip`)"""
    if last_frame_skip or skip is None:
        return curr_skip
    if use_curr_skip is not None:
        return (curr_skip if use_curr_skip
                else [s.to(c.dtype) for c, s in zip(curr_skip, skip)])
    return skip


class _VectorModel(nn.Module):
    def __init__(self, cfg: Config, stochastic: bool, device=None,
                 param_dtype=None):
        super().__init__()
        self.cfg = cfg
        dt = param_dtype or compute_dtype(cfg)
        g, hw = cfg.g_dim, _feat_hw(cfg)
        self.encoder = Encoder(g, _enc_channels(cfg), hw, dt, device)
        self.decoder = Decoder(g, cfg.channels, hw, dt, device)
        self.action_enc = MLPEncoder(cfg.action_dim, cfg.action_enc_dim,
                                     dtype=dt, device=device)
        if cfg.model_use_robot_state:
            self.robot_enc = MLPEncoder(cfg.robot_dim, cfg.robot_enc_dim,
                                        dtype=dt, device=device)
        self.frame_lstm = L.LSTM(_frame_in_dim(cfg, stochastic), g,
                                 cfg.rnn_size, cfg.predictor_rnn_layers, dt,
                                 device)
        if stochastic:
            prior_dim = cfg.action_enc_dim + g
            post_dim = g
            if cfg.model_use_robot_state:
                prior_dim += cfg.robot_enc_dim
                post_dim += cfg.robot_enc_dim
            self.prior = L.GaussianLSTM(prior_dim, cfg.z_dim, cfg.rnn_size,
                                        cfg.prior_rnn_layers, dt, device)
            self.posterior = L.GaussianLSTM(post_dim, cfg.z_dim, cfg.rnn_size,
                                            cfg.posterior_rnn_layers, dt,
                                            device)

    def _encode(self, image, mask, stats, keep):
        cfg = self.cfg
        img = torch.cat([image, mask], -1) if cfg.model_use_mask else image
        return self.encoder(img.to(compute_dtype(cfg)), stats, keep,
                            cfg.dropout)

    def _cond(self, action, robot):
        """The embedded action (and robot state) of the step."""
        dtype = compute_dtype(self.cfg)
        feats = [self.action_enc(action.to(dtype))]
        if self.cfg.model_use_robot_state:
            r = robot[0] if isinstance(robot, tuple) else robot
            feats.append(self.robot_enc(r.to(dtype)))
        return feats


class SVGVec(_VectorModel):
    """The stochastic vector model (JAX `svg_vector.step`; reference
    SVGModel, dynamics.py:159-266)."""

    def __init__(self, cfg: Config, device=None, param_dtype=None):
        super().__init__(cfg, True, device, param_dtype)

    def forward(self, carry: Carry, image, mask, robot, heatmap, action,
                generator: Optional[torch.Generator] = None, next_image=None,
                next_mask=None, next_robot=None, skip=None,
                use_curr_skip: Optional[bool] = None,
                force_use_prior: bool = False, sample_mean: bool = False,
                train: bool = False, noise=None, drop=None):
        """One prediction step. `heatmap` is ignored, as in the JAX step.
        `noise` = (eps_prior, eps_post) (B, z_dim) float32 draws used in
        place of the generator's; `drop` = (the current frame's keep masks,
        the next frame's), each a list of four (B, C) masks or None.
        Returns (out, new_carry); out holds x_pred (B, H, W, channels),
        skip, curr_skip, mu/logvar (None without next_image), mu_p/logvar_p
        and bn_stats (the train-mode BatchNorm updates, else None)."""
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        stats = [] if train else None
        eps_prior, eps_post = noise if noise is not None else (None, None)
        keep, keep_next = drop if drop is not None else (None, None)
        h, curr_skip = self._encode(image, mask, stats, keep)
        skip = _select_skip(skip, curr_skip, use_curr_skip, cfg.last_frame_skip)
        feats = self._cond(action, robot)
        z_p, mu_p, logvar_p, prior_carry = self.prior(
            torch.cat(feats + [h], -1), carry.prior, generator, eps_prior)
        z = mu_p if sample_mean else z_p

        mu = logvar = None
        post_carry = carry.posterior
        if next_image is not None:
            h_t, _ = self._encode(next_image, next_mask, stats, keep_next)
            post_feats = [h_t]
            if cfg.model_use_robot_state:
                post_feats = [self.robot_enc(next_robot.to(dtype)), h_t]
            z_t, mu, logvar, post_carry = self.posterior(
                torch.cat(post_feats, -1), carry.posterior, generator, eps_post)
            if not force_use_prior:
                z = z_t

        h_pred, frame_carry = self.frame_lstm(
            torch.cat(feats + [h, z.to(dtype)], -1), carry.frame)
        x_pred = self.decoder(h_pred, skip, stats)
        out = {"x_pred": x_pred, "skip": skip, "curr_skip": curr_skip,
               "mu": mu, "logvar": logvar, "mu_p": mu_p, "logvar_p": logvar_p,
               "bn_stats": stats}
        return out, Carry(frame_carry, prior_carry, post_carry)


class DetVec(_VectorModel):
    """The deterministic vector model (JAX `svg_vector.det`; reference
    DeterministicModel, dynamics.py:75-156)."""

    def __init__(self, cfg: Config, device=None, param_dtype=None):
        super().__init__(cfg, False, device, param_dtype)

    def forward(self, carry: DetCarry, image, mask, robot, action, skip=None,
                use_curr_skip=None, train: bool = False, drop=None):
        """One prediction step; `drop` the current frame's four keep masks
        or None. Returns (out, new_carry); out holds x_pred, skip,
        curr_skip and bn_stats."""
        cfg = self.cfg
        stats = [] if train else None
        h, curr_skip = self._encode(image, mask, stats, drop)
        skip = _select_skip(skip, curr_skip, use_curr_skip, cfg.last_frame_skip)
        h_pred, frame_carry = self.frame_lstm(
            torch.cat(self._cond(action, robot) + [h], -1), carry.frame)
        x_pred = self.decoder(h_pred, skip, stats)
        out = {"x_pred": x_pred, "skip": skip, "curr_skip": curr_skip,
               "bn_stats": stats}
        return out, DetCarry(frame_carry)


def init(cfg: Config, seed: int = 0, device="cuda", train: bool = False) -> SVGVec:
    """A randomly initialised svg_vec model on `device` (models/common.py:
    `init_weights`); inference mode unless `train`."""
    model = SVGVec(cfg, device=resolve_device(device),
                   param_dtype=torch.float32 if train else None)
    return init_weights(model, seed, train)


def init_carry(cfg: Config, batch: int, dtype=torch.float32,
               device=None) -> Carry:
    mk = lambda n: L.lstm_zero_state(batch, cfg.rnn_size, n, dtype, device)
    return Carry(frame=mk(cfg.predictor_rnn_layers),
                 prior=mk(cfg.prior_rnn_layers),
                 posterior=mk(cfg.posterior_rnn_layers))


class det:
    """The deterministic vector model's module protocol (--model det_vec),
    as the JAX package's `svg_vector.det`."""

    Carry = DetCarry

    @staticmethod
    def init(cfg: Config, seed: int = 0, device="cuda",
             train: bool = False) -> DetVec:
        model = DetVec(cfg, device=resolve_device(device),
                       param_dtype=torch.float32 if train else None)
        return init_weights(model, seed, train)

    @staticmethod
    def init_carry(cfg: Config, batch: int, dtype=torch.float32,
                   device=None) -> DetCarry:
        return DetCarry(frame=L.lstm_zero_state(
            batch, cfg.rnn_size, cfg.predictor_rnn_layers, dtype, device))
