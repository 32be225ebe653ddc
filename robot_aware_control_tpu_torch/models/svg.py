"""SVG conv video-prediction model (stochastic, learned prior).

Counterpart of `robot_aware_control_tpu/models/svg.py` (reference:
src/prediction/models/dynamics.py:457-644):

  ConvEncoder -> [tile action/state spatially, 3x3 conv fuse]
              -> 2-cell ConvLSTM frame predictor
              -> ConvDecoder with skips -> RGB + attention channel.
  Gaussian-ConvLSTM learned prior p(z|x_t,a_t,r_t) and posterior
  q(z|x_{t+1},r_{t+1}).

`SVG.forward` is the JAX package's `svg.step`. The recurrent state is
threaded through `Carry`; random draws come from an explicit
`torch.Generator`, or are passed in (`noise`), as the train step does so
that a checkpointed step recomputes the same draws. With `train=True`
BatchNorm normalizes by batch statistics and the step returns their
updates in `out["bn_stats"]`, in the order the JAX step threads its state:
the current-frame encoder, the next-frame encoder, the decoder; the
ConvLSTM cells take the autograd path. With `train=False` BatchNorm uses
its running statistics and the cells the hand kernel when
cfg.fused_lstm. As in the JAX package the posterior encodes the *next*
frame unless cfg.posterior_use_current_frame.

A model built for inference (`init`, `convert.svg_from_jax`) stores its
convolution weights in the compute dtype; one built for training
(`init(..., train=True)`) stores every parameter in float32, as the JAX
tree does, and each layer casts its weights to the activations' type at
use, so that the optimizer updates float32 master weights.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.ops import lstm as L
from robot_aware_control_tpu_torch.ops.encoders import ConvDecoder, ConvEncoder
from robot_aware_control_tpu_torch.ops.nn import BatchNorm, Conv2d
from robot_aware_control_tpu_torch.utils.device import resolve_device


class Carry(NamedTuple):
    frame: tuple
    prior: tuple
    posterior: tuple


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _lstm_channels(cfg: Config) -> int:
    c = cfg.g_dim + cfg.action_dim + cfg.z_dim
    if cfg.model_use_robot_state:
        c += cfg.robot_dim
    if cfg.model_use_future_robot_state:
        c += cfg.robot_dim
    return c


def _prior_channels(cfg: Config) -> int:
    c = cfg.g_dim + cfg.action_dim
    if cfg.model_use_robot_state:
        c += cfg.robot_dim
    if cfg.model_use_future_robot_state:
        c += cfg.robot_dim
    return c


def _post_channels(cfg: Config) -> int:
    c = cfg.g_dim
    if cfg.model_use_robot_state:
        c += cfg.robot_dim
    return c


def _tile(vec, fh, fw):
    """(B, D) -> (B, fh, fw, D) spatial tiling (reference: dynamics.py:592)."""
    return vec[:, None, None, :].expand(vec.shape[0], fh, fw, vec.shape[-1])


def _encoder_input(cfg: Config, image, mask, heatmap):
    """Channel-concat conditioning (reference: dynamics.py:577-582)."""
    parts = [image]
    if cfg.model_use_heatmap:
        parts.append(heatmap)
    if cfg.model_use_mask:
        parts.append(mask)
    return torch.cat(parts, -1) if len(parts) > 1 else image


class SVG(nn.Module):
    def __init__(self, cfg: Config, device=None, param_dtype=None):
        super().__init__()
        if cfg.lstm_group_norm:
            raise NotImplementedError(
                "lstm_group_norm: the GroupNorm ConvLSTM cell is not ported yet")
        if cfg.model_use_heatmap:
            raise NotImplementedError(
                "model_use_heatmap: heatmap conditioning is not ported yet")
        self.cfg = cfg
        dt = param_dtype or compute_dtype(cfg)
        g = cfg.g_dim
        self.encoder = ConvEncoder(g, cfg.enc_channels, dt, device)
        self.decoder = ConvDecoder(g, cfg.channels + 1, dt, device)
        self.frame_in = Conv2d(_lstm_channels(cfg), g, 3, dtype=dt, device=device)
        self.prior_in = Conv2d(_prior_channels(cfg), g, 3, dtype=dt, device=device)
        self.post_in = Conv2d(_post_channels(cfg), g, 3, dtype=dt, device=device)
        self.frame_lstm = L.ConvLSTM(g, g, dt, device)
        self.prior = L.GaussianConvLSTM(g, g, cfg.z_dim, dt, device)
        self.posterior = L.GaussianConvLSTM(g, g, cfg.z_dim, dt, device)

    def forward(self, carry: Carry, image, mask, robot, heatmap, action,
                generator: Optional[torch.Generator] = None, next_image=None,
                next_mask=None, next_robot=None, next_heatmap=None, skip=None,
                use_curr_skip: Optional[bool] = None,
                force_use_prior: bool = False, sample_mean: bool = False,
                train: bool = False, noise=None):
        """One prediction step (reference: dynamics.py:544-644).

        `noise` = (eps_prior, eps_post), float32 (B, fh, fw, z_dim) draws
        used in place of the generator's. Returns (out, new_carry); out
        holds x_pred (B, H, W, channels + 1), skip, curr_skip, the
        posterior/prior statistics mu/logvar, mu_p/logvar_p (None when
        unused) and bn_stats (the train-mode BatchNorm updates, else
        None)."""
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        fh, fw = cfg.feat_height, cfg.feat_width
        stats = [] if train else None
        fused = cfg.fused_lstm and not train
        eps_prior, eps_post = noise if noise is not None else (None, None)

        img = _encoder_input(cfg, image, mask, heatmap).to(dtype)
        h, curr_skip = self.encoder(img, stats)
        if cfg.last_frame_skip or skip is None:
            skip = curr_skip
        elif use_curr_skip is not None:
            skip = (curr_skip if use_curr_skip
                    else [s.to(c.dtype) for c, s in zip(curr_skip, skip)])

        a = _tile(action.to(dtype), fh, fw)
        if cfg.model_use_robot_state:
            if cfg.model_use_future_robot_state:
                r, r_next = robot
                frame_cond = [a, _tile(r.to(dtype), fh, fw),
                              _tile(r_next.to(dtype), fh, fw)]
            else:
                frame_cond = [a, _tile(robot.to(dtype), fh, fw)]
        else:
            frame_cond = [a]
        prior_in = self.prior_in(torch.cat(frame_cond + [h], -1))
        z_p, mu_p, logvar_p, prior_carry = self.prior(
            prior_in, carry.prior, generator, fused, eps_prior)
        z = mu_p if sample_mean else z_p

        mu = logvar = None
        post_carry = carry.posterior
        if next_image is not None:
            if cfg.posterior_use_current_frame:
                h_target = h  # reference behavior (dynamics.py:619)
            else:
                next_img = _encoder_input(cfg, next_image, next_mask,
                                          next_heatmap)
                h_target, _ = self.encoder(next_img.to(dtype), stats)
            if cfg.model_use_robot_state:
                post_feed = torch.cat(
                    [_tile(next_robot.to(dtype), fh, fw), h_target], -1)
            else:
                post_feed = h_target
            z_t, mu, logvar, post_carry = self.posterior(
                self.post_in(post_feed), carry.posterior, generator, fused,
                eps_post)
            if not force_use_prior:
                z = z_t

        frame_in = self.frame_in(torch.cat(frame_cond + [h, z.to(dtype)], -1))
        h_pred, frame_carry = self.frame_lstm(frame_in, carry.frame, fused)
        x_pred = self.decoder(h_pred, skip, stats)

        out = {"x_pred": x_pred, "skip": skip, "curr_skip": curr_skip,
               "mu": mu, "logvar": logvar, "mu_p": mu_p, "logvar_p": logvar_p,
               "bn_stats": stats}
        return out, Carry(frame_carry, prior_carry, post_carry)


@torch.no_grad()
def init(cfg: Config, seed: int = 0, device="cuda", train: bool = False) -> SVG:
    """A randomly initialised SVG model on `device` with the reference's
    SVG init (reference: src/prediction/models/base.py:26-35): weights
    N(0, 0.02), biases 0, BatchNorm scale N(1, 0.02), drawn on the CPU from
    `seed` in float32 and copied into each parameter's own type and device.
    In inference mode (no grad, weights in the compute dtype) unless
    `train`: then float32 parameters that require grad."""
    model = SVG(cfg, device=resolve_device(device),
                param_dtype=torch.float32 if train else None)
    gen = torch.Generator().manual_seed(seed)

    def normal(p, mean=0.0, std=0.02):
        p.copy_(mean + std * torch.randn(p.shape, generator=gen))

    for m in model.modules():
        if isinstance(m, (Conv2d, L.ConvLSTMCell)):
            normal(m.weight)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            normal(m.weight, mean=1.0)
            m.bias.zero_()
    if train:
        return model.train()
    return model.eval().requires_grad_(False)


def init_carry(cfg: Config, batch: int, dtype=torch.float32,
               device=None) -> Carry:
    fh, fw = cfg.feat_height, cfg.feat_width
    mk = lambda: L.zero_state(batch, fh, fw, cfg.g_dim, dtype, device)
    return Carry(frame=mk(), prior=mk(), posterior=mk())
