"""SVG conv video-prediction model (stochastic, learned prior).

Counterpart of `robot_aware_control_tpu/models/svg.py` (reference:
src/prediction/models/dynamics.py:457-644):

  ConvEncoder -> [tile action/state spatially, 3x3 conv fuse]
              -> 2-cell ConvLSTM frame predictor
              -> ConvDecoder with skips -> RGB + attention channel.
  Gaussian-ConvLSTM learned prior p(z|x_t,a_t,r_t) and posterior
  q(z|x_{t+1},r_{t+1}).

`SVG.forward` is the JAX package's `svg.step` at inference: BatchNorm uses
its running statistics, the recurrent state is threaded through `Carry`,
and random draws come from an explicit `torch.Generator`. As in the JAX
package the posterior encodes the *next* frame unless
cfg.posterior_use_current_frame. Planning never runs the posterior; it is
here so that trained parameters load whole.
"""

from __future__ import annotations

from typing import NamedTuple

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
    def __init__(self, cfg: Config, device=None):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype(cfg)
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
                generator: torch.Generator, next_image=None, next_mask=None,
                next_robot=None, next_heatmap=None, skip=None,
                force_use_prior: bool = False, sample_mean: bool = False):
        """One prediction step (reference: dynamics.py:544-644).

        Returns (out, new_carry); out holds x_pred (B, H, W, channels + 1),
        skip, curr_skip and the posterior/prior statistics mu/logvar,
        mu_p/logvar_p (None when unused)."""
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        fh, fw = cfg.feat_height, cfg.feat_width

        img = _encoder_input(cfg, image, mask, heatmap).to(dtype)
        h, curr_skip = self.encoder(img)
        if cfg.last_frame_skip or skip is None:
            skip = curr_skip

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
            prior_in, carry.prior, generator)
        z = mu_p if sample_mean else z_p

        mu = logvar = None
        post_carry = carry.posterior
        if next_image is not None:
            if cfg.posterior_use_current_frame:
                h_target = h  # reference behavior (dynamics.py:619)
            else:
                next_img = _encoder_input(cfg, next_image, next_mask,
                                          next_heatmap)
                h_target, _ = self.encoder(next_img.to(dtype))
            if cfg.model_use_robot_state:
                post_feed = torch.cat(
                    [_tile(next_robot.to(dtype), fh, fw), h_target], -1)
            else:
                post_feed = h_target
            z_t, mu, logvar, post_carry = self.posterior(
                self.post_in(post_feed), carry.posterior, generator)
            if not force_use_prior:
                z = z_t

        frame_in = self.frame_in(torch.cat(frame_cond + [h, z.to(dtype)], -1))
        h_pred, frame_carry = self.frame_lstm(frame_in, carry.frame)
        x_pred = self.decoder(h_pred, skip)

        out = {"x_pred": x_pred, "skip": skip, "curr_skip": curr_skip,
               "mu": mu, "logvar": logvar, "mu_p": mu_p, "logvar_p": logvar_p}
        return out, Carry(frame_carry, prior_carry, post_carry)


@torch.no_grad()
def init(cfg: Config, seed: int = 0, device="cuda") -> SVG:
    """A randomly initialised SVG model on `device`, in inference mode,
    with the reference's SVG init (reference:
    src/prediction/models/base.py:26-35): weights N(0, 0.02), biases 0,
    BatchNorm scale N(1, 0.02), drawn on the CPU from `seed` in float32 and
    copied into each parameter's own type and device."""
    model = SVG(cfg, device=resolve_device(device))
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
    return model.eval().requires_grad_(False)


def init_carry(cfg: Config, batch: int, dtype=torch.float32,
               device=None) -> Carry:
    fh, fw = cfg.feat_height, cfg.feat_width
    mk = lambda: L.zero_state(batch, fh, fw, cfg.g_dim, dtype, device)
    return Carry(frame=mk(), prior=mk(), posterior=mk())
