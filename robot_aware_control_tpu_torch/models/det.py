"""Deterministic ConvLSTM video-prediction model.

Counterpart of `robot_aware_control_tpu/models/det.py` (reference:
`DeterministicConvModel`, src/prediction/models/dynamics.py:363-454):
ConvEncoder -> [action/state projected by a Linear into 2-channel maps at
(H/8, W/8)] -> 2-cell ConvLSTM -> ConvDecoder with skips, with the extra
attention channel for compositing. No prior, no posterior, no draws.

The ConvLSTM runs g_dim + 2 action maps (+ 2 state maps) channels, 260 at
g_dim 256 (258 without the state maps): not a multiple of 8, so a
contiguous (B, H, W, 260) bf16 tensor has 520-byte pixel rows, which TMA
cannot describe. The cell input and the carries are therefore views of
buffers padded to a multiple of 8 channels a pixel (kernels.padded_nhwc;
the lanes past 260 are never read), and the wgmma/TMA kernel reads them
in place (ops/kernels.py:tma_ready; a contiguous input would be copied
into such a view first) with the parameters' shapes unchanged. Public
shapes stay (B, H, W, 260); only strides differ.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models.common import init_weights
from robot_aware_control_tpu_torch.models.svg import compute_dtype
from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.ops import lstm as L
from robot_aware_control_tpu_torch.ops.encoders import ConvDecoder, ConvEncoder
from robot_aware_control_tpu_torch.ops.nn import Linear
from robot_aware_control_tpu_torch.utils.device import resolve_device


class Carry(NamedTuple):
    frame: tuple


def _lstm_channels(cfg: Config) -> int:
    # g_dim + 2 action channels (+ 2 state channels) (reference: dynamics.py:403)
    return cfg.g_dim + 2 + (2 if cfg.model_use_robot_state else 0)


class Det(nn.Module):
    def __init__(self, cfg: Config, device=None, param_dtype=None):
        super().__init__()
        if cfg.model_use_heatmap:
            # the JAX model's encoder would take the heatmap channels that
            # its step never feeds (det.py:83-86)
            raise ValueError("model det takes no heatmap conditioning")
        self.cfg = cfg
        dt = param_dtype or compute_dtype(cfg)
        fmap = cfg.feat_height * cfg.feat_width * 2
        c = _lstm_channels(cfg)
        self.encoder = ConvEncoder(cfg.g_dim, cfg.enc_channels, dt, device)
        self.decoder = ConvDecoder(c, cfg.channels + 1, dt, device)
        self.action_enc = Linear(cfg.action_dim, fmap, dt, device)
        if cfg.model_use_robot_state:
            self.state_enc = Linear(cfg.robot_dim, fmap, dt, device)
        self.frame_lstm = L.ConvLSTM(c, c, dt, device, cfg.lstm_group_norm)

    def forward(self, carry: Carry, image, mask, robot, action, skip=None,
                use_curr_skip=None, train: bool = False):
        """One prediction step (reference: dynamics.py:422-454). Returns
        (out, new_carry); out holds x_pred (B, H, W, channels + 1), skip,
        curr_skip and bn_stats (the train-mode BatchNorm updates, else
        None). The skip is the current frame's unless one is given, as the
        JAX step does whatever cfg.last_frame_skip says."""
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        fh, fw = cfg.feat_height, cfg.feat_width
        stats = [] if train else None
        img = torch.cat([image, mask], -1) if cfg.model_use_mask else image
        h, curr_skip = self.encoder(img.to(dtype), stats)
        if skip is None:
            skip = curr_skip
        elif use_curr_skip is not None:
            skip = (curr_skip if use_curr_skip
                    else [s.to(c.dtype) for c, s in zip(curr_skip, skip)])
        feats = [h, self.action_enc(action.to(dtype)).reshape(-1, fh, fw, 2)]
        if cfg.model_use_robot_state:
            feats.append(self.state_enc(robot.to(dtype)).reshape(-1, fh, fw, 2))
        # the cell input, written by one cat into a buffer padded to a
        # multiple of 8 channels a pixel and viewed at its width
        c = sum(f.shape[-1] for f in feats)
        pad = h.new_empty(*h.shape[:3], kernels.round_up(c) - c)
        x = torch.cat(feats + [pad], -1)[..., :c]
        h_pred, frame_carry = self.frame_lstm(
            x, carry.frame, cfg.fused_lstm and not train)
        x_pred = self.decoder(h_pred, skip, stats)
        out = {"x_pred": x_pred, "skip": skip, "curr_skip": curr_skip,
               "bn_stats": stats}
        return out, Carry(frame_carry)


def init(cfg: Config, seed: int = 0, device="cuda", train: bool = False) -> Det:
    """A randomly initialised det model on `device` (models/common.py:
    `init_weights`); inference mode unless `train`."""
    model = Det(cfg, device=resolve_device(device),
                param_dtype=torch.float32 if train else None)
    return init_weights(model, seed, train)


def init_carry(cfg: Config, batch: int, dtype=torch.float32,
               device=None) -> Carry:
    """Zero carries, views of buffers padded to a multiple of 8 channels a
    pixel (the cell kernel returns h' and c' in the same layout)."""
    fh, fw = cfg.feat_height, cfg.feat_width
    return Carry(frame=L.zero_state(batch, fh, fw, _lstm_channels(cfg), dtype,
                                    device))
