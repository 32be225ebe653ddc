"""CDNA compositing video-prediction models.

Counterpart of `robot_aware_control_tpu/models/cdna.py` (reference:
src/prediction/models/dynamics.py:647-815, decoders vgg_64.py:245-376,
kernel ops cdna.py:7-117):

  ConvEncoder -> [tile action/state, 3x3 conv fuse] -> 2-cell ConvLSTM ->
  MaskDecoder (upsampling stack -> 2 F channels) ->
  F = 13 CDNA kernels (one applied to the context image, F - 1 to the
  previous image) + F softmax compositing masks -> the masked composite.

The ConvLSTM is g_dim -> g_dim and, at inference (`cfg.fused_lstm and not
train`), runs the hand cell kernel (ops/kernels.py), as the JAX model takes
its fused Pallas cell there; at g_dim 256 in bf16 that is the wgmma/TMA
kernel. The kernels' application is one `torch.einsum` over k x k
neighbourhoods, as the JAX model's is one einsum outside any Pallas kernel.

Like the JAX model, this follows the reference's intent, not its shipped
code (which cannot run, `cdna.py:25-35`): the compositing masks are a
softmax across flows per pixel. Dtypes are the JAX model's: the kernels
normalised in the compute dtype, the masks' softmax in float32 cast to the
warped images' dtype, the robonet attention in float32.

`CDNARobonet` (--model cdna_robonet) adds dot-product attention of each
encoding over a rolling buffer of the last 16 (reference:
dynamics.py:728-815). Its step counter is a device tensor, and the buffer
is written by `index_copy` at t mod 16: no host sync.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models.common import init_weights
from robot_aware_control_tpu_torch.models.svg import _tile, compute_dtype
from robot_aware_control_tpu_torch.ops import lstm as L
from robot_aware_control_tpu_torch.ops import nn as N
from robot_aware_control_tpu_torch.ops.encoders import ConvEncoder
from robot_aware_control_tpu_torch.utils.device import resolve_device

NUM_FLOWS = 13
RELU_SHIFT = 1e-12


class Carry(NamedTuple):
    frame: tuple


class RobonetCarry(NamedTuple):
    frame: tuple
    enc_buffer: torch.Tensor  # (B, T_MAX, fh * fw * g) rolling encodings
    t: torch.Tensor           # () int64 step counter, on the device


def extract_patches(img, k: int):
    """img (B, H, W, C) -> (B, H, W, k * k, C) zero-padded SAME
    neighbourhoods, row-major over the k x k window."""
    p = k // 2
    padded = F.pad(img, (0, 0, p, p, p, p))
    H, W = img.shape[1], img.shape[2]
    return torch.stack([padded[:, dy:dy + H, dx:dx + W]
                        for dy in range(k) for dx in range(k)], 3)


def apply_cdna_kernels(img, kernels):
    """img (B, H, W, C), kernels (B, k, k, F) normalised -> (B, H, W, F, C):
    out[b, h, w, f, c] = sum_p kernels[b, p, f] patches[b, h, w, p, c]
    (reference: cdna.py:7-117, one einsum instead of grouped convs)."""
    B, k = kernels.shape[0], kernels.shape[1]
    patches = extract_patches(img, k)
    kf = kernels.reshape(B, k * k, -1)
    return torch.einsum("bhwpc,bpf->bhwfc", patches, kf.to(patches.dtype))


class MaskDecoder(nn.Module):
    """latent (H/8, W/8, dim) -> 2F channels at full resolution
    (reference: vgg_64.py:245-297)."""

    def __init__(self, dim: int, out_ch: int, dtype=torch.float32, device=None):
        super().__init__()
        self.upc2 = N.vgg_stack([dim, 512, 512, 256], dtype, device)
        self.upc3 = N.vgg_stack([256, 256, 256, 128], dtype, device)
        self.upc4 = N.vgg_stack([128, 128, 64], dtype, device)
        self.upc5 = N.vgg_stack([64, 64], dtype, device)
        self.out = N.Conv2d(64, out_ch, 3, dtype=dtype, device=device)

    def forward(self, vec, stats=None):
        d2 = self.upc2(vec, stats)
        d3 = self.upc3(N.upsample_nearest2(d2), stats)
        d4 = self.upc4(N.upsample_nearest2(d3), stats)
        d5 = self.upc5(N.upsample_nearest2(d4), stats)
        return self.out(d5)


def _lstm_in_channels(cfg: Config) -> int:
    c = cfg.g_dim + cfg.action_dim
    if cfg.model_use_robot_state:
        c += cfg.robot_dim
    return c


def _enc_channels(cfg: Config) -> int:
    c = cfg.channels
    if cfg.model_use_mask:
        c += 1
        if cfg.model_use_future_mask:
            c += 1
    return c


class CDNA(nn.Module):
    """--model cdna_det (JAX `cdna.step`; reference: dynamics.py:693-728)."""

    def __init__(self, cfg: Config, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        dt = param_dtype or compute_dtype(cfg)
        g = cfg.g_dim
        self.encoder = ConvEncoder(g, _enc_channels(cfg), dt, device)
        self.state_conv = N.Conv2d(_lstm_in_channels(cfg), g, 3, dtype=dt,
                                   device=device)
        self.frame_lstm = L.ConvLSTM(g, g, dt, device, cfg.lstm_group_norm)
        self.mask_decoder = MaskDecoder(g, 2 * NUM_FLOWS, dt, device)
        self.kernel_mlp = N.Linear(cfg.image_height * cfg.image_width,
                                   cfg.cdna_kernel_size ** 2, dt, device)

    def decode(self, prev_image, latent, context_image, stats):
        """(reference CDNADecoder: vgg_64.py:299-376) The composite of the
        context image warped by the first kernel and the previous image by
        the other F - 1, weighted by the softmax masks."""
        out = self.mask_decoder(latent, stats)
        kernel_maps, mask_maps = out[..., :NUM_FLOWS], out[..., NUM_FLOWS:]
        B, k = out.shape[0], self.cfg.cdna_kernel_size
        # per-flow kernels from the kernel maps flattened in NHWC order
        # (vgg_64.py:319-326): (B, H, W, F) -> (B, F, H * W)
        km = kernel_maps.reshape(B, -1, NUM_FLOWS).transpose(1, 2)
        kern = torch.relu(self.kernel_mlp(km) - RELU_SHIFT) + RELU_SHIFT
        kern = kern / kern.sum(-1, keepdim=True)  # normalised per flow
        kern = kern.transpose(1, 2).reshape(B, k, k, NUM_FLOWS)
        masks = torch.softmax(mask_maps.float(), -1)
        warped = torch.cat([apply_cdna_kernels(context_image, kern[..., :1]),
                            apply_cdna_kernels(prev_image, kern[..., 1:])], 3)
        return (masks[..., None].to(warped.dtype) * warped).sum(3)

    def _encode(self, image, mask, stats):
        img = torch.cat([image, mask], -1) if self.cfg.model_use_mask else image
        return self.encoder(img.to(compute_dtype(self.cfg)), stats)

    def _predict(self, h, carry_frame, image, robot, action, context_image,
                 train, stats):
        """The recurrence and the decoder from the step's encoding h."""
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        fh, fw = cfg.feat_height, cfg.feat_width
        feats = [_tile(action.to(dtype), fh, fw)]
        if cfg.model_use_robot_state:
            r = robot[0] if isinstance(robot, tuple) else robot
            feats.append(_tile(r.to(dtype), fh, fw))
        feed = self.state_conv(torch.cat(feats + [h], -1))
        h_pred, frame_carry = self.frame_lstm(feed, carry_frame,
                                              cfg.fused_lstm and not train)
        ctx = image if context_image is None else context_image
        c = cfg.channels
        x_pred = self.decode(image.to(dtype)[..., :c], h_pred,
                             ctx.to(dtype)[..., :c], stats)
        return x_pred, frame_carry

    def forward(self, carry: Carry, image, mask, robot, action,
                context_image=None, skip=None, use_curr_skip=None,
                train: bool = False):
        """One prediction step; context_image defaults to the current
        image. Returns (out, new_carry); out holds x_pred (B, H, W,
        channels), skip and curr_skip (the current frame's) and bn_stats."""
        stats = [] if train else None
        h, curr_skip = self._encode(image, mask, stats)
        x_pred, frame_carry = self._predict(h, carry.frame, image, robot,
                                            action, context_image, train, stats)
        out = {"x_pred": x_pred, "skip": curr_skip, "curr_skip": curr_skip,
               "bn_stats": stats}
        return out, Carry(frame_carry)


class CDNARobonet(CDNA):
    """--model cdna_robonet (JAX `cdna.robonet.step`; reference:
    dynamics.py:728-815, lstm.py:342-372): the current encoding plus its
    float32 dot-product attention over the buffer of the last T_MAX
    encodings, the current one written first."""

    T_MAX = 16

    def forward(self, carry: RobonetCarry, image, mask, robot, action,
                context_image=None, skip=None, use_curr_skip=None,
                train: bool = False):
        cfg = self.cfg
        stats = [] if train else None
        h, curr_skip = self._encode(image, mask, stats)
        B = h.shape[0]
        hv = h.reshape(B, -1)
        slot = (carry.t % self.T_MAX).reshape(1)
        buf = carry.enc_buffer.index_copy(
            1, slot, hv[:, None].to(carry.enc_buffer.dtype))
        bf = buf.float()
        scores = torch.einsum("bd,btd->bt", hv.float(), bf) / math.sqrt(hv.shape[-1])
        valid = torch.arange(self.T_MAX, device=hv.device) <= carry.t
        scores = scores.masked_fill(~valid[None], -1e9)
        h_att = torch.einsum("bt,btd->bd", torch.softmax(scores, -1), bf)
        h = (hv + h_att.to(hv.dtype)).reshape(B, cfg.feat_height,
                                              cfg.feat_width, -1)
        x_pred, frame_carry = self._predict(h, carry.frame, image, robot,
                                            action, context_image, train, stats)
        out = {"x_pred": x_pred, "skip": curr_skip, "curr_skip": curr_skip,
               "bn_stats": stats}
        return out, RobonetCarry(frame_carry, buf, carry.t + 1)


def init(cfg: Config, seed: int = 0, device="cuda", train: bool = False) -> CDNA:
    """A randomly initialised cdna_det model on `device` (models/common.py:
    `init_weights`); inference mode unless `train`."""
    model = CDNA(cfg, device=resolve_device(device),
                 param_dtype=torch.float32 if train else None)
    return init_weights(model, seed, train)


def init_carry(cfg: Config, batch: int, dtype=torch.float32,
               device=None) -> Carry:
    return Carry(frame=L.zero_state(batch, cfg.feat_height, cfg.feat_width,
                                    cfg.g_dim, dtype, device))


class robonet:
    """cdna_robonet's module protocol, as the JAX package's `cdna.robonet`."""

    Carry = RobonetCarry
    T_MAX = CDNARobonet.T_MAX

    @staticmethod
    def init(cfg: Config, seed: int = 0, device="cuda",
             train: bool = False) -> CDNARobonet:
        model = CDNARobonet(cfg, device=resolve_device(device),
                            param_dtype=torch.float32 if train else None)
        return init_weights(model, seed, train)

    @staticmethod
    def init_carry(cfg: Config, batch: int, dtype=torch.float32,
                   device=None) -> RobonetCarry:
        fh, fw = cfg.feat_height, cfg.feat_width
        return RobonetCarry(
            frame=L.zero_state(batch, fh, fw, cfg.g_dim, dtype, device),
            enc_buffer=torch.zeros(batch, robonet.T_MAX, fh * fw * cfg.g_dim,
                                   dtype=dtype, device=device),
            t=torch.zeros((), dtype=torch.long, device=device))
