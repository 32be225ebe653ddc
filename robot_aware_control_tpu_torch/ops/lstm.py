"""Conv LSTM cells with explicit state (NHWC), counterpart of
`robot_aware_control_tpu/ops/lstm.py` (reference:
src/prediction/models/lstm.py:109-149, 201-286).

A cell has two paths, chosen as `lstm.py:conv_lstm` chooses between the
fused Pallas cell and the XLA cell:

  * fused (inference: planning and eval, `cfg.fused_lstm and not train`):
    `ops.kernels.conv_lstm_cell`, the CUDA kernel for GPU tensors and its
    plain version for CPU tensors; gates summed in float32. The kernel has
    no backward, and its wrapper raises under autograd.
  * autograd (training): `conv_lstm_cell_autograd`, the counterpart of the
    XLA cell `lstm.py:conv_lstm_cell`, one `F.conv2d` in the compute dtype
    and the update in x's type.

A cell keeps its gate weights in the kernel's layout, HWIO (k, k, in + hid,
4 hid), with gate order i, f, o, g, and its bias in float32; both paths
cast the weights to x's type at use.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.ops.nn import Conv2d


def conv_lstm_cell_autograd(x, h, c, w, b):
    """x (B,H,W,Cx), h/c (B,H,W,C), w (k,k,Cx+C,4C) HWIO, b (4C,): the JAX
    XLA cell (`lstm.py:39-51`). The gate convolution over cat(x, h) runs in
    x's type with the bias added in that type, and so do the nonlinearities
    and the state update. Returns (h_new, c_new)."""
    k = w.shape[0]
    xh = torch.cat([x, h.to(x.dtype)], -1).permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).to(x.dtype,
                                      memory_format=torch.channels_last)
    g = F.conv2d(xh, w_oihw, b.to(x.dtype), padding=k // 2)
    i, f, o, gc = g.permute(0, 2, 3, 1).chunk(4, -1)
    c_new = torch.sigmoid(f) * c.to(x.dtype) + torch.sigmoid(i) * torch.tanh(gc)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


class ConvLSTMCell(nn.Module):
    def __init__(self, in_ch: int, hid_ch: int, k: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            k, k, in_ch + hid_ch, 4 * hid_ch, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.empty(4 * hid_ch, device=device))

    def forward(self, x, state, fused: bool = True):
        """state = (h, c). Returns (h_new, (h_new, c_new))."""
        h, c = state
        if fused:
            h_new, c_new = kernels.conv_lstm_cell(
                x.contiguous(), h, c, self.weight.to(x.dtype), self.bias)
        else:
            h_new, c_new = conv_lstm_cell_autograd(x, h, c, self.weight,
                                                   self.bias)
        return h_new, (h_new, c_new)


class ConvLSTM(nn.Module):
    """2-cell stack: kernel 5 then kernel 3 (reference: lstm.py:206-212)."""

    def __init__(self, in_ch: int, hid_ch: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cell0 = ConvLSTMCell(in_ch, hid_ch, 5, dtype, device)
        self.cell1 = ConvLSTMCell(hid_ch, hid_ch, 3, dtype, device)

    def forward(self, x, state, fused: bool = True):
        s0, s1 = state
        h, s0 = self.cell0(x, s0, fused)
        h, s1 = self.cell1(h, s1, fused)
        return h, (s0, s1)


def zero_state(batch, fh, fw, hid_ch, dtype=torch.float32, device=None):
    z = lambda: torch.zeros(batch, fh, fw, hid_ch, dtype=dtype, device=device)
    return ((z(), z()), (z(), z()))


def reparameterize(mu, logvar, generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None):
    """mu + eps * exp(logvar / 2) in float32, cast back to mu's type; eps
    ~ N(0, 1) is drawn from `generator` (on mu's device) unless given."""
    std = torch.exp(0.5 * logvar.float())
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                          dtype=torch.float32)
    return (mu.float() + eps * std).to(mu.dtype)


class GaussianConvLSTM(nn.Module):
    """ConvLSTM + mu/logvar 3x3 conv heads + reparameterization
    (reference: lstm.py:260-286)."""

    def __init__(self, in_ch: int, hid_ch: int, out_ch: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.lstm = ConvLSTM(in_ch, hid_ch, dtype, device)
        self.mu = Conv2d(hid_ch, out_ch, 3, dtype=dtype, device=device)
        self.logvar = Conv2d(hid_ch, out_ch, 3, dtype=dtype, device=device)

    def forward(self, x, state, generator: Optional[torch.Generator] = None,
                fused: bool = True, eps: Optional[torch.Tensor] = None):
        """Returns (z, mu, logvar, new_state)."""
        h, new_state = self.lstm(x, state, fused)
        mu = self.mu(h)
        logvar = self.logvar(h)
        return (reparameterize(mu, logvar, generator, eps), mu, logvar,
                new_state)
