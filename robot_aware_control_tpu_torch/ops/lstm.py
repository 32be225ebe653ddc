"""Conv LSTM cells with explicit state (NHWC), counterpart of
`robot_aware_control_tpu/ops/lstm.py` (reference:
src/prediction/models/lstm.py:109-286).

A plain cell has two paths, chosen as `lstm.py:conv_lstm` chooses between
the fused Pallas cell and the XLA cell:

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

The GroupNorm cell (`--lstm_group_norm`, `lstm.py:norm_conv_lstm_cell`)
never takes the kernel, as the JAX package keeps it on the XLA path
(`lstm.py:106-113`): two convolutions, `ih` on x and `hh` on h, each
followed by its own GroupNorm of the 4 hid gates, and a third GroupNorm on
c'. It runs on PyTorch's convolutions and GroupNorm in training and at
inference alike.

The vector models (models/svg_vector.py) step fully-connected LSTMs
(`lstm.py:164-226`; reference: lstm.py:10-106): `LSTM` (embed -> LSTMCells
-> Linear + tanh head) and `GaussianLSTM` (mu and logvar heads, the
reparameterized draw). Their cells take torch's gate order i, f, g, o,
unlike the conv cell's i, f, o, g, and run as plain products: the JAX
package computes them outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.ops.nn import Conv2d, Linear


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
            # the wrapper reads x as it is or stages it (kernels.stage_cell)
            h_new, c_new = kernels.conv_lstm_cell(
                x, h, c, self.weight.to(x.dtype), self.bias)
        else:
            h_new, c_new = conv_lstm_cell_autograd(x, h, c, self.weight,
                                                   self.bias)
        return h_new, (h_new, c_new)


GROUPS = 16  # the JAX group_norm's default (lstm.py:54)
GN_EPS = 1e-5


class GroupNorm(nn.Module):
    """GroupNorm of NHWC activations over 16 groups of channels
    (`lstm.py:group_norm`): population statistics, scale and bias in
    float32, the result cast back to x's type."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))

    def forward(self, x):
        y = F.group_norm(x.float().permute(0, 3, 1, 2), GROUPS, self.weight,
                         self.bias, GN_EPS)
        return y.permute(0, 2, 3, 1).to(x.dtype)


class NormConvLSTMCell(nn.Module):
    """The GroupNorm-gated cell (`lstm.py:norm_conv_lstm_cell`, reference:
    lstm.py:151-198): gates = GN(conv(x)) + GN(conv(h)), each normalised
    term in x's type and their sum too; c' = GN(f c + i g); h' = o tanh(c')."""

    def __init__(self, in_ch: int, hid_ch: int, k: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.ih = Conv2d(in_ch, 4 * hid_ch, k, dtype=dtype, device=device)
        self.hh = Conv2d(hid_ch, 4 * hid_ch, k, dtype=dtype, device=device)
        self.ih_gn = GroupNorm(4 * hid_ch, device)
        self.hh_gn = GroupNorm(4 * hid_ch, device)
        self.c_gn = GroupNorm(hid_ch, device)

    def forward(self, x, state, fused: bool = False):
        """state = (h, c). `fused` is ignored: no kernel takes this cell.
        Returns (h_new, (h_new, c_new))."""
        h, c = state
        g = self.ih_gn(self.ih(x)) + self.hh_gn(self.hh(h.to(x.dtype)))
        i, f, o, gc = g.chunk(4, -1)
        c_new = torch.sigmoid(f) * c.to(x.dtype) + torch.sigmoid(i) * torch.tanh(gc)
        c_new = self.c_gn(c_new)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class ConvLSTM(nn.Module):
    """2-cell stack: kernel 5 then kernel 3 (reference: lstm.py:206-212),
    of GroupNorm cells with `group_norm`."""

    def __init__(self, in_ch: int, hid_ch: int, dtype=torch.float32,
                 device=None, group_norm: bool = False):
        super().__init__()
        cell = NormConvLSTMCell if group_norm else ConvLSTMCell
        self.cell0 = cell(in_ch, hid_ch, 5, dtype, device)
        self.cell1 = cell(hid_ch, hid_ch, 3, dtype, device)

    def forward(self, x, state, fused: bool = True):
        s0, s1 = state
        h, s0 = self.cell0(x, s0, fused)
        h, s1 = self.cell1(h, s1, fused)
        return h, (s0, s1)


def zero_state(batch, fh, fw, hid_ch, dtype=torch.float32, device=None):
    """Zero (h, c) of both cells, views of buffers whose pixel stride is
    hid_ch rounded up to 8 (kernels.padded_nhwc; contiguous where hid_ch is
    a multiple of 8), which the wgmma/TMA cell kernel reads in place at any
    hid_ch."""
    z = lambda: kernels.padded_nhwc(batch, fh, fw, hid_ch, dtype, device,
                                    zero=True)
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
                 dtype=torch.float32, device=None, group_norm: bool = False):
        super().__init__()
        self.lstm = ConvLSTM(in_ch, hid_ch, dtype, device, group_norm)
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


# ---------------------------------------------------------------------------
# fully-connected LSTM (vector models)


class LSTMCell(nn.Module):
    """`lstm.py:lstm_cell`: gates = ih(x) + hh(h) in x's type, torch's gate
    order i, f, g, o; c' = sig(f) c + sig(i) tanh(g), h' = sig(o) tanh(c'),
    with c cast to x's type."""

    def __init__(self, din: int, dhid: int, dtype=torch.float32, device=None):
        super().__init__()
        self.ih = Linear(din, 4 * dhid, dtype, device)
        self.hh = Linear(dhid, 4 * dhid, dtype, device)

    def forward(self, x, state):
        """state = (h, c). Returns (h_new, (h_new, c_new))."""
        h, c = state
        g = self.ih(x) + self.hh(h.to(x.dtype))
        i, f, gc, o = g.chunk(4, -1)
        c_new = torch.sigmoid(f) * c.to(x.dtype) + torch.sigmoid(i) * torch.tanh(gc)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class _LSTMStack(nn.Module):
    def __init__(self, din: int, dhid: int, n_layers: int, dtype, device):
        super().__init__()
        self.embed = Linear(din, dhid, dtype, device)
        self.cells = nn.ModuleList(
            LSTMCell(dhid, dhid, dtype, device) for _ in range(n_layers))

    def _stack(self, x, state):
        h = self.embed(x)
        new_state = []
        for cell, s in zip(self.cells, state):
            h, s = cell(h, s)
            new_state.append(s)
        return h, tuple(new_state)


class LSTM(_LSTMStack):
    """Embed -> n LSTMCells -> Linear + tanh (`lstm.py:lstm_apply`)."""

    def __init__(self, din: int, dout: int, dhid: int, n_layers: int,
                 dtype=torch.float32, device=None):
        super().__init__(din, dhid, n_layers, dtype, device)
        self.out = Linear(dhid, dout, dtype, device)

    def forward(self, x, state):
        """Returns (y, new_state)."""
        h, new_state = self._stack(x, state)
        return torch.tanh(self.out(h)), new_state


class GaussianLSTM(_LSTMStack):
    """Embed -> n LSTMCells -> mu and logvar heads, z reparameterized
    (`lstm.py:gaussian_lstm_apply`)."""

    def __init__(self, din: int, dout: int, dhid: int, n_layers: int,
                 dtype=torch.float32, device=None):
        super().__init__(din, dhid, n_layers, dtype, device)
        self.mu = Linear(dhid, dout, dtype, device)
        self.logvar = Linear(dhid, dout, dtype, device)

    def forward(self, x, state, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        """Returns (z, mu, logvar, new_state); eps (B, dout) float32 replaces
        the generator's draw."""
        h, new_state = self._stack(x, state)
        mu, logvar = self.mu(h), self.logvar(h)
        return reparameterize(mu, logvar, generator, eps), mu, logvar, new_state


def lstm_zero_state(batch, dhid, n_layers, dtype=torch.float32, device=None):
    """Zero (h, c) of each of the n cells (`lstm.py:lstm_zero_state`)."""
    z = lambda: torch.zeros(batch, dhid, dtype=dtype, device=device)
    return tuple((z(), z()) for _ in range(n_layers))
