"""Conv LSTM cells with explicit state (NHWC), counterpart of
`robot_aware_control_tpu/ops/lstm.py` (reference:
src/prediction/models/lstm.py:109-149, 201-286).

Every cell runs through `ops.kernels.conv_lstm_cell`: the plain PyTorch
version for CPU tensors, the CUDA kernel for GPU tensors, as the JAX
package runs its fused Pallas cell at inference. A cell keeps its gate
weights in the kernel's layout, HWIO (k, k, in + hid, 4 hid) in the
compute dtype, with gate order i, f, o, g, and its bias in float32.
"""

from __future__ import annotations

import torch
from torch import nn

from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.ops.nn import Conv2d


class ConvLSTMCell(nn.Module):
    def __init__(self, in_ch: int, hid_ch: int, k: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            k, k, in_ch + hid_ch, 4 * hid_ch, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.empty(4 * hid_ch, device=device))

    def forward(self, x, state):
        """state = (h, c). Returns (h_new, (h_new, c_new))."""
        h, c = state
        h_new, c_new = kernels.conv_lstm_cell(
            x.contiguous(), h, c, self.weight, self.bias)
        return h_new, (h_new, c_new)


class ConvLSTM(nn.Module):
    """2-cell stack: kernel 5 then kernel 3 (reference: lstm.py:206-212)."""

    def __init__(self, in_ch: int, hid_ch: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cell0 = ConvLSTMCell(in_ch, hid_ch, 5, dtype, device)
        self.cell1 = ConvLSTMCell(hid_ch, hid_ch, 3, dtype, device)

    def forward(self, x, state):
        s0, s1 = state
        h, s0 = self.cell0(x, s0)
        h, s1 = self.cell1(h, s1)
        return h, (s0, s1)


def zero_state(batch, fh, fw, hid_ch, dtype=torch.float32, device=None):
    z = lambda: torch.zeros(batch, fh, fw, hid_ch, dtype=dtype, device=device)
    return ((z(), z()), (z(), z()))


def reparameterize(mu, logvar, generator: torch.Generator):
    """mu + eps * exp(logvar / 2) in float32 with eps ~ N(0, 1) drawn from
    `generator` (on mu's device), cast back to mu's type."""
    std = torch.exp(0.5 * logvar.float())
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

    def forward(self, x, state, generator: torch.Generator):
        """Returns (z, mu, logvar, new_state)."""
        h, new_state = self.lstm(x, state)
        mu = self.mu(h)
        logvar = self.logvar(h)
        return reparameterize(mu, logvar, generator), mu, logvar, new_state
