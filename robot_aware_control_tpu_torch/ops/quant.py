"""int8 planning: quantized convolutions for the forward-only CEM rollout.

Counterpart of `robot_aware_control_tpu/ops/quant.py` and of the int8 conv
`robot_aware_control_tpu/ops/nn.py:_conv2d_int8`. Post-training dynamic
quantization, as the JAX package does it:

  * weights: per-output-channel symmetric int8, scale = max(max|w| / 127,
    1e-12) and w_q = clip(round(w / scale), -127, 127), in float32 and in
    the JAX package's order of operations, so that w_q and the scales are
    its bits;
  * activations: one dynamic symmetric scale s_x = max(amax / 127, 1e-8)
    per conv over exactly the tensor the JAX conv sees: a request's rows
    when several requests are planned together (`amax_rows`, the JAX
    package vmaps over requests), a chunk's rows when the candidates go in
    chunks (each chunk is a conv of its own there too), and every rank's
    rows together under a mesh (`amax_group`: an all-reduce MAX over the
    data group, the reduction XLA's SPMD partitioner inserts);
  * products: int8 x int8 with exact int32 sums, dequantized as
    y * (s_x * w_scale), then the bias in float32, then cast to x's type.

On the GPU the product is an int8 GEMM on the tensor cores: an im2col of
the int8 activation and `torch._int_mm` (cuBLASLt IMMA), with K and N
padded with zeros to multiples of 8 and M to more than 16, which its
kernel requires (zeros add nothing to an integer sum). On the CPU the
plain version convolves the integer values in float64, which is exact
(|sum| <= 25 * 520 * 127^2 < 2^53), so both routes give the same int32
sums. Nothing here reads a value back to the host.

`quantize_model` returns a new model, a deep copy whose `Conv2d`s are
`Int8Conv2d`s and whose `ConvLSTMCell`s are `Int8ConvLSTMCell`s; the
caller's float model (which a trainer, an eval step or a server may share)
is left as it is. Transpose convolutions (the vector decoder's `upc1`),
Linear layers and BatchNorm stay float, as in the JAX package. Under int8
the cell leaves the cell kernel and takes the plain cell math of JAX
`lstm.py:conv_lstm_cell` (JAX `lstm.py:117-120`). `quantize_model` is
idempotent: a model with nothing left to quantize comes back as it is.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from robot_aware_control_tpu_torch.ops.lstm import ConvLSTMCell
from robot_aware_control_tpu_torch.ops.nn import Conv2d, same_pads

# rows of the batch that share one activation scale (None: all of them)
_AMAX_ROWS = contextvars.ContextVar("int8_amax_rows", default=None)
# the process group whose ranks' rows share it (None: this rank alone)
_AMAX_GROUP = contextvars.ContextVar("int8_amax_group", default=None)

# launches of the int8 GEMM (the im2col + torch._int_mm route)
launches = {"int8_mm": 0}


@contextlib.contextmanager
def amax_rows(rows: Optional[int]):
    """Inside, every int8 conv takes one activation scale per `rows` rows
    of its batch: each request's, when several are planned together."""
    token = _AMAX_ROWS.set(rows)
    try:
        yield
    finally:
        _AMAX_ROWS.reset(token)


@contextlib.contextmanager
def amax_group(group):
    """Inside, every int8 conv's activation scale is the MAX over the ranks
    of `group` (the candidates of a mesh plan shard over them)."""
    token = _AMAX_GROUP.set(group)
    try:
        yield
    finally:
        _AMAX_GROUP.reset(token)


def quantize_weight(w: torch.Tensor, out_dim: int):
    """Per-output-channel symmetric int8 of a conv weight whose output
    channels lie on `out_dim` (JAX `quant.py:quantize_conv_params`).
    Returns (w_q int8 in w's layout, scale float32 (O,))."""
    w = w.detach().float()
    dims = tuple(d for d in range(w.dim()) if d != out_dim % w.dim())
    scale = torch.clamp(w.abs().amax(dim=dims) / 127.0, min=1e-12)
    shape = [1] * w.dim()
    shape[out_dim] = -1
    w_q = torch.clamp(torch.round(w / scale.view(shape)), -127, 127)
    return w_q.to(torch.int8), scale


def quantize_activation(x: torch.Tensor):
    """x (B, ...) -> (x_q int8, s_x float32 (B, 1, ..., 1)): one scale per
    `amax_rows` rows (all rows by default), MAX-reduced over
    `amax_group`'s ranks."""
    xf = x.float()
    B = x.shape[0]
    rows = _AMAX_ROWS.get() or B
    if B % rows:
        raise ValueError(f"{B} rows do not split into groups of {rows}")
    amax = xf.abs().reshape(B // rows, -1).amax(1)
    group = _AMAX_GROUP.get()
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    s_x = torch.clamp(amax / 127.0, min=1e-8)
    s_x = s_x.repeat_interleave(rows).view((B,) + (1,) * (x.dim() - 1))
    x_q = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
    return x_q, s_x


def _pads(x_shape, k, stride, padding):
    """((top, bottom), (left, right)) of a SAME (XLA's) or VALID conv."""
    if padding != "same":
        return (0, 0), (0, 0)
    return tuple(same_pads(n, kk, stride) for n, kk in zip(x_shape[1:3], k))


def conv_int8_plain(x_q, w_q, stride: int, pads):
    """The plain version: x_q (B, H, W, C) int8, w_q (O, C, kh, kw) int8 ->
    (B, Ho, Wo, O) int32, a float64 convolution of the integer values
    (exact: every partial sum is an integer below 2^53)."""
    (pt, pb), (pl, pr) = pads
    xc = F.pad(x_q.double().permute(0, 3, 1, 2), (pl, pr, pt, pb))
    y = F.conv2d(xc, w_q.double(), stride=stride)
    return y.permute(0, 2, 3, 1).to(torch.int32)


def gemm_weight(w_q):
    """(O, C, kh, kw) int8 -> the GEMM's (Np, Kp) int8 weight, rows in
    im2col's (kh, kw, C) order, zero-padded to multiples of 8; row-major,
    so that its transpose is the column-major operand on which cuBLASLt
    takes its fast int8 kernel (a cell's weight, quantized from its
    (k, k, I, O) layout, would otherwise come out column-major, and the
    planner's cell GEMMs took a WMMA kernel at 5x the time)."""
    O = w_q.shape[0]
    wm = w_q.permute(0, 2, 3, 1).reshape(O, -1)
    K = wm.shape[1]
    return F.pad(wm, (0, -K % 8, 0, -O % 8)).contiguous()


def conv_int8_mm(x_q, w_mat, O: int, k, stride: int, pads):
    """The GPU route, also run on the CPU by the tests: the im2col of the
    int8 activation times `gemm_weight`'s matrix through torch._int_mm
    (int32 sums). x_q (B, H, W, C) int8 -> (B, Ho, Wo, O) int32."""
    kh, kw = k
    (pt, pb), (pl, pr) = pads
    xp = F.pad(x_q, (0, 0, pl, pr, pt, pb))
    B, Hp, Wp, C = xp.shape
    Ho, Wo = (Hp - kh) // stride + 1, (Wp - kw) // stride + 1
    sB, sH, sW, sC = xp.stride()
    cols = xp.as_strided((B, Ho, Wo, kh, kw, C),
                         (sB, stride * sH, stride * sW, sH, sW, sC))
    M, K = B * Ho * Wo, kh * kw * C
    a = cols.reshape(M, K)
    # cuBLASLt's int8 GEMM: K a multiple of 8, more than 16 rows (a pad of
    # nothing would still copy the im2col)
    pad_k, pad_m = w_mat.shape[1] - K, max(17 - M, 0)
    if pad_k or pad_m:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    y = torch._int_mm(a, w_mat.t())
    launches["int8_mm"] += 1
    return y[:M, :O].reshape(B, Ho, Wo, O)


class Int8Conv2d(nn.Module):
    """The int8 counterpart of `ops.nn.Conv2d` (NHWC in and out, the same
    stride and padding): JAX `nn.py:_conv2d_int8`. Holds w_q (O, C, kh,
    kw) int8, w_scale (O,) float32, the GEMM's padded weight and the bias
    in float32. Forward only."""

    def __init__(self, weight_oihw, bias, stride: int = 1,
                 padding: str = "same"):
        super().__init__()
        w_q, scale = quantize_weight(weight_oihw, 0)
        self.register_buffer("w_q", w_q.contiguous())
        self.register_buffer("w_scale", scale)
        self.register_buffer("w_mat", gemm_weight(w_q))
        self.register_buffer("bias", None if bias is None
                             else bias.detach().float().clone())
        self.stride = stride
        self.padding = padding

    @classmethod
    def from_conv(cls, conv: Conv2d) -> "Int8Conv2d":
        return cls(conv.weight, conv.bias, conv.stride, conv.padding)

    def forward(self, x):
        k = tuple(self.w_q.shape[-2:])
        pads = _pads(x.shape, k, self.stride, self.padding)
        x_q, s_x = quantize_activation(x)
        if x.is_cuda:
            y = conv_int8_mm(x_q, self.w_mat, self.w_q.shape[0], k,
                             self.stride, pads)
        else:
            y = conv_int8_plain(x_q, self.w_q, self.stride, pads)
        y = y.float() * (s_x * self.w_scale)
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


class Int8ConvLSTMCell(nn.Module):
    """A ConvLSTM cell with int8 gates: JAX `lstm.py:conv_lstm_cell` over
    the int8 conv of cat(x, h) (gate order i, f, o, g), the gates and the
    state update in x's type. The gate weight (k, k, I, O) is quantized
    per output channel (its last dim) as JAX quantizes it. The cell kernel
    never runs: `fused` is ignored."""

    def __init__(self, cell: ConvLSTMCell):
        super().__init__()
        self.gates = Int8Conv2d(cell.weight.detach().permute(3, 2, 0, 1),
                                cell.bias)

    def forward(self, x, state, fused: bool = True):
        h, c = state
        g = self.gates(torch.cat([x, h.to(x.dtype)], -1))
        i, f, o, gc = g.chunk(4, -1)
        c_new = (torch.sigmoid(f) * c.to(x.dtype)
                 + torch.sigmoid(i) * torch.tanh(gc))
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, (h_new, c_new)


def _replacement(module):
    if isinstance(module, Conv2d):
        return Int8Conv2d.from_conv(module)
    if isinstance(module, ConvLSTMCell):
        return Int8ConvLSTMCell(module)
    return None


def quantize_model(model: nn.Module) -> nn.Module:
    """A new model whose convolutions and conv cells are int8 (JAX
    `quant.py:quantize_conv_tree`); `model` itself is not touched. A model
    with nothing left to quantize is returned as it is."""
    if not any(isinstance(m, (Conv2d, ConvLSTMCell)) for m in model.modules()):
        return model
    out = copy.deepcopy(model)
    for name, module in list(out.named_modules()):
        new = _replacement(module)
        if new is None:
            continue
        parent, _, leaf = name.rpartition(".")
        setattr(out.get_submodule(parent) if parent else out, leaf, new)
    return out.eval().requires_grad_(False)


def maybe_quantize_plan_model(cfg, model: nn.Module) -> nn.Module:
    """The config-gated entry point of CEMPolicy and TrajectorySampler
    (JAX `quant.py:maybe_quantize_plan_params`); a planner without a
    model (the ground-truth policies) passes None through."""
    if cfg.plan_quantize != "int8" or model is None:
        return model
    return quantize_model(model)
