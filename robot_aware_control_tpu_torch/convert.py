"""Carry SVG parameters from the JAX package's layout into the port.

The JAX model keeps parameters and BatchNorm statistics as nested dicts
(and lists, for VGG stacks) of arrays: convolutions `{"w": HWIO, "b"}`,
BatchNorm `{"scale", "bias"}` with state `{"mean", "var"}`, ConvLSTM cells
`{"gates": {"w", "b"}}`. `svg_state_dict` turns them, as numpy arrays, into
a state dict whose keys are the port's module paths:

  * conv weights HWIO -> OIHW (`F.conv2d`'s layout);
  * ConvLSTM gate weights stay HWIO (k, k, in + hid, 4 hid), the CUDA
    cell's layout, so they are packed once here and never per launch;
  * BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var.

`svg_from_jax` strict-loads it; the copy casts each tensor to its parameter's
type (the compute dtype for convolutions, float32 for BatchNorm and the
cells' biases) and device.
"""

from __future__ import annotations

import numpy as np
import torch

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models.svg import SVG
from robot_aware_control_tpu_torch.utils.device import resolve_device

_RENAME = {"b": "bias", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var"}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, np.asarray(tree, np.float32)


def svg_state_dict(params, bn_state) -> dict:
    """JAX SVG (params, bn_state) -> the port's state dict (float32)."""
    sd = {}
    for path, arr in list(_leaves(params)) + list(_leaves(bn_state)):
        *mod, leaf = path
        if mod and mod[-1] == "gates":  # ConvLSTM cell: kernel layout
            mod = mod[:-1]
            name = "weight" if leaf == "w" else _RENAME[leaf]
        elif leaf == "w":
            if arr.ndim != 4:
                raise ValueError(f"{'.'.join(path)}: expected HWIO, got {arr.shape}")
            name, arr = "weight", arr.transpose(3, 2, 0, 1)
        else:
            name = _RENAME[leaf]
        sd[".".join(mod + [name])] = torch.tensor(arr)
    return sd


def svg_from_jax(cfg: Config, params, bn_state, device="cuda") -> SVG:
    """An inference-mode SVG on `device` holding the JAX parameters
    (a strict load: every port parameter and statistic must be given)."""
    model = SVG(cfg, device=resolve_device(device))
    model.load_state_dict(svg_state_dict(params, bn_state), strict=True)
    return model.eval().requires_grad_(False)
