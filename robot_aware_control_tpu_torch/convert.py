"""Carry SVG parameters, BatchNorm statistics and optimizer state between
the JAX package's layout and the port's.

The JAX model keeps parameters and BatchNorm statistics as nested dicts
(and lists, for VGG stacks) of arrays: convolutions `{"w": HWIO, "b"}`,
BatchNorm `{"scale", "bias"}` with state `{"mean", "var"}`, ConvLSTM cells
`{"gates": {"w", "b"}}`. Its checkpoints flatten them to keys that
`jax.tree_util.keystr` gives, such as `['encoder']['c1'][0]['conv']['w']`.
The port's state dict is keyed by module paths:

  * conv weights HWIO <-> OIHW (`F.conv2d`'s layout);
  * ConvLSTM gate weights stay HWIO (k, k, in + hid, 4 hid), the CUDA
    cell's layout, so they are packed once here and never per launch;
  * BatchNorm scale/bias/mean/var <-> weight/bias/running_mean/running_var.

`svg_state_dict` (nested trees) and `state_dict_from_flat` (keystr dicts)
go from JAX to the port, `jax_flat_trees` back. The optimizer state maps
to optax's: adam `[0].count`, `[0].mu[...]`, `[0].nu[...]`
(`torch.optim.Adam`'s step, exp_avg, exp_avg_sq), rmsprop `[0].nu[...]`,
sgd nothing.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models.svg import SVG
from robot_aware_control_tpu_torch.ops.lstm import ConvLSTMCell
from robot_aware_control_tpu_torch.ops.nn import BatchNorm
from robot_aware_control_tpu_torch.utils.device import resolve_device

_RENAME = {"b": "bias", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var"}
_BN_LEAF = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("bn", "mean"), "running_var": ("bn", "var")}
_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def keystr(path) -> str:
    """`jax.tree_util.keystr` of a path of dict keys (str) and list
    indices (int)."""
    return "".join(f"[{p}]" if isinstance(p, int) else f"['{p}']"
                   for p in path)


def parse_keystr(key: str) -> tuple:
    """Inverse of `keystr`: dict keys as str, list indices as str digits."""
    parts = _KEY.findall(key)
    if "".join(f"['{a}']" if a else f"[{b}]" for a, b in parts) != key:
        raise ValueError(f"not a keystr of dict keys and list indices: {key!r}")
    return tuple(a or b for a, b in parts)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, np.asarray(tree, np.float32)


def _state_dict(leaves) -> dict:
    sd = {}
    for path, arr in leaves:
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
        sd[".".join(mod + [name])] = torch.tensor(np.ascontiguousarray(arr))
    return sd


def svg_state_dict(params, bn_state) -> dict:
    """JAX SVG (params, bn_state) -> the port's state dict (float32)."""
    return _state_dict(list(_leaves(params)) + list(_leaves(bn_state)))


def state_dict_from_flat(params_flat: dict, bn_flat: dict) -> dict:
    """{keystr: array} of the params and BatchNorm trees -> the port's
    state dict (float32)."""
    return _state_dict(
        (parse_keystr(k), np.asarray(v, np.float32))
        for k, v in list(params_flat.items()) + list(bn_flat.items()))


def _jax_leaf(model: SVG, name: str):
    """A port state-dict entry -> (tree name, JAX path, whether the array
    is a conv weight that transposes OIHW <-> HWIO)."""
    *mod, leaf = name.split(".")
    module = model.get_submodule(".".join(mod))
    path = [int(p) if p.isdigit() else p for p in mod]
    if isinstance(module, ConvLSTMCell):
        return "params", path + ["gates", "w" if leaf == "weight" else "b"], False
    if isinstance(module, BatchNorm):
        tree, jleaf = _BN_LEAF[leaf]
        return tree, path + [jleaf], False
    return "params", path + ["w" if leaf == "weight" else "b"], leaf == "weight"


def _to_jax(t: torch.Tensor, conv: bool) -> np.ndarray:
    """A copy (never a view of the live tensor) in the JAX layout."""
    a = t.detach().float().cpu().numpy()
    return np.array(a.transpose(2, 3, 1, 0) if conv else a, order="C")


def _from_jax(a, conv: bool) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    return torch.tensor(np.ascontiguousarray(a.transpose(3, 2, 0, 1) if conv else a))


def jax_flat_trees(model: SVG):
    """The port's model -> ({keystr: array} params, {keystr: array} bn),
    float32 numpy in the JAX layouts."""
    trees = {"params": {}, "bn": {}}
    for name, t in model.state_dict().items():
        tree, path, conv = _jax_leaf(model, name)
        trees[tree][keystr(path)] = _to_jax(t, conv)
    return trees["params"], trees["bn"]


def _param_paths(model: SVG):
    for name, p in model.named_parameters():
        _, path, conv = _jax_leaf(model, name)
        yield p, keystr(path), conv


def optimizer_to_jax(cfg: Config, model: SVG, optimizer) -> dict:
    """The optimizer's state -> {keystr: array} of optax's state tree for
    cfg.optimizer (zeros and count 0 before the first step)."""
    flat = {}
    if cfg.optimizer == "sgd":
        return flat
    count = 0
    for p, key, conv in _param_paths(model):
        st = optimizer.state.get(p, {})
        zeros = lambda: torch.zeros_like(p)
        if cfg.optimizer == "adam":
            count = int(st.get("step", 0))
            flat[f"[0].mu{key}"] = _to_jax(st.get("exp_avg", zeros()), conv)
            flat[f"[0].nu{key}"] = _to_jax(st.get("exp_avg_sq", zeros()), conv)
        elif cfg.optimizer == "rmsprop":
            flat[f"[0].nu{key}"] = _to_jax(st.get("nu", zeros()), conv)
        else:
            raise ValueError(f"Unknown optimizer: {cfg.optimizer}")
    if cfg.optimizer == "adam":
        flat["[0].count"] = np.asarray(count, np.int32)
    return flat


@torch.no_grad()
def optimizer_from_jax(cfg: Config, model: SVG, optimizer, flat: dict):
    """Loads optax's state ({keystr: array}) into the optimizer."""
    if cfg.optimizer == "sgd":
        return
    for p, key, conv in _param_paths(model):
        like = lambda k: _from_jax(flat[f"[0].{k}{key}"], conv).to(p)
        if cfg.optimizer == "adam":
            optimizer.state[p] = {
                "step": torch.tensor(float(flat["[0].count"])),
                "exp_avg": like("mu"), "exp_avg_sq": like("nu")}
        elif cfg.optimizer == "rmsprop":
            optimizer.state[p] = {"nu": like("nu")}
        else:
            raise ValueError(f"Unknown optimizer: {cfg.optimizer}")


def svg_from_jax(cfg: Config, params, bn_state, device="cuda") -> SVG:
    """An inference-mode SVG on `device` holding the JAX parameters
    (a strict load: every port parameter and statistic must be given)."""
    model = SVG(cfg, device=resolve_device(device))
    model.load_state_dict(svg_state_dict(params, bn_state), strict=True)
    return model.eval().requires_grad_(False)
