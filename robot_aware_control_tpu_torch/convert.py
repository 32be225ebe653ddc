"""Carry model parameters, BatchNorm statistics and optimizer state
between the JAX package's layout and the port's, for every family (svg,
det, svg_vec, det_vec, cdna_det, cdna_robonet) and the inverse model.

The JAX models keep parameters and BatchNorm statistics as nested dicts
(and lists, for VGG stacks) of arrays: convolutions `{"w": HWIO, "b"}`,
linears `{"w": (in, out), "b"}`, BatchNorm `{"scale", "bias"}` with state
`{"mean", "var"}`, ConvLSTM cells `{"gates": {"w", "b"}}`, GroupNorm cells
`{"ih", "hh": conv, "ih_gn", "hh_gn", "c_gn": {"scale", "bias"}}`. Their
checkpoints flatten them to keys that `jax.tree_util.keystr` gives, such as
`['encoder']['c1'][0]['conv']['w']`. The port's state dict is keyed by
module paths:

  * conv weights HWIO <-> OIHW (`F.conv2d`'s layout), linear weights
    (in, out) <-> (out, in) (`F.linear`'s); the vector decoder's transpose
    conv (`upc1`) too, whose module flips the kernel at use
    (ops/nn.py:ConvTranspose);
  * ConvLSTM gate weights stay HWIO (k, k, in + hid, 4 hid), the CUDA
    cell's layout, so they are packed once here and never per launch;
  * BatchNorm scale/bias/mean/var <-> weight/bias/running_mean/running_var,
    GroupNorm scale/bias <-> weight/bias.

`svg_state_dict` (nested trees) and `state_dict_from_flat` (keystr dicts)
go from JAX to the port, `jax_flat_trees` back. The robot MLPs' trees
`{"l1", "l2", "l3", "out"} x {"w" (in, out), "b"}` map to `nn.Linear`
state dicts (weight (out, in)) through `robot_mlp_state_dict` and back
through `robot_mlp_tree`. The CycleGAN baseline's `CycleGANParams` (g_ab,
g_ba, d_a, d_b: convolutions, the up-sampling transpose convolutions'
HWIO kernels, instance norms {"scale", "bias"}) map to
`baselines/cyclegan.py:CycleGANNets` through `cyclegan_state_dict` and
back through `cyclegan_flat`, whose keys are the JAX checkpoint's
(`.g_ab['blocks'][0]['c1']['w']`). The optimizer state maps
to optax's: adam `[0].count`, `[0].mu[...]`, `[0].nu[...]`
(`torch.optim.Adam`'s step, exp_avg, exp_avg_sq), rmsprop `[0].nu[...]`,
sgd nothing.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from robot_aware_control_tpu_torch.baselines.cyclegan import InstanceNorm
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models.cdna import CDNA, CDNARobonet
from robot_aware_control_tpu_torch.models.det import Det
from robot_aware_control_tpu_torch.models.svg import SVG
from robot_aware_control_tpu_torch.models.svg_vector import DetVec, SVGVec
from robot_aware_control_tpu_torch.ops.lstm import ConvLSTMCell, GroupNorm
from robot_aware_control_tpu_torch.ops.nn import BatchNorm, Linear
from robot_aware_control_tpu_torch.utils.device import resolve_device

_RENAME = {"b": "bias", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var"}
_BN_LEAF = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("bn", "mean"), "running_var": ("bn", "var")}
# JAX layout -> port layout of a "w" leaf, by its rank: conv HWIO -> OIHW,
# linear (in, out) -> (out, in)
_TO_PORT = {4: (3, 2, 0, 1), 2: (1, 0)}
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
            if arr.ndim not in _TO_PORT:
                raise ValueError(f"{'.'.join(path)}: expected a conv (HWIO) or "
                                 f"linear (in, out) weight, got {arr.shape}")
            name, arr = "weight", arr.transpose(_TO_PORT[arr.ndim])
        else:
            name = _RENAME[leaf]
        sd[".".join(mod + [name])] = torch.tensor(np.ascontiguousarray(arr))
    return sd


def svg_state_dict(params, bn_state) -> dict:
    """A JAX model's (params, bn_state) -> the port's state dict (float32);
    the trees of every family alike."""
    return _state_dict(list(_leaves(params)) + list(_leaves(bn_state)))


def state_dict_from_flat(params_flat: dict, bn_flat: dict) -> dict:
    """{keystr: array} of the params and BatchNorm trees -> the port's
    state dict (float32)."""
    return _state_dict(
        (parse_keystr(k), np.asarray(v, np.float32))
        for k, v in list(params_flat.items()) + list(bn_flat.items()))


def _jax_leaf(model: nn.Module, name: str):
    """A port state-dict entry -> (tree name, JAX path, the permutation
    from the port's layout to JAX's, or None)."""
    *mod, leaf = name.split(".")
    module = model.get_submodule(".".join(mod))
    path = [int(p) if p.isdigit() else p for p in mod]
    if isinstance(module, ConvLSTMCell):
        return "params", path + ["gates", "w" if leaf == "weight" else "b"], None
    if isinstance(module, BatchNorm):
        tree, jleaf = _BN_LEAF[leaf]
        return tree, path + [jleaf], None
    if isinstance(module, (GroupNorm, InstanceNorm)):
        return "params", path + ["scale" if leaf == "weight" else "bias"], None
    if leaf != "weight":
        return "params", path + ["b"], None
    perm = (1, 0) if isinstance(module, Linear) else (2, 3, 1, 0)
    return "params", path + ["w"], perm


def _to_jax(t: torch.Tensor, perm) -> np.ndarray:
    """A copy (never a view of the live tensor) in the JAX layout; a
    DTensor (a sharded parameter or optimizer state) is gathered whole,
    which every rank of its mesh must do alike."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    a = t.detach().float().cpu().numpy()
    return np.array(a if perm is None else a.transpose(perm), order="C")


def _from_jax(a, perm) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    if perm is not None:
        a = a.transpose(np.argsort(perm))
    return torch.tensor(np.ascontiguousarray(a))


def jax_flat_trees(model: nn.Module):
    """The port's model -> ({keystr: array} params, {keystr: array} bn),
    float32 numpy in the JAX layouts."""
    trees = {"params": {}, "bn": {}}
    for name, t in model.state_dict().items():
        tree, path, perm = _jax_leaf(model, name)
        trees[tree][keystr(path)] = _to_jax(t, perm)
    return trees["params"], trees["bn"]


def _param_paths(model: nn.Module):
    for name, p in model.named_parameters():
        _, path, perm = _jax_leaf(model, name)
        yield p, keystr(path), perm


def optimizer_to_jax(cfg: Config, model: nn.Module, optimizer) -> dict:
    """The optimizer's state -> {keystr: array} of optax's state tree for
    cfg.optimizer (zeros and count 0 before the first step)."""
    flat = {}
    if cfg.optimizer == "sgd":
        return flat
    count = 0
    for p, key, perm in _param_paths(model):
        st = optimizer.state.get(p, {})
        zeros = lambda: torch.zeros_like(p)
        if cfg.optimizer == "adam":
            count = int(st.get("step", 0))
            flat[f"[0].mu{key}"] = _to_jax(st.get("exp_avg", zeros()), perm)
            flat[f"[0].nu{key}"] = _to_jax(st.get("exp_avg_sq", zeros()), perm)
        elif cfg.optimizer == "rmsprop":
            flat[f"[0].nu{key}"] = _to_jax(st.get("nu", zeros()), perm)
        else:
            raise ValueError(f"Unknown optimizer: {cfg.optimizer}")
    if cfg.optimizer == "adam":
        flat["[0].count"] = np.asarray(count, np.int32)
    return flat


@torch.no_grad()
def optimizer_from_jax(cfg: Config, model: nn.Module, optimizer, flat: dict):
    """Loads optax's state ({keystr: array}) into the optimizer."""
    if cfg.optimizer == "sgd":
        return
    for p, key, perm in _param_paths(model):
        like = lambda k: _like_param(_from_jax(flat[f"[0].{k}{key}"], perm), p)
        if cfg.optimizer == "adam":
            optimizer.state[p] = {
                "step": torch.tensor(float(flat["[0].count"])),
                "exp_avg": like("mu"), "exp_avg_sq": like("nu")}
        elif cfg.optimizer == "rmsprop":
            optimizer.state[p] = {"nu": like("nu")}
        else:
            raise ValueError(f"Unknown optimizer: {cfg.optimizer}")


def _like_param(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """t as p holds it: p's dtype and device, and p's placements where p
    is a DTensor."""
    if isinstance(p, DTensor):
        return distribute_tensor(t.to(p.dtype).to(p.device), p.device_mesh,
                                 p.placements)
    return t.to(p)


def _from_jax_trees(model: nn.Module, params, bn_state):
    model.load_state_dict(svg_state_dict(params, bn_state), strict=True)
    return model.eval().requires_grad_(False)


# the port's model class of each family
MODEL_CLASSES = {"svg": SVG, "det": Det, "svg_vec": SVGVec, "det_vec": DetVec,
                 "cdna_det": CDNA, "cdna_robonet": CDNARobonet}


def model_from_jax(cfg: Config, params, bn_state, device="cuda") -> nn.Module:
    """An inference-mode model of cfg.model on `device` holding the JAX
    parameters (a strict load: every port parameter and statistic must be
    given)."""
    model = MODEL_CLASSES[cfg.model](cfg, device=resolve_device(device))
    return _from_jax_trees(model, params, bn_state)


def svg_from_jax(cfg: Config, params, bn_state, device="cuda") -> SVG:
    return model_from_jax(cfg.replace(model="svg"), params, bn_state, device)


def det_from_jax(cfg: Config, params, bn_state, device="cuda") -> Det:
    return model_from_jax(cfg.replace(model="det"), params, bn_state, device)


def svg_vec_from_jax(cfg: Config, params, bn_state, device="cuda") -> SVGVec:
    return model_from_jax(cfg.replace(model="svg_vec"), params, bn_state,
                          device)


def det_vec_from_jax(cfg: Config, params, bn_state, device="cuda") -> DetVec:
    return model_from_jax(cfg.replace(model="det_vec"), params, bn_state,
                          device)


def cdna_from_jax(cfg: Config, params, bn_state, device="cuda") -> CDNA:
    return model_from_jax(cfg.replace(model="cdna_det"), params, bn_state,
                          device)


def cdna_robonet_from_jax(cfg: Config, params, bn_state,
                          device="cuda") -> CDNARobonet:
    return model_from_jax(cfg.replace(model="cdna_robonet"), params, bn_state,
                          device)


def robot_mlp_state_dict(tree) -> dict:
    """A JAX robot MLP, as a nested tree {"l1": {"w", "b"}, ...} or a flat
    {keystr: array} dict, -> the port's `RobotMLP` state dict (float32)."""
    leaves = (tree.items() if all(isinstance(k, str) and k.startswith("[")
                                  for k in tree)
              else ((keystr(p), a) for p, a in _leaves(tree)))
    sd = {}
    for key, arr in leaves:
        layer, leaf = parse_keystr(key)
        arr = np.asarray(arr, np.float32)
        sd[f"{layer}.{'weight' if leaf == 'w' else 'bias'}"] = torch.tensor(
            np.ascontiguousarray(arr.T if leaf == "w" else arr))
    return sd


def robot_mlp_tree(mlp: nn.Module) -> dict:
    """The port's `RobotMLP` -> {keystr: array} of the JAX tree (float32
    numpy, w as (in, out))."""
    out = {}
    for name, t in mlp.state_dict().items():
        layer, leaf = name.split(".")
        out[keystr([layer, "w" if leaf == "weight" else "b"])] = _to_jax(
            t, (1, 0) if leaf == "weight" else None)
    return out


_FIELD_KEY = re.compile(r"\.(\w+)(.*)")


def cyclegan_state_dict(params) -> dict:
    """The JAX package's CycleGANParams (a NamedTuple or a dict of its four
    fields, numpy or JAX arrays) -> the state dict of the port's
    `CycleGANNets` (float32)."""
    tree = params._asdict() if hasattr(params, "_asdict") else dict(params)
    return _state_dict(_leaves(tree))


def cyclegan_flat(nets: nn.Module) -> dict:
    """The port's `CycleGANNets` -> {key: array} with the JAX checkpoint's
    keys (`jax.tree_util.keystr` of CycleGANParams), float32 numpy in the
    JAX layouts."""
    out = {}
    for name, t in nets.state_dict().items():
        _, path, perm = _jax_leaf(nets, name)
        out[f".{path[0]}{keystr(path[1:])}"] = _to_jax(t, perm)
    return out


def cyclegan_state_dict_from_flat(flat: dict) -> dict:
    """Inverse of `cyclegan_flat`: the JAX checkpoint's {key: array} ->
    the port's state dict."""
    leaves = []
    for key, arr in flat.items():
        m = _FIELD_KEY.fullmatch(key)
        if m is None:
            raise ValueError(f"not a CycleGANParams key: {key!r}")
        leaves.append(((m.group(1),) + parse_keystr(m.group(2)),
                       np.asarray(arr, np.float32)))
    return _state_dict(leaves)
