"""Load the reference's PyTorch checkpoints into the port's models.

The reference saves torch `state_dict`s of `SVGConvModel`,
`DeterministicConvModel` and the vector `SVGModel` / `DeterministicModel`
(reference: src/prediction/trainer.py:829-844; legacy whole-module pickles
via dynamics.py:39-49). The port's copy of the name map and layout
conversions of `robot_aware_control_tpu/models/torch_import.py` turns such
a state dict into the JAX package's parameter trees (numpy, no JAX), and
`convert.py`, which maps those trees to the port's modules, finishes the
job (`state_dict_from_torch`, `model_from_torch`): one map, not two. The
reference's transpose convolutions become the JAX layout here and the
port's layout in convert.py (where the vector decoder's `ConvTranspose`
flips its kernel at use, ops/nn.py), so each weight is flipped exactly
where the JAX package flips it.

Layout conversions:
  * Conv2d weight (O, I, kh, kw)        -> HWIO (kh, kw, I, O)
  * ConvTranspose2d k3 s1 p1 (I, O, kh, kw)
        == same-padded conv with spatially flipped, transposed kernel
  * BatchNorm running stats -> {mean, var} state; weight/bias -> scale/bias
  * ConvLSTM gate convs transfer directly (same i,f,o,g order:
    reference lstm.py:132-148)

Module-name map (reference: dynamics.py:457-543, vgg_64.py:87-241,
lstm.py:109-286):
  encoder.c1..c4 / decoder.upc2..upc5 / frame_pred_input_conv /
  prior_input_conv / posterior_input_conv / frame_predictor.lstm.{0,1}.gates /
  {prior,posterior}.{lstm.*.gates, mu_net, logvar_net}
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from robot_aware_control_tpu_torch import convert
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.utils.device import resolve_device


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load `ckpt_*.pt` saved by the reference; returns numpy tensors.
    The file is unpickled: load only checkpoints you trust."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("model", blob) if isinstance(blob, dict) else blob
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().numpy() for k, v in sd.items()}


def conv_w(w: np.ndarray) -> np.ndarray:
    """(O, I, kh, kw) -> (kh, kw, I, O)."""
    return np.transpose(w, (2, 3, 1, 0)).copy()


def conv_transpose_w(w: np.ndarray) -> np.ndarray:
    """ConvTranspose2d k3 s1 p1 (I, O, kh, kw) -> equivalent same-conv HWIO."""
    flipped = w[:, :, ::-1, ::-1]
    return np.transpose(flipped, (2, 3, 0, 1)).copy()


def _conv(sd, prefix):
    p = {"w": conv_w(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"].copy()
    return p


def _bn(sd, prefix):
    params = {"scale": sd[f"{prefix}.weight"].copy(),
              "bias": sd[f"{prefix}.bias"].copy()}
    state = {"mean": sd[f"{prefix}.running_mean"].copy(),
             "var": sd[f"{prefix}.running_var"].copy()}
    return params, state


def _vgg_layer(sd, prefix):
    """reference vgg_layer: main.0=conv(no bias), main.1=BN."""
    conv = {"w": conv_w(sd[f"{prefix}.main.0.weight"])}
    bn_p, bn_s = _bn(sd, f"{prefix}.main.1")
    return {"conv": conv, "bn": bn_p}, {"bn": bn_s}


def _vgg_stack(sd, prefix, n):
    ps, ss = [], []
    for i in range(n):
        p, s = _vgg_layer(sd, f"{prefix}.{i}")
        ps.append(p)
        ss.append(s)
    return ps, ss


def _conv_lstm(sd, prefix):
    return {
        "cell0": {"gates": _conv(sd, f"{prefix}.lstm.0.gates")},
        "cell1": {"gates": _conv(sd, f"{prefix}.lstm.1.gates")},
    }


def _gaussian_conv_lstm(sd, prefix):
    return {
        "lstm": _conv_lstm(sd, prefix),
        "mu": _conv(sd, f"{prefix}.mu_net"),
        "logvar": _conv(sd, f"{prefix}.logvar_net"),
    }


def import_conv_encoder(sd, prefix="encoder"):
    params, state = {}, {}
    params["c1"], state["c1"] = _vgg_stack(sd, f"{prefix}.c1", 2)
    params["c2"], state["c2"] = _vgg_stack(sd, f"{prefix}.c2", 2)
    params["c3"], state["c3"] = _vgg_stack(sd, f"{prefix}.c3", 3)
    # reference c4 has 3 layers; ours splits head(2) + out(1)
    head, head_s = _vgg_stack(sd, f"{prefix}.c4", 2)
    params["c4_head"], state["c4_head"] = head, head_s
    out_p, out_s = _vgg_layer(sd, f"{prefix}.c4.2")
    params["c4_out"], state["c4_out"] = out_p, out_s
    return params, state


def import_conv_decoder(sd, prefix="decoder"):
    params, state = {}, {}
    params["upc2"], state["upc2"] = _vgg_stack(sd, f"{prefix}.upc2", 3)
    params["upc3"], state["upc3"] = _vgg_stack(sd, f"{prefix}.upc3", 3)
    params["upc4"], state["upc4"] = _vgg_stack(sd, f"{prefix}.upc4", 2)
    # reference upc5 = [vgg_layer, ConvTranspose2d, Sigmoid]
    l0, s0 = _vgg_layer(sd, f"{prefix}.upc5.0")
    params["upc5"], state["upc5"] = [l0], [s0]
    params["out"] = {
        "w": conv_transpose_w(sd[f"{prefix}.upc5.1.weight"]),
        "b": sd[f"{prefix}.upc5.1.bias"].copy(),
    }
    return params, state


def _linear(sd, prefix):
    """torch Linear (out, in) -> ours (in, out)."""
    p = {"w": np.transpose(sd[f"{prefix}.weight"]).copy()}
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"].copy()
    return p


def _spatial_map_linear(sd, prefix, fh: int, fw: int, c: int):
    """Linear head whose output is viewed as an NCHW (c, fh, fw) spatial
    map by the reference (dynamics.py:446-449) but reshaped NHWC
    (fh, fw, c) by us — permute the OUTPUT units accordingly."""
    w = sd[f"{prefix}.weight"]  # (c*fh*fw, in)
    din = w.shape[1]
    w = w.reshape(c, fh, fw, din).transpose(1, 2, 0, 3).reshape(-1, din)
    p = {"w": np.transpose(w).copy()}
    if f"{prefix}.bias" in sd:
        b = sd[f"{prefix}.bias"]
        p["b"] = b.reshape(c, fh, fw).transpose(1, 2, 0).reshape(-1).copy()
    return p


def import_det_conv_model(sd: Dict[str, np.ndarray], fh: int, fw: int
                          ) -> Tuple[Dict, Dict]:
    """torch DeterministicConvModel state_dict -> (params, bn_state) for
    models/det.py (reference: dynamics.py:363-454). fh/fw are the
    (H/8, W/8) feature-map dims the action/state Linears tile into."""
    params, state = {}, {}
    params["encoder"], state["encoder"] = import_conv_encoder(sd)
    params["decoder"], state["decoder"] = import_conv_decoder(sd)
    params["action_enc"] = _spatial_map_linear(sd, "action_encoder.0", fh, fw, 2)
    if "state_encoder.0.weight" in sd:
        params["state_enc"] = _spatial_map_linear(
            sd, "state_encoder.0", fh, fw, 2
        )
    params["frame_lstm"] = _conv_lstm(sd, "frame_predictor")
    return params, state


def _fc_lstm_cells(sd, prefix):
    """torch nn.LSTMCell list -> our lstm_cell params (gate order i,f,g,o
    matches, reference lstm.py:24-26); both torch biases are kept (they sum)."""
    cells = []
    i = 0
    while f"{prefix}.lstm.{i}.weight_ih" in sd:
        cells.append({
            "ih": {"w": np.transpose(sd[f"{prefix}.lstm.{i}.weight_ih"]).copy(),
                   "b": sd[f"{prefix}.lstm.{i}.bias_ih"].copy()},
            "hh": {"w": np.transpose(sd[f"{prefix}.lstm.{i}.weight_hh"]).copy(),
                   "b": sd[f"{prefix}.lstm.{i}.bias_hh"].copy()},
        })
        i += 1
    return cells


def import_fc_lstm(sd, prefix):
    """reference LSTM (lstm.py:10-55): embed -> LSTMCells -> Linear+Tanh."""
    return {"embed": _linear(sd, f"{prefix}.embed"),
            "cells": _fc_lstm_cells(sd, prefix),
            "out": _linear(sd, f"{prefix}.output.0")}


def import_gaussian_fc_lstm(sd, prefix):
    """reference GaussianLSTM (lstm.py:58-106)."""
    return {"embed": _linear(sd, f"{prefix}.embed"),
            "cells": _fc_lstm_cells(sd, prefix),
            "mu": _linear(sd, f"{prefix}.mu_net"),
            "logvar": _linear(sd, f"{prefix}.logvar_net")}


def import_mlp_encoder(sd, prefix):
    """reference MLPEncoder (base.py:5-23): Linear -> Tanh -> Linear."""
    return {"l1": _linear(sd, f"{prefix}.output.0"),
            "l2": _linear(sd, f"{prefix}.output.2")}


def import_encoder(sd, prefix="encoder"):
    """Vector-bottleneck Encoder (reference vgg_64.py:21-84)."""
    params, state = {}, {}
    params["c1"], state["c1"] = _vgg_stack(sd, f"{prefix}.c1", 2)
    params["c2"], state["c2"] = _vgg_stack(sd, f"{prefix}.c2", 2)
    params["c3"], state["c3"] = _vgg_stack(sd, f"{prefix}.c3", 3)
    params["c4"], state["c4"] = _vgg_stack(sd, f"{prefix}.c4", 3)
    params["c5"] = {"conv": _conv(sd, f"{prefix}.c5.0")}
    bn_p, bn_s = _bn(sd, f"{prefix}.c5.1")
    params["c5"]["bn"] = bn_p
    state["c5"] = {"bn": bn_s}
    return params, state


def import_decoder(sd, prefix="decoder"):
    """Vector Decoder (reference vgg_64.py:146-193); both ConvTranspose2d
    layers map through the flipped-kernel conversion (verified vs torch)."""
    params, state = {}, {}
    params["upc1"] = {"conv": {
        "w": conv_transpose_w(sd[f"{prefix}.upc1.0.weight"]),
        "b": sd[f"{prefix}.upc1.0.bias"].copy(),
    }}
    bn_p, bn_s = _bn(sd, f"{prefix}.upc1.1")
    params["upc1"]["bn"] = bn_p
    state["upc1"] = {"bn": bn_s}
    params["upc2"], state["upc2"] = _vgg_stack(sd, f"{prefix}.upc2", 3)
    params["upc3"], state["upc3"] = _vgg_stack(sd, f"{prefix}.upc3", 3)
    params["upc4"], state["upc4"] = _vgg_stack(sd, f"{prefix}.upc4", 2)
    l0, s0 = _vgg_layer(sd, f"{prefix}.upc5.0")
    params["upc5"], state["upc5"] = [l0], [s0]
    params["out"] = {
        "w": conv_transpose_w(sd[f"{prefix}.upc5.1.weight"]),
        "b": sd[f"{prefix}.upc5.1.bias"].copy(),
    }
    return params, state


def import_det_vector_model(sd: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """torch DeterministicModel (vector, reference dynamics.py:75-156)
    state_dict -> (params, bn_state) for models/svg_vector.py:det."""
    params, state = {}, {}
    params["encoder"], state["encoder"] = import_encoder(sd)
    params["decoder"], state["decoder"] = import_decoder(sd)
    params["action_enc"] = import_mlp_encoder(sd, "action_enc")
    if "robot_enc.output.0.weight" in sd:
        params["robot_enc"] = import_mlp_encoder(sd, "robot_enc")
    params["frame_lstm"] = import_fc_lstm(sd, "frame_predictor")
    return params, state


def import_svg_vector_model(sd: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """torch SVGModel (vector, reference dynamics.py:159-266) state_dict
    -> (params, bn_state) for models/svg_vector.py."""
    params, state = import_det_vector_model(sd)
    params["prior"] = import_gaussian_fc_lstm(sd, "prior")
    params["posterior"] = import_gaussian_fc_lstm(sd, "posterior")
    return params, state


def import_svg_conv_model(sd: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """torch SVGConvModel state_dict -> (params, bn_state) for models/svg.py."""
    params, state = {}, {}
    params["encoder"], state["encoder"] = import_conv_encoder(sd)
    params["decoder"], state["decoder"] = import_conv_decoder(sd)
    params["frame_in"] = _conv(sd, "frame_pred_input_conv")
    params["prior_in"] = _conv(sd, "prior_input_conv")
    params["post_in"] = _conv(sd, "posterior_input_conv")
    params["frame_lstm"] = _conv_lstm(sd, "frame_predictor")
    params["prior"] = _gaussian_conv_lstm(sd, "prior")
    params["posterior"] = _gaussian_conv_lstm(sd, "posterior")
    return params, state


def import_model(cfg: Config, sd: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """A reference state dict of cfg.model (svg, det, svg_vec, det_vec) ->
    the JAX package's (params, bn_state) trees, numpy."""
    sd = {k: np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v)
          for k, v in sd.items()}
    if cfg.model == "svg":
        return import_svg_conv_model(sd)
    if cfg.model == "det":
        return import_det_conv_model(sd, cfg.feat_height, cfg.feat_width)
    if cfg.model == "svg_vec":
        return import_svg_vector_model(sd)
    if cfg.model == "det_vec":
        return import_det_vector_model(sd)
    raise ValueError(f"no torch import for model {cfg.model!r} (supported: "
                     "svg, det, svg_vec, det_vec)")


def state_dict_from_torch(cfg: Config, sd) -> dict:
    """A reference state dict -> the port's state dict of cfg.model."""
    return convert.svg_state_dict(*import_model(cfg, sd))


def model_from_torch(cfg: Config, sd, device="cuda"):
    """An inference-mode model of cfg.model on `device` holding a reference
    state dict (a dict of arrays or tensors, or the path of a ckpt_*.pt),
    loaded strictly: every port parameter and statistic must be given."""
    if isinstance(sd, str):
        sd = load_torch_state_dict(sd)
    model = convert.MODEL_CLASSES[cfg.model](cfg, device=resolve_device(device))
    model.load_state_dict(state_dict_from_torch(cfg, sd), strict=True)
    return model.eval().requires_grad_(False)
