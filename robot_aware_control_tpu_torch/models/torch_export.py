"""Export the port's models as the reference's PyTorch checkpoints.

Counterpart of `robot_aware_control_tpu/models/torch_export.py`, the
inverse of models/torch_import.py: a model trained or loaded in the port is
handed back to the reference stack as a state dict its modules load with
`load_state_dict(..., strict=True)`, in the names, layouts and tensor
conventions the reference saves (reference: src/prediction/trainer.py:
829-844 `{"model": state_dict, "optimizer": ..., "step": N}`; module
layouts dynamics.py:363-644, vgg_64.py:21-241, lstm.py:10-286). The port's
model goes to the JAX package's trees through `convert.jax_flat_trees`, and
the port's copy of the JAX name map (below) takes the trees to the
reference's layout, so an export equals the JAX package's export of the
same weights key for key and bit for bit.

Layout conversions (inverse of torch_import.py):
  * HWIO conv weight (kh, kw, I, O)       -> Conv2d (O, I, kh, kw)
  * same-padded flipped-kernel conv HWIO  -> ConvTranspose2d (I, O, kh, kw)
  * {scale, bias} + {mean, var} state     -> BN weight/bias/running_* (+
    a zero num_batches_tracked so strict loads succeed)
  * Linear (in, out)                      -> torch (out, in)

    python -m robot_aware_control_tpu_torch.models.torch_export \\
        --dynamics_model_ckpt runs/myrun/ckpt_10000.npz --model svg \\
        [model shape flags...] [--out ckpt_10000.pt] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np
import torch

from robot_aware_control_tpu_torch import convert


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def inv_conv_w(w) -> np.ndarray:
    """(kh, kw, I, O) -> (O, I, kh, kw)."""
    return np.transpose(_np(w), (3, 2, 0, 1)).copy()


def inv_conv_transpose_w(w) -> np.ndarray:
    """Same-conv HWIO kernel -> ConvTranspose2d k3 s1 p1 (I, O, kh, kw)."""
    t = np.transpose(_np(w), (2, 3, 0, 1))
    return t[:, :, ::-1, ::-1].copy()


def _ex_conv(out: Dict, prefix: str, p: Dict) -> None:
    out[f"{prefix}.weight"] = inv_conv_w(p["w"])
    if "b" in p:
        out[f"{prefix}.bias"] = _np(p["b"]).copy()


def _ex_bn(out: Dict, prefix: str, p: Dict, s: Dict) -> None:
    out[f"{prefix}.weight"] = _np(p["scale"]).copy()
    out[f"{prefix}.bias"] = _np(p["bias"]).copy()
    out[f"{prefix}.running_mean"] = _np(s["mean"]).copy()
    out[f"{prefix}.running_var"] = _np(s["var"]).copy()
    out[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def _ex_vgg_layer(out: Dict, prefix: str, p: Dict, s: Dict) -> None:
    """Inverse of torch_import._vgg_layer: main.0=conv(no bias), main.1=BN."""
    out[f"{prefix}.main.0.weight"] = inv_conv_w(p["conv"]["w"])
    _ex_bn(out, f"{prefix}.main.1", p["bn"], s["bn"])


def _ex_vgg_stack(out: Dict, prefix: str, ps, ss, start: int = 0) -> None:
    for i, (p, s) in enumerate(zip(ps, ss)):
        _ex_vgg_layer(out, f"{prefix}.{start + i}", p, s)


def _ex_conv_lstm(out: Dict, prefix: str, p: Dict) -> None:
    _ex_conv(out, f"{prefix}.lstm.0.gates", p["cell0"]["gates"])
    _ex_conv(out, f"{prefix}.lstm.1.gates", p["cell1"]["gates"])


def _ex_gaussian_conv_lstm(out: Dict, prefix: str, p: Dict) -> None:
    _ex_conv_lstm(out, prefix, p["lstm"])
    _ex_conv(out, f"{prefix}.mu_net", p["mu"])
    _ex_conv(out, f"{prefix}.logvar_net", p["logvar"])


def export_conv_encoder(out: Dict, params: Dict, state: Dict,
                        prefix: str = "encoder") -> None:
    _ex_vgg_stack(out, f"{prefix}.c1", params["c1"], state["c1"])
    _ex_vgg_stack(out, f"{prefix}.c2", params["c2"], state["c2"])
    _ex_vgg_stack(out, f"{prefix}.c3", params["c3"], state["c3"])
    # ours splits c4 into head(2) + out(1); reference c4 has 3 layers
    _ex_vgg_stack(out, f"{prefix}.c4", params["c4_head"], state["c4_head"])
    _ex_vgg_layer(out, f"{prefix}.c4.2", params["c4_out"], state["c4_out"])


def export_conv_decoder(out: Dict, params: Dict, state: Dict,
                        prefix: str = "decoder") -> None:
    _ex_vgg_stack(out, f"{prefix}.upc2", params["upc2"], state["upc2"])
    _ex_vgg_stack(out, f"{prefix}.upc3", params["upc3"], state["upc3"])
    _ex_vgg_stack(out, f"{prefix}.upc4", params["upc4"], state["upc4"])
    # reference upc5 = [vgg_layer, ConvTranspose2d, Sigmoid]
    _ex_vgg_layer(out, f"{prefix}.upc5.0", params["upc5"][0],
                  state["upc5"][0])
    out[f"{prefix}.upc5.1.weight"] = inv_conv_transpose_w(params["out"]["w"])
    out[f"{prefix}.upc5.1.bias"] = _np(params["out"]["b"]).copy()


def _ex_linear(out: Dict, prefix: str, p: Dict) -> None:
    out[f"{prefix}.weight"] = np.transpose(_np(p["w"])).copy()
    if "b" in p:
        out[f"{prefix}.bias"] = _np(p["b"]).copy()


def _ex_spatial_map_linear(out: Dict, prefix: str, p: Dict,
                           fh: int, fw: int, c: int) -> None:
    """Inverse of torch_import._spatial_map_linear: our (in, fh*fw*c)
    NHWC-ordered output units back to the reference's NCHW view."""
    w = np.transpose(_np(p["w"]))  # (fh*fw*c, in)
    din = w.shape[1]
    w = w.reshape(fh, fw, c, din).transpose(2, 0, 1, 3).reshape(-1, din)
    out[f"{prefix}.weight"] = w.copy()
    if "b" in p:
        b = _np(p["b"]).reshape(fh, fw, c).transpose(2, 0, 1).reshape(-1)
        out[f"{prefix}.bias"] = b.copy()


def export_svg_conv_model(params: Dict, state: Dict) -> Dict[str, np.ndarray]:
    """models/svg.py params -> torch SVGConvModel state_dict (numpy values;
    inverse of torch_import.import_svg_conv_model)."""
    out: Dict[str, np.ndarray] = {}
    export_conv_encoder(out, params["encoder"], state["encoder"])
    export_conv_decoder(out, params["decoder"], state["decoder"])
    _ex_conv(out, "frame_pred_input_conv", params["frame_in"])
    _ex_conv(out, "prior_input_conv", params["prior_in"])
    _ex_conv(out, "posterior_input_conv", params["post_in"])
    _ex_conv_lstm(out, "frame_predictor", params["frame_lstm"])
    _ex_gaussian_conv_lstm(out, "prior", params["prior"])
    _ex_gaussian_conv_lstm(out, "posterior", params["posterior"])
    return out


def export_det_conv_model(params: Dict, state: Dict, fh: int, fw: int
                          ) -> Dict[str, np.ndarray]:
    """models/det.py params -> torch DeterministicConvModel state_dict
    (inverse of torch_import.import_det_conv_model)."""
    out: Dict[str, np.ndarray] = {}
    export_conv_encoder(out, params["encoder"], state["encoder"])
    export_conv_decoder(out, params["decoder"], state["decoder"])
    _ex_spatial_map_linear(out, "action_encoder.0", params["action_enc"],
                           fh, fw, 2)
    if "state_enc" in params:
        _ex_spatial_map_linear(out, "state_encoder.0", params["state_enc"],
                               fh, fw, 2)
    _ex_conv_lstm(out, "frame_predictor", params["frame_lstm"])
    return out


# --- vector-bottleneck family (reference vgg_64.py Encoder/Decoder,
# lstm.py LSTM/GaussianLSTM, dynamics.py:75-266) -------------------------


def _ex_fc_lstm_cells(out: Dict, prefix: str, cells) -> None:
    for i, c in enumerate(cells):
        out[f"{prefix}.lstm.{i}.weight_ih"] = np.transpose(
            _np(c["ih"]["w"])).copy()
        out[f"{prefix}.lstm.{i}.bias_ih"] = _np(c["ih"]["b"]).copy()
        out[f"{prefix}.lstm.{i}.weight_hh"] = np.transpose(
            _np(c["hh"]["w"])).copy()
        out[f"{prefix}.lstm.{i}.bias_hh"] = _np(c["hh"]["b"]).copy()


def _ex_fc_lstm(out: Dict, prefix: str, p: Dict) -> None:
    _ex_linear(out, f"{prefix}.embed", p["embed"])
    _ex_fc_lstm_cells(out, prefix, p["cells"])
    _ex_linear(out, f"{prefix}.output.0", p["out"])


def _ex_gaussian_fc_lstm(out: Dict, prefix: str, p: Dict) -> None:
    _ex_linear(out, f"{prefix}.embed", p["embed"])
    _ex_fc_lstm_cells(out, prefix, p["cells"])
    _ex_linear(out, f"{prefix}.mu_net", p["mu"])
    _ex_linear(out, f"{prefix}.logvar_net", p["logvar"])


def _ex_mlp_encoder(out: Dict, prefix: str, p: Dict) -> None:
    _ex_linear(out, f"{prefix}.output.0", p["l1"])
    _ex_linear(out, f"{prefix}.output.2", p["l2"])


def export_encoder(out: Dict, params: Dict, state: Dict,
                   prefix: str = "encoder") -> None:
    _ex_vgg_stack(out, f"{prefix}.c1", params["c1"], state["c1"])
    _ex_vgg_stack(out, f"{prefix}.c2", params["c2"], state["c2"])
    _ex_vgg_stack(out, f"{prefix}.c3", params["c3"], state["c3"])
    _ex_vgg_stack(out, f"{prefix}.c4", params["c4"], state["c4"])
    _ex_conv(out, f"{prefix}.c5.0", params["c5"]["conv"])
    _ex_bn(out, f"{prefix}.c5.1", params["c5"]["bn"], state["c5"]["bn"])


def export_decoder(out: Dict, params: Dict, state: Dict,
                   prefix: str = "decoder") -> None:
    out[f"{prefix}.upc1.0.weight"] = inv_conv_transpose_w(
        params["upc1"]["conv"]["w"])
    out[f"{prefix}.upc1.0.bias"] = _np(params["upc1"]["conv"]["b"]).copy()
    _ex_bn(out, f"{prefix}.upc1.1", params["upc1"]["bn"], state["upc1"]["bn"])
    _ex_vgg_stack(out, f"{prefix}.upc2", params["upc2"], state["upc2"])
    _ex_vgg_stack(out, f"{prefix}.upc3", params["upc3"], state["upc3"])
    _ex_vgg_stack(out, f"{prefix}.upc4", params["upc4"], state["upc4"])
    _ex_vgg_layer(out, f"{prefix}.upc5.0", params["upc5"][0],
                  state["upc5"][0])
    out[f"{prefix}.upc5.1.weight"] = inv_conv_transpose_w(params["out"]["w"])
    out[f"{prefix}.upc5.1.bias"] = _np(params["out"]["b"]).copy()


def export_det_vector_model(params: Dict, state: Dict
                            ) -> Dict[str, np.ndarray]:
    """models/svg_vector.py (det) -> torch DeterministicModel state_dict."""
    out: Dict[str, np.ndarray] = {}
    export_encoder(out, params["encoder"], state["encoder"])
    export_decoder(out, params["decoder"], state["decoder"])
    _ex_mlp_encoder(out, "action_enc", params["action_enc"])
    if "robot_enc" in params:
        _ex_mlp_encoder(out, "robot_enc", params["robot_enc"])
    _ex_fc_lstm(out, "frame_predictor", params["frame_lstm"])
    return out


def export_svg_vector_model(params: Dict, state: Dict
                            ) -> Dict[str, np.ndarray]:
    """models/svg_vector.py (svg) -> torch SVGModel state_dict."""
    out = export_det_vector_model(params, state)
    _ex_gaussian_fc_lstm(out, "prior", params["prior"])
    _ex_gaussian_fc_lstm(out, "posterior", params["posterior"])
    return out


def _nest(flat: Dict) -> Dict:
    """{keystr: array} -> the nested tree of dicts and lists it flattens
    (list indices are the digit keys)."""
    root: Dict = {}
    for key, v in flat.items():
        *path, leaf = convert.parse_keystr(key)
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def model_trees(model) -> tuple:
    """The port's model -> the JAX package's nested (params, bn_state)
    trees, float32 numpy."""
    params, bn = convert.jax_flat_trees(model)
    return _nest(params), _nest(bn)


def export_state_dict(model, cfg, fh: Optional[int] = None,
                      fw: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The port's model of cfg.model -> the reference's state dict (numpy
    values). fh/fw default to (H/8, W/8) for the det conv action/state
    heads."""
    name = getattr(cfg, "model", "svg")
    exports = {
        "svg": export_svg_conv_model, "svg_vec": export_svg_vector_model,
        "det_vec": export_det_vector_model,
        "det": lambda p, s: export_det_conv_model(
            p, s, fh or cfg.feat_height, fw or cfg.feat_width)}
    if name not in exports:
        raise ValueError(f"no torch export for model {name!r} (supported: "
                         "svg, det, svg_vec, det_vec)")
    return exports[name](*model_trees(model))


def save_torch_checkpoint(path: str, model, cfg, step: int = 0,
                          fh: Optional[int] = None,
                          fw: Optional[int] = None) -> str:
    """Write a `ckpt_*.pt` of the port's model that the reference trainer
    resumes from (trainer.py:846-885 expects {"model": state_dict, "step":
    N})."""
    sd = export_state_dict(model, cfg, fh, fw)
    # The reference's non-finetune resume also loads ckpt["optimizer"]
    # unconditionally (trainer.py:884,896); ship a fresh Adam state_dict
    # (empty per-param state — torch Adam initializes lazily on the first
    # step) whose param-index list matches model.parameters(): every
    # exported tensor except BN buffers (running_*, num_batches_tracked).
    n_params = sum(1 for k in sd
                   if not k.endswith(("running_mean", "running_var",
                                      "num_batches_tracked")))
    probe = torch.optim.Adam(
        [torch.nn.Parameter(torch.zeros(1)) for _ in range(n_params)],
        lr=float(getattr(cfg, "lr", 3e-4)),
        betas=(float(getattr(cfg, "beta1", 0.9)), 0.999),
    )
    # np.array keeps num_batches_tracked 0-d (np.ascontiguousarray would
    # make it (1,), a shape torch loads into the reference's buffer only
    # through its pre-0.4 compatibility path)
    blob = {"model": {k: torch.from_numpy(np.array(v, order="C"))
                      for k, v in sd.items()},
            "optimizer": probe.state_dict(),
            "step": int(step)}
    torch.save(blob, path)
    return path


def main(argv=None):
    """CLI: convert a saved .npz checkpoint to a reference ckpt_*.pt. The
    model is built on --device (cuda by default; there is no fallback)."""
    from robot_aware_control_tpu_torch.config import argparser
    from robot_aware_control_tpu_torch.models.registry import load_model

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="cuda (default) or cpu; there is no fallback")
    pre.add_argument("--out", default=None,
                     help="output .pt path (default: ckpt .npz renamed)")
    args, rest = pre.parse_known_args(argv)
    cfg, _ = argparser(rest)
    src = cfg.dynamics_model_ckpt
    if not src:
        raise SystemExit("--dynamics_model_ckpt <ckpt.npz> is required")
    out = args.out or (os.path.splitext(src)[0] + ".pt")
    model = load_model(cfg, src, device=args.device)
    with np.load(src, allow_pickle=False) as data:
        step = int(data["__step__"])
    save_torch_checkpoint(out, model, cfg, step=step)
    print(f"wrote {out} (step {step}, model {cfg.model})")
    return out


if __name__ == "__main__":
    main()
