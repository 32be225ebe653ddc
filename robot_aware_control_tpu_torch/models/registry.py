"""Model registry keyed by the reference's --model flag values
(reference: src/config/__init__.py:225, src/prediction/trainer.py:99-107),
every family of the JAX package's registry."""

from __future__ import annotations

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models import cdna, copy_model, det, svg, svg_vector

_MODELS = {"svg": svg, "det": det, "copy": copy_model, "svg_vec": svg_vector,
           "det_vec": svg_vector.det, "cdna_det": cdna,
           "cdna_robonet": cdna.robonet}


def get_model(cfg: Config):
    """Returns the module (or module-like class) of cfg.model: init and
    init_carry for the learned models, step for copy."""
    if cfg.model in _MODELS:
        return _MODELS[cfg.model]
    raise ValueError(f"unknown model {cfg.model!r}")


def is_stochastic(cfg: Config) -> bool:
    """Models with a learned prior/posterior (KL term in the loss)."""
    return cfg.model in ("svg", "svg_vec")


def load_model(cfg: Config, ckpt_path=None, device="cuda"):
    """An inference model of cfg.model on `device`: the weights of a
    ckpt_<step>.npz of either package's trainer, or random ones from
    cfg.seed without one."""
    from robot_aware_control_tpu_torch import convert
    from robot_aware_control_tpu_torch.training import checkpoint as ckpt

    model = get_model(cfg).init(cfg, cfg.seed, device)
    if ckpt_path:
        params, bn = convert.jax_flat_trees(model)
        trees, _ = ckpt.load_checkpoint(ckpt_path, {"params": params,
                                                    "bn": bn})
        model.load_state_dict(
            convert.state_dict_from_flat(trees["params"], trees["bn"]),
            strict=True)
    return model
