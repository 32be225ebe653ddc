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
