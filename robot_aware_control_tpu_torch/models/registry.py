"""Model registry keyed by the reference's --model flag values
(reference: src/config/__init__.py:225, src/prediction/trainer.py:99-107).
The port has svg, det and the parameter-free copy baseline."""

from __future__ import annotations

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models import copy_model, det, svg

_MODELS = {"svg": svg, "det": det, "copy": copy_model}
# the JAX package's other families (models/registry.py), not ported yet
_NOT_PORTED = ("svg_vec", "det_vec", "cdna_det", "cdna_robonet")


def get_model(cfg: Config):
    """Returns the module of cfg.model: init/init_carry for svg and det,
    step for copy."""
    if cfg.model in _MODELS:
        return _MODELS[cfg.model]
    if cfg.model in _NOT_PORTED:
        raise NotImplementedError(f"model {cfg.model!r} is not ported yet")
    raise ValueError(f"unknown model {cfg.model!r}")


def is_stochastic(cfg: Config) -> bool:
    """Models with a learned prior/posterior (KL term in the loss)."""
    return cfg.model in ("svg", "svg_vec")
