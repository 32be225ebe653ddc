"""Model registry keyed by the reference's --model flag values
(reference: src/config/__init__.py:225). The port has the svg family."""

from __future__ import annotations

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models import svg


def get_model(cfg: Config):
    """Returns the module implementing init/init_carry for cfg.model."""
    if cfg.model == "svg":
        return svg
    raise NotImplementedError(f"model {cfg.model!r} is not ported yet")
