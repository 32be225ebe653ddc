"""Per-step model dispatch and conditioning shared with the planner
(counterpart of `robot_aware_control_tpu/training/step.py:_model_step`
and `_conditioning`; reference: src/prediction/trainer.py:373-381). The
training step itself comes with the training slice."""

from __future__ import annotations

import torch

from robot_aware_control_tpu_torch.config import Config


def _model_step(cfg: Config, model, carry, x_j, m_in, r_in, hm_in, a_j,
                generator, sample_mean=False):
    """Dispatch one prediction step (no posterior) to the configured model
    family; the port has svg. Returns (out, new_carry)."""
    if cfg.model != "svg":
        raise NotImplementedError(f"model {cfg.model!r} is not ported yet")
    return model(carry, image=x_j, mask=m_in, robot=r_in, heatmap=hm_in,
                 action=a_j, generator=generator, sample_mean=sample_mean)


def _conditioning(cfg: Config, m_j, m_i, r_j, r_i, hm_j, hm_i):
    """Build mask/state/heatmap conditioning inputs for one step
    (reference: trainer.py:373-381)."""
    m_in = m_j
    if cfg.model_use_future_mask:
        m_in = torch.cat([m_j, m_i], -1)
    r_in = r_j
    if cfg.model_use_future_robot_state:
        r_in = (r_j, r_i)
    hm_in = hm_j
    if cfg.model_use_future_heatmap and hm_j is not None:
        hm_in = torch.cat([hm_j, hm_i], -1)
    return m_in, r_in, hm_in
