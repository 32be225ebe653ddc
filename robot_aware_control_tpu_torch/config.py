"""Run configuration for the PyTorch port.

A copy of the fields of `robot_aware_control_tpu.config.Config` that the
CEM planning path reads, with the same names and defaults, so a config
written for one package means the same thing in the other. The argparse
front end and the YAML helpers come with the training slice.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Config:
    """Immutable run configuration (field names match the reference CLI)."""

    seed: int = 0
    experiment: str = "train_robonet"
    modified: bool = False  # the longer-forearm locobot variant

    # --- model ---
    model: str = "svg"
    image_width: int = 64
    image_height: int = 48
    channels: int = 3
    z_dim: int = 10
    g_dim: int = 128
    action_dim: int = 2
    robot_dim: int = 6
    last_frame_skip: bool = False
    model_use_mask: bool = False
    model_use_future_mask: bool = False
    model_use_robot_state: bool = True
    model_use_future_robot_state: bool = False
    model_use_heatmap: bool = False
    model_use_future_heatmap: bool = False
    black_robot_input: bool = False
    reconstruction_loss: str = "mse"  # mse|l1|dontcare_mse|dontcare_l1
    robot_pixel_weight: float = 0.0
    sample_mean: bool = False
    # the reference's posterior re-encodes the current frame; False keeps
    # the standard SVG-LP semantics (posterior sees the next frame)
    posterior_use_current_frame: bool = False
    # activations and conv weights; BatchNorm and LSTM biases stay float32
    compute_dtype: str = "bfloat16"  # float32|bfloat16

    # --- planner ---
    reward_type: str = "weighted"
    horizon: int = 5
    opt_iter: int = 10
    action_candidates: int = 30
    topk: int = 5
    candidates_batch_size: int = 200
    cem_init_std: float = 1.0
    sparse_cost: bool = False
    cem_prediction_use_thick_mask: bool = True
    # metres of eef displacement per unit planner action
    eef_action_scale: float = 1.0

    # --- cost ---
    robot_cost_weight: float = 0.0
    world_cost_weight: float = 1.0
    img_cost_threshold: Optional[float] = None
    img_cost_world_norm: bool = True

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def feat_height(self) -> int:
        return self.image_height // 8

    @property
    def feat_width(self) -> int:
        return self.image_width // 8

    @property
    def enc_channels(self) -> int:
        """Encoder input channel count (reference: dynamics.py:476-486)."""
        c = self.channels
        if self.model_use_mask:
            c += 1
            if self.model_use_future_mask:
                c += 1
        if self.model_use_heatmap:
            c += 1
            if self.model_use_future_heatmap:
                c += 1
        return c

    @property
    def dontcare(self) -> bool:
        return "dontcare" in self.reconstruction_loss or self.black_robot_input
