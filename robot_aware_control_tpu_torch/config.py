"""Run configuration for the PyTorch port.

A copy of the fields of `robot_aware_control_tpu.config.Config` that the
port reads (the CEM planner, the train and eval steps and the trainer),
with the same names and defaults, so a config written for one package
means the same thing in the other; and a copy of its argparse front end
(`create_parser`, `argparser`), so the port's trainer takes the same
`--flags`. Fields the port cannot honour yet raise `NotImplementedError`
where they are read.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() == "true"


@dataclass(frozen=True)
class Config:
    """Immutable run configuration (field names match the reference CLI)."""

    # --- job / logging ---
    jobname: Optional[str] = None
    log_dir: str = "logs"
    seed: int = 0
    experiment: str = "train_robonet"
    modified: bool = False  # the longer-forearm locobot variant

    # --- prediction / SVG ---
    lr: float = 0.0003
    beta1: float = 0.9
    optimizer: str = "adam"  # adam|rmsprop|sgd
    batch_size: int = 100
    test_batch_size: int = 16
    niter: int = 300
    epoch_size: int = 600
    dataset: str = "smmnist"
    n_past: int = 1
    n_future: int = 9
    n_eval: int = 10
    checkpoint_interval: int = 5
    eval_interval: int = 5
    # eval batches per epoch metric pass; 0 = the full eval set
    eval_batches: int = 0
    model: str = "svg"
    image_width: int = 64
    image_height: int = 48
    channels: int = 3
    z_dim: int = 10
    g_dim: int = 128
    action_dim: int = 2
    robot_dim: int = 6
    robot_joint_dim: int = 7
    beta: float = 0.0001
    last_frame_skip: bool = False
    model_use_mask: bool = False
    model_use_future_mask: bool = False
    model_use_robot_state: bool = True
    model_use_future_robot_state: bool = False
    model_use_heatmap: bool = False
    model_use_future_heatmap: bool = False
    black_robot_input: bool = False
    reconstruction_loss: str = "mse"  # mse|l1|dontcare_mse|dontcare_l1
    scheduled_sampling: bool = False
    scheduled_sampling_k: int = 4000
    robot_pixel_weight: float = 0.0
    lstm_group_norm: bool = False
    # the hand-written ConvLSTM cell kernel on inference paths (planning,
    # eval); training runs the autograd cell (the kernel has no backward)
    fused_lstm: bool = True
    sharded_checkpoint: bool = False
    sample_mean: bool = False
    # the reference's posterior re-encodes the current frame; False keeps
    # the standard SVG-LP semantics (posterior sees the next frame)
    posterior_use_current_frame: bool = False

    # --- dataset ---
    video_length: int = 31
    random_snippet: bool = True
    movement_weight: float = 1.0

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

    # --- port of the JAX package's additions ---
    # activations and conv weights at use; BatchNorm, LSTM biases and a
    # training model's parameters stay float32
    compute_dtype: str = "bfloat16"  # float32|bfloat16
    # write npz checkpoints on a background thread
    async_checkpoint: bool = True
    # recompute per-step activations in the backward pass: "full" the whole
    # step, "conv" all but the convolutions' outputs
    remat: bool = False
    remat_policy: str = "full"  # full|conv

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


_BOOL_FIELDS = {
    f.name for f in dataclasses.fields(Config) if f.type in ("bool", bool)
}


def create_parser() -> argparse.ArgumentParser:
    """An argparse parser whose flags mirror the reference CLI: every
    Config field becomes `--<name>`; booleans accept true/false strings."""
    parser = argparse.ArgumentParser(
        "Robot Aware Cost (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    for f in dataclasses.fields(Config):
        name = f"--{f.name}"
        if f.name in _BOOL_FIELDS:
            parser.add_argument(name, type=str2bool, default=f.default)
        elif f.type in ("int", int):
            parser.add_argument(name, type=int, default=f.default)
        elif f.type in ("float", float, "Optional[float]"):
            parser.add_argument(name, type=float, default=f.default)
        else:
            parser.add_argument(name, type=str, default=f.default)
    return parser


def argparser(argv=None) -> Tuple[Config, list]:
    """Parse CLI args into a Config; returns (cfg, unparsed flags)."""
    args, unparsed = create_parser().parse_known_args(argv)
    return Config(**vars(args)), unparsed
