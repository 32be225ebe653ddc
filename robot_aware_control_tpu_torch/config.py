"""Run configuration for the PyTorch port.

A copy of the fields of `robot_aware_control_tpu.config.Config` that the
port reads (the CEM planner and its server, the controller, the train and
eval steps, the data loaders and the trainer, the simulated envs, data
collection and the episode runner),
with the same names and defaults, so a config written for one package
means the same thing in the other; and a copy of its argparse front end
(`create_parser`, `argparser`), so the port's trainer takes the same
`--flags`; and of its YAML helpers (`from_yaml`, `to_yaml`), whose files
read in either package. Fields the port cannot honour yet raise
`NotImplementedError` where they are read.
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


def str2intlist(value):
    if not value:
        return ()
    if isinstance(value, (list, tuple)):
        return tuple(int(v) for v in value)
    return tuple(int(num) for num in value.split(","))


def str2strlist(value):
    if isinstance(value, (list, tuple)):
        return tuple(value)
    return tuple(v for v in value.split(",") if v)


@dataclass(frozen=True)
class Config:
    """Immutable run configuration (field names match the reference CLI)."""

    # --- job / logging ---
    jobname: Optional[str] = None
    log_dir: str = "logs"
    seed: int = 0
    experiment: str = "train_robonet"
    modified: bool = False  # the longer-forearm locobot variant
    # the task env; picks the plan server's CEM variant (control/plan_server.py)
    env: str = "FetchPush"  # FetchPush|LocobotTable|LocobotPick

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
    # the vector models' fc-LSTM stacks (models/svg_vector.py)
    rnn_size: int = 256
    prior_rnn_layers: int = 2
    posterior_rnn_layers: int = 2
    predictor_rnn_layers: int = 2
    model: str = "svg"  # svg|det|copy|svg_vec|det_vec|cdna_det|cdna_robonet
    image_width: int = 64
    image_height: int = 48
    channels: int = 3
    z_dim: int = 10
    g_dim: int = 128
    action_dim: int = 2
    action_enc_dim: int = 2
    robot_dim: int = 6
    robot_enc_dim: int = 6
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
    # finetune: the learned robot MLPs (training/robot_trainer.py) in place
    # of the analytical model, loaded from a {joint_model, gripper_model}
    # checkpoint
    learned_robot_model: bool = False
    robot_model_ckpt: Optional[str] = None
    cdna_kernel_size: int = 5
    lstm_group_norm: bool = False
    # the hand-written ConvLSTM cell kernel on inference paths (planning,
    # eval); training runs the autograd cell (the kernel has no backward)
    fused_lstm: bool = True
    # int8 planning path (none|int8): the rollout's convolutions and conv
    # cells in int8 (ops/quant.py)
    plan_quantize: str = "none"
    # planning-as-a-service endpoint (control/plan_server.py): one warm
    # planner on the GPU host, robot clients over TCP
    plan_server_host: str = "127.0.0.1"
    plan_server_port: int = 0
    sharded_checkpoint: bool = False
    sample_mean: bool = False
    # the reference's posterior re-encodes the current frame; False keeps
    # the standard SVG-LP semantics (posterior sees the next frame)
    posterior_use_current_frame: bool = False
    # channel dropout of the vector encoder's stages in training (svg_vec,
    # det_vec); None: off
    dropout: Optional[float] = None

    # --- dataset ---
    data_threads: int = 5
    data_root: str = "data"
    train_val_split: float = 0.8
    video_type: str = "object_inpaint_demo"
    video_length: int = 31
    impute_autograsp_action: bool = True
    preload_ram: bool = False
    preprocess_action: str = "raw"  # raw|camera_raw|state_infer|camera_state_infer
    img_augmentation: bool = False
    color_jitter_range: float = 0.1
    random_crop_size: int = 59
    # a {file path: high movement} pickle (evaluation/obj_movement.py)
    world_error_dict: Optional[str] = None
    finetune_num_train: int = 400
    finetune_num_test: int = 100
    random_snippet: bool = True
    load_movement_info: bool = False
    movement_weight: float = 1.0
    # runner demos (data/demo_io.py) that the demo-video loaders read
    demo_dir: str = "demos/fetch_push"

    # --- planner ---
    # weighted|dense|inpaint|sparse|blackrobot|inpaint-blur|eef_inpaint|dontcare
    reward_type: str = "weighted"
    # inpaint-blur: Gaussian sigma, the unblurred steps' cost scale, and the
    # number of final rollout steps scored unblurred
    blur_sigma: float = 10.0
    unblur_cost_scale: float = 3.0
    unblur_timestep: float = 1.0
    horizon: int = 5
    opt_iter: int = 10
    action_candidates: int = 30
    topk: int = 5
    replan_every: int = 1
    # a checkpoint (ckpt_<step>.npz) whose model the plan server loads
    dynamics_model_ckpt: Optional[str] = None
    candidates_batch_size: int = 200
    # save top-K rollout gifs of each plan (not ported: raises)
    debug_cem: bool = False
    # seed the CEM mean from the demo's actions (opt_traj) when given
    demo_cost: bool = False
    cem_init_std: float = 1.0
    # pick CEM, demo-seeded: False (default) keeps exploration local around
    # the demo seed; True applies the reference's unseeded wide-x scheme
    # (pick/cem.py:66-74 x-std 0.2, gripper std 0.005) even when seeded
    pick_wide_x_std: bool = False
    sparse_cost: bool = False
    # execute the whole plan before replanning (visual MPC controller)
    cem_open_loop: bool = False
    cem_prediction_use_thick_mask: bool = True
    # metres of eef displacement per unit planner action
    eef_action_scale: float = 1.0

    # --- cost ---
    robot_cost_weight: float = 0.0
    world_cost_weight: float = 1.0
    img_cost_threshold: Optional[float] = None
    img_cost_world_norm: bool = True

    # --- envs and control ---
    max_episode_length: int = 10
    # the env's render size; the inpaint-blur cost's blur window follows it
    img_dim: int = 128
    # a measured camera of data/calibration.py (others: locobot_c0)
    camera_name: str = "external_camera_0"
    # extra views of the multiview envs (envs/variants.py)
    camera_ids: Tuple[int, ...] = (0, 4)
    multiview: bool = False
    red_robot: bool = False
    action_repeat: int = 1
    action_noise: float = 0.0
    pixels_ob: bool = True
    norobot_pixels_ob: bool = False
    most_recent_background: bool = False
    robot_mask_with_obj: bool = False
    inpaint_eef: bool = True
    # depth maps: the analytic rasterizer has none (raises)
    depth_ob: bool = False
    large_block: bool = False
    object_dist_threshold: float = 0.01
    gripper_dist_threshold: float = 0.025
    # scripted demos (envs/*.generate_demo) and data collection
    temporal_beta: float = 1.0
    demo_length: int = 12
    push_dist: float = 0.2
    robot_goal_distribution: str = "random"
    invisible_demo: bool = False
    num_episodes: int = 100
    collect_target: str = "train"  # train|demos|both
    # the episode runner (control/episode_runner.py)
    mbrl_algo: str = "cem"
    use_env_dynamics: bool = False
    debug_trajectory_path: Optional[str] = None
    object_demo_dir: Optional[str] = None
    subgoal_start: int = 0
    sequential_subgoal: bool = True
    # advance a pending subgoal after this many executed steps (0: never)
    subgoal_step_limit: int = 0
    demo_timescale: int = 1
    demo_type: str = "object_only_demo"
    goal_image_type: str = "image"
    world_cost_success: float = 4000.0
    robot_cost_success: float = 0.01
    subgoal_completion_bonus: float = 0.0
    record_trajectory: bool = False
    record_trajectory_interval: int = 5
    record_video_interval: int = 1
    # observation translation for transfer (not ported: raises)
    cyclegan: bool = False
    cyclegan_ckpt: Optional[str] = None

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

    # --- parallel layouts (parallel/mesh.py) ---
    # ranks of the process group to use (0: all of them)
    num_devices: int = 0
    # mesh dimension names: the data axis first, then the model axis
    mesh_axes: Tuple[str, ...] = ("data",)
    # ranks a model axis (tensor parallelism) groups; must divide the world
    model_axis_size: int = 1
    # replicated (DDP) | data (FSDP2) | model (channel-sharded parameters
    # over the model axis, gathered at use)
    param_sharding: str = "replicated"

    def __post_init__(self):
        if self.plan_quantize not in ("none", "int8"):
            raise ValueError(f"plan_quantize={self.plan_quantize!r}: expected "
                             "'none' or 'int8'")
        if self.param_sharding not in ("replicated", "data", "model"):
            raise ValueError(f"param_sharding={self.param_sharding!r}: "
                             "expected 'replicated', 'data' or 'model'")

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
        elif f.name == "camera_ids":
            parser.add_argument(name, type=str2intlist, default=f.default)
        elif f.name == "mesh_axes":
            parser.add_argument(name, type=str2strlist, default=f.default)
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


# The JAX Config's fields that the port does not carry, at their JAX
# defaults: a YAML file written by the JAX package's `to_yaml` loads here
# while they hold these values. wandb logging is not ported; `gpu` the JAX
# package itself accepts and ignores.
JAX_ONLY_DEFAULTS = {
    "wandb": False,
    "wandb_entity": "pal",
    "wandb_project": "roboaware",
    "wandb_group": None,
    "wandb_job_type": None,
    "gpu": None,
}


def from_yaml(path: str, **overrides) -> Config:
    """A Config from a YAML mapping (JAX `config.from_yaml`; reference: the
    vendored robonet YAML configs, robonet/robonet/yaml_util.py); keyword
    arguments override the file's values. Unknown keys raise KeyError; a
    JAX-only field (JAX_ONLY_DEFAULTS) away from its default raises
    NotImplementedError."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    fields = {f.name for f in dataclasses.fields(Config)}
    unknown = set(data) - fields - set(JAX_ONLY_DEFAULTS)
    if unknown:
        raise KeyError(f"unknown config keys in {path}: {sorted(unknown)}")
    for k, default in JAX_ONLY_DEFAULTS.items():
        if k in data and data.pop(k) != default:
            raise NotImplementedError(
                f"{path}: {k} is a JAX package field the port does not "
                f"carry; it must keep its default {default!r}")
    data.update(overrides)
    for k in ("camera_ids", "mesh_axes"):
        if k in data:
            data[k] = tuple(data[k])
    return Config(**data)


def to_yaml(cfg: Config, path: str):
    """Writes a Config as YAML (round-trips with from_yaml, and reads in
    the JAX package's from_yaml)."""
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(
            {k: (list(v) if isinstance(v, tuple) else v)
             for k, v in dataclasses.asdict(cfg).items()},
            f, sort_keys=True)
