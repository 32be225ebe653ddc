"""The model variants a JAX checkpoint can carry, as checks that run on the
card as well as on the CPU (not a test module; imports no JAX), shared by
chip_smoke.py and tests/test_torch_port_gpu.py:

  * `VARIANTS`: heatmap conditioning (current and future), the inpaint-blur
    cost, GroupNorm ConvLSTM cells and the det model, each as the config
    fields it sets on top of a planning config; `TRAIN_VARIANTS` the two
    trained variants (GroupNorm with heatmaps, det);
  * `plan_launches`: the kernel launches one CEM plan of a variant makes;
  * `small_plan_parity`: a small float32 plan of a variant on the GPU
    against the same plan on the CPU, with injected action noise;
  * `small_cost_parity`: the rollout costs of fixed candidates and the
    cells' states on the way, GPU against CPU; for the blur cost within
    `blur_flip_allowance`.

The inpaint-blur cost floors 255 x the blur to whole steps, so two runs
whose images differ in the last float32 bits may put a pixel on either side
of a step; and with random weights the model's prediction hardly depends on
the candidate, so the candidates' blur costs differ by 3e-8 to 4e-7 (of
0.265, the small config on the CPU): less than float32 noise moves them, so
their order, and a plan, is not a function of the weights alone. The blur
variant is therefore held at its costs, each within one 1/255 step of every
pixel that lands on another step; the other variants at their plans too.
"""

from __future__ import annotations

import numpy as np
import torch

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models.registry import get_model
from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.ops.lstm import ConvLSTMCell, NormConvLSTMCell
from robot_aware_control_tpu_torch.planning.cem import CEMPolicy
from robot_aware_control_tpu_torch.planning.cost import InpaintBlurCost, gaussian_blur
from robot_aware_control_tpu_torch.planning.rollout import RolloutEngine, request_inputs
from robot_aware_control_tpu_torch.utils.state import DemoGoalState, State

VARIANTS = {
    "heatmap": dict(model_use_heatmap=True, model_use_future_heatmap=True),
    # the defaults: img_dim 128 (a 255-tap blur), blur_sigma 10,
    # unblur_timestep 1 (the last rollout step scores unblurred)
    "blur": dict(reward_type="inpaint-blur"),
    "group_norm": dict(lstm_group_norm=True),
    "det": dict(model="det"),
}

# the training variants: GroupNorm cells with current and future heatmaps,
# and det
TRAIN_VARIANTS = {
    "gn_heatmap": dict(lstm_group_norm=True, model_use_heatmap=True,
                       model_use_future_heatmap=True),
    "det": dict(model="det"),
}

# the canonical planning config of bench.py:266-287
CANONICAL = dict(
    model="svg", g_dim=256, z_dim=64, image_height=48, image_width=64,
    action_dim=5, robot_dim=5, model_use_mask=True, model_use_future_mask=True,
    model_use_robot_state=True, reconstruction_loss="dontcare_l1",
    reward_type="dontcare", compute_dtype="bfloat16", horizon=5, opt_iter=10,
    action_candidates=100, topk=5, cem_init_std=0.015,
)
# cut to g_dim 16, z_dim 4, float32, N 6, horizon 3, opt_iter 2
SMALL = dict(CANONICAL, g_dim=16, z_dim=4, compute_dtype="float32",
             horizon=3, opt_iter=2, action_candidates=6, topk=2,
             sample_mean=True)
PLAN_TOL = 1e-4
COST_RTOL = 1e-4
# the cells' h' and c' in a small rollout, relative to their largest |value|
CELL_RTOL = 1e-4
# the most one pixel's move by one 1/255 step changes (blurred image -
# blurred goal)^2, both in [0, 1]
FLIP_STEP = 2 / 255 + 1 / 255 ** 2


def plan_launches(cfg: Config) -> dict:
    """Kernel launches of one plan: per model step 2 cells in each of the
    prior and frame stacks (svg) or in the frame stack (det, cdna_det,
    cdna_robonet), none with GroupNorm cells and none in the vector models
    (svg_vec, det_vec: fc-LSTMs); bf16 cells all through the wgmma/TMA
    kernel, at any g_dim; float32 cells all through the float32 kernel;
    one mask render an iteration."""
    steps = (cfg.horizon - 1) * cfg.opt_iter
    per_step = {"svg": 4, "svg_vec": 0, "det_vec": 0}.get(cfg.model, 2)
    cells = 0 if cfg.lstm_group_norm else per_step * steps
    sm90 = cells if cfg.compute_dtype == "bfloat16" else 0
    f32 = cells if cfg.compute_dtype == "float32" else 0
    return {"conv_lstm_cell": cells, "conv_lstm_cell_sm90": sm90,
            "conv_lstm_cell_f32": f32, "capsule_mask_render": cfg.opt_iter}


def start_goal(rng, h=48, w=64):
    start = State(img=rng.rand(h, w, 3).astype(np.float32),
                  state=np.array([0.3, 0.0, 0.15, 0.0, 0.0], np.float32),
                  qpos=np.zeros(5, np.float32))
    goal = DemoGoalState(
        imgs=[rng.rand(h, w, 3).astype(np.float32) for _ in range(4)],
        masks=[np.zeros((h, w), np.float32) for _ in range(4)])
    return start, goal


def small_plan_parity(name: str, dev="cuda", fields=None):
    """The variant's small float32 plan on `dev` against the CPU's, same
    weights (seed 3) and injected action noise; not for the blur variant
    (module docstring). `fields` replaces VARIANTS[name] (the model
    families: tests/torch_family_cases.py). Call with TF32 off.
    Returns (max |difference|, the kernel launches of the `dev` plan);
    raises AssertionError past PLAN_TOL or where the launches are not
    `plan_launches`'."""
    cfg = Config(**dict(SMALL, **(VARIANTS[name] if fields is None else fields)))
    start, goal = start_goal(np.random.RandomState(1))
    noise = np.random.RandomState(2).randn(
        cfg.opt_iter, cfg.action_candidates, cfg.horizon - 1, 2)
    plans = {}
    for d in ("cpu", dev):
        model = get_model(cfg).init(cfg, seed=3, device=d)
        before = dict(kernels.launches)
        plans[str(d)] = CEMPolicy(cfg, model, device=d).get_action(
            start, goal, noise=noise)
        launched = {k: kernels.launches[k] - before[k] for k in before}
    err = float(np.abs(plans[str(dev)] - plans["cpu"]).max())
    if not err <= PLAN_TOL or launched != plan_launches(cfg):
        raise AssertionError(
            f"{name}: small plan on {dev} differs from the CPU's by {err} "
            f"(tolerance {PLAN_TOL}) or launched {launched}, expected "
            f"{plan_launches(cfg)}")
    return err, launched


def blur_floor(cfg: Config, img):
    """floor(255 x blur) / 255 of images (..., H, W, C), as InpaintBlurCost
    takes it, on the CPU."""
    cost = InpaintBlurCost(cfg)
    x = torch.tensor(np.array(img, np.float32))
    lead = x.shape[:-3]
    x = x.reshape((-1,) + x.shape[-3:])
    out = torch.floor(255.0 * gaussian_blur(x, cost.sigma, cost.radius)) / 255.0
    return out.reshape(lead + out.shape[1:])


def blur_flip_allowance(cfg: Config, obs_a, obs_b, goal_flips=None):
    """The most two runs of one inpaint-blur rollout can differ in each
    candidate's summed cost through pixels on different 1/255 steps: obs
    (T, N, H, W, C) of both runs; goal_flips (T,) the goal's pixels on
    different steps in the two runs, if they blurred it apart. Returns
    ((N,) allowance, pixels on different steps over all blurred steps)."""
    T, N = obs_a.shape[:2]
    numel = int(np.prod(obs_a.shape[2:]))
    flips = torch.zeros(N, dtype=torch.float64)
    for t in range(T):
        if not t < T - cfg.unblur_timestep:  # an unblurred step
            continue
        diff = blur_floor(cfg, obs_a[t]) != blur_floor(cfg, obs_b[t])
        flips += diff.reshape(N, -1).sum(1).double()
        if goal_flips is not None:
            flips += float(goal_flips[t])
    return (flips * FLIP_STEP / numel).numpy(), int(flips.sum())


def small_rollout(name: str, dev):
    """The variant's small float32 rollout on `dev` for fixed candidates
    (weights from seed 3, the prior's mean). Returns (costs (N,) float64,
    predicted images, the float32 (h', c') of every ConvLSTM cell call in
    call order), all on the CPU."""
    cfg = Config(**dict(SMALL, **VARIANTS[name]))
    start, goal = start_goal(np.random.RandomState(1))
    rng = np.random.RandomState(4)
    acts = np.zeros((8, cfg.horizon - 1, cfg.action_dim), np.float32)
    acts[..., :2] = rng.uniform(-0.05, 0.05, acts[..., :2].shape)
    model = get_model(cfg).init(cfg, seed=3, device=dev)
    states = []

    def keep(module, args, out):
        states.append([t.float().cpu() for t in out[1]])

    hooks = [m.register_forward_hook(keep) for m in model.modules()
             if isinstance(m, (ConvLSTMCell, NormConvLSTMCell))]
    inputs = [None if a is None else torch.tensor(a, device=dev)
              for a in request_inputs(cfg, start, goal, cfg.horizon - 1)]
    try:
        cost, obs = RolloutEngine(cfg, device=dev)(
            model, *inputs[:3], torch.tensor(acts, device=dev), *inputs[3:5],
            torch.Generator(dev).manual_seed(0), ret_obs=True)
    finally:
        for hook in hooks:
            hook.remove()
    return cost.cpu().double().numpy(), obs.cpu(), states


def cell_state_err(got, want) -> float:
    """The largest max |got - want| / max |want| over the cell calls'
    h' and c' of two rollouts (`small_rollout`)."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} cell calls, expected {len(want)}")
    return max((float((g - w).abs().max() / w.abs().max())
                for gs, ws in zip(got, want) for g, w in zip(gs, ws)),
               default=0.0)


def small_cost_parity(name: str, dev="cuda"):
    """The variant's small float32 rollout on `dev` against the CPU's
    (`small_rollout`): the summed costs to COST_RTOL relative, plus
    `blur_flip_allowance` for the blur cost, and every cell call's h' and
    c' to CELL_RTOL of the CPU's largest |value| in it. The costs alone
    cannot see a wrong cell: at the reference's N(0, 0.02) weights the
    cells' states are about 1e-3 and the prediction hardly depends on them
    (a planted weight-stride fault in det's cell moves the costs by 1e-7
    relative, its states by their own size: test_torch_port_variants.py).
    Call with TF32 off. Returns (max |difference| / |cost|, pixels on
    different blur steps, `cell_state_err`); raises AssertionError past a
    bound."""
    cfg = Config(**dict(SMALL, **VARIANTS[name]))
    want, obs_cpu, cells_cpu = small_rollout(name, "cpu")
    got, obs_dev, cells_dev = small_rollout(name, dev)
    allow, flips = np.zeros_like(want), 0
    if cfg.reward_type == "inpaint-blur":
        allow, flips = blur_flip_allowance(cfg, obs_dev, obs_cpu)
    err = np.abs(got - want)
    if not np.all(err <= COST_RTOL * np.abs(want) + allow):
        raise AssertionError(
            f"{name}: rollout costs on {dev} differ from the CPU's by {err} "
            f"(bound {COST_RTOL} x |cost| + {allow}, {flips} pixels on "
            "other blur steps)")
    cell_err = cell_state_err(cells_dev, cells_cpu)
    if not cell_err <= CELL_RTOL:
        raise AssertionError(
            f"{name}: cell states on {dev} differ from the CPU's by "
            f"{cell_err} of their largest value (tolerance {CELL_RTOL})")
    return float((err / np.abs(want)).max()), flips, cell_err
