"""The model variants a JAX checkpoint can carry, held against the JAX
package on the CPU: the GroupNorm ConvLSTM cell, heatmap conditioning
(current and future) with its heatmaps, the inpaint-blur cost and its
per-step blur flag, the det model, the copy baseline, checkpoints of det
and GroupNorm models in both directions, and the trainer's
--dynamics_model_ckpt. Inputs come from seeded numpy arrays; the JAX
functions' random draws are patched to the injected noise the port is
given. Small sizes: g_dim 16, z_dim 4, 24x32 frames."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.data import calibration as jcalib
from robot_aware_control_tpu.data import heatmaps as jheatmaps
from robot_aware_control_tpu.data.synthetic import synthetic_batch as jsynthetic_batch
from robot_aware_control_tpu.models import det as jdet
from robot_aware_control_tpu.models import svg as jsvg
from robot_aware_control_tpu.ops import lstm as jlstm
from robot_aware_control_tpu.planning import cost as jcost
from robot_aware_control_tpu.planning.rollout import RolloutEngine as JRolloutEngine
from robot_aware_control_tpu.robot.mask_renderer import CapsuleMaskRenderer as JRenderer
from robot_aware_control_tpu.training import checkpoint as jckpt
from robot_aware_control_tpu.training import step as jstep
from robot_aware_control_tpu.training.trainer import PredictionTrainer as JTrainer
from robot_aware_control_tpu_torch import convert
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.control.plan_server import build_server
from robot_aware_control_tpu_torch.data import calibration as tcalib
from robot_aware_control_tpu_torch.data import heatmaps as theatmaps
from robot_aware_control_tpu_torch.data.norm import LOCOBOT_HIGH, LOCOBOT_LOW, normalize
from robot_aware_control_tpu_torch.models import det as tdet
from robot_aware_control_tpu_torch.models import svg as tsvg
from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.ops.lstm import NormConvLSTMCell
from robot_aware_control_tpu_torch.planning import cost as tcost
from robot_aware_control_tpu_torch.planning.cem import CEMPolicy
from robot_aware_control_tpu_torch.planning.rollout import RolloutEngine, prepare_goals
from robot_aware_control_tpu_torch.robot.mask_renderer import CapsuleMaskRenderer
from robot_aware_control_tpu_torch.training import checkpoint as tckpt
from robot_aware_control_tpu_torch.training import step as tstep
from robot_aware_control_tpu_torch.training.trainer import PredictionTrainer
from torch_train_cases import one_torch_thread  # noqa: F401 (autouse)
from torch_train_cases import (
    STEP_KW,
    random_tree as _random_tree,
    STEP_TOL,
    fake_jax_normal,
    flat,
    np_tree,
    port_noise,
    torch_batch,
    window,
)
from torch_train_small import GRAD_TOL_DEVICES, GRAD_TOL_JAX, detached_group_statistics
from torch_variant_cases import (
    CELL_RTOL,
    COST_RTOL,
    FLIP_STEP,
    TRAIN_VARIANTS,
    blur_flip_allowance,
    blur_floor,
    cell_state_err,
    small_rollout,
    start_goal,
)

# the planning variants at 24x32 frames: N 6, horizon 4 (3 model steps);
# the blur's unblur_timestep 1.5 leaves steps 0 and 1 blurred, 2 not
PLAN_KW = dict(STEP_KW, reward_type="dontcare", horizon=4, opt_iter=2,
               action_candidates=6, topk=2, cem_init_std=0.015,
               sample_mean=True)
PLAN_VARIANTS = {
    "heatmap": dict(model_use_heatmap=True, model_use_future_heatmap=True),
    "blur": dict(reward_type="inpaint-blur", unblur_timestep=1.5),
    "group_norm": dict(lstm_group_norm=True),
    "det": dict(model="det"),
}
STACK_TOL = dict(rtol=1e-4, atol=1e-5)
_JAX_CONV_LSTM = jlstm.conv_lstm


def _jax_conv_lstm(params, state, x, group_norm_cells=False, fused=False):
    """JAX `conv_lstm` for GroupNorm cells: the JAX function reads
    params["cell0"]["gates"] (its int8 probe, lstm.py:119) before it
    dispatches, and a GroupNorm cell has no "gates", so every JAX step of a
    GroupNorm model raises KeyError. This runs what conv_lstm runs for
    them after the probe (lstm.py:128-132; _fused_active is False for
    them), and conv_lstm itself for plain cells."""
    if not group_norm_cells:
        return _JAX_CONV_LSTM(params, state, x, group_norm_cells, fused)
    s0, s1 = state
    h, s0 = jlstm.norm_conv_lstm_cell(params["cell0"], s0, x)
    h, s1 = jlstm.norm_conv_lstm_cell(params["cell1"], s1, h)
    return h, (s0, s1)


@pytest.fixture(scope="module", autouse=True)
def jax_group_norm_steps():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlstm, "conv_lstm", _jax_conv_lstm)
        yield


def _jax_trees(jcfg, seed=0, he=True):
    """A JAX model's (params, BatchNorm state), svg or det, as `_random_tree`
    makes them, in the structure the JAX init gives; for svg the prior's
    heads offset (torch_train_small.PRIOR_MU_BIAS) so that the KL term is
    not a cancellation."""
    mod = jdet if jcfg.model == "det" else jsvg
    shapes = jax.eval_shape(lambda k: mod.init(k, jcfg), jax.random.PRNGKey(0))
    params, bn = _random_tree(shapes, np.random.RandomState(seed), he)
    if jcfg.model == "svg":
        for head, value in (("mu", 0.3), ("logvar", -0.5)):
            params["prior"][head]["b"][:] = value
    return params, bn


def _port_model(cfg, params, bn, train=True):
    cls = tdet.Det if cfg.model == "det" else tsvg.SVG
    model = cls(cfg, "cpu", param_dtype=torch.float32 if train else None)
    model.load_state_dict(convert.svg_state_dict(np_tree(params), np_tree(bn)),
                          strict=True)
    return model if train else model.eval().requires_grad_(False)


def _heatmaps(states, w, h):
    """(T, B, h, w, 1) heatmaps of normalized locobot states (T, B, 5)."""
    return np.stack([
        theatmaps.create_heatmaps(states[:, b], LOCOBOT_LOW, LOCOBOT_HIGH,
                                  "locobot", "c0", (w, h))
        for b in range(states.shape[1])], 1)


# ------------------------------------------------------- GroupNorm cell
def _gn_cell_case(rng, cin=12, hid=16, k=3, B=2, H=3, W=4):
    shapes = jax.eval_shape(lambda key: jlstm.norm_conv_lstm_cell_init(
        key, cin, hid, k), jax.random.PRNGKey(0))
    params = _random_tree(shapes, rng)
    x, h, c = (rng.randn(B, H, W, n).astype(np.float32) for n in (cin, hid, hid))
    return params, (x, h, c)


def _port_gn_cell(params, cin=12, hid=16, k=3):
    cell = NormConvLSTMCell(cin, hid, k)
    cell.load_state_dict(convert.svg_state_dict(np_tree(params), {}), strict=True)
    return cell


def test_group_norm_cell_matches_jax(rng):
    """NormConvLSTMCell against norm_conv_lstm_cell, float32, GroupNorm
    scales and biases perturbed: h' and c' to 1e-5. The same weights with
    ih_gn and hh_gn swapped differ by far more."""
    params, (x, h, c) = _gn_cell_case(rng)
    want_h, (_, want_c) = jlstm.norm_conv_lstm_cell(
        jax.tree_util.tree_map(jnp.asarray, params), (jnp.asarray(h), jnp.asarray(c)),
        jnp.asarray(x))
    run = lambda p: _port_gn_cell(p)(torch.tensor(x), (torch.tensor(h),
                                                       torch.tensor(c)))
    with torch.no_grad():
        got_h, (_, got_c) = run(params)
        swapped = dict(params, ih_gn=params["hh_gn"], hh_gn=params["ih_gn"])
        bad_h, _ = run(swapped)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5, atol=1e-5)
    assert np.abs(bad_h.numpy() - np.asarray(want_h)).max() > 1e-2


def test_group_norm_cell_never_takes_the_kernel(monkeypatch):
    """GroupNorm cells run PyTorch ops in inference too (fused requested)."""
    from robot_aware_control_tpu_torch.ops import kernels

    def refuse(*a, **k):
        raise AssertionError("the GroupNorm cell reached the kernel wrapper")

    monkeypatch.setattr(kernels, "conv_lstm_cell", refuse)
    cfg = Config(**dict(STEP_KW, lstm_group_norm=True))
    model = tsvg.init(cfg, 0, "cpu")
    B = 2
    with torch.no_grad():
        out, _ = model(tsvg.init_carry(cfg, B), image=torch.rand(B, 24, 32, 3),
                       mask=torch.zeros(B, 24, 32, 2), robot=torch.rand(B, 5),
                       heatmap=None, action=torch.rand(B, 5), sample_mean=True)
    assert out["x_pred"].shape == (B, 24, 32, 4)


# ------------------------------------------------------------- heatmaps
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("robot,viewpoint", [("locobot", "c0"),
                                             ("sawyer", "sudri0_c1"),
                                             ("widowx", "widowx1_c0")])
def test_create_heatmaps_equals_jax(rng, robot, viewpoint, quantize):
    """The data layer's heatmaps bit for bit, subpixel and quantized."""
    states = rng.uniform(0.0, 1.0, (12, 5)).astype(np.float32)
    args = (states, LOCOBOT_LOW, LOCOBOT_HIGH, robot, viewpoint, (32, 24))
    want = jheatmaps.create_heatmaps(*args, quantize=quantize)
    got = theatmaps.create_heatmaps(*args, quantize=quantize)
    assert got.shape == (12, 24, 32, 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if robot == "locobot":
        assert got.max() > 0.1


@pytest.mark.parametrize("robot,viewpoint", [("locobot", "c3"), ("sawyer", "sudri2_c2"),
                                             ("baxter", "left_c0"), ("franka", "c0"),
                                             ("kuka", "nowhere")])
def test_robot_camera_info_equals_jax(robot, viewpoint):
    for got, want in zip(tcalib.robot_camera_info(robot, viewpoint),
                         jcalib.robot_camera_info(robot, viewpoint)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_render_heatmaps_matches_jax(rng):
    """Eef heatmaps of the planner's renderer on its pixel grid, out-of-frame
    points zeroed: to 1e-6 of the JAX renderer's."""
    eef = np.concatenate([
        rng.uniform([0.15, -0.25, 0.1], [0.5, 0.25, 0.3], (20, 3)),
        [[3.0, 0.0, 0.1], [0.3, 2.0, 0.1]]]).astype(np.float32).reshape(2, 11, 3)
    want = np.asarray(JRenderer((24, 32)).render_heatmaps(jnp.asarray(eef)))
    got = CapsuleMaskRenderer((24, 32), device="cpu").render_heatmaps(
        torch.tensor(eef)).numpy()
    assert got.shape == (2, 11, 24, 32, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert want.max() > 0.1 and not want[1, -2:].any()


# ---------------------------------------------------------- blur cost
@pytest.mark.parametrize("img_dim,sigma", [(128, 10.0), (8, 3.0)])
def test_gaussian_blur_matches_jax(rng, img_dim, sigma):
    """Before the floor, to 1e-5: the default 255-tap blur, mostly zero
    padding on 24x32 images, and a 15-tap one. A TF32-like rounding of the
    input (10 mantissa bits) is off by far more."""
    radius = tcost.InpaintBlurCost(Config(img_dim=img_dim)).radius
    img = rng.rand(4, 24, 32, 3).astype(np.float32)
    want = np.asarray(jcost.gaussian_blur(jnp.asarray(img), sigma, radius))
    got = tcost.gaussian_blur(torch.tensor(img), sigma, radius)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    tf32 = torch.tensor(img).view(torch.int32).bitwise_and(~0x1FFF).view(torch.float32)
    assert np.abs(tcost.gaussian_blur(tf32, sigma, radius).numpy() - want).max() > 1e-5


@pytest.mark.parametrize("blur", [True, False])
def test_inpaint_blur_cost_matches_jax(rng, record_property, blur):
    """InpaintBlurCost per image. Unblurred: -unblur_cost_scale x MSE to
    1e-6. Blurred: floor(255 x blur) / 255 moves a pixel a whole step
    where the two blurs straddle a step, so each cost is held to 1e-6 plus
    one step's worth (FLIP_STEP / pixels) for every pixel of that image or
    of the goal on another step; the pixels on other steps are few
    (recorded as flipped_pixels)."""
    cfg = Config(reward_type="inpaint-blur")
    img = rng.rand(6, 24, 32, 3).astype(np.float32)
    goal = rng.rand(24, 32, 3).astype(np.float32)
    want = np.asarray(jcost.InpaintBlurCost(JConfig(reward_type="inpaint-blur"))(
        jnp.asarray(img), jnp.asarray(goal), blur=blur))
    got = tcost.InpaintBlurCost(cfg)(torch.tensor(img), torch.tensor(goal),
                                     blur=blur).numpy()
    allow = np.zeros(6)
    if blur:
        jc = jcost.InpaintBlurCost(JConfig(reward_type="inpaint-blur"))
        floor = lambda x: np.floor(255.0 * np.asarray(jcost.gaussian_blur(
            jnp.asarray(x), jc.sigma, jc.radius))) / 255.0
        img_flips = (floor(img) != blur_floor(cfg, img).numpy()).reshape(6, -1).sum(1)
        goal_flips = int((floor(goal[None])
                          != blur_floor(cfg, goal[None]).numpy()).sum())
        flips = img_flips + goal_flips
        record_property("flipped_pixels", int(img_flips.sum()) + goal_flips)
        assert flips.sum() <= 1e-3 * img.size, flips
        allow = flips * FLIP_STEP / img[0].size
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 + allow.max())
    assert np.all(np.abs(got - want) <= 1e-6 * np.abs(want) + 1e-7 + allow)


@pytest.mark.parametrize("unblur", [0.5, 1.0, 1.5, 2.5, 4.0])
def test_rollout_blur_flag_follows_unblur_timestep(monkeypatch, unblur):
    """The rollout scores step t blurred iff t < steps - unblur_timestep,
    the JAX rollout's flag (rollout.py:280-288), for fractional values too."""
    cfg = Config(**dict(PLAN_KW, horizon=5, reward_type="inpaint-blur",
                        unblur_timestep=unblur))
    flags = []
    cost = tcost.RobotWorldCost.__call__

    def record(self, *a, blur=True, **k):
        flags.append(blur)
        return cost(self, *a, blur=blur, **k)

    monkeypatch.setattr(tcost.RobotWorldCost, "__call__", record)
    start, goal = start_goal(np.random.RandomState(0), 24, 32)
    gi, gm, _ = prepare_goals(goal, 4)
    RolloutEngine(cfg, device="cpu")(
        tsvg.init(cfg, 0, "cpu"), torch.tensor(start.img),
        torch.tensor(normalize(start.state, LOCOBOT_LOW, LOCOBOT_HIGH)),
        torch.tensor(start.qpos), torch.zeros(2, 4, 5), torch.tensor(gi),
        torch.tensor(gm))
    want = np.asarray(jnp.arange(4) < 4 - unblur).tolist()
    assert flags == want


# ------------------------------------------------------------- rollouts
@pytest.mark.parametrize("variant", sorted(PLAN_VARIANTS))
def test_variant_rollout_matches_jax(rng, variant):
    """The rollout engine's summed costs for the same candidates against the
    JAX engine's (TrajectorySampler's core), the prior's mean for svg: to
    1e-4 relative, and for the blur cost within one 1/255 step a pixel on
    another step (blur_flip_allowance, the goal's blur included)."""
    kw = dict(PLAN_KW, **PLAN_VARIANTS[variant])
    jcfg, cfg = JConfig(**kw), Config(**kw)
    params, bn = _jax_trees(jcfg)
    model = _port_model(cfg, params, bn, train=False)
    start, goal = start_goal(rng, 24, 32)
    goal.masks = [(rng.rand(24, 32) > 0.8).astype(np.float32)
                  for _ in goal.masks]
    acts = np.zeros((6, 3, 5), np.float32)
    acts[..., :2] = rng.uniform(-0.05, 0.05, (6, 3, 2))
    gi, gm, _ = prepare_goals(goal, 3)
    s_norm = normalize(start.state, LOCOBOT_LOW, LOCOBOT_HIGH)
    want, jobs = JRolloutEngine(jcfg)(
        params, bn, jnp.asarray(start.img), jnp.asarray(s_norm),
        jnp.asarray(start.qpos), jnp.asarray(acts), jnp.asarray(gi),
        jnp.asarray(gm), jax.random.PRNGKey(0), ret_obs=True)
    got, obs = RolloutEngine(cfg, device="cpu")(
        model, torch.tensor(start.img), torch.tensor(s_norm),
        torch.tensor(start.qpos), torch.tensor(acts), torch.tensor(gi),
        torch.tensor(gm), torch.Generator().manual_seed(0), ret_obs=True)
    want, allow = np.asarray(want, np.float64), np.zeros(6)
    if cfg.reward_type == "inpaint-blur":
        jc = jcost.InpaintBlurCost(jcfg)
        jgoal = np.floor(255.0 * np.asarray(jcost.gaussian_blur(
            jnp.asarray(gi), jc.sigma, jc.radius))) / 255.0
        goal_flips = (jgoal != blur_floor(cfg, gi).numpy()).reshape(3, -1).sum(1)
        allow, flips = blur_flip_allowance(cfg, obs, np.asarray(jobs), goal_flips)
        assert flips <= 1e-3 * np.asarray(jobs).size
    err = np.abs(got.double().numpy() - want)
    assert np.all(err <= 1e-4 * np.abs(want) + allow), (err, allow)


@pytest.mark.parametrize("robot_state", [True, False])
def test_det_steps_with_padded_carries_match_jax(rng, robot_state):
    """Three det steps at inference from init_carry's carries, each cell
    input built into a padded buffer: x_pred and the carries equal the JAX
    model's to STACK_TOL, and every carry, before and after each step, is a
    (B, 3, 4, C) view of a buffer of C rounded up to 8 channels a pixel (C =
    16 + 2 + 2 with the state maps, 18 without)."""
    kw = dict(STEP_KW, model="det", model_use_robot_state=robot_state)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    params, bn = _jax_trees(jcfg)
    model = _port_model(cfg, params, bn, train=False)
    B, C = 3, cfg.g_dim + (4 if robot_state else 2)
    jcarry = jdet.init_carry(jcfg, B)
    carry = tdet.init_carry(cfg, B, torch.float32, "cpu")

    def states(frame):
        return [t for cell in frame for t in cell]

    for _ in range(3):
        for t in states(carry.frame):
            assert t.shape == (B, 3, 4, C)
            assert kernels.pixel_stride(t) == kernels.round_up(C) > C
        img = rng.rand(B, 24, 32, 3).astype(np.float32)
        mask = (rng.rand(B, 24, 32, 2) > 0.7).astype(np.float32)  # and the next
        robot = rng.randn(B, 5).astype(np.float32)
        action = rng.randn(B, 5).astype(np.float32)
        jout, jcarry, _ = jdet.step(jcfg, params, bn, jcarry, jnp.asarray(img),
                                    jnp.asarray(mask), jnp.asarray(robot),
                                    jnp.asarray(action))
        with torch.no_grad():
            out, carry = model(carry, torch.tensor(img), torch.tensor(mask),
                               torch.tensor(robot), torch.tensor(action))
        np.testing.assert_allclose(out["x_pred"].numpy(),
                                   np.asarray(jout["x_pred"]), **STACK_TOL)
        for got, want in zip(states(carry.frame), states(jcarry.frame)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **STACK_TOL)


_plain_cell = kernels.conv_lstm_cell_plain


def _gate_rows_misread(x, h, c, w, b):
    """The plain cell on weights read the way a kernel that takes them at a
    row stride of 4 Cp reads `pack_gate_weights`' copy, whose rows hold
    4 Cp + 32 columns: every row after the first 32 more columns off."""
    C = h.shape[-1]
    k, _, cin, _ = w.shape
    cp = kernels.round_up(C, 64)
    flat = kernels.pack_gate_weights(w, C).reshape(-1)
    rows = flat[:k * k * cin * 4 * cp].reshape(k, k, cin, 4, cp)
    return _plain_cell(x, h, c, rows[..., :C].reshape(k, k, cin, 4 * C), b)


def test_cost_parity_rejects_a_planted_cell_weight_fault(monkeypatch):
    """The small det rollout of torch_variant_cases (the GPU-vs-CPU cost
    parity) with det's cell reading its gate weights 32 columns a row off:
    its costs stay within COST_RTOL of the right rollout's (at the
    reference's N(0, 0.02) weights the prediction hardly depends on the
    cell), so the check also holds the cells' states, which move by more
    than their own size."""
    want_cost, _, want_cells = small_rollout("det", "cpu")
    monkeypatch.setattr(kernels, "conv_lstm_cell_plain", _gate_rows_misread)
    got_cost, _, got_cells = small_rollout("det", "cpu")
    assert np.all(np.abs(got_cost - want_cost) <= COST_RTOL * np.abs(want_cost))
    assert cell_state_err(got_cells, want_cells) > 1000 * CELL_RTOL
    monkeypatch.undo()
    again = small_rollout("det", "cpu")[2]
    assert cell_state_err(again, want_cells) == 0.0


@pytest.mark.parametrize("variant", sorted(PLAN_VARIANTS))
def test_variant_batched_plans_equal_single(variant):
    """get_action_batched of 3 requests (padded to 4) equals their single
    plans bit for bit: heatmaps rendered and GroupNorms taken over all
    rows, blur costs per request; det draws no prior noise, and its
    requests' generators still draw in single-plan order."""
    cfg = Config(**dict(PLAN_KW, **PLAN_VARIANTS[variant]))
    policy = CEMPolicy(cfg, tsvg.init(cfg, 0, "cpu") if cfg.model == "svg"
                       else tdet.init(cfg, 0, "cpu"), device="cpu")
    reqs = [start_goal(np.random.RandomState(i), 24, 32) for i in range(3)]
    singles = [policy.get_action(s, g, ep_num=i, step=1)
               for i, (s, g) in enumerate(reqs)]
    got = policy.get_action_batched([r[0] for r in reqs], [r[1] for r in reqs],
                                    ep_nums=[0, 1, 2], steps=[1, 1, 1])
    for i in range(3):
        np.testing.assert_array_equal(got[i], singles[i])
    assert len({p.tobytes() for p in singles}) == 3


# ------------------------------------------------- train and eval steps
_JAX_STEPS = {}


def _jax_steps(variant):
    """JAX trees, windows and the JAX train step (sched_prob 1) and eval
    steps (autoregressive and one-step) of a training variant, jitted once,
    with jax.random.normal patched to the injected noise while they trace;
    cached per variant."""
    if variant in _JAX_STEPS:
        return _JAX_STEPS[variant]
    jcfg = JConfig(**dict(STEP_KW, **TRAIN_VARIANTS[variant]))
    params, bn = _jax_trees(jcfg)
    # the train step at the reference's weight scale, where GRAD_TOL_JAX was
    # set: He-scaled weights raise the float32 gradient noise of max pools
    # and BatchNorm (test_torch_port_train.py) to 7e-3 - 9e-3 of a norm
    tparams, tbn = _jax_trees(jcfg, he=False)
    batch = window(jsynthetic_batch(jcfg, 2, 8, seed=0), 4)
    ebatch = window(jsynthetic_batch(jcfg, 2, 8, seed=5), 4)
    if jcfg.model_use_heatmap:
        for b in (batch, ebatch):
            b["states"] = np.random.RandomState(6).uniform(
                0.1, 0.9, b["states"].shape).astype(np.float32)
            b["heatmaps"] = _heatmaps(b["states"], 32, 24)
            assert b["heatmaps"].max() > 0.1
    out = {"cfg": jcfg, "params": params, "bn": bn, "train_params": tparams,
           "train_bn": tbn, "batch": batch, "ebatch": ebatch, "eval": {}}
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", fake_jax_normal)
        step, tx = jstep.make_train_step(jcfg)
        new_p, new_bn, _, metrics = step(
            copy(tparams), copy(tbn), tx.init(tparams),
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(3), jnp.float32(1.0))
        out["train"] = np_tree(new_p), np_tree(new_bn), np_tree(metrics)
        for ar in (True, False):
            per_step, preds = jstep.make_eval_step(jcfg, ar)(
                params, bn, {k: jnp.asarray(v) for k, v in ebatch.items()},
                jax.random.PRNGKey(4))
            out["eval"][ar] = np_tree(per_step), np.asarray(preds)
    _JAX_STEPS[variant] = out
    return out


@pytest.mark.parametrize("variant", sorted(TRAIN_VARIANTS))
def test_variant_train_step_matches_jax(variant):
    """One whole-window train step (sgd at lr 1, ground truth fed) against
    make_train_step: metrics (no kld for det) to 1e-4, BatchNorm statistics
    to 1e-5, every gradient to GRAD_TOL_JAX of its leaf's norm (the limits
    of test_torch_port_train.py, at its weight scale), the GroupNorm
    parameters' included."""
    metrics, errs, bn = _port_train_step(variant)
    new_p, new_bn, jmetrics = _jax_steps(variant)["train"]
    assert set(metrics) == set(jmetrics)
    assert ("kld" in metrics) == (variant != "det")
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, **STEP_TOL, err_msg=k)
    assert set(errs) == set(flat(new_p))
    assert max(errs.values()) <= GRAD_TOL_JAX, max(errs.items(), key=lambda e: e[1])
    if variant == "gn_heatmap":
        assert any("_gn']" in k for k in errs)
    for k, v in flat(new_bn).items():
        np.testing.assert_allclose(bn[k], v, rtol=1e-5, atol=1e-6, err_msg=k)


def _port_train_step(variant):
    """The port's train step on the JAX side's trees and window: its
    metrics, each gradient leaf's |port - JAX| / |JAX| (norms; sgd at lr 1,
    so a step's change is minus its gradient) and its BatchNorm tree."""
    js = _jax_steps(variant)
    cfg = Config(**dict(STEP_KW, **TRAIN_VARIANTS[variant]))
    new_p, _, _ = js["train"]
    model = _port_model(cfg, js["train_params"], js["train_bn"])
    step, _ = tstep.make_train_step(cfg, model)
    before, _ = convert.jax_flat_trees(model)
    metrics = step(torch_batch(js["batch"]), 1.0, noise=port_noise(3, True))
    after, bn = convert.jax_flat_trees(model)
    old = flat(js["train_params"])
    errs = {}
    for k, v in flat(new_p).items():
        g = old[k] - v
        errs[k] = float(np.linalg.norm((before[k] - after[k]) - g) / np.linalg.norm(g))
    return metrics, errs, bn


@pytest.mark.parametrize("stats", [("mean",), ("var",)])
def test_gradient_limits_reject_a_planted_group_norm_fault(stats):
    """The GroupNorm + heatmap step with GroupNorm's mean or variance
    detached in the backward pass (torch_train_small.py) keeps its metrics
    to 1e-4 of the JAX step's, and exceeds both gradient limits, GRAD_TOL_JAX
    and GRAD_TOL_DEVICES, on some leaf (worst leaves 29.1 and 1.68 of their
    norm, both the bias of an `hh` convolution, ahead of a GroupNorm)."""
    _, _, jmetrics = _jax_steps("gn_heatmap")["train"]
    with detached_group_statistics(stats):
        metrics, errs, _ = _port_train_step("gn_heatmap")
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, **STEP_TOL, err_msg=k)
    worst = max(errs.items(), key=lambda e: e[1])
    assert worst[1] > max(GRAD_TOL_JAX, GRAD_TOL_DEVICES), worst


@pytest.mark.parametrize("autoregressive", [True, False])
@pytest.mark.parametrize("variant", sorted(TRAIN_VARIANTS))
def test_variant_eval_step_matches_jax(variant, autoregressive):
    """make_eval_step, the prior (svg) driving the prediction with the
    injected noise: per-step metrics to 1e-4, predictions to 1e-4."""
    js = _jax_steps(variant)
    cfg = Config(**dict(STEP_KW, **TRAIN_VARIANTS[variant]))
    jper, jpreds = js["eval"][autoregressive]
    model = _port_model(cfg, js["params"], js["bn"])
    per, preds = tstep.make_eval_step(cfg, model, autoregressive)(
        torch_batch(js["ebatch"]), noise=port_noise(3, True))
    assert set(per) == set(jper) and preds.shape == jpreds.shape
    for k, v in jper.items():
        np.testing.assert_allclose(per[k].numpy(), v, **STEP_TOL, err_msg=k)
    np.testing.assert_allclose(preds.numpy(), jpreds, rtol=1e-4, atol=1e-5)


def test_swapped_heatmap_and_mask_channels_fail_the_eval_parity(monkeypatch):
    """The eval parity of the heatmap model catches an encoder input with
    the heatmap and mask channels swapped (both non-zero)."""
    js = _jax_steps("gn_heatmap")
    cfg = Config(**dict(STEP_KW, **TRAIN_VARIANTS["gn_heatmap"]))
    encoder_input = tsvg._encoder_input
    monkeypatch.setattr(tsvg, "_encoder_input", lambda c, image, mask, heatmap:
                        encoder_input(c, image, heatmap, mask))
    _, preds = tstep.make_eval_step(cfg, _port_model(cfg, js["params"], js["bn"]))(
        torch_batch(js["ebatch"]), noise=port_noise(3, True))
    jpreds = js["eval"][True][1]
    assert np.abs(preds.numpy() - jpreds).max() > 100 * (1e-4 * np.abs(jpreds).max())


@pytest.mark.parametrize("autoregressive", [True, False])
def test_copy_eval_step_matches_jax(autoregressive):
    """make_copy_eval_step against the JAX copy eval window: predictions
    exact, per-step metrics (make_eval_step's keys, no kld) to 1e-5."""
    jcfg = JConfig(**STEP_KW)
    batch = window(jsynthetic_batch(jcfg, 3, 6, seed=2), 6)
    jper, jpreds = jstep.make_copy_eval_step(jcfg, autoregressive)(
        None, None, {k: jnp.asarray(v) for k, v in batch.items()}, None)
    per, preds = tstep.make_copy_eval_step(Config(**STEP_KW), autoregressive)(
        torch_batch(batch))
    np.testing.assert_array_equal(preds.numpy(), np.asarray(jpreds))
    assert set(per) == set(jper) == {"recon_loss", "robot_loss", "world_loss",
                                     "psnr", "ssim"}
    for k, v in jper.items():
        np.testing.assert_allclose(per[k].numpy(), np.asarray(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------- checkpoints
def _trainer_kw(tmp_path, **kw):
    return dict(dict(STEP_KW, experiment="synthetic", log_dir=str(tmp_path),
                     jobname="v", optimizer="adam", lr=1e-3, test_batch_size=2,
                     niter=1, epoch_size=1, video_length=8, eval_interval=1,
                     checkpoint_interval=1), **kw)


def _adam_state(jcfg, params, seed=3):
    """An optax adam state of `params`' structure: count 4, moments
    U(0, 1e-3)."""
    shapes = jax.eval_shape(jstep.make_optimizer(jcfg).init, params)
    r = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: (np.asarray(4, s.dtype) if s.shape == () else
                   r.uniform(0, 1e-3, s.shape).astype(np.float32)), shapes)


def _assert_flat_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("variant", ["det", "group_norm"])
def test_variant_checkpoints_load_both_ways(tmp_path, variant):
    """A JAX checkpoint of a det or GroupNorm model (params, BatchNorm,
    adam state) loads into the port's trainer and its plan server; a port
    checkpoint after a train step loads through the JAX load_checkpoint
    with JAX templates. Every leaf equal."""
    kw = _trainer_kw(tmp_path / "port", **PLAN_VARIANTS[variant])
    jcfg = JConfig(**kw)
    params, bn = _jax_trees(jcfg)
    state = _adam_state(jcfg, params)
    path = jckpt.save_checkpoint(str(tmp_path / "jax"), 5, {
        "params": params, "bn": bn, "opt": state})
    tr = PredictionTrainer(Config(**kw), device="cpu")
    tr.load_checkpoint(path)
    assert tr._step == 5
    got_p, got_bn = convert.jax_flat_trees(tr.model)
    _assert_flat_equal(got_p, flat(params))
    _assert_flat_equal(got_bn, flat(bn))
    _assert_flat_equal(convert.optimizer_to_jax(tr.cfg, tr.model, tr.optimizer),
                       flat(state))
    server = build_server(Config(**dict(kw, dynamics_model_ckpt=path)), "cpu")
    try:
        _assert_flat_equal(convert.jax_flat_trees(server.policy.model)[0],
                           flat(params))
    finally:
        server.close()
    # the port's own checkpoint, after a step, through the JAX loader
    tr.train_step(torch_batch(window(jsynthetic_batch(jcfg, 2, 4, seed=0), 4)),
                  1.0, tr._generator)
    tr._step = 6
    tr._save(0)
    tckpt.wait_for_checkpoints()
    templates = {"params": params, "bn": bn,
                 "opt": jstep.make_optimizer(jcfg).init(params)}
    trees, step = jckpt.load_checkpoint(tckpt.latest_checkpoint(tr.log_dir),
                                        templates)
    assert step == 6
    for name, want in tr._trees().items():
        _assert_flat_equal(flat(trees[name]), want)
    tr.logger.close()


def _jax_trainer(jcfg):
    """The JAX PredictionTrainer, its model's init jitted while it builds
    (the same values; op by op it takes some 15 s on the CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsvg, "init", jax.jit(jsvg.init, static_argnums=1))
        return JTrainer(jcfg)


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    """One JAX trainer of the svg config for the --dynamics_model_ckpt
    cases, its fresh state put back after each."""
    kw = _trainer_kw(tmp_path_factory.mktemp("jax"), num_devices=1)
    jtr = _jax_trainer(JConfig(**kw))
    fresh = jtr.params, jtr.bn, jtr.opt_state, jtr._step
    yield jtr
    jtr.params, jtr.bn, jtr.opt_state, jtr._step = fresh


@pytest.mark.parametrize("finetune", [False, True])
def test_dynamics_model_ckpt_matches_jax_trainer(jax_trainer, tmp_path, finetune):
    """--dynamics_model_ckpt: the JAX trainer's load_checkpoint and the
    port's give the same parameters, BatchNorm, optimizer state and step
    from one JAX checkpoint; a finetune load takes params and BatchNorm
    only (optimizer fresh, step 0). Without finetune the port's train()
    reads the flag itself: with niter 0 it trains nothing and saves the
    loaded state at the loaded step."""
    kw = _trainer_kw(tmp_path / "run")
    jcfg = JConfig(**kw)
    params, bn = _jax_trees(jcfg, seed=7)
    path = jckpt.save_checkpoint(str(tmp_path / "src"), 9, {
        "params": params, "bn": bn, "opt": _adam_state(jcfg, params)})
    jtr = jax_trainer
    fresh = jtr.params, jtr.bn, jtr.opt_state, jtr._step
    jtr.load_checkpoint(path, finetune=finetune)
    cfg = Config(**dict(kw, niter=0, dynamics_model_ckpt=path))
    tr = PredictionTrainer(cfg, device="cpu")
    if finetune:
        tr.load_checkpoint(path, finetune=True)
    else:
        tr.train()
        with open(os.path.join(tr.log_dir, "log.txt")) as f:
            assert f"loaded {path} at step 9" in f.read()
        saved, step = tckpt.load_checkpoint(tckpt.latest_checkpoint(tr.log_dir),
                                            tr._trees())
        assert step == 9
        _assert_flat_equal(saved["params"], flat(jtr.params))
    assert tr._step == jtr._step == (0 if finetune else 9)
    trees = tr._trees()
    _assert_flat_equal(trees["params"], flat(jtr.params))
    _assert_flat_equal(trees["bn"], flat(jtr.bn))
    _assert_flat_equal(trees["opt"], flat(jtr.opt_state))
    tr.logger.close()
    jtr.params, jtr.bn, jtr.opt_state, jtr._step = fresh


def test_copy_baseline_matches_jax_trainer(tmp_path):
    """--model copy: full train and test epochs of the copy eval, logged at
    steps 0 and 500000 under train/ and test/, equal to the JAX trainer's
    copy_baseline to 1e-5 on the same synthetic data."""
    kw = _trainer_kw(tmp_path / "port", model="copy", epoch_size=2)
    want = _jax_trainer(JConfig(**dict(kw, log_dir=str(tmp_path / "jax"),
                                       num_devices=1))).copy_baseline()
    tr = PredictionTrainer(Config(**kw), device="cpu")
    assert tr.model is None and tr.optimizer is None
    got = tr.train()
    tr.logger.close()
    assert set(got) == set(want) == {"train", "test"}
    for split in want:
        assert set(got[split]) == set(want[split])
        for k, v in want[split].items():
            np.testing.assert_allclose(got[split][k], v, rtol=1e-5, err_msg=k)
    with open(os.path.join(tr.log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    scalars = [r for r in recs if not any(k.endswith("/rollout") for k in r)]
    assert sorted(r["step"] for r in scalars) == [0, 0, 500000, 500000]
    # a rollout gif of each split, at step 0, as the JAX trainer writes
    gifs = {k: r["step"] for r in recs for k in r if k.endswith("/rollout")}
    assert gifs == {"train/rollout": 0, "test/rollout": 0}
    assert {"train_0.gif", "test_0.gif"} <= set(os.listdir(tr.log_dir))


def test_heatmap_model_on_synthetic_data_raises(tmp_path):
    """The synthetic data carries no heatmaps (the JAX step fails on it
    with a TypeError): the port's trainer refuses before it trains."""
    tr = PredictionTrainer(Config(**_trainer_kw(
        tmp_path, **TRAIN_VARIANTS["gn_heatmap"])), device="cpu")
    with pytest.raises(ValueError, match="no heatmaps"):
        tr.train()
    assert tr._step == 0
    tr.logger.close()
