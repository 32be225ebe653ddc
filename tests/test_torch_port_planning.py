"""The port's planner held against the JAX package on the CPU: costs per
reward type, rollout costs for the same actions, and whole CEM plans with
the same injected action noise (f32, sample_mean=True)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.models import svg as jsvg
from robot_aware_control_tpu.planning import cem as jcem
from robot_aware_control_tpu.planning import cost as jcost
from robot_aware_control_tpu.planning.rollout import (
    RolloutEngine as JRolloutEngine,
    TrajectorySampler,
)
from robot_aware_control_tpu.utils.state import DemoGoalState, State
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.convert import svg_from_jax
from robot_aware_control_tpu_torch.data.norm import LOCOBOT_HIGH, LOCOBOT_LOW, normalize
from robot_aware_control_tpu_torch.planning import cost as tcost
from robot_aware_control_tpu_torch.planning.cem import CEMPolicy
from robot_aware_control_tpu_torch.planning.rollout import (
    RolloutEngine,
    frame_shift,
    prepare_goals,
)

# the planning config of bench.py cut to test size: g_dim 16, z_dim 4,
# N 6, horizon 3, opt_iter 2, in float32
PLAN_KW = dict(
    model="svg", g_dim=16, z_dim=4, image_height=48, image_width=64,
    action_dim=5, robot_dim=5, model_use_mask=True, model_use_future_mask=True,
    model_use_robot_state=True, reconstruction_loss="dontcare_l1",
    reward_type="dontcare", compute_dtype="float32", horizon=3, opt_iter=2,
    action_candidates=6, topk=2, cem_init_std=0.015, sample_mean=True,
)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    jcfg = JConfig(**PLAN_KW)
    # jitted: one compile instead of one per op, half the time on the CPU
    params, bn = jax.jit(jsvg.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    # non-trivial BatchNorm statistics, so that they are carried across too
    r = np.random.RandomState(1)
    bn = jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.uniform(0.5, 1.5, a.shape).astype(np.float32)), bn)
    cfg = Config(**PLAN_KW)
    model = svg_from_jax(cfg, _np(params), _np(bn), device="cpu")
    return jcfg, params, bn, cfg, model


def _start_goal(rng, n_goals=2, states=False):
    start = State(img=rng.rand(48, 64, 3).astype(np.float32),
                  state=np.array([0.3, 0.0, 0.15, 0, 0], np.float32),
                  qpos=np.zeros(5, np.float32))
    goal = DemoGoalState(
        imgs=[rng.rand(48, 64, 3).astype(np.float32) for _ in range(n_goals)],
        masks=[(rng.rand(48, 64) > 0.8).astype(np.float32)
               for _ in range(n_goals)],
        states=([rng.rand(5).astype(np.float32) for _ in range(n_goals)]
                if states else None))
    return start, goal


# ---------------------------------------------------------------- costs
COST_CASES = {
    "dontcare": {},
    "dontcare_threshold": dict(reward_type="dontcare", img_cost_threshold=20.0),
    "dontcare_no_world_norm": dict(reward_type="dontcare",
                                   img_cost_world_norm=False),
    "dense": dict(reward_type="dense"),
    "weighted": dict(reward_type="weighted", robot_pixel_weight=0.3),
    "inpaint": dict(reward_type="inpaint"),
    "eef_inpaint": dict(reward_type="eef_inpaint", robot_cost_weight=0.5),
    "blackrobot": dict(reward_type="blackrobot"),
    "sparse": dict(reward_type="sparse", img_cost_threshold=3000.0),
}


@pytest.mark.parametrize("case", sorted(COST_CASES))
def test_cost_matches_jax(case, rng):
    """Each reward branch of RobotWorldCost against the JAX cost, to 1e-5
    relative: the same float32 reductions in another summation order."""
    kw = dict(PLAN_KW, **COST_CASES[case])
    c = rng.rand(4, 8, 8, 3).astype(np.float32)
    g = rng.rand(8, 8, 3).astype(np.float32)
    cm = (rng.rand(4, 8, 8, 1) > 0.7).astype(np.float32)
    gm = (rng.rand(8, 8, 1) > 0.7).astype(np.float32)
    bg = rng.rand(8, 8, 3).astype(np.float32)
    cs, gs = rng.rand(4, 5).astype(np.float32), rng.rand(5).astype(np.float32)
    want = jcost.RobotWorldCost(JConfig(**kw))(
        jnp.asarray(c), jnp.asarray(g), jnp.asarray(cm), jnp.asarray(gm),
        jnp.asarray(cs), jnp.asarray(gs), background=jnp.asarray(bg))
    got = tcost.RobotWorldCost(Config(**kw))(
        torch.tensor(c), torch.tensor(g), torch.tensor(cm), torch.tensor(gm),
        torch.tensor(cs), torch.tensor(gs), background=torch.tensor(bg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_inpaint_blur_cost_dispatches():
    """RobotWorldCost dispatches reward_type inpaint-blur to
    InpaintBlurCost, the blurred branch by default and the unblurred one
    (-unblur_cost_scale x MSE) when asked, as the JAX RobotWorldCost."""
    rng = np.random.RandomState(3)
    cfg = Config(reward_type="inpaint-blur", img_dim=8, world_cost_weight=2.0)
    c = torch.tensor(rng.rand(3, 8, 8, 3).astype(np.float32))
    g = torch.tensor(rng.rand(8, 8, 3).astype(np.float32))
    cost = tcost.RobotWorldCost(cfg)
    blur = tcost.InpaintBlurCost(cfg)
    torch.testing.assert_close(cost(c, g), 2.0 * blur(c, g), rtol=0, atol=0)
    want = jcost.RobotWorldCost(JConfig(reward_type="inpaint-blur", img_dim=8,
                                        world_cost_weight=2.0))(
        jnp.asarray(c.numpy()), jnp.asarray(g.numpy()), blur=False)
    np.testing.assert_allclose(cost(c, g, blur=False).numpy(), np.asarray(want),
                               rtol=1e-6)


def test_prepare_goals_matches_jax(models, rng):
    jcfg, params, bn, _, _ = models
    _, goal = _start_goal(rng, n_goals=2, states=True)
    want = TrajectorySampler(jcfg, params, bn).prepare_goals(goal, 4)
    for w, g in zip(want, prepare_goals(goal, 4)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("experiment",
                         ["train_robonet", "control_franka", "control_wx250s"])
def test_frame_shift_matches_jax(models, experiment):
    jcfg, params, bn, cfg, _ = models
    state = np.array([0.3, -0.1, 0.15, 0.2, 0.0], np.float32)
    want = TrajectorySampler(jcfg.replace(experiment=experiment), params,
                             bn)._frame_shift(state)
    np.testing.assert_array_equal(
        frame_shift(cfg.replace(experiment=experiment), state), want)


# ------------------------------------------------------------- rollouts
ROLLOUT_CASES = {
    "f32": {},
    "f32_robot_cost": dict(robot_cost_weight=0.5),
    # no robot-pixel blackout of the model input, final step scored only
    "f32_sparse_no_blackout": dict(sparse_cost=True, reconstruction_loss="mse"),
    "bf16": dict(compute_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(ROLLOUT_CASES))
def test_rollout_sum_cost_matches_jax(models, rng, case):
    """RolloutEngine sum_cost for the same actions. float32 to 1e-4
    relative: two model steps of stacked convolutions, then costs on a 255
    scale. bfloat16 to 1e-3: activations keep 8 significant bits and the
    port's cells sum their gates in float32 where the JAX package's CPU
    cells round them to bf16, but each cost sums 9216 pixel values, so the
    roundings average out (1.6e-5 measured)."""
    jcfg, params, bn, cfg, model = models
    kw = ROLLOUT_CASES[case]
    jcfg, cfg = jcfg.replace(**kw), cfg.replace(**kw)
    rtol = 1e-4 if cfg.compute_dtype == "float32" else 1e-3
    if cfg.compute_dtype != "float32":
        model = svg_from_jax(cfg, _np(params), _np(bn), device="cpu")
    start, goal = _start_goal(rng, states=True)
    acts = rng.uniform(-0.05, 0.05, (6, 2, 5)).astype(np.float32)
    gi, gm, gs = prepare_goals(goal, 2)
    s_norm = normalize(start.state, LOCOBOT_LOW, LOCOBOT_HIGH)
    want = JRolloutEngine(jcfg)(
        params, bn, jnp.asarray(start.img), jnp.asarray(s_norm),
        jnp.asarray(start.qpos), jnp.asarray(acts), jnp.asarray(gi),
        jnp.asarray(gm), jax.random.PRNGKey(0), goal_states=jnp.asarray(gs))
    got = RolloutEngine(cfg, device="cpu")(
        model, torch.tensor(start.img), torch.tensor(s_norm),
        torch.tensor(start.qpos), torch.tensor(acts), torch.tensor(gi),
        torch.tensor(gm), torch.Generator().manual_seed(0),
        goal_states=torch.tensor(gs))
    assert got.shape == (6,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol)


# ------------------------------------------------------------------ CEM
def _jax_plan_with_noise(monkeypatch, jcfg, params, bn, start, goal, noise):
    """The JAX plan with jax.random.normal returning `noise` for the
    action-sample shape (traced once inside the fori_loop, so every
    iteration sees the same noise); other shapes pass through."""
    normal = jax.random.normal

    def fake(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == noise.shape:
            return jnp.asarray(noise, dtype)
        return normal(key, shape, dtype)

    monkeypatch.setattr(jax.random, "normal", fake)
    return np.asarray(jcem.CEMPolicy(jcfg, params, bn).get_action(start, goal))


@pytest.mark.parametrize("batch_size", [200, 3])
def test_cem_plan_matches_jax(models, rng, monkeypatch, batch_size):
    """The whole slice: CEMPolicy.get_action with the same injected action
    noise gives the JAX plan to 1e-5. The plan is the mean of the top-K
    clamped actions, so it moves only if the rollout costs reorder; 1e-5
    covers float32 sums in another order. candidates_batch_size 3 runs the
    candidates in two chunks."""
    jcfg, params, bn, cfg, model = models
    cfg = cfg.replace(candidates_batch_size=batch_size)
    start, goal = _start_goal(rng)
    noise = rng.randn(6, 2, 2).astype(np.float32)
    want = _jax_plan_with_noise(monkeypatch, jcfg, params, bn, start, goal,
                                noise)
    got = CEMPolicy(cfg, model, device="cpu").get_action(
        start, goal, noise=np.broadcast_to(noise, (2, 6, 2, 2)))
    assert got.shape == (2, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_cem_sampled_plan_is_seeded_and_bounded(models, rng):
    """Without injected noise the plan is a function of (seed, ep, step)
    and stays inside the locobot clamp."""
    _, _, _, cfg, model = models
    start, goal = _start_goal(rng)
    policy = CEMPolicy(cfg, model, device="cpu")
    a = policy.get_action(start, goal, ep_num=1, step=2)
    b = policy.get_action(start, goal, ep_num=1, step=2)
    c = policy.get_action(start, goal, ep_num=1, step=3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert np.all(np.abs(a) <= 0.05)


def test_cem_rejects_bad_noise_shape(models, rng):
    _, _, _, cfg, model = models
    start, goal = _start_goal(rng)
    with pytest.raises(ValueError):
        CEMPolicy(cfg, model, device="cpu").get_action(
            start, goal, noise=np.zeros((1, 6, 2, 2), np.float32))
