"""The port's robot slice held against the JAX package on the CPU: the
measured kinematic chains (rotations, FK, multi-start DLS IK) and their
mask envs for every chain key, the chain robots' planning rollouts and CEM
plans (control_franka, control_wx250s), the analytical robot models, the
learned robot MLPs with their trainer and checkpoints, and the GAN/VAE
losses and perceptual metrics.

The chain IK's choice is not a function of its inputs at float32: where
several starts reach a target, all of them end within about 1e-7 m of it,
and the argmin over their errors follows rounding; redundant arms then
take different, equally good poses in the two packages (and on the two
devices). So IK is held at its tips everywhere and at its joints where the
best start wins by more than IK_MARGIN; masks are held at the same joints;
rollout costs and CEM plans at the same robot trajectory (the JAX
package's), and the port's own chain trajectories at their tips and at
the JAX env's masks of their joints."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.models import robot_mlp as jmlp
from robot_aware_control_tpu.models import svg as jsvg
from robot_aware_control_tpu.ops import losses as jlosses
from robot_aware_control_tpu.ops import metrics as jmetrics
from robot_aware_control_tpu.planning import cem as jcem
from robot_aware_control_tpu.planning.rollout import RolloutEngine as JEngine
from robot_aware_control_tpu.robot import analytical as janalytical
from robot_aware_control_tpu.robot import kinematic_chain as jkc
from robot_aware_control_tpu.training import checkpoint as jckpt
from robot_aware_control_tpu.training import robot_trainer as jrt
from robot_aware_control_tpu_torch import convert
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.control.plan_server import PlanClient, PlanServer
from robot_aware_control_tpu_torch.convert import svg_from_jax
from robot_aware_control_tpu_torch.data.norm import (
    LOCOBOT_HIGH,
    LOCOBOT_LOW,
    denormalize,
    normalize,
)
from robot_aware_control_tpu_torch.models import robot_mlp
from robot_aware_control_tpu_torch.ops import losses, metrics
from robot_aware_control_tpu_torch.planning.cem import CEMPolicy
from robot_aware_control_tpu_torch.planning.rollout import RolloutEngine
from robot_aware_control_tpu_torch.robot import analytical
from robot_aware_control_tpu_torch.robot import kinematic_chain as tkc
from robot_aware_control_tpu_torch.training import checkpoint as tckpt
from robot_aware_control_tpu_torch.training import robot_trainer as trt
from robot_aware_control_tpu_torch.utils.state import State
from torch_chain_cases import (
    CHAIN_EXPERIMENTS,
    CHAIN_PARITY_PLAN,
    CHAIN_PLAN,
    IK_MARGIN,
    MASK_EDGE_PX,
    TIP_TOL,
    chain_start_goal,
    edge_band,
    range_qpos,
)
from torch_train_cases import one_torch_thread  # noqa: F401 (autouse)

KEYS = sorted(jkc.CHAINS)
QPOS_TOL = 1e-4  # rad
PLAN_TOL = 1e-4
COST_RTOL = 1e-4


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def jax_ik():
    """One jitted JAX IK a (robot, iters), compiled once a module."""
    cache = {}

    def get(key, iters):
        if (key, iters) not in cache:
            chain = jkc.CHAINS[key]
            cache[key, iters] = jax.jit(
                lambda t, q: chain.ik(t, q, iters=iters))
        return cache[key, iters]
    return get


# ------------------------------------------------------------ geometry
@pytest.mark.parametrize("key", KEYS)
def test_rot_and_fk_match_jax(key):
    """Every joint's rotation (_rot, float64 axis products rounded once, as
    JAX multiplies Python floats) to 1e-7; fk_frames, fk_points and
    fk_full to 1e-6 m (and 1e-6 for rotations and axes), over joint
    configurations across the measured ranges."""
    jc, tc = jkc.CHAINS[key], tkc.CHAINS[key]
    q = range_qpos(jc, 16, seed=1, scale=1.0)
    k = tc.consts("cpu")
    rots = tkc._rot(k["outer"], k["skew"], k["eye"], _t(q)).numpy()
    for i in range(jc.dof):
        want = np.asarray(jkc._rot(tuple(np.asarray(jc.axes[i], np.float64)),
                                   jnp.asarray(q[:, i])))
        np.testing.assert_allclose(rots[:, i], want, atol=1e-7, err_msg=str(i))
    for name in ("fk_frames", "fk_full"):
        for got, want in zip(getattr(tc, name)(_t(q)),
                             getattr(jc, name)(jnp.asarray(q))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                       err_msg=name)
    np.testing.assert_allclose(tc.fk_points(_t(q)).numpy(),
                               np.asarray(jc.fk_points(jnp.asarray(q))),
                               atol=1e-6)


@pytest.mark.parametrize("key", KEYS)
def test_ik_matches_jax(jax_ik, key):
    """Multi-start DLS IK, 5 iterations from q0, to FK-made targets
    (reachable) and the same targets pushed 0.4 m out (mostly not), held
    where the JAX IK is a function of its inputs at float32: rows whose
    JAX result moves by less than a tenth of the tolerance when the targets
    move by one part in 1e7. There the tips within TIP_TOL and the best
    start's distance to the target within IK_MARGIN of JAX's, and the
    joints within QPOS_TOL where also the port's best start beats its
    runner-up by IK_MARGIN. `valid` alike except within 1e-5 m of the
    5e-3 m tolerance."""
    jc, tc = jkc.CHAINS[key], tkc.CHAINS[key]
    targets, q0 = _ik_case(jc)
    runs = [_jax_ik_run(jax_ik, jc, tg, q0, 5)
            for tg in (targets, targets * np.float32(1 + 1e-7))]
    (jq, jvalid, jtip, jerr), (jq2, _, jtip2, jerr2) = runs
    tq, tvalid = tc.ik(_t(targets), _t(q0), iters=5)
    e = np.sort(tc.ik_starts(_t(targets), _t(q0), iters=5)[0].numpy(), 0)
    ttip = tc.fk_points(tq).numpy()[:, -1]
    terr = np.linalg.norm(targets - ttip, axis=-1)
    stable_q = (np.abs(jq - jq2).max(-1) < QPOS_TOL / 10) & (e[1] - e[0] > IK_MARGIN)
    stable_tip = np.abs(jtip - jtip2).max(-1) < TIP_TOL / 10
    stable_err = np.abs(jerr - jerr2) < IK_MARGIN / 10
    print(f"{key}: JAX stable (and the port decisive) at {stable_q.sum()} "
          f"(joints), {stable_tip.sum()} (tips), {stable_err.sum()} (errors) "
          f"of {len(targets)} targets")
    assert stable_q.sum() >= 3 and stable_tip.sum() >= len(targets) // 2
    np.testing.assert_allclose(tq.numpy()[stable_q], jq[stable_q], atol=QPOS_TOL)
    np.testing.assert_allclose(ttip[stable_tip], jtip[stable_tip], atol=TIP_TOL)
    np.testing.assert_allclose(terr[stable_err], jerr[stable_err], atol=IK_MARGIN)
    settled = np.abs(jerr - 5e-3) > 1e-5
    np.testing.assert_array_equal(tvalid.numpy()[settled], jvalid[settled])


@pytest.mark.parametrize("key", KEYS)
def test_ik_converged_matches_jax(jax_ik, key):
    """The IK at its default 60 iterations on the same targets. Every start
    reaches a reachable target within about 1e-7 m, so the choice between
    them follows rounding and the joints are not comparable; on unreachable
    targets DLS with joint clipping amplifies rounding (JAX's own best
    distance moves by up to centimetres when the targets move by one part
    in 1e7, and the port's lands above or below it). So: the FK-made
    targets reached within TIP_TOL in both packages and `valid` there; on
    the far targets the port's mean best distance within a quarter of
    JAX's (plus 1 mm), and `valid` alike where both distances stand 1 cm
    clear of the 5e-3 m tolerance."""
    jc, tc = jkc.CHAINS[key], tkc.CHAINS[key]
    targets, q0 = _ik_case(jc)
    n = len(targets) // 2
    (_, jvalid, _, jerr), (_, _, _, jerr2) = [
        _jax_ik_run(jax_ik, jc, tg, q0, 60)
        for tg in (targets, targets * np.float32(1 + 1e-7))]
    tq, tvalid = tc.ik(_t(targets), _t(q0))
    terr = np.linalg.norm(targets - tc.fk_points(tq).numpy()[:, -1], axis=-1)
    print(f"{key}: far targets, best distance port {np.round(terr[n:], 4)}, "
          f"JAX {np.round(jerr[n:], 4)}, JAX perturbed {np.round(jerr2[n:], 4)}")
    assert (terr[:n] < TIP_TOL).all() and (jerr[:n] < TIP_TOL).all()
    assert tvalid.numpy()[:n].all() and jvalid[:n].all()
    assert abs(terr[n:].mean() - jerr[n:].mean()) <= 0.25 * jerr[n:].mean() + 1e-3
    clear = (np.abs(terr - 5e-3) > 1e-2) & (np.abs(jerr - 5e-3) > 1e-2)
    np.testing.assert_array_equal(tvalid.numpy()[clear], jvalid[clear])


def _ik_case(chain):
    """8 FK-made targets, the same 0.4 m out along x, and 16 starts."""
    tips = np.asarray(chain.fk_points(jnp.asarray(range_qpos(chain, 8, seed=2,
                                                             scale=0.6))))[:, -1]
    targets = np.concatenate([tips, tips + np.array([0.4, 0.0, 0.0])])
    return targets.astype(np.float32), range_qpos(chain, 16, seed=3, scale=0.3)


def _jax_ik_run(jax_ik, chain, targets, q0, iters):
    """JAX IK -> (joints, valid, tips, distances to the targets)."""
    jq, jvalid = (np.asarray(a) for a in jax_ik(chain.name, iters)(
        jnp.asarray(targets), jnp.asarray(q0)))
    jtip = np.asarray(chain.fk_points(jnp.asarray(jq)))[:, -1]
    return jq, jvalid, jtip, np.linalg.norm(targets - jtip, axis=-1)


def _mask_case(key, thick, occlude=True):
    je = jkc.ChainMaskEnv(key, thick=thick, occlude=occlude)
    te = tkc.ChainMaskEnv(key, thick=thick, occlude=occlude, device="cpu")
    q = range_qpos(je.chain, 12, seed=4, scale=0.5)
    return je, te, q


@pytest.mark.parametrize("thick", [False, True])
@pytest.mark.parametrize("key", KEYS)
def test_chain_masks_match_jax(key, thick):
    """ChainMaskEnv.generate_masks for the same joints (fetch with its
    occluders): equal except pixels within MASK_EDGE_PX of a capsule's edge
    (their count printed)."""
    je, te, q = _mask_case(key, thick)
    want = je.generate_masks(q)
    got = te.generate_masks(q)
    assert got.shape == want.shape == (12, 48, 64, 1) and got.dtype == np.float32
    assert 0 < want.mean() < 1
    differ = got != want
    band = edge_band(te, _t(q))
    print(f"{key} thick={thick}: {int(differ.sum())} pixels differ, "
          f"{int(band.sum())} within {MASK_EDGE_PX} px of an edge")
    assert not (differ & ~band).any()


def test_fetch_occluders_match_jax():
    """fetch: the occluder depth map to 1e-5 m where an occluder covers a
    pixel in both packages, 1e9 elsewhere; its occlusion hides mask pixels
    (the occluded render is a subset of the unoccluded one, and smaller),
    and the render with occlusion switched off equals JAX's."""
    je, te, q = _mask_case("fetch", False)
    assert te.occlude and je.occlude
    want = np.asarray(je.occluder_depth(jnp.asarray(q)))
    got = te.occluder_depth(_t(q)).numpy()
    both = (want < 1e8) & (got < 1e8)
    assert both.mean() > 0.01
    np.testing.assert_allclose(got[both], want[both], atol=1e-5)
    assert ((want < 1e8) != (got < 1e8)).mean() < 1e-3
    je_off, te_off, _ = _mask_case("fetch", False, occlude=False)
    off = te_off.generate_masks(q)
    np.testing.assert_array_equal(off, je_off.generate_masks(q))
    on = te.generate_masks(q)
    assert (on <= off).all() and on.sum() < off.sum()


def test_locobot_mask_env_matches_jax(rng):
    """get_mask_env("locobot"): the capsule renderer (here its kernel's
    plain version) behind the MaskEnv API, equal to JAX's bit for bit."""
    q = rng.uniform(-0.5, 0.5, (6, 5)).astype(np.float32)
    want = jkc.get_mask_env("locobot").generate_masks(q)
    got = tkc.get_mask_env("locobot", device="cpu").generate_masks(q)
    np.testing.assert_array_equal(got, want)
    assert isinstance(tkc.get_mask_env("wx250s", device="cpu"), tkc.ChainMaskEnv)


# ------------------------------------------------------------- planning
@pytest.fixture(scope="module")
def chain_models():
    """The small planning config's JAX svg trees and the port's model."""
    out = {}
    for exp in CHAIN_EXPERIMENTS:
        kw = dict(CHAIN_PLAN, experiment=exp)
        jcfg, cfg = JConfig(**kw), Config(**kw)
        params, bn = jax.jit(jsvg.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                          jcfg)
        model = svg_from_jax(cfg, jax.tree_util.tree_map(np.asarray, params),
                             jax.tree_util.tree_map(np.asarray, bn), device="cpu")
        out[exp] = (jcfg, cfg, params, bn, model)
    return out


def _jax_joints(engine, start_raw, q0, actions):
    """The JAX engine's chain joints, by the loop of its
    `_chain_trajectory` (IK warm-started from the previous step, 20
    iterations)."""
    planar = actions[..., :2] * engine.cfg.eef_action_scale
    xy0 = jnp.broadcast_to(start_raw[:2], planar.shape[1:])
    xy = jnp.concatenate([xy0[None], xy0[None] + jnp.cumsum(planar, 0)], 0)
    tg = jnp.concatenate([xy - engine.chain_shift,
                          jnp.full(xy.shape[:-1] + (1,), engine.push_height)], -1)

    def step(q, t):
        q, _ = engine.chain.ik(t, q, iters=20)
        return q, q

    return jax.lax.scan(step, jnp.broadcast_to(q0, planar.shape[1:2] + q0.shape),
                        tg)[1]


@pytest.mark.parametrize("experiment", CHAIN_EXPERIMENTS)
def test_chain_robot_trajectory_matches_jax(chain_models, experiment, rng):
    """RolloutEngine.robot_trajectory of the chain robots: qpos_dim is the
    chain's dof; the locobot-frame states equal JAX's (1e-6); every step's
    IK tip within TIP_TOL of its target wherever JAX's is (see the module
    docstring for why not of JAX's joints); the masks are the thick chain
    env's (JAX's render) of the port's joints, but within MASK_EDGE_PX of
    an edge, and the JAX masks are that env's of the JAX joints."""
    jcfg, cfg, *_ = chain_models[experiment]
    je, te = JEngine(jcfg), RolloutEngine(cfg, device="cpu")
    dof = jkc.CHAINS[te.chain_robot].dof
    assert te.qpos_dim == je.qpos_dim == dof
    acts = rng.uniform(-0.05, 0.05, (2, 6, 5)).astype(np.float32)
    s0 = normalize(np.array([0.3, 0.0, 0.15, 0, 0], np.float32),
                   LOCOBOT_LOW, LOCOBOT_HIGH).astype(np.float32)
    q0 = range_qpos(je.chain, 1, seed=5, scale=0.2)[0]
    want = [np.asarray(a) for a in jax.jit(je.robot_trajectory)(
        jnp.asarray(s0), jnp.asarray(q0), jnp.asarray(acts))]
    rows = lambda a: _t(a)[None].expand(6, len(a))
    got = [a.numpy() for a in te.robot_trajectory(rows(s0), rows(q0), _t(acts))]
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, atol=1e-6)
    raw0 = denormalize(rows(s0), te.low, te.high)
    _, tq = te.chain_joints(raw0, rows(q0), _t(acts))
    jq = np.asarray(jax.jit(_jax_joints, static_argnums=0)(
        je, jnp.asarray(want[1][0, 0]), jnp.asarray(q0), jnp.asarray(acts)))
    targets = np.concatenate([want[1][..., :2] - te.chain_shift.numpy(),
                              np.full(want[1].shape[:-1] + (1,), 0.15)], -1)
    tdist, jdist = (np.linalg.norm(targets - tip, axis=-1) for tip in (
        tkc.CHAINS[te.chain_robot].fk_points(tq).numpy()[..., -1, :],
        np.asarray(je.chain.fk_points(jnp.asarray(jq)))[..., -1, :]))
    assert (jdist < TIP_TOL).mean() > 0.5
    assert (tdist[jdist < TIP_TOL] < TIP_TOL).all()
    np.testing.assert_array_equal(je.chain_env.generate_masks(jq), want[2])
    differ = got[2] != je.chain_env.generate_masks(tq.numpy())
    assert not (differ & ~edge_band(te.chain_env, tq)).any()
    assert got[2].shape == (3, 6, 48, 64, 1) and 0 < got[2].mean() < 1


def _jax_trajectory_in_port(monkeypatch, engine, jengine):
    """Makes the port engine's robot_trajectory return the JAX engine's for
    the same inputs (rows of one request)."""
    jfn = jax.jit(jengine.robot_trajectory)

    def traj(start_state_norm, start_qpos, actions_tna):
        out = jfn(jnp.asarray(start_state_norm[0].numpy()),
                  jnp.asarray(start_qpos[0].numpy()),
                  jnp.asarray(actions_tna.numpy()))
        return tuple(torch.tensor(np.asarray(a)) for a in out)

    monkeypatch.setattr(engine, "robot_trajectory", traj)


@pytest.mark.parametrize("experiment", CHAIN_EXPERIMENTS)
def test_chain_rollout_costs_match_jax(chain_models, experiment, monkeypatch):
    """The chain robots' rollout costs (svg, dontcare, masks and robot
    states) for fixed candidates, at the JAX robot trajectory: to 1e-4
    relative."""
    jcfg, cfg, params, bn, model = chain_models[experiment]
    start, goal = chain_start_goal(np.random.RandomState(6), experiment)
    acts = np.random.RandomState(7).uniform(-0.05, 0.05, (6, 2, 5)).astype(np.float32)
    je, te = JEngine(jcfg), RolloutEngine(cfg, device="cpu")
    dof = te.qpos_dim
    state_norm = normalize(start.state + np.pad(te.chain_shift.numpy(), (0, 3)),
                           LOCOBOT_LOW, LOCOBOT_HIGH).astype(np.float32)
    gi = np.stack(goal.imgs[:2])
    gm = np.stack([m[..., None] for m in goal.masks[:2]])
    want = np.asarray(jax.jit(je.__call__)(
        params, bn, jnp.asarray(start.img), jnp.asarray(state_norm),
        jnp.asarray(start.qpos[:dof]), jnp.asarray(acts), jnp.asarray(gi),
        jnp.asarray(gm), jax.random.PRNGKey(0)))
    _jax_trajectory_in_port(monkeypatch, te, je)
    got = te(model, _t(start.img), _t(state_norm), _t(start.qpos[:dof]),
             _t(acts), _t(gi), _t(gm), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), want, rtol=COST_RTOL)


def _jax_plan(monkeypatch, jcfg, params, bn, start, goal, noise, engine):
    """The JAX plan with the injected action noise, its robot trajectory
    the port `engine`'s for the same inputs (a host callback)."""
    normal = jax.random.normal

    def fake(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == noise.shape:
            return jnp.asarray(noise, dtype)
        return normal(key, shape, dtype)

    def port_traj(s, q, a):
        rows = lambda x: torch.tensor(np.asarray(x))[None].expand(a.shape[1], -1)
        return tuple(t.numpy() for t in engine.robot_trajectory(
            rows(s), rows(q), torch.tensor(np.asarray(a))))

    def traj(s, q, a):
        T1, N = a.shape[0] + 1, a.shape[1]
        shapes = (jax.ShapeDtypeStruct((T1, N, jcfg.robot_dim), jnp.float32),
                  jax.ShapeDtypeStruct((T1, N, 5), jnp.float32),
                  jax.ShapeDtypeStruct((T1, N, jcfg.image_height,
                                        jcfg.image_width, 1), jnp.float32))
        return jax.pure_callback(port_traj, shapes, s, q, a)

    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "normal", fake)
        policy = jcem.CEMPolicy(jcfg, params, bn)
        mp.setattr(policy.engine, "robot_trajectory", traj)
        return np.asarray(policy.get_action(start, goal))


@pytest.mark.parametrize("experiment", CHAIN_EXPERIMENTS)
def test_chain_cem_plan_matches_jax(chain_models, experiment, monkeypatch):
    """A small CEM plan of each chain robot (one iteration:
    CHAIN_PARITY_PLAN) with the same injected action noise, the JAX engine
    at the port's robot trajectory (a host callback): the JAX plan to
    PLAN_TOL. The port's own plan at CHAIN_PLAN (its own IK) is finite,
    inside the +-0.05 clamp, and a function of (seed, ep, step)."""
    jcfg, cfg, params, bn, model = chain_models[experiment]
    start, goal = chain_start_goal(np.random.RandomState(8), experiment)
    policy = CEMPolicy(cfg, model, device="cpu")
    assert policy.engine.qpos_dim == jkc.CHAINS[policy.engine.chain_robot].dof
    own = policy.get_action(start, goal, ep_num=1, step=2)
    assert own.shape == (2, 2) and np.all(np.isfinite(own))
    assert np.all(np.abs(own) <= 0.05)
    np.testing.assert_array_equal(own, policy.get_action(start, goal, ep_num=1,
                                                         step=2))
    kw = dict(CHAIN_PARITY_PLAN, experiment=experiment)
    policy = CEMPolicy(Config(**kw), model, device="cpu")
    noise = np.random.RandomState(9).randn(6, 2, 2).astype(np.float32)
    want = _jax_plan(monkeypatch, JConfig(**kw), params, bn, start, goal, noise,
                     policy.engine)
    got = policy.get_action(start, goal, noise=noise[None])
    np.testing.assert_allclose(got, want, atol=PLAN_TOL)


@pytest.mark.parametrize("experiment", CHAIN_EXPERIMENTS)
def test_chain_batched_plans_equal_single(chain_models, experiment):
    """get_action_batched of 2 chain requests equals their single plans bit
    for bit on the CPU (the chain IK and render are row-independent)."""
    _, cfg, _, _, model = chain_models[experiment]
    policy = CEMPolicy(cfg, model, device="cpu")
    reqs = [chain_start_goal(np.random.RandomState(s), experiment) for s in (10, 11)]
    batched = policy.get_action_batched([r[0] for r in reqs], [r[1] for r in reqs],
                                        ep_nums=[0, 1], steps=[3, 4])
    for i, (s, g) in enumerate(reqs):
        np.testing.assert_array_equal(batched[i], policy.get_action(
            s, g, ep_num=i, step=3 + i))


def test_chain_plan_server_serves_local_plans(chain_models):
    """A PlanServer of control_wx250s: a request carrying the arm's 6
    joints, and one carrying 7 (a client's full qpos, cut to the chain's
    dof), planned over the wire equal their local plans bit for bit."""
    _, cfg, _, _, model = chain_models["control_wx250s"]
    server = PlanServer(cfg, model, device="cpu")
    thread = server.start()
    try:
        assert server.policy.engine.qpos_dim == 6
        client = PlanClient(*server.address)
        start, goal = chain_start_goal(np.random.RandomState(12), "control_wx250s")
        long = State(img=start.img, state=start.state,
                     qpos=np.arange(7, dtype=np.float32) * 0.1)
        for s, step in ((start, 1), (long, 2)):
            np.testing.assert_array_equal(
                client.plan(s, goal, ep_num=4, step=step),
                server.policy.get_action(s, goal, ep_num=4, step=step))
        client.close()
    finally:
        server.close()
        thread.join(timeout=5)


# ---------------------------------------------------- analytical models
def test_locobot_analytical_model_matches_jax(rng):
    """predict_batch (thin and thick): states to 1e-6, masks bit for bit
    (the capsule renderer at the same joints); the franka / wx250s
    models' frame shifts."""
    cfg = dict(image_height=48, image_width=64)
    jm = janalytical.LocobotAnalyticalModel(JConfig(**cfg))
    tm = analytical.LocobotAnalyticalModel(Config(**cfg), device="cpu")
    N = 5
    data = {"states": rng.uniform(0.2, 0.8, (4, N, 5)).astype(np.float32),
            "qpos": np.zeros((4, N, 5), np.float32),
            "actions": rng.uniform(-0.03, 0.03, (3, N, 5)).astype(np.float32),
            "low": np.tile(LOCOBOT_LOW, (N, 1)), "high": np.tile(LOCOBOT_HIGH, (N, 1))}
    for thick in (False, True):
        ws, wm = (np.asarray(a) for a in jm.predict_batch(data, thick=thick))
        gs, gm = tm.predict_batch(data, thick=thick)
        np.testing.assert_allclose(gs.numpy(), ws, atol=1e-6)
        np.testing.assert_array_equal(gm.numpy(), wm)
    state = np.array([0.3, 0.1, 0.2, 0, 0], np.float32)
    for exp, cls, jcls in (("control_franka", analytical.FrankaAnalyticalModel,
                            janalytical.FrankaAnalyticalModel),
                           ("control_wx250s", analytical.WX250sAnalyticalModel,
                            janalytical.WX250sAnalyticalModel)):
        model = analytical.get_robot_model(Config(experiment=exp, **cfg), device="cpu")
        assert type(model) is cls
        np.testing.assert_array_equal(model.to_locobot_frame(state),
                                      jcls(JConfig(**cfg)).to_locobot_frame(state))
    assert type(analytical.get_robot_model(Config(**cfg), device="cpu")) is (
        analytical.LocobotAnalyticalModel)


@pytest.mark.parametrize("robot", ["franka", "wx250s", "sawyer"])
def test_chain_analytical_model_matches_jax(robot, rng):
    """ChainAnalyticalModel.predict_trajectory: eef targets equal JAX's;
    the IK (60 iterations) reaches the same tips within TIP_TOL; the masks
    are the robot's env's (JAX's) of the port's joints, but near edges."""
    jm = janalytical.ChainAnalyticalModel(JConfig(), robot)
    tm = analytical.ChainAnalyticalModel(Config(), robot, device="cpu")
    chain = jkc.CHAINS[robot]
    start_q = range_qpos(chain, 1, seed=12, scale=0.3)[0]
    start = np.asarray(chain.fk_points(jnp.asarray(start_q)))[-1]
    acts = rng.uniform(-0.02, 0.02, (2, 3, 2)).astype(np.float32)
    we, wq, wm = jm.predict_trajectory(start, start_q, jnp.asarray(acts))
    ge, gq, gm = tm.predict_trajectory(start, start_q, acts)
    np.testing.assert_allclose(ge.numpy(), np.asarray(we), atol=1e-7)
    np.testing.assert_allclose(tm.chain.fk_points(gq).numpy()[..., -1, :],
                               np.asarray(chain.fk_points(wq))[..., -1, :],
                               atol=TIP_TOL)
    differ = gm.numpy() != jm.env.generate_masks(gq.numpy())
    assert not (differ & ~edge_band(tm.env, gq)).any()
    assert gm.shape == np.asarray(wm).shape


# ---------------------------------------------------- robot MLPs, trainer
ROBOT_KW = dict(robot_dim=5, robot_joint_dim=5, action_dim=5, image_height=48,
                image_width=64, lr=1e-3, batch_size=16, test_batch_size=16,
                niter=1, eval_interval=1, jobname="robot")


def _jax_mlp_params(cfg):
    k = jax.random.split(jax.random.PRNGKey(3), 2)
    return (jmlp.joint_pos_predictor_init(k[0], cfg),
            jmlp.gripper_state_predictor_init(k[1], cfg))


def test_robot_mlps_convert_and_match_jax(rng):
    """The JAX MLP trees -> the port's nn.Linear modules (w (in, out) ->
    weight (out, in)) and back, leaf for leaf; both MLPs' outputs to 1e-6."""
    jcfg = JConfig(**ROBOT_KW)
    jp, gp = _jax_mlp_params(jcfg)
    cfg = Config(**ROBOT_KW)
    joint = robot_mlp.JointPosPredictor(cfg)
    grip = robot_mlp.GripperStatePredictor(cfg)
    assert joint.l1.weight.shape == (robot_mlp.HIDDEN, 10)
    assert joint.out.weight.shape == (5, robot_mlp.HIDDEN)
    joint.load_state_dict(convert.robot_mlp_state_dict(jax.tree_util.tree_map(
        np.asarray, jp)))
    flat = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(gp)[0]}
    grip.load_state_dict(convert.robot_mlp_state_dict(flat))
    back = convert.robot_mlp_tree(grip)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    x = rng.randn(7, 5).astype(np.float32)
    a = rng.randn(7, 5).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(
            joint(_t(x), _t(a)).numpy(),
            np.asarray(jmlp.joint_pos_predictor(jp, jnp.asarray(x), jnp.asarray(a))),
            atol=1e-6)
        np.testing.assert_allclose(
            grip(_t(x), _t(a)).numpy(),
            np.asarray(jmlp.gripper_state_predictor(gp, jnp.asarray(x),
                                                    jnp.asarray(a))), atol=1e-6)


@pytest.fixture(scope="module")
def robot_trainers(tmp_path_factory):
    """The JAX and the port's RobotPredictionTrainer on the same weights."""
    d = tmp_path_factory.mktemp("robot")
    jtr = jrt.RobotPredictionTrainer(JConfig(**ROBOT_KW, log_dir=str(d / "jax")))
    jtr.joint_params, jtr.grip_params = _jax_mlp_params(jtr.cfg)
    jtr.opt_state = jtr.tx.init((jtr.joint_params, jtr.grip_params))
    tr = trt.RobotPredictionTrainer(Config(**ROBOT_KW, log_dir=str(d / "port")),
                                    device="cpu")
    for m, p in ((tr.joint, jtr.joint_params), (tr.grip, jtr.grip_params)):
        m.load_state_dict(convert.robot_mlp_state_dict(
            jax.tree_util.tree_map(np.asarray, p)))
    return jtr, tr


def test_joint_pos_dataset_matches_jax():
    """The synthetic (qpos, state, action) sequences: numpy draws in JAX's
    order through each package's planar kinematics, to 1e-6."""
    jd = jrt.JointPosDataset(JConfig(**ROBOT_KW), num=40, T=6, seed=2)
    td = trt.JointPosDataset(Config(**ROBOT_KW), num=40, T=6, seed=2)
    for k in ("states", "qpos", "actions"):
        np.testing.assert_allclose(getattr(td, k), getattr(jd, k), atol=1e-6,
                                   err_msg=k)
    jb = list(jd.batches(16, seed=1))
    tb = list(td.batches(16, seed=1))
    assert len(tb) == len(jb) == 2
    np.testing.assert_allclose(tb[1]["qpos"], jb[1]["qpos"], atol=1e-6)


def test_robot_train_step_and_eval_match_jax(robot_trainers):
    """One train step (both MLPs' delta MSE, one Adam update, float32):
    losses to 1e-5 relative and every parameter after the update to 1e-6;
    then the eval rollout: state and qpos rollout MSE to 1e-4 relative and
    the mask IoU (the capsule renderer) to 1e-5."""
    jtr, tr = robot_trainers
    data = jrt.JointPosDataset(jtr.cfg, num=32, T=6, seed=4)
    batch = next(data.batches(16))
    params = (jtr.joint_params, jtr.grip_params)
    jparams, _, jmetrics_ = jtr._train_step(
        params, jtr.opt_state, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tr.train_step(batch)
    for k, v in jmetrics_.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, err_msg=k)
    for m, p in ((tr.joint, jparams[0]), (tr.grip, jparams[1])):
        want = {jax.tree_util.keystr(path): np.asarray(v) for path, v in
                jax.tree_util.tree_flatten_with_path(p)[0]}
        have = convert.robot_mlp_tree(m)
        for k in want:
            np.testing.assert_allclose(have[k], want[k], atol=1e-6, err_msg=k)
    jev = jtr._eval_rollout(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    ev = tr.eval_rollout(batch)
    for k in ("qpos_rollout_mse", "state_rollout_mse"):
        np.testing.assert_allclose(float(ev[k]), float(jev[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(ev["mask_iou"]), float(jev["mask_iou"]),
                               atol=1e-5)
    assert 0.0 < float(ev["mask_iou"]) <= 1.0


def test_robot_trainer_learns_and_checkpoints_both_ways(tmp_path):
    """train() lowers the state rollout MSE and writes ckpt_<step>.npz with
    the {joint_model, gripper_model} trees, which JAX load_checkpoint reads
    with its templates leaf for leaf; a JAX robot checkpoint loads into the
    port's MLPs (load_robot_models)."""
    cfg = Config(**dict(ROBOT_KW, niter=3, log_dir=str(tmp_path)))
    tr = trt.RobotPredictionTrainer(cfg, device="cpu")
    test = trt.JointPosDataset(cfg, num=32, T=6, seed=1)
    before = tr.evaluate(test)
    tr.train(trt.JointPosDataset(cfg, num=64, T=6, seed=0), test)
    after = tr.evaluate(test)
    assert after["state_rollout_mse"] < before["state_rollout_mse"]
    assert 0.0 <= after["mask_iou"] <= 1.0
    path = tckpt.latest_checkpoint(tr.log_dir)
    assert path.endswith(f"ckpt_{tr._step}.npz") and tr._step == 3 * 4
    jcfg = JConfig(**ROBOT_KW)
    jp, gp = _jax_mlp_params(jcfg)
    trees, step = jckpt.load_checkpoint(path, {"joint_model": jp,
                                               "gripper_model": gp})
    assert step == tr._step
    want = trt.robot_trees(tr.joint, tr.grip)
    for name in trt.ROBOT_TREES:
        got = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
               jax.tree_util.tree_flatten_with_path(trees[name])[0]}
        assert set(got) == set(want[name])
        for k in got:
            np.testing.assert_array_equal(got[k], want[name][k], err_msg=k)
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), 5,
                                  {"joint_model": jp, "gripper_model": gp})
    joint, grip = robot_mlp.JointPosPredictor(cfg), robot_mlp.GripperStatePredictor(cfg)
    trt.load_robot_models(jpath, joint, grip)
    np.testing.assert_array_equal(joint.l2.weight.detach().numpy(),
                                  np.asarray(jp["l2"]["w"]).T)
    with pytest.raises(ValueError, match="shape mismatch"):
        trt.load_robot_models(path, robot_mlp.JointPosPredictor(
            cfg.replace(action_dim=4)), grip)


def test_robot_trainer_cli(tmp_path):
    """The CLI with --device cpu trains and writes its checkpoint."""
    trt.main(["--device", "cpu", "--niter", "1", "--batch_size", "64",
              "--robot_dim", "5", "--robot_joint_dim", "5", "--action_dim", "5",
              "--log_dir", str(tmp_path), "--jobname", "cli"])
    assert tckpt.latest_checkpoint(str(tmp_path / "cli")).endswith("ckpt_4.npz")


# ----------------------------------------------------- losses, metrics
GAN_CASES = [("GAN", 1.0), ("GAN", 0.0), ("GAN", 0.9), ("LSGAN", 1.0),
             ("LSGAN", 0.0), ("SNGAN", 1.0), ("SNGAN", 0.0)]


@pytest.mark.parametrize("kind,label", GAN_CASES)
def test_gan_criterion_matches_jax(kind, label, rng):
    """gan_criterion (the label-entropy correction for a smoothed GAN
    label, LSGAN, SNGAN) to 1e-6 relative, on logits up to +-30."""
    logits = (rng.randn(4, 9) * 10).astype(np.float32)
    logits[0, 0], logits[1, 1] = 30.0, -30.0
    want = float(jlosses.gan_criterion(jnp.asarray(logits), label, kind))
    got = float(losses.gan_criterion(_t(logits), label, kind))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_gan_and_vae_losses_edges(rng):
    """vae_kl_loss to 1e-6 relative; SNGAN with a smoothed label and an
    unknown type raise as in JAX."""
    mu, lv = rng.randn(6, 8).astype(np.float32), rng.randn(6, 8).astype(np.float32)
    np.testing.assert_allclose(float(losses.vae_kl_loss(_t(mu), _t(lv))),
                               float(jlosses.vae_kl_loss(jnp.asarray(mu),
                                                         jnp.asarray(lv))),
                               rtol=1e-6)
    with pytest.raises(NotImplementedError):
        losses.gan_criterion(torch.zeros(2), 0.9, "SNGAN")
    with pytest.raises(ValueError):
        losses.gan_criterion(torch.zeros(2), 1.0, "WGAN")


def test_perceptual_metrics_match_jax(rng):
    """normalize_tensor, cosine_similarity/distance, the expected (square)
    pixel distances and the perceptual cosine distance with a caller's
    feature stack, to 1e-5 relative."""
    a, b = rng.randn(3, 5, 7).astype(np.float32), rng.randn(3, 5, 7).astype(np.float32)
    for name in ("normalize_tensor",):
        np.testing.assert_allclose(getattr(metrics, name)(_t(a)).numpy(),
                                   np.asarray(getattr(jmetrics, name)(jnp.asarray(a))),
                                   rtol=1e-5, atol=1e-7)
    for name in ("cosine_similarity", "cosine_distance"):
        np.testing.assert_allclose(
            np.asarray(getattr(metrics, name)(_t(a), _t(b))),
            np.asarray(getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b))),
            rtol=1e-5, atol=1e-7)
    real = rng.rand(2, 3, 6, 8, 2).astype(np.float32)
    pred = rng.rand(2, 3, 6, 8, 2).astype(np.float32)
    pred /= pred.sum((-3, -2), keepdims=True)
    real /= real.sum((-3, -2), keepdims=True)
    for name in ("expected_pixel_distance", "expected_square_pixel_distance"):
        np.testing.assert_allclose(
            getattr(metrics, name)(_t(real), _t(pred)).numpy(),
            np.asarray(getattr(jmetrics, name)(jnp.asarray(real), jnp.asarray(pred))),
            rtol=1e-5, err_msg=name)
    w = rng.randn(3, 4).astype(np.float32)
    imgs0, imgs1 = rng.rand(2, 6, 8, 3).astype(np.float32), rng.rand(2, 6, 8, 3).astype(np.float32)
    jfeat = lambda x: [x, jnp.maximum(x @ jnp.asarray(w), 0.0)]
    tfeat = lambda x: [x, torch.relu(x @ _t(w))]
    np.testing.assert_allclose(
        float(metrics.perceptual_cosine_distance(_t(imgs0), _t(imgs1), tfeat)),
        float(jmetrics.perceptual_cosine_distance(jnp.asarray(imgs0),
                                                  jnp.asarray(imgs1), jfeat)),
        rtol=1e-5)
