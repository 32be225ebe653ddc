"""The port's plan serving held against the JAX package on the CPU: the
push/pick CEM variants, the pick integrator and TrajectorySampler rollouts
to float32 tolerances; and the port's PlanServer, controller and socket
bridge, mirroring tests/test_plan_server.py and tests/test_real_robot.py
bit for bit where those are. The wire format is checked both ways: each
package's numpy client plans against the other package's server."""

import concurrent.futures as cf
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.control import plan_server as jserver
from robot_aware_control_tpu.data import calibration as jcalib
from robot_aware_control_tpu.models import svg as jsvg
from robot_aware_control_tpu.planning import cem as jcem
from robot_aware_control_tpu.planning.rollout import (
    TrajectorySampler as JTrajectorySampler,
)
from robot_aware_control_tpu.robot import locobot_kinematics as jlk
from robot_aware_control_tpu.robot.mask_renderer import (
    CapsuleMaskRenderer as JRenderer,
)
from robot_aware_control_tpu.training import checkpoint as jckpt
from robot_aware_control_tpu.utils.state import DemoGoalState, State
from robot_aware_control_tpu_torch.config import Config, argparser
from robot_aware_control_tpu_torch.control.plan_server import (
    PlanClient,
    PlanServer,
    RemotePolicy,
    build_server,
    warm,
)
from robot_aware_control_tpu_torch.control.real_robot import (
    RobotBridgeServer,
    SimRobotInterface,
    SocketRobotInterface,
    VisualMPCController,
)
from robot_aware_control_tpu_torch.convert import jax_flat_trees, svg_from_jax
from robot_aware_control_tpu_torch.data import calibration as tcalib
from robot_aware_control_tpu_torch.models import svg as tsvg
from robot_aware_control_tpu_torch.planning.cem import (
    CEMPolicy,
    PickCEMPolicy,
    PushCEMPolicy,
)
from robot_aware_control_tpu_torch.planning.rollout import TrajectorySampler
from robot_aware_control_tpu_torch.robot import locobot_kinematics as tlk
from robot_aware_control_tpu_torch.robot.mask_renderer import CapsuleMaskRenderer
from robot_aware_control_tpu_torch.training import plot
from torch_mesh_cases import world1_mesh
from torch_train_cases import one_torch_thread  # noqa: F401  (autouse)

# the small float32 config of tests/test_plan_server.py
SERVE_KW = dict(
    model="svg", g_dim=16, z_dim=4, image_width=64, image_height=48,
    action_dim=5, robot_dim=5, robot_joint_dim=5, model_use_mask=True,
    model_use_robot_state=True, reconstruction_loss="dontcare_l1",
    reward_type="dontcare", compute_dtype="float32", horizon=3, opt_iter=2,
    action_candidates=8, topk=3, cem_init_std=0.015,
)
# the parity cases take the prior's mean: JAX and torch draw other noise
PARITY_KW = dict(SERVE_KW, sample_mean=True)
# the port-only server, batching and controller tests plan one CEM
# iteration: a plan of the small config takes about 0.7 s an iteration on
# one CPU thread, most of it in the VGG encoder's convolutions
ONE_ITER_KW = dict(SERVE_KW, opt_iter=1)
TOL = 1e-5  # float32 sums in another order (as tests/test_torch_port_planning.py)


@pytest.fixture(scope="module")
def weights():
    """JAX trees of the port's seeded initialisation: jitting the JAX init
    would take ten times as long as the rest of this fixture."""
    params, bn = jax_flat_trees(tsvg.init(Config(**SERVE_KW), 0, "cpu"))
    shapes = jax.eval_shape(
        functools.partial(jsvg.init, cfg=JConfig(**SERVE_KW)),
        jax.random.PRNGKey(0))
    fill = lambda flat: (lambda path, _: flat[jax.tree_util.keystr(path)])
    return tuple(jax.tree_util.tree_map_with_path(fill(flat), tree)
                 for flat, tree in zip((params, bn), shapes))


def _model(weights, **kw):
    return svg_from_jax(Config(**dict(SERVE_KW, **kw)), *weights, device="cpu")


@pytest.fixture(scope="module")
def served(weights):
    """One batching server on a thread for the module's server tests."""
    cfg = Config(**ONE_ITER_KW)
    model = _model(weights)
    server = PlanServer(cfg, model, device="cpu")
    thread = server.start()
    yield server, cfg, model
    server.close()
    thread.join(timeout=5)


def _start_goal(rng, states=False):
    h, w = 48, 64
    start = State(img=rng.rand(h, w, 3).astype(np.float32),
                  state=np.array([0.3, 0.0, 0.15, 0.0, 0.0], np.float32),
                  qpos=np.zeros(5, np.float32))
    goal = DemoGoalState(
        imgs=[rng.rand(h, w, 3).astype(np.float32) for _ in range(2)],
        masks=[np.zeros((h, w), np.float32) for _ in range(2)],
        states=([rng.rand(5).astype(np.float32) for _ in range(2)]
                if states else None))
    return start, goal


# ------------------------------------------------------------ config etc.
def test_config_serving_fields_match_jax():
    """The serving fields, and the fields of the simulated envs, the
    episode runner and data collection, exist with the JAX defaults and
    parse from the command line; plan_quantize takes int8 (ops/quant.py)
    and nothing but none and int8."""
    names = ["env", "plan_server_host", "plan_server_port",
             "dynamics_model_ckpt", "demo_cost", "pick_wide_x_std",
             "cem_open_loop", "replan_every", "max_episode_length",
             "plan_quantize", "debug_cem",
             # the envs
             "camera_name", "red_robot", "modified", "action_repeat",
             "action_noise", "pixels_ob", "norobot_pixels_ob",
             "most_recent_background", "robot_mask_with_obj", "inpaint_eef",
             "depth_ob", "large_block", "multiview", "camera_ids",
             "object_dist_threshold", "gripper_dist_threshold",
             "temporal_beta", "push_dist", "robot_goal_distribution",
             "invisible_demo",
             # the episode runner
             "use_env_dynamics", "demo_dir", "demo_timescale", "demo_type",
             "goal_image_type", "subgoal_start", "sequential_subgoal",
             "subgoal_step_limit", "world_cost_success", "robot_cost_success",
             "subgoal_completion_bonus", "record_trajectory",
             "record_trajectory_interval", "record_video_interval",
             "cyclegan", "cyclegan_ckpt", "mbrl_algo", "object_demo_dir",
             "debug_trajectory_path",
             # collection
             "collect_target", "num_episodes", "demo_length"]
    for n in names:
        assert getattr(Config(), n) == getattr(JConfig(), n), n
    cfg, rest = argparser(["--camera_ids", "0,2", "--use_env_dynamics",
                           "true", "--demo_timescale", "2"])
    assert not rest
    assert (cfg.camera_ids, cfg.use_env_dynamics, cfg.demo_timescale) == (
        (0, 2), True, 2)
    cfg, rest = argparser(["--env", "LocobotPick", "--demo_cost", "true",
                           "--plan_server_port", "7000",
                           "--dynamics_model_ckpt", "c.npz"])
    assert not rest
    assert (cfg.env, cfg.demo_cost, cfg.plan_server_port,
            cfg.dynamics_model_ckpt) == ("LocobotPick", True, 7000, "c.npz")
    cfg, rest = argparser(["--plan_quantize", "int8"])
    assert not rest and cfg.plan_quantize == "int8"
    with pytest.raises(ValueError, match="plan_quantize"):
        Config(plan_quantize="int4")


def test_calibration_table_matches_jax():
    for key, c2w in jcalib._MEASURED_CAMERA_TO_WORLD.items():
        np.testing.assert_array_equal(tcalib.get_camera_to_world(key),
                                      jcalib.get_camera_to_world(key))
    for cam, K in jcalib.CAM_INTRINSICS.items():
        np.testing.assert_array_equal(tcalib.CAM_INTRINSICS[cam], K)
    assert tcalib.CAM_RESOLUTION == jcalib.CAM_RESOLUTION
    np.testing.assert_array_equal(tcalib.get_world_to_camera("synthetic_c0"),
                                  jcalib.get_world_to_camera("synthetic_c0"))
    # a runtime calibration replaces the measured one
    moved = jcalib.get_camera_to_world("wx250s_c0").copy()
    moved[:3, 3] += 0.01
    tcalib.register_camera("test_rig_c0", moved)
    np.testing.assert_allclose(tcalib.get_world_to_camera("test_rig_c0"),
                               np.linalg.inv(moved))


@pytest.mark.parametrize("key", ["locobot_modified_c0", "wx250s_c0"])
def test_renderer_camera_key_matches_jax(rng, key):
    q = rng.uniform(-0.5, 0.5, (6, 5)).astype(np.float32)
    want = JRenderer((48, 64), key, thick=True).segment_params(jnp.asarray(q))
    got = CapsuleMaskRenderer((48, 64), key, thick=True, device="cpu")
    np.testing.assert_allclose(got.segment_params(torch.tensor(q)).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-4)


def test_pick_integrator_matches_jax(rng):
    """3-D eef integration with the workspace clip, IK and eef_position."""
    start = np.array([[0.3, 0.0, 0.2, 0, 0], [0.5, 0.25, 0.12, 0, 0]],
                     np.float32)
    q0 = np.zeros((2, 5), np.float32)
    acts = rng.uniform(-1.5, 1.5, (6, 2, 4)).astype(np.float32)
    s_j, q_j = jlk.integrate_pick_actions(jnp.asarray(start), jnp.asarray(q0),
                                          jnp.asarray(acts))
    s_t, q_t = tlk.integrate_pick_actions(torch.tensor(start),
                                          torch.tensor(q0), torch.tensor(acts))
    assert s_t.shape == (7, 2, 5) and q_t.shape == (7, 2, 5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=1e-6)
    np.testing.assert_allclose(
        tlk.eef_position(q_t).numpy(), np.asarray(jlk.eef_position(q_j)),
        atol=1e-6)
    for t, j in ((tlk.PICK_WS_LOW, jlk.PICK_WS_LOW),
                 (tlk.PICK_WS_HIGH, jlk.PICK_WS_HIGH)):
        np.testing.assert_array_equal(np.float32(t), np.asarray(j))


# ------------------------------------------------------ planner vs JAX
def _jax_plan(monkeypatch, policy, start, goal, noise, **kw):
    """The JAX plan with jax.random.normal returning `noise` for the
    action-sample shape (traced once inside the fori_loop, so every
    iteration sees it); other shapes pass through."""
    normal = jax.random.normal

    def fake(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == noise.shape:
            return jnp.asarray(noise, dtype)
        return normal(key, shape, dtype)

    monkeypatch.setattr(jax.random, "normal", fake)
    return np.asarray(policy.get_action(start, goal, **kw))


VARIANTS = {"push": (jcem.PushCEMPolicy, PushCEMPolicy),
            "pick": (jcem.PickCEMPolicy, PickCEMPolicy)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_plans_match_jax(weights, rng, monkeypatch, variant):
    """PushCEMPolicy and PickCEMPolicy with the same injected action noise
    give the JAX plans to 1e-5; pick unseeded, demo-seeded (local std) and
    demo-seeded with --pick_wide_x_std. The plans move only if the rollout
    costs reorder. Demo-seeded pick rollouts clipped to the workspace tie
    on cost: the port ranks ties as jax.lax.top_k does."""
    jcls, tcls = VARIANTS[variant]
    kw = dict(PARITY_KW, demo_cost=True)
    opt = 0.4 * rng.randn(2, 4).astype(np.float32)
    # (pick_wide_x_std, opt_traj): unseeded, seeded local, seeded wide
    cases = ([(False, None), (False, opt), (True, opt)] if variant == "pick"
             else [(False, None)])
    start, goal = _start_goal(rng)
    A = tcls.action_dim
    noise = rng.randn(8, 2, A).astype(np.float32)
    jpolicy = jcls(JConfig(**kw), *weights)
    model = _model(weights, sample_mean=True)
    for wide, opt in cases:
        cfg = Config(**dict(kw, pick_wide_x_std=wide))
        tpolicy = tcls(cfg, model, device="cpu")
        jpolicy.cfg = JConfig(**dict(kw, pick_wide_x_std=wide))
        want = _jax_plan(monkeypatch, jpolicy, start, goal, noise,
                         opt_traj=opt)
        got = tpolicy.get_action(start, goal, opt_traj=opt,
                                 noise=np.broadcast_to(noise,
                                                       (2,) + noise.shape))
        assert got.shape == (2, A) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=TOL)
        if variant == "pick":
            assert np.all(got[:, -1] <= 0) and np.all(got[:, -1] >= -0.01)


def test_constructor_overrides_and_hooks(weights, rng, monkeypatch, tmp_path):
    """horizon/opt_iter/action_candidates/topk/init_std override the config
    as in the JAX constructor; a mesh of one gloo process plans what the
    plain policy plans (tests/test_torch_port_mesh.py holds a world of 2);
    a debug_cem plan hands save_gif its rollout beside the goal; a chain
    robot's policy plans."""
    cfg = Config(**SERVE_KW)
    model = _model(weights)
    p = CEMPolicy(cfg, model, device="cpu", horizon=4, opt_iter=1,
                  action_candidates=5, topk=2, init_std=0.01)
    assert (p.horizon, p.opt_iter, p.num_candidates, p.topk, p.init_std) == (
        4, 1, 5, 2, 0.01)
    start, goal = _start_goal(rng)
    plan = p.get_action(start, goal)
    assert plan.shape == (3, 2)
    with world1_mesh(tmp_path) as mesh:
        meshed = CEMPolicy(cfg, model, device="cpu", horizon=4, opt_iter=1,
                           action_candidates=5, topk=2, init_std=0.01,
                           mesh=mesh)
        np.testing.assert_array_equal(meshed.get_action(start, goal), plan)
    saved = []
    monkeypatch.setattr(plot, "save_gif",
                        lambda path, frames, fps=2: saved.append((path, frames)))
    debug = CEMPolicy(cfg.replace(debug_cem=True, log_dir=str(tmp_path)), model,
                      device="cpu", horizon=4, opt_iter=1, action_candidates=5,
                      topk=2)
    assert debug.get_action(start, goal, ep_num=2, step=3).shape == (3, 2)
    (path, frames), = saved
    assert path == str(tmp_path / "debug_cem_ep2_step3.gif")
    assert len(frames) == 3 and all(f.shape == (48, 128, 3) for f in frames)
    assert all(np.isfinite(f).all() for f in frames)
    # control_franka plans through the franka's measured chain (7 joints)
    franka = CEMPolicy(cfg.replace(experiment="control_franka"), model,
                       device="cpu", horizon=3, opt_iter=1, action_candidates=4,
                       topk=2)
    assert franka.engine.qpos_dim == 7
    plan = franka.get_action(start, goal)
    assert plan.shape == (2, 2) and np.all(np.isfinite(plan))
    assert np.all(np.abs(plan) <= 0.05)


def test_generate_model_rollouts_matches_jax(weights, rng):
    """sum_cost, optimal_sum_cost (a demo opt_traj rolled out beside the
    candidates), topk_idx and the top-K rollouts' frames, to 1e-5."""
    start, goal = _start_goal(rng, states=True)
    acts = rng.uniform(-0.05, 0.05, (6, 2, 5)).astype(np.float32)
    opt = rng.uniform(-0.05, 0.05, (2, 2)).astype(np.float32)
    kw = dict(PARITY_KW, robot_cost_weight=0.5)
    want = JTrajectorySampler(JConfig(**kw), *weights).generate_model_rollouts(
        acts, start, goal, opt_traj=opt, ret_obs=True)
    got = TrajectorySampler(Config(**kw), _model(weights, sample_mean=True),
                            device="cpu").generate_model_rollouts(
        acts, start, goal, opt_traj=opt, ret_obs=True)
    assert set(got) == set(want)
    for k in ("sum_cost", "optimal_sum_cost", "obs", "optimal_obs"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got["topk_idx"], want["topk_idx"])
    assert got["obs"].shape == (3, 2, 48, 64, 3)


# ------------------------------------------------------- batched planning
def test_batched_matches_single(weights, rng):
    """get_action_batched of R = 3 requests (padded to 4) equals 3
    get_action calls bit for bit: PickCEMPolicy, one request demo-seeded,
    candidates in chunks of 4, goal states and a robot cost."""
    cfg = Config(**dict(ONE_ITER_KW, candidates_batch_size=4,
                        robot_cost_weight=0.5, demo_cost=True))
    policy = PickCEMPolicy(cfg, _model(weights), device="cpu")
    reqs = [_start_goal(rng, states=True) for _ in range(3)]
    eps, steps = [0, 4, 9], [0, 2, 5]
    opts = [None, 0.3 * rng.randn(2, 4).astype(np.float32), None]
    batched = policy.get_action_batched(
        [r[0] for r in reqs], [r[1] for r in reqs], ep_nums=eps, steps=steps,
        opt_trajs=opts)
    assert batched.shape == (3, cfg.horizon - 1, 4)
    for i, (s, g) in enumerate(reqs):
        np.testing.assert_array_equal(
            batched[i], policy.get_action(s, g, ep_num=eps[i], step=steps[i],
                                          opt_traj=opts[i]))
    with pytest.raises(ValueError, match="agree"):
        policy.get_action_batched([reqs[0][0]] * 2,
                                  [reqs[0][1], _start_goal(rng)[1]])


# ------------------------------------------- server (tests/test_plan_server.py)
def test_plan_matches_local_policy(served, rng):
    server, cfg, model = served
    start, goal = _start_goal(rng)
    client = PlanClient(*server.address)
    try:
        info = client.info()
        assert info["horizon"] == cfg.horizon
        assert info["action_candidates"] == cfg.action_candidates
        assert info["device"] == "cpu" and info["fused_lstm"] is True
        remote = client.plan(start, goal, ep_num=1, step=2)
        assert client.last_plan_s is not None
        local = CEMPolicy(cfg, model, device="cpu").get_action(
            start, goal, ep_num=1, step=2)
        np.testing.assert_array_equal(remote, local)
        assert remote.shape == (cfg.horizon - 1, 2)
    finally:
        client.close()


def test_sequential_clients_and_errors(served, rng):
    server, _, _ = served
    start, goal = _start_goal(rng)
    c1 = PlanClient(*server.address)
    with pytest.raises(RuntimeError, match="unknown cmd"):
        c1._call("bogus")
    assert c1.ping()["ok"]
    c1.close()

    policy = RemotePolicy(*server.address)
    try:
        plan = policy.get_action(start, goal, ep_num=0, step=0)
        assert plan.shape == (2, 2) and np.isfinite(plan).all()
        np.testing.assert_array_equal(
            plan, policy.get_action(start, goal, ep_num=0, step=0))
        with pytest.raises(ValueError, match="rng is server-side"):
            policy.get_action(start, goal, rng=np.random.RandomState(0))
    finally:
        policy.close()


def test_concurrent_clients(served, rng):
    server, _, _ = served
    start, goal = _start_goal(rng)
    c1, c2 = PlanClient(*server.address), PlanClient(*server.address)
    try:
        with cf.ThreadPoolExecutor(2) as pool:
            f1 = pool.submit(c1.plan, start, goal, 5, 0)
            f2 = pool.submit(c2.plan, start, goal, 5, 0)
            p1, p2 = f1.result(timeout=120), f2.result(timeout=120)
        np.testing.assert_array_equal(p1, p2)
    finally:
        c1.close()
        c2.close()


def test_batched_service_matches_local(served, rng):
    """Concurrent distinct requests, planned singly or micro-batched, each
    come back equal to the in-process plan of that request."""
    server, cfg, model = served
    reqs = [_start_goal(rng) for _ in range(4)]
    clients = [PlanClient(*server.address) for _ in range(4)]
    try:
        with cf.ThreadPoolExecutor(4) as pool:
            futs = [pool.submit(clients[i].plan, reqs[i][0], reqs[i][1],
                                i, 2 * i) for i in range(4)]
            plans = [f.result(timeout=300) for f in futs]
        local = CEMPolicy(cfg, model, device="cpu")
        for i in range(4):
            np.testing.assert_array_equal(
                plans[i], local.get_action(reqs[i][0], reqs[i][1], ep_num=i,
                                           step=2 * i))
    finally:
        for c in clients:
            c.close()


def test_batching_server_keeps_plans_consistent(weights, rng):
    """A batching server plans with the cell kernel (its plain version on
    the CPU) on both paths, also when the config asks for the autograd
    cell, and says so in info(); its batched and single plans agree. With
    batch_plans=False the config is kept."""
    cfg = Config(**dict(ONE_ITER_KW, fused_lstm=False))
    model = _model(weights, fused_lstm=False)
    batching = PlanServer(cfg, model, device="cpu")
    try:
        assert batching.consistent_cells and batching.policy.cfg.fused_lstm
        thread = batching.start()
        client = PlanClient(*batching.address)
        info = client.info()
        assert info["fused_lstm"] is True and info["batch_plans"] is True
        reqs = [_start_goal(rng) for _ in range(2)]
        single = [batching.policy.get_action(s, g, ep_num=3) for s, g in reqs]
        batched = batching.policy.get_action_batched(
            [r[0] for r in reqs], [r[1] for r in reqs], ep_nums=[3, 3])
        np.testing.assert_array_equal(batched, np.stack(single))
        client.close(shutdown_server=True)
        thread.join(timeout=5)
    finally:
        batching.close()
    single_server = PlanServer(cfg, model, batch_plans=False, device="cpu")
    try:
        assert not single_server.consistent_cells
        assert not single_server.policy.cfg.fused_lstm
    finally:
        single_server.close()


def test_demo_seeded_plan_roundtrip(weights, rng):
    """opt_traj crosses the wire and changes the plan under --demo_cost."""
    cfg = Config(**dict(ONE_ITER_KW, demo_cost=True))
    server = PlanServer(cfg, _model(weights), device="cpu")
    thread = server.start()
    start, goal = _start_goal(rng)
    opt = 0.03 * rng.randn(cfg.horizon - 1, 2).astype(np.float32)
    client = PlanClient(*server.address)
    try:
        base = client.plan(start, goal, ep_num=3, step=0)
        seeded = client.plan(start, goal, ep_num=3, step=0, opt_traj=opt)
        assert np.abs(base - seeded).max() > 0
        np.testing.assert_array_equal(
            seeded, server.policy.get_action(start, goal, ep_num=3,
                                             opt_traj=opt))
    finally:
        client.close(shutdown_server=True)
        server.close()
        thread.join(timeout=5)


def test_build_server_loads_a_jax_checkpoint(weights, rng, tmp_path):
    """build_server loads --dynamics_model_ckpt written by the JAX
    package's checkpoint module, picks the policy by --env and warms; its
    plan equals the plan of a policy holding the same weights."""
    path = jckpt.save_checkpoint(str(tmp_path), 7, {"params": weights[0],
                                                    "bn": weights[1]})
    jckpt.wait_for_checkpoints()
    cfg = Config(**dict(ONE_ITER_KW, env="LocobotPush",
                        dynamics_model_ckpt=path, seed=5))
    server = build_server(cfg, device="cpu")
    try:
        assert isinstance(server.policy, PushCEMPolicy)
        assert warm(server) > 0
        start, goal = _start_goal(rng)
        want = PushCEMPolicy(cfg, _model(weights), device="cpu").get_action(
            start, goal, ep_num=2)
        np.testing.assert_array_equal(
            server.policy.get_action(start, goal, ep_num=2), want)
    finally:
        server.close()


# ------------------------------------------------------ wire, both ways
def test_port_client_plans_on_the_jax_server(weights, rng):
    jcfg = JConfig(**SERVE_KW)
    server = jserver.PlanServer(jcfg, *weights, batch_plans=False)
    thread = server.start()
    start, goal = _start_goal(rng)
    client = PlanClient(*server.address)
    try:
        plan = client.plan(start, goal, ep_num=1, step=1)
        assert plan.shape == (2, 2) and np.isfinite(plan).all()
        np.testing.assert_array_equal(
            plan, np.asarray(server.policy.get_action(start, goal, ep_num=1,
                                                      step=1), np.float32))
        assert client.info()["horizon"] == jcfg.horizon
    finally:
        client.close(shutdown_server=True)
        server.close()
        thread.join(timeout=5)


def test_jax_client_plans_on_the_port_server(served, rng):
    server, cfg, model = served
    start, goal = _start_goal(rng)
    client = jserver.PlanClient(*server.address)
    try:
        plan = client.plan(start, goal, ep_num=2, step=1)
        assert plan.shape == (2, 2) and np.isfinite(plan).all()
        np.testing.assert_array_equal(
            plan, CEMPolicy(cfg, model, device="cpu").get_action(
                start, goal, ep_num=2, step=1))
        assert client.info()["action_candidates"] == cfg.action_candidates
    finally:
        client.close()


# ---------------------------------- controller (tests/test_real_robot.py)
class StubEnv:
    """A numpy push env: the eef moves by action[:3] * 0.05 inside the
    workspace; the frame shows the eef as a bright disc on a fixed
    background."""

    action_dim = 5

    class _State:
        pass

    def __init__(self, seed=0):
        self._bg = np.random.RandomState(seed).rand(48, 64, 3).astype(
            np.float32) * 0.5
        self.state = self._State()
        self.state.eef = np.array([0.3, 0.0, 0.15], np.float32)
        self.state.qpos = np.zeros(5, np.float32)
        self.steps = 0

    def render(self):
        img = self._bg.copy()
        yy, xx = np.mgrid[:48, :64]
        u = 32 + 60 * self.state.eef[1]
        v = 24 + 60 * (self.state.eef[0] - 0.3)
        img[(yy - v) ** 2 + (xx - u) ** 2 < 16] = 1.0
        return img

    def step(self, a):
        self.state.eef = np.clip(self.state.eef + a[:3] * 0.05,
                                 [0.015, -0.3, 0.1], [0.55, 0.3, 0.4]
                                 ).astype(np.float32)
        self.steps += 1


def test_visual_mpc_closed_and_open_loop(weights):
    cfg = Config(**dict(ONE_ITER_KW, action_candidates=6, topk=2,
                        max_episode_length=2, replan_every=1))
    env = StubEnv()
    robot = SimRobotInterface(env)
    ctrl = VisualMPCController(cfg, robot, _model(weights), device="cpu")
    ctrl.collect_goal_img()
    ctrl.set_start_pose(np.array([0.25, 0.0, 0.15], np.float32))
    moved = env.steps
    assert moved > 0
    executed = ctrl.run()
    assert executed.shape == (cfg.max_episode_length, 2)
    assert env.steps == moved + cfg.max_episode_length

    cfg2 = cfg.replace(cem_open_loop=True)
    ctrl2 = VisualMPCController(cfg2, robot, _model(weights), device="cpu")
    ctrl2.collect_goal_img()
    assert ctrl2.run().shape[0] == cfg2.max_episode_length
    # AprilTag calibration (control/apriltag.py): the stub's frame holds no
    # tag, so nothing is registered
    assert ctrl2.calibrate_extrinsics("stub_no_tag_c0", np.eye(4),
                                      np.eye(3)) is None


def test_visual_mpc_over_socket_bridge(weights):
    """The controller loop across a socket: a RobotBridgeServer wraps the
    stub robot on a thread, the controller drives it through
    SocketRobotInterface; robot faults surface as errors."""
    import threading

    cfg = Config(**dict(ONE_ITER_KW, action_candidates=6, topk=2,
                        max_episode_length=2))
    env = StubEnv()
    server = RobotBridgeServer(SimRobotInterface(env))
    t = threading.Thread(target=server.serve_once, daemon=True)
    t.start()
    robot = SocketRobotInterface(*server.address)
    try:
        ctrl = VisualMPCController(cfg, robot, _model(weights), device="cpu")
        img = ctrl.collect_goal_img()
        assert img.shape == (48, 64, 3)
        ctrl.set_start_pose(np.array([0.25, 0.0, 0.15], np.float32))
        assert ctrl.run().shape[0] == cfg.max_episode_length
        with pytest.raises(RuntimeError, match="bogus_command"):
            robot._call("bogus_command")
    finally:
        robot.close()
        t.join(timeout=10)
        server.close()
