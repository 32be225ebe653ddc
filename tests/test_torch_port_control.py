"""The port's demos, data collection, ground-truth CEM, the cem_demo CLI
and the episode runner held against the JAX package on the CPU.

JAX's draws are injected: `jax.random.normal` is patched, while the JAX
plan traces, to return fixed action noise (its plans trace once inside a
fori_loop, so every iteration and every plan of an episode sees the same
noise), and the port's policies take the same noise through their `noise`
argument. Tolerances: GT plans and their costs 1e-5 (float32 sums in
another order; a plan moves only where costs reorder); episode actions
1e-5 and episode stats 1e-5; demos and collected files as the envs (1e-6,
joints 1e-5, masks equal)."""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.control import episode_runner as jrunner
from robot_aware_control_tpu.data import collect as jcollect
from robot_aware_control_tpu.data import demo_io as jdemo
from robot_aware_control_tpu.planning import gt_rollout as jgt
from robot_aware_control_tpu.utils.state import DemoGoalState
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.control import episode_runner as trunner
from robot_aware_control_tpu_torch.data import collect as tcollect
from robot_aware_control_tpu_torch.data import demo_io as tdemo
from robot_aware_control_tpu_torch.envs import variants as tvariants
from robot_aware_control_tpu_torch.envs.base import SimState
from robot_aware_control_tpu_torch.models import svg as tsvg
from robot_aware_control_tpu_torch.models.torch_export import model_trees
from robot_aware_control_tpu_torch.planning import cem_demo
from robot_aware_control_tpu_torch.planning import gt_rollout as tgt
from robot_aware_control_tpu_torch.planning.rollout import prepare_goals
from torch_sim_cases import GT_SMALL, push_goal
from torch_sim_jax import jax_env
from torch_train_cases import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-6
JOINT_TOL = 1e-5  # the analytic IK's tolerance (tests/test_torch_port_model.py)
PLAN_TOL = 1e-5
GT_POLICIES = {"LocobotPush": (jgt.GTPushCEMPolicy, tgt.GTPushCEMPolicy, {}),
               "LocobotPick": (jgt.GTPickCEMPolicy, tgt.GTPickCEMPolicy,
                               dict(robot_cost_weight=1.0)),
               "ClutterPush": (jgt.GTCEMPolicy, tgt.GTCEMPolicy,
                               dict(reward_type="weighted",
                                    robot_pixel_weight=0.3))}


def _assert_demo_equal(got, want):
    assert set(got) >= set(want) - {"robot_demo"}
    for k, w in want.items():
        if k == "robot_demo":
            continue
        tol = JOINT_TOL if k == "qpos" else TOL
        if k == "sim_start":  # its joints too
            np.testing.assert_allclose(got[k][3:8], w[3:8], atol=JOINT_TOL)
            np.testing.assert_allclose(got[k][8:], w[8:], atol=TOL)
            continue
        if k == "masks":
            np.testing.assert_array_equal(got[k], w)
            continue
        np.testing.assert_allclose(np.asarray(got[k], np.float32),
                                   np.asarray(w, np.float32), atol=tol,
                                   err_msg=k)


@pytest.fixture
def fake_jax_normal(monkeypatch):
    """Sets jax.random.normal to return `noise` for its shape (others pass
    through)."""
    normal = jax.random.normal

    def install(noise):
        def fake(key, shape=(), dtype=jnp.float32):
            if tuple(shape) == noise.shape:
                return jnp.asarray(noise, dtype)
            return normal(key, shape, dtype)

        monkeypatch.setattr(jax.random, "normal", fake)

    return install


# -------------------------------------------------------------- demos, data
@pytest.mark.parametrize("name", ["LocobotPush", "LocobotPick", "ClutterPush"])
def test_demo_from_history_matches_jax(name):
    jenv = jax_env(name, rng_seed=5, demo_length=8)
    tenv = tvariants.make(name, Config(demo_length=8), seed=5, device="cpu")
    want = jdemo.demo_from_history(jenv, jenv.generate_demo())
    got = tdemo.demo_from_history(tenv, tenv.generate_demo())
    _assert_demo_equal(got, want)
    render = jax.jit(lambda q, o: jenv.renderer.render_scene(
        q, o, jenv._halfs, jenv._colors, include_arm=False)[0])
    np.testing.assert_allclose(tdemo.object_only_images(tenv, got),
                               np.asarray(render(want["qpos"],
                                                 want["obj_poses"])), atol=TOL)


def test_collected_files_match_jax(tmp_path):
    """Runner demos, training episodes and mask data written by the port
    read back as the JAX package's files of the same seed."""
    cfg = dict(demo_length=6)
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    want = jcollect.collect_runner_demos("LocobotPush", 2, jd,
                                         JConfig(**cfg), seed=3)
    got = tcollect.collect_runner_demos("LocobotPush", 2, td, Config(**cfg),
                                        seed=3, device="cpu")
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        _assert_demo_equal(jdemo.load_demo(g), jdemo.load_demo(w))
    import h5py

    want = jcollect.collect_training_data("LocobotPick", 1, jd,
                                          JConfig(**cfg), seed=3)
    got = tcollect.collect_training_data("LocobotPick", 1, td, Config(**cfg),
                                         seed=3, device="cpu")
    with h5py.File(got[0]) as g, h5py.File(want[0]) as w:
        assert set(g) == set(w) and dict(g.attrs) == dict(w.attrs)
        for k in w:
            np.testing.assert_allclose(g[k][()], w[k][()],
                                       atol=JOINT_TOL if k == "qpos" else TOL)
    want = jcollect.collect_mask_data("ClutterPush", 3, jd, JConfig(), seed=3)
    got = tcollect.collect_mask_data("ClutterPush", 3, td, Config(), seed=3,
                                     device="cpu")
    with h5py.File(got) as g, h5py.File(want) as w:
        np.testing.assert_array_equal(g["masks"][()], w["masks"][()])
        np.testing.assert_allclose(g["qpos"][()], w["qpos"][()],
                                   atol=JOINT_TOL)


def test_collect_cli(tmp_path):
    """`python -m ...data.collect` with --device cpu writes both targets;
    without --device it runs on the card, and raises without one."""
    argv = ["--env", "LocobotPush", "--collect_target", "both",
            "--num_episodes", "1", "--demo_length", "4",
            "--data_root", str(tmp_path / "data"),
            "--demo_dir", str(tmp_path / "demos")]
    tcollect.main(argv + ["--device", "cpu"])
    assert len(tdemo.list_demos(str(tmp_path / "demos"))) == 1
    assert os.listdir(tmp_path / "data" / "locobot_c0")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcollect.main(argv)


def test_writers_name_a_missing_h5py(tmp_path, monkeypatch):
    """Without h5py the writers raise ImportError naming it, before any
    episode runs, and write nothing else."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    for fn in (tcollect.collect_runner_demos, tcollect.collect_training_data,
               tcollect.collect_mask_data):
        with pytest.raises(ImportError, match="h5py"):
            fn("LocobotPush", 1, str(tmp_path), device="cpu")
    with pytest.raises(ImportError, match="h5py"):
        tdemo.save_demo(str(tmp_path / "d.hdf5"), {"x": np.zeros(2)})
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------- GT CEM
def _gt_setup(name, **extra):
    kw = dict(GT_SMALL, **GT_POLICIES[name][2], **extra)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jenv = jax_env(name, rng_seed=1, **kw)
    tenv = tvariants.make(name, cfg, seed=1, device="cpu")
    goal = push_goal(jenv) if name != "LocobotPick" else _pick_goal(jenv)
    push_goal(tenv) if name != "LocobotPick" else _pick_goal(tenv)
    return jcfg, cfg, jenv, tenv, goal


def _pick_goal(env):
    hist = env.generate_demo()
    env.reset()
    return DemoGoalState(imgs=[o["observation"] for o in hist["obs"][1:]],
                         masks=[o["masks"] for o in hist["obs"][1:]],
                         states=[o["states"] for o in hist["obs"][1:]])


@pytest.mark.parametrize("name", sorted(GT_POLICIES))
def test_gt_costs_match_jax(name, rng):
    """GTRolloutEngine: the costs of the same candidate actions from the
    env's state (with the robot cost for pick, the weighted cost for the
    clutter env) and the rendered frames."""
    jcfg, cfg, jenv, tenv, goal = _gt_setup(name)
    A = tenv.action_dim
    acts = rng.uniform(-1, 1, (5, 3, A)).astype(np.float32)
    gi, gm, gs = prepare_goals(goal, 3)
    engine = jgt.GTRolloutEngine(jcfg, jenv)
    want, wobs = jax.jit(lambda *a: engine(*a, ret_obs=True))(
        jenv.state, acts, gi, gm, gs)
    t = torch.tensor
    got, obs = tgt.GTRolloutEngine(cfg, tenv)(
        tenv.state, t(acts), t(gi), t(gm), goal_states=t(gs), ret_obs=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PLAN_TOL)
    np.testing.assert_allclose(obs.numpy(), np.asarray(wobs), atol=TOL)


@pytest.mark.parametrize("name", sorted(GT_POLICIES))
def test_gt_plan_matches_jax(name, fake_jax_normal):
    """A whole GT CEM plan from the env's state with the same injected
    noise: push, pick with the robot cost, clutter with the do-nothing
    candidate."""
    jcfg, cfg, jenv, tenv, goal = _gt_setup(name)
    jcls, tcls, _ = GT_POLICIES[name]
    policy = tcls(cfg, tenv)
    noise = np.random.RandomState(7).randn(
        cfg.action_candidates, cfg.horizon - 1, policy.action_dim
    ).astype(np.float32)
    fake_jax_normal(noise)
    want = np.asarray(jcls(jcfg, jenv).get_action(None, goal))
    got = policy.get_action(None, goal, noise=np.broadcast_to(
        noise, (cfg.opt_iter,) + noise.shape))
    assert got.shape == want.shape == (cfg.horizon - 1, policy.action_dim)
    np.testing.assert_allclose(got, want, atol=PLAN_TOL)


def test_gt_plan_renders_once_an_iteration(monkeypatch):
    """Each CEM iteration renders all N x (horizon - 1) scenes in one call
    (one mask launch on the card); the plan is a function of (seed, ep,
    step)."""
    _, cfg, _, tenv, goal = _gt_setup("LocobotPush")
    policy = tgt.GTPushCEMPolicy(cfg, tenv)
    render, calls = tenv.renderer.render, []

    def counted(qpos):
        calls.append(tuple(qpos.shape))
        return render(qpos)

    monkeypatch.setattr(tenv.renderer, "render", counted)
    a = policy.get_action(None, goal, ep_num=0, step=1)
    N, T = cfg.action_candidates, cfg.horizon - 1
    assert calls == [(N * T, 5)] * cfg.opt_iter
    np.testing.assert_array_equal(policy.get_action(None, goal, 0, 1), a)
    assert np.abs(policy.get_action(None, goal, 0, 2) - a).max() > 0


def test_demo_cem_policy_compares_env_and_model(tmp_path):
    """DemoCEMPolicy dispatches to the GT policy under use_env_dynamics
    and needs a model otherwise; compare_optimal_actions rolls the actions
    through the env, restores its state and returns the env's frames."""
    cfg = Config(**dict(GT_SMALL, use_env_dynamics=True))
    env = tvariants.make("LocobotPush", cfg, seed=1, device="cpu")
    goal = push_goal(env)
    policy = tgt.DemoCEMPolicy(cfg, env, policy_cls=tgt.PushCEMPolicy,
                               gt_policy_cls=tgt.GTPushCEMPolicy)
    assert isinstance(policy.policy, tgt.GTPushCEMPolicy)
    before = env.get_flattened_state()
    acts = np.full((3, 2), 0.5, np.float32)
    frames = policy.compare_optimal_actions(acts, None, goal,
                                            str(tmp_path / "cmp.gif"))
    np.testing.assert_array_equal(env.get_flattened_state(), before)
    assert len(frames) == 3 and frames[0].shape == (48, 64, 3)
    with pytest.raises(ValueError, match="needs a model"):
        tgt.DemoCEMPolicy(cfg.replace(use_env_dynamics=False), env)


# -------------------------------------------------------------- cem_demo
def test_cem_demo_cli(tmp_path):
    """The planner CLI in the push env on --device cpu: a (horizon-1, 2)
    plan, run in the env; without --device it needs the card."""
    argv = ["--g_dim", "16", "--z_dim", "4", "--horizon", "3", "--opt_iter",
            "1", "--action_candidates", "4", "--topk", "2", "--compute_dtype",
            "float32", "--log_dir", str(tmp_path), "--demo_length", "4"]
    plan = cem_demo.main(argv + ["--device", "cpu"])
    assert plan.shape == (2, 2) and np.all(np.isfinite(plan))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cem_demo.main(argv)


# -------------------------------------------------------- episode runner
RUN_KW = dict(env="LocobotPush", horizon=3, opt_iter=2, action_candidates=8,
              topk=3, cem_init_std=0.5, replan_every=1, max_episode_length=10,
              num_episodes=1, demo_length=10, world_cost_success=0.3,
              reward_type="dontcare", record_video_interval=0, seed=0,
              jobname="run")


def _runner_pair(tmp_path, model_pair=None, **kw):
    """The JAX and the port's PushEpisodeRunner, the same demo for both
    (the JAX one's, saved as HDF5 for the JAX runner), and the noise."""
    fields = dict(RUN_KW, **kw)
    jcfg = JConfig(**fields, log_dir=str(tmp_path / "j"))
    cfg = Config(**fields, log_dir=str(tmp_path / "t"))
    if model_pair is None:
        jr = jrunner.PushEpisodeRunner(jcfg)
        tr = trunner.PushEpisodeRunner(cfg, device="cpu")
    else:
        params, bn, model = model_pair
        jr = jrunner.PushEpisodeRunner(jcfg, params, bn)
        tr = trunner.PushEpisodeRunner(cfg, model, device="cpu")
    demo = jdemo.demo_from_history(jr.env, jr.env.generate_demo())
    path = str(tmp_path / "demo.hdf5")
    jdemo.save_demo(path, demo)
    noise = np.random.RandomState(9).randn(
        cfg.action_candidates, cfg.horizon - 1, 2).astype(np.float32)
    pol = tr.policy.policy
    pol.get_action = functools.partial(pol.get_action, noise=np.broadcast_to(
        noise, (cfg.opt_iter,) + noise.shape))
    return jr, tr, path, noise


def _recorded(env):
    acts = []
    step = env.step

    def rec(a):
        acts.append(np.asarray(a, np.float32))
        return step(a)

    env.step = rec
    return acts


def _episode_pair(jr, tr, demo, noise, fake_jax_normal):
    fake_jax_normal(noise)
    jacts, tacts = _recorded(jr.env), _recorded(tr.env)
    want = jr.run_episode(0, demo)
    got = tr.run_episode(0, demo)
    tr.logger.close()
    assert len(tacts) == len(jacts) > 1
    np.testing.assert_allclose(np.stack(tacts), np.stack(jacts),
                               atol=PLAN_TOL)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=PLAN_TOL, err_msg=k)
    return got, tacts


def test_gt_episode_matches_jax(tmp_path, fake_jax_normal):
    """A whole GT PushEpisodeRunner episode following a demo (9 plans,
    contact included): the same actions each step and the same stats as
    the JAX runner. The port's
    runner follows the demo from its HDF5 path and from the dict in
    memory alike."""
    jr, tr, path, noise = _runner_pair(tmp_path, use_env_dynamics=True)
    got, _ = _episode_pair(jr, tr, path, noise, fake_jax_normal)
    assert got["push_progress"] > 0  # the plans pushed the block
    again = tr.run_episode(1, tdemo.load_demo(path))
    assert again == got


@pytest.fixture(scope="module")
def small_svg():
    """A small float32 svg from a seed, and its JAX trees (convert.py)."""
    kw = dict(model="svg", g_dim=16, z_dim=4, action_dim=5, robot_dim=5,
              robot_joint_dim=5, model_use_mask=True,
              model_use_robot_state=True, reconstruction_loss="dontcare_l1",
              compute_dtype="float32", sample_mean=True,
              eef_action_scale=0.05)
    model = tsvg.init(Config(**kw), seed=0, device="cpu")
    return (kw,) + model_trees(model) + (model,)


def test_learned_episode_matches_jax(tmp_path, small_svg, fake_jax_normal):
    """A PushEpisodeRunner episode planning through a small svg (the same
    weights in both packages through convert.py; sample_mean, so no prior
    draws): the same actions each step and the same stats."""
    kw, params, bn, model = small_svg
    jr, tr, path, noise = _runner_pair(
        tmp_path, (params, bn, model), max_episode_length=4, **kw)
    _episode_pair(jr, tr, path, noise, fake_jax_normal)


def test_runner_refusals_and_cli(tmp_path):
    """--cyclegan builds the CycleGAN translator (baselines/cyclegan.py);
    --mbrl_algo other than cem raises; main() on --device cpu runs the
    demos of --demo_dir."""
    from robot_aware_control_tpu_torch.baselines.cyclegan import CycleGANTranslator

    cfg = Config(**RUN_KW, log_dir=str(tmp_path), cyclegan=True,
                 use_env_dynamics=True)
    runner = trunner.PushEpisodeRunner(cfg, device="cpu")
    runner.logger.close()
    assert isinstance(runner.translator, CycleGANTranslator)
    img = np.random.RandomState(0).rand(48, 64, 3).astype(np.float32)
    out = runner.translator(img)
    assert out.shape == img.shape and np.all((out >= 0) & (out <= 1))
    with pytest.raises(ValueError, match="mbrl_algo"):
        trunner.main(["--mbrl_algo", "sac", "--device", "cpu"])
    demos = str(tmp_path / "demos")
    tcollect.collect_runner_demos("LocobotPush", 1, demos,
                                  Config(demo_length=4), device="cpu")
    summary = trunner.main(["--env", "LocobotPush", "--use_env_dynamics",
                            "true", "--demo_dir", demos, "--num_episodes", "1",
                            "--horizon", "3", "--opt_iter", "1",
                            "--action_candidates", "4", "--topk", "2",
                            "--log_dir", str(tmp_path), "--device", "cpu",
                            "--record_trajectory", "true",
                            "--record_trajectory_interval", "1"])
    assert 0.0 <= summary["goal_progress"] <= 1.0
    assert os.listdir(os.path.join(tmp_path, "svg_train_robonet_0",
                                   "trajectory"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trunner.main(["--env", "LocobotPush", "--use_env_dynamics",
                          "true", "--demo_dir", demos])


def test_sim_state_is_a_tuple_of_tensors():
    env = tvariants.make("LocobotPick", Config(), seed=0, device="cpu")
    env.reset()
    assert isinstance(env.state, SimState)
    assert all(torch.is_tensor(x) for x in env.state)
