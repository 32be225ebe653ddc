"""The port's simulation layer held against the JAX package on the CPU:
rotations, the geometric planning helpers, the scene renderer, the physics
step, the task envs and their variants.

Tolerances: float32 work of another order (XLA's and PyTorch's CPU
kernels) moves positions by a few 1e-8 m, so the physics (tip, blocks,
velocities, grip and hold flags) and the images are held to 1e-6 over 20+
steps (`sim_case`: contact, chains of three blocks, grab, carry, release,
drop). The joints come from the analytic IK, whose atan2 chains differ
between the libraries by up to 1.2e-6 rad here: they are held to 1e-5, the
IK's tolerance in tests/test_torch_port_model.py. The robot masks must be
equal: the port's mask kernel
compares squared distances (d^2 <= r^2) where the JAX scene renderer
compares sqrt(d^2) <= r, and on these poses no pixel differs (the tests
count them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_aware_control_tpu.envs import base as jbase
from robot_aware_control_tpu.envs import variants as jvariants
from robot_aware_control_tpu.envs.renderer import SceneRenderer as JScene
from robot_aware_control_tpu.robot.mask_renderer import (
    CapsuleMaskRenderer as JRenderer,
)
from robot_aware_control_tpu.utils import planning_geom as jgeom
from robot_aware_control_tpu.utils import rotations as jrot
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.envs import base as tbase
from robot_aware_control_tpu_torch.envs import renderer as trenderer
from robot_aware_control_tpu_torch.envs import variants as tvariants
from robot_aware_control_tpu_torch.envs.renderer import SceneRenderer
from robot_aware_control_tpu_torch.robot.mask_renderer import CapsuleMaskRenderer
from robot_aware_control_tpu_torch.utils import planning_geom as tgeom
from robot_aware_control_tpu_torch.utils import rotations as trot
from torch_sim_cases import case_coverage, run_case, sim_case
from torch_sim_jax import jax_env, jax_run
from torch_train_cases import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-6
JOINT_TOL = 1e-5
JOINTS = slice(3, 8)  # the joints of a flattened state
ENVS = sorted(jvariants._REGISTRY)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _assert_obs_equal(got, want):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, err_msg=k,
                                   atol=JOINT_TOL if k == "qpos" else TOL)


def _assert_flat_equal(got, want):
    """Flattened states (..., S): the joints to JOINT_TOL, the rest to TOL."""
    g, w = np.array(got, ndmin=2), np.array(want, ndmin=2)
    np.testing.assert_allclose(g[:, JOINTS], w[:, JOINTS], atol=JOINT_TOL,
                               rtol=0)
    g[:, JOINTS] = w[:, JOINTS] = 0.0
    np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


def _assert_runs_equal(got, want):
    _assert_flat_equal(got["flat"], want["flat"])
    np.testing.assert_allclose(got["img"], want["img"], atol=TOL, rtol=0)
    assert int((got["mask"] != want["mask"]).sum()) == 0


# ---------------------------------------------------------------- rotations
def _euler(rng, n=64):
    e = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    e[:, 1] = np.clip(e[:, 1], -1.4, 1.4)  # away from gimbal lock
    return e


@pytest.mark.parametrize("name", ["euler2mat", "mat2euler", "euler2quat",
                                  "quat2euler", "quat2mat", "mat2quat",
                                  "quat_mul", "quat_conjugate", "quat_rotate"])
def test_rotations_match_jax(rng, name):
    e = _euler(rng)
    q = np.asarray(jrot.euler2quat(jnp.asarray(e)))
    m = np.asarray(jrot.euler2mat(jnp.asarray(e)))
    v = rng.randn(64, 3).astype(np.float32)
    args = {"euler2mat": (e,), "mat2euler": (m,), "euler2quat": (e,),
            "quat2euler": (q,), "quat2mat": (q,), "mat2quat": (m,),
            "quat_mul": (q, q[::-1].copy()), "quat_conjugate": (q,),
            "quat_rotate": (q, v)}[name]
    want = np.asarray(getattr(jrot, name)(*map(jnp.asarray, args)))
    got = getattr(trot, name)(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ------------------------------------------------------------ planning geom
def test_planning_geom_matches_jax():
    """The numpy copy plans the same RRT paths from the same seeds."""
    low, high = [0.0, -0.3], [0.6, 0.3]
    obstacles = [(0.3, 0.0), (0.2, 0.15)]
    want = jgeom.planar_rrt((0.05, 0.0), (0.55, 0.05), low, high, obstacles,
                            seed=3)
    got = tgeom.planar_rrt((0.05, 0.0), (0.55, 0.05), low, high, obstacles,
                           seed=3)
    assert want is not None and len(got) == len(want)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    objs = dict(j=[jgeom.CollisionBox((0.3, 0.0, 0.2), (0.05, 0.1, 0.1)),
                   jgeom.CollisionSphere((0.2, 0.1, 0.2), 0.05)],
                t=[tgeom.CollisionBox((0.3, 0.0, 0.2), (0.05, 0.1, 0.1)),
                   tgeom.CollisionSphere((0.2, 0.1, 0.2), 0.05)])
    a, b = (0.05, 0.0, 0.2), (0.55, 0.0, 0.2)
    want = jgeom.rrt_with_objects(a, b, (0, -0.3, 0.1), (0.6, 0.3, 0.4),
                                  objs["j"], seed=1)
    got = tgeom.rrt_with_objects(a, b, (0, -0.3, 0.1), (0.6, 0.3, 0.4),
                                 objs["t"], seed=1)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    assert objs["t"][1].line_in_collision(a, (1, 0, 0)) == \
        objs["j"][1].line_in_collision(a, (1, 0, 0))
    assert tgeom.segment_sphere_collision(a, b, (0.3, 0.02, 0.2), 0.03)
    assert tgeom.point_in_aabb((0.1, 0.1), (0, 0), (0.2, 0.2))


# ----------------------------------------------------------------- renderer
def _scene_inputs(rng, n=6, K=3):
    q = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.4, 0.6, n),
                  rng.uniform(-0.2, 0.8, n), rng.uniform(0.2, 1.2, n),
                  np.zeros(n)], -1).astype(np.float32)
    obj = np.stack([rng.uniform(0.25, 0.5, (n, K)),
                    rng.uniform(-0.2, 0.2, (n, K)),
                    np.full((n, K), 0.12)], -1).astype(np.float32)
    return q, obj


@pytest.mark.parametrize("kw", [
    dict(), dict(modified=True), dict(camera_key="external_camera_0"),
    dict(arm_color=(0.55, 0.30, 0.10),
         radii=np.array([0.060, 0.056, 0.050, 0.065], np.float32))],
    ids=["default", "modified", "camera", "modified_robot"])
@pytest.mark.parametrize("include_arm", [True, False])
def test_scene_render_matches_jax(rng, kw, include_arm):
    q, obj = _scene_inputs(rng)
    halfs = np.full(3, 0.02, np.float32)
    colors = jbase.RobotEnv.OBJ_COLORS[:3]
    jimg, jmask = JScene((48, 64), **kw).render_scene(
        jnp.asarray(q), jnp.asarray(obj), halfs, colors,
        include_arm=include_arm)
    timg, tmask = SceneRenderer((48, 64), device="cpu", **kw).render_scene(
        _t(q), _t(obj), halfs, colors, include_arm=include_arm)
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=TOL)
    differ = int((tmask.numpy() != np.asarray(jmask)).sum())
    assert differ == 0, f"{differ} mask pixels differ"
    if include_arm:
        assert tmask.numpy().mean() > 0.01  # the arm is in view


def _equal_depth_blocks():
    """Two overlapping blocks at the same depth (a camera-frame z of equal
    float32 bits: the same world point shifted along the image's u axis
    would change z, so the second block is the first one's copy)."""
    q = np.array([[0.3, 0.2, 0.4, 0.8, 0.0]], np.float32)
    obj = np.array([[[0.35, 0.0, 0.12], [0.35, 0.0, 0.12]]], np.float32)
    halfs = np.array([0.02, 0.025], np.float32)
    colors = jbase.RobotEnv.OBJ_COLORS[:2]
    return q, obj, halfs, colors


def test_blocks_at_equal_depth_keep_their_order(monkeypatch):
    """Blocks at equal depth are drawn in index order (a stable sort, as
    jnp.argsort): the later block wins where they overlap. A planted draw
    order that reverses ties (an ascending sort read backwards) is
    rejected."""
    q, obj, halfs, colors = _equal_depth_blocks()
    want = np.asarray(JScene((48, 64)).render_scene(
        jnp.asarray(q), jnp.asarray(obj), halfs, colors)[0])
    renderer = SceneRenderer((48, 64), device="cpu")
    got = renderer.render_scene(_t(q), _t(obj), halfs, colors)[0].numpy()
    np.testing.assert_allclose(got, want, atol=TOL)
    monkeypatch.setattr(trenderer, "draw_order", lambda z: torch.argsort(
        z, dim=-1, stable=True).flip(-1))
    planted = renderer.render_scene(_t(q), _t(obj), halfs, colors)[0].numpy()
    assert np.abs(planted - want).max() > 0.1


@pytest.mark.parametrize("kw", [
    dict(radii=np.array([0.06, 0.05, 0.04, 0.05], np.float32)),
    dict(cam_name="intel_realsense_d435", include_base=False),
    dict(base_segments=np.array([[[0.0, 0.0, 0.05], [0.1, 0.0, 0.05]]],
                                np.float32),
         base_radii=np.array([0.05], np.float32), thick=True)],
    ids=["radii", "no_base", "base"])
def test_mask_renderer_options_match_jax(rng, kw):
    """The constructor options the JAX renderer has (radii, cam_name,
    include_base, base_segments, base_radii)."""
    q, _ = _scene_inputs(rng)
    want = JRenderer((48, 64), **kw).segment_params(jnp.asarray(q))
    got = CapsuleMaskRenderer((48, 64), device="cpu", **kw).segment_params(
        _t(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


# ------------------------------------------------------------------ physics
@pytest.mark.parametrize("name", ENVS)
def test_physics_matches_jax(name):
    """20 steps of every env class from the same scripted start: states,
    images and masks against the JAX env's (its jitted physics_step)."""
    start, actions = sim_case(name)
    env = tvariants.make(name, Config(), device="cpu")
    got = run_case(env, start, actions)
    want = jax_run(jax_env(name), start, actions)
    _assert_runs_equal(got, want)
    cov = case_coverage(env, got)
    if env.pick:
        assert cov["grabs"] and cov["drops"], cov
    else:
        assert cov["moved"] == env.num_objects, cov  # all of a chain


def test_physics_step_batches(rng):
    """A batch of states steps as each state alone (the GT planner's
    candidates are one batch)."""
    start, actions = sim_case("ClutterPush")
    env = tvariants.make("ClutterPush", Config(), device="cpu")
    env.set_flattened_state(start)
    acts = torch.tensor(rng.uniform(-1, 1, (5, 2)).astype(np.float32))
    batch = tbase.SimState(*(x.expand((5,) + x.shape) for x in env.state))
    stepped = tbase.physics_step(batch, acts)
    for i in range(5):
        alone = tbase.physics_step(env.state, acts[i])
        for b, a in zip(stepped, alone):
            np.testing.assert_allclose(b[i].numpy(), a.numpy(), atol=1e-7)


def test_chain_planted_fault_is_rejected(monkeypatch):
    """A planted fault, contacts without chain passes (a pushed block never
    shoves the next), fails the chain case against JAX."""
    start, actions = sim_case("ClutterPush")
    want = jax_run(jax_env("ClutterPush"), start, actions)
    good = tbase._resolve_contacts
    monkeypatch.setattr(tbase, "_resolve_contacts",
                        lambda *a: good(*a[:-1], 0))
    got = run_case(tvariants.make("ClutterPush", Config(), device="cpu"),
                   start, actions)
    assert np.abs(got["flat"] - want["flat"]).max() > 1e-3


@pytest.mark.parametrize("name", ENVS)
def test_reset_matches_jax(name):
    """Same seed, same start: the sampled poses bit for bit, the solved
    joints and the observation to 1e-6."""
    jenv = jax_env(name, rng_seed=11)
    tenv = tvariants.make(name, Config(), seed=11, device="cpu")
    for _ in range(2):
        jo, to = jenv.reset(), tenv.reset()
        for k in ("eef", "obj_pos", "gripper", "attached", "obj_vel"):
            np.testing.assert_array_equal(tenv._host(k),
                                          np.asarray(getattr(jenv.state, k)))
        np.testing.assert_allclose(tenv._host("qpos"),
                                   np.asarray(jenv.state.qpos), atol=JOINT_TOL)
        _assert_obs_equal(to, jo)


@pytest.mark.parametrize("name", ["LocobotTable", "LocobotPush",
                                  "LocobotPick", "ClutterPush"])
def test_generate_demo_matches_jax(name):
    """The scripted demo of each task env: same actions, observations and
    start state (the scripts read the state on the host each step)."""
    kw = dict(demo_length=10, action_noise=0.05)
    want = jax_env(name, rng_seed=4, **kw).generate_demo()
    got = tvariants.make(name, Config(**kw), seed=4,
                         device="cpu").generate_demo()
    assert len(got["obs"]) == len(want["obs"])
    np.testing.assert_allclose(np.stack(got["ac"]), np.stack(want["ac"]),
                               atol=TOL)
    _assert_flat_equal(got["sim_start"], want["sim_start"])
    for go, wo in zip(got["obs"], want["obs"]):
        _assert_obs_equal(go, wo)
    for k in ("pushed_obj", "goal", "goal_robot_pose"):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], atol=TOL)


@pytest.mark.parametrize("fields", [
    dict(norobot_pixels_ob=True), dict(norobot_pixels_ob=True,
                                       most_recent_background=True),
    dict(norobot_pixels_ob=True, inpaint_eef=False),
    dict(robot_mask_with_obj=True), dict(pixels_ob=False),
    dict(red_robot=True, large_block=True, action_repeat=2),
    dict(multiview=True, camera_ids=(0, 2, 3))],
    ids=["norobot", "recent_bg", "inpaint_eef", "mask_obj", "lowdim",
         "red_large_repeat", "multiview"])
def test_observation_modes_match_jax(fields):
    start, actions = sim_case("ClutterPush", steps=6)
    jenv = jax_env("ClutterPush", **fields)
    tenv = tvariants.make("ClutterPush", Config(**fields), device="cpu")
    if fields.get("multiview"):
        assert type(tenv).__name__ == type(jenv).__name__
    for env in (jenv, tenv):
        env.reset()
        env.set_flattened_state(start)
    for a in actions:
        _assert_obs_equal(tenv.step(a)[0], jenv.step(a)[0])


def test_env_api_matches_jax(rng):
    """Flattened state round trip, robot_kinematics, envelope_action,
    render_object_only, get_robot_mask; the registry's errors."""
    jenv = jax_env("LocobotPush", rng_seed=2)
    tenv = tvariants.make("LocobotPush", Config(), seed=2, device="cpu")
    jenv.reset()
    tenv.reset()
    flat = tenv.get_flattened_state()
    tenv.step(np.array([0.7, 0.2], np.float32))
    tenv.set_flattened_state(flat)
    np.testing.assert_array_equal(tenv.get_flattened_state(), flat)
    q = rng.uniform(-0.5, 0.5, 5).astype(np.float32)
    for g, w in zip(tenv.robot_kinematics(q), jenv.robot_kinematics(q)):
        np.testing.assert_allclose(g, w, atol=TOL)
    np.testing.assert_allclose(tenv.render_object_only(),
                               jenv.render_object_only(), atol=TOL)
    np.testing.assert_array_equal(tenv.get_robot_mask(), jenv.get_robot_mask())
    block = tenv._host("obj_pos")[0]
    eef = tenv._host("eef")
    slow = np.zeros(5, np.float32)
    slow[:2] = 0.3 * (block[:2] - eef[:2]) / np.linalg.norm(block[:2] - eef[:2])
    for env in (jenv, tenv):
        env.set_flattened_state(np.concatenate(
            [[block[0] - 0.05, block[1]], flat[2:]]))
    np.testing.assert_allclose(tenv.envelope_action(slow),
                               jenv.envelope_action(slow), atol=TOL)
    with pytest.raises(KeyError):
        tvariants.make("NoSuchEnv", device="cpu")
    with pytest.raises(NotImplementedError, match="depth"):
        tvariants.make("LocobotPush", Config(depth_ob=True), device="cpu")


def test_envs_need_a_gpu_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvariants.make("LocobotPush")
