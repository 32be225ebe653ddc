"""The port's real-robot and baseline modules (data/camera_calib.py,
control/apriltag.py, control/real_robot.py's calibration and ROS adapter,
baselines/cyclegan.py and the episode runner's --cyclegan) held against
the JAX package on the CPU.

The calibration modules are numpy copies: detections, poses, PnP solutions
and registered extrinsics equal the JAX package's (1e-12). CycleGAN runs
on weights carried from JAX (convert.cyclegan_state_dict; n_blocks 1, ngf
and ndf 8 at 16x24): the networks and the translator to 1e-5 (float32
convolutions, a few layers), one G/D step's losses to 1e-5 relative, the
pool's draws equal, and after three steps the translator's images to
1e-3: Adam moves each weight by about lr (2e-4) whatever the size of its
gradient, so gradients that are float32 noise (the biases ahead of an
instance norm, which cancels them) move by lr in either package in
directions that rounding picks. A push episode under --cyclegan takes the
actions of the JAX runner (1e-5, the episode tests' tolerance of
tests/test_torch_port_control.py)."""


import jax
import numpy as np
import pytest
import torch

from robot_aware_control_tpu.baselines import cyclegan as jcg
from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.control import apriltag as japril
from robot_aware_control_tpu.control import real_robot as jreal
from robot_aware_control_tpu.data import calibration as jcalib
from robot_aware_control_tpu.data import camera_calib as jcc
from robot_aware_control_tpu.training import checkpoint as jckpt
from robot_aware_control_tpu_torch import convert
from robot_aware_control_tpu_torch.baselines import cyclegan as tcg
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.control import apriltag as tapril
from robot_aware_control_tpu_torch.control import real_robot as treal
from robot_aware_control_tpu_torch.data import calibration as tcalib
from robot_aware_control_tpu_torch.data import camera_calib as tcc
from robot_aware_control_tpu_torch.training import checkpoint as tckpt
from test_torch_port_control import (  # noqa: F401 (fake_jax_normal: a fixture)
    _episode_pair,
    _runner_pair,
    fake_jax_normal,
)
from torch_train_cases import one_torch_thread  # noqa: F401 (autouse)

K = np.array([[612.45, 0.0, 330.55],
              [0.0, 612.45, 248.61],
              [0.0, 0.0, 1.0]])  # the reference rig (:134)
TAG_SIZE = 0.0353
EXACT = 1e-12
NET_TOL = 1e-5
STEP_TOL = 1e-3
LOSS_RTOL = 1e-5


def _pose(rvec, t):
    T = np.eye(4)
    T[:3, :3] = tcc._rodrigues(np.asarray(rvec, np.float64))
    T[:3, 3] = t
    return T


CAM_T_TAG = _pose([0.25, -0.35, 0.15], [0.03, -0.02, 0.45])


@pytest.fixture(scope="module")
def tag_image():
    img = tapril.render_tag(1, CAM_T_TAG, K, TAG_SIZE, (480, 640))
    np.testing.assert_array_equal(
        img, japril.render_tag(1, CAM_T_TAG, K, TAG_SIZE, (480, 640)))
    return img


# ------------------------------------------------------------- calibration
def test_apriltag_detection_and_pose_match_jax(tag_image):
    """detect_tag (id, corners, pose), estimate_tag_pose and
    cam_to_base_from_tag on a rendered tag, as the JAX package computes
    them; the pose within the JAX tests' 2 mm of the truth."""
    got = tapril.detect_tag(tag_image, K=K, tag_size=TAG_SIZE)
    want = japril.detect_tag(tag_image, K=K, tag_size=TAG_SIZE)
    assert got.tag_id == want.tag_id == 1
    for a in ("corners", "pose_R", "pose_t"):
        np.testing.assert_allclose(getattr(got, a), getattr(want, a),
                                   atol=EXACT, err_msg=a)
    np.testing.assert_allclose(got.pose_t, CAM_T_TAG[:3, 3], atol=2e-3)
    R, t = tapril.estimate_tag_pose(got.corners, K, TAG_SIZE)
    jR, jt = japril.estimate_tag_pose(got.corners, K, TAG_SIZE)
    np.testing.assert_allclose(R, jR, atol=EXACT)
    np.testing.assert_allclose(t, jt, atol=EXACT)
    tag_T_base = _pose([0.0, 0.3, 1.2], [0.45, -0.05, 0.12])
    for flip in (None, tapril.TAGC_T_TAGW):
        np.testing.assert_allclose(
            tapril.cam_to_base_from_tag(tag_T_base, R, t, flip),
            japril.cam_to_base_from_tag(tag_T_base, R, t, flip), atol=EXACT)
    assert tapril.detect_tag(np.full((48, 64), 0.5)) is None


def test_solve_pnp_matches_jax():
    """solve_pnp (DLT + Gauss-Newton) on 12 noisy projections of known
    points: the JAX package's pose and error; calibrate_viewpoint
    registers the same camera."""
    r = np.random.RandomState(0)
    pts = r.uniform([-0.2, -0.2, 0.0], [0.2, 0.2, 0.3], (12, 3))
    w2c = _pose([0.3, -2.8, 0.2], [0.1, 0.05, 0.9])
    cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
    px = (cam / cam[:, 2:3]) @ K.T
    px = px[:, :2] + r.randn(12, 2) * 0.3
    got, rms = tcc.solve_pnp(pts, px, K)
    want, jrms = jcc.solve_pnp(pts, px, K)
    np.testing.assert_allclose(got, want, atol=EXACT)
    assert abs(rms - jrms) <= EXACT and rms < 1.0
    key = "port_pnp_test_c0"
    try:
        tcc.calibrate_viewpoint(key, pts, px, "intel_realsense_d435")
        jcc.calibrate_viewpoint(key, pts, px, "intel_realsense_d435")
        np.testing.assert_allclose(tcalib.get_camera_to_world(key),
                                   jcalib.get_camera_to_world(key), atol=EXACT)
    finally:
        for reg in (tcalib, jcalib):
            reg.CAMERA_TO_WORLD.pop(key, None)
            reg.WORLD_TO_CAMERA.pop(key, None)


class _TagRobot:
    """A robot surface whose camera frame is the rendered tag."""

    def __init__(self, img):
        self.img = np.repeat(img[..., None], 3, axis=-1)

    def get_image(self):
        return self.img


def test_calibrate_extrinsics_registers_the_jax_camera(tag_image):
    """VisualMPCController.calibrate_extrinsics (the reference rig's tag
    size and offset) registers the camera the JAX controller registers,
    within 5 mm of the truth before the offset; a frame without a tag
    registers nothing and returns None."""
    cam_T_base = _pose([0.05, 2.95, 0.1], [0.85, 0.05, 0.55])
    tag_T_base = cam_T_base @ CAM_T_TAG
    key = "port_tag_test_c0"
    no_policy = lambda *a, **k: None
    robot = _TagRobot(tag_image)
    tctrl = treal.VisualMPCController(Config(), robot, None,
                                      policy_cls=no_policy, device="cpu")
    jctrl = jreal.VisualMPCController(JConfig(), robot, None, None,
                                      policy_cls=no_policy)
    try:
        got = tctrl.calibrate_extrinsics(key, tag_T_base, K)
        reg = tcalib.get_camera_to_world(key).copy()
        want = jctrl.calibrate_extrinsics(key, tag_T_base, K)
        np.testing.assert_allclose(got, want, atol=EXACT)
        np.testing.assert_allclose(reg, jcalib.get_camera_to_world(key),
                                   atol=EXACT)
        off = np.eye(4)
        off[:3, 3] = (0.0, -0.015, 0.0125)
        np.testing.assert_allclose(got[:3, 3] - off[:3, 3], cam_T_base[:3, 3],
                                   atol=5e-3)
        blank = _TagRobot(np.full((48, 64), 0.5))
        tctrl.robot = blank
        assert tctrl.calibrate_extrinsics("port_no_tag_c0", tag_T_base, K) is None
        assert "port_no_tag_c0" not in tcalib.CAMERA_TO_WORLD
    finally:
        for reg in (tcalib, jcalib):
            reg.CAMERA_TO_WORLD.pop(key, None)
            reg.WORLD_TO_CAMERA.pop(key, None)


def test_ros_interface_needs_rospy():
    """make_ros_interface raises the JAX package's message without rospy."""
    with pytest.raises(RuntimeError) as got:
        treal.make_ros_interface(Config())
    with pytest.raises(RuntimeError) as want:
        jreal.make_ros_interface(JConfig())
    assert str(got.value) == str(want.value)
    assert "rospy not available" in str(got.value)


# ------------------------------------------------------------------ CycleGAN
SMALL = dict(ngf=8, ndf=8, n_blocks=1)


@pytest.fixture(scope="module")
def jax_gan():
    params = jax.jit(jcg.init, static_argnames=tuple(SMALL))(
        jax.random.PRNGKey(3), **SMALL)
    return params, jax.tree_util.tree_map(np.asarray, params)


def _nets(np_params):
    nets = tcg.CycleGANNets(**SMALL)
    nets.load_state_dict(convert.cyclegan_state_dict(np_params), strict=True)
    return nets


def test_cyclegan_networks_match_jax(jax_gan, monkeypatch):
    """Generator and discriminator on carried weights at 16x24 (the
    generator's stride-2 SAME convolutions pad (0, 1); the discriminator's
    4x4 stride-1 ones (1, 2)); the translator; a planted fault, the
    transpose convolution's kernel left unflipped, is rejected."""
    params, np_params = jax_gan
    nets = _nets(np_params)
    x = np.random.RandomState(0).uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)
    with torch.no_grad():
        for name, jfn in (("g_ab", jcg.generator), ("g_ba", jcg.generator),
                          ("d_a", jcg.discriminator), ("d_b", jcg.discriminator)):
            want = np.asarray(jax.jit(jfn)(getattr(params, name), x))
            got = getattr(nets, name)(torch.from_numpy(x)).numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=NET_TOL, err_msg=name)
    img = (x[0] + 1) / 2
    for d in ("ab", "ba"):
        np.testing.assert_allclose(tcg.CycleGANTranslator(nets, d)(img),
                                   jcg.CycleGANTranslator(params, d)(img),
                                   atol=NET_TOL)
    want = np.asarray(jax.jit(jcg.generator)(params.g_ab, x))

    def unflipped(self, h):
        H, W = h.shape[1:3]
        y = torch.nn.functional.conv_transpose2d(
            h.permute(0, 3, 1, 2), self.weight.permute(1, 0, 2, 3), self.bias,
            stride=2)
        return y[:, :, :2 * H, :2 * W].permute(0, 2, 3, 1)

    monkeypatch.setattr(tcg.ConvTranspose2x, "forward", unflipped)
    with torch.no_grad():
        planted = nets.g_ab(torch.from_numpy(x)).numpy()
    assert np.abs(planted - want).max() > 100 * NET_TOL


def test_cyclegan_train_steps_match_jax(jax_gan, monkeypatch):
    """Three train_steps (batch 2, a pool of 2: the first step fills it,
    the next two draw from it) from the same weights and fresh Adam
    states: the losses of each step, the pool's RandomState, and the
    translators after the steps."""
    params, np_params = jax_gan
    monkeypatch.setattr(jcg, "init", lambda key, **kw: params)
    jgan = jcg.CycleGAN(jax.random.PRNGKey(0), n_blocks=1, pool_size=2)
    gan = tcg.CycleGAN(0, n_blocks=1, pool_size=2, device="cpu")
    gan.nets = _nets(np_params)
    gan.reset_optimizers()
    r = np.random.RandomState(1)
    for step in range(3):
        a, b = (r.uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)
                for _ in range(2))
        want = jgan.train_step(a, b)
        got = gan.train_step(a, b)
        for k in ("g_loss", "d_loss"):
            tol = LOSS_RTOL if step == 0 else STEP_TOL
            np.testing.assert_allclose(got[k], want[k], rtol=tol,
                                       err_msg=f"step {step} {k}")
    js, ts = jgan._rng.get_state(), gan._rng.get_state()
    assert js[2] == ts[2] and np.array_equal(js[1], ts[1])
    img = r.rand(16, 24, 3).astype(np.float32)
    np.testing.assert_allclose(tcg.CycleGANTranslator(gan.nets)(img),
                               jcg.CycleGANTranslator(jgan.params)(img),
                               atol=STEP_TOL)


def test_cyclegan_checkpoints_load_both_ways(jax_gan, tmp_path):
    """A JAX checkpoint's "cyclegan" tree loads into the port's networks
    (load_cyclegan_checkpoint, strict), and the port's tree
    (convert.cyclegan_flat) loads through the JAX load_checkpoint."""
    params, np_params = jax_gan
    path = jckpt.save_checkpoint(str(tmp_path / "j"), 4, {"cyclegan": params})
    nets = tcg.load_cyclegan_checkpoint(tcg.init(9, **SMALL, device="cpu"), path)
    want = _nets(np_params).state_dict()
    for k, v in nets.state_dict().items():
        assert torch.equal(v, want[k]), k
    tpath = tckpt.save_checkpoint(str(tmp_path / "t"), 5,
                                  {"cyclegan": convert.cyclegan_flat(nets)})
    trees, step = jckpt.load_checkpoint(tpath, {"cyclegan": params})
    assert step == 5
    for got, ref in zip(jax.tree_util.tree_leaves(trees["cyclegan"]),
                        jax.tree_util.tree_leaves(np_params)):
        np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def full_gan_ckpt(tmp_path_factory):
    """A checkpoint of the runner's default CycleGAN (ngf 64, 6 blocks)
    with N(0, 0.02) weights, written by the JAX save_checkpoint."""
    shapes = jax.eval_shape(jcg.init, jax.random.PRNGKey(0))
    r = np.random.RandomState(4)
    tree = jax.tree_util.tree_map(
        lambda s: (r.randn(*s.shape) * 0.02).astype(np.float32)
        if len(s.shape) == 4 else r.uniform(0.5, 1.0, s.shape).astype(np.float32),
        shapes)
    path = jckpt.save_checkpoint(str(tmp_path_factory.mktemp("gan")), 0,
                                 {"cyclegan": tree})
    return tree, path


def test_cyclegan_push_episode_matches_jax(tmp_path, full_gan_ckpt,
                                           fake_jax_normal, monkeypatch):
    """A PushEpisodeRunner episode with --cyclegan and --cyclegan_ckpt
    planning through a small svg: each runner builds its CycleGAN and
    loads the same checkpoint, and the translated observations drive the
    same actions and stats as the JAX runner's."""
    tree, path = full_gan_ckpt
    # the JAX CycleGAN draws its init op by op (tens of seconds on the
    # CPU) before the checkpoint replaces it: start it from the tree
    monkeypatch.setattr(jcg, "init", lambda key, **kw: tree)
    from robot_aware_control_tpu_torch.models import svg as tsvg
    from robot_aware_control_tpu_torch.models.torch_export import model_trees

    kw = dict(model="svg", g_dim=16, z_dim=4, action_dim=5, robot_dim=5,
              robot_joint_dim=5, model_use_mask=True,
              model_use_robot_state=True, reconstruction_loss="dontcare_l1",
              compute_dtype="float32", sample_mean=True,
              eef_action_scale=0.05, cyclegan=True, cyclegan_ckpt=path)
    model = tsvg.init(Config(**kw), seed=0, device="cpu")
    params, bn = model_trees(model)
    jr, tr, demo, noise = _runner_pair(tmp_path, (params, bn, model),
                                       max_episode_length=3, **kw)
    assert isinstance(tr.translator, tcg.CycleGANTranslator)
    img = np.random.RandomState(5).rand(48, 64, 3).astype(np.float32)
    np.testing.assert_allclose(tr.translator(img), jr.translator(img),
                               atol=NET_TOL)
    _episode_pair(jr, tr, demo, noise, fake_jax_normal)
