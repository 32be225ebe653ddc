"""The raw public-RoboNet route's cases that run on the card as well as on
the CPU (not a test module; imports no JAX): trajectories in the raw
layout built in memory, every mask-kernel launch of a run kept and held
to the plain version, and a trajectory read on the card against the CPU.
`chip_smoke.py` (phase 17), tests/test_torch_port_raw.py and
tests/test_torch_port_gpu.py share them."""

from __future__ import annotations

import os

import numpy as np

from robot_aware_control_tpu_torch.data import raw_robonet as rr
from robot_aware_control_tpu_torch.data.robonet_hdf5 import RoboNetHDF5Dataset
from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.robot.kinematic_chain import get_mask_env
from torch_chain_cases import edge_band

# the stored workspace bounds of the sawyer trajectories (normalized states)
SAWYER_LOW = np.array([0.42, 0.14, 0.17, 0.0, 0.0], np.float32)
SAWYER_HIGH = np.array([0.87, 0.75, 0.31, 1.0, 100.0], np.float32)
# RoboNet's stored frame size (the RoboNet paper: 240x320 a camera)
STORED_HW = (240, 320)
# the preprocessing size the raw route decodes to (collect_mask_data.py:160)
NATIVE_HW = (64, 85)
# (directory under the data root, viewpoint, trajectories): the sawyer views
# of train_sawyer_multiview (train and test, and the held-out sudri2_c1
# transfer view) and locobot trajectories, whose masks take the kernel
RAW_LAYOUT = (
    ("sawyer_views/sudri0_c0", "sawyer_sudri0_c0", 3),
    ("sawyer_views/sudri0_c1", "sawyer_sudri0_c1", 2),
    ("sawyer_views/sudri2_c1", "sawyer_sudri2_c1", 1),
    ("locobot_views/c0", "locobot_c0", 2),
)
# train_sawyer_multiview on the raw route: the Config defaults' widths
# (svg, g_dim 128, z_dim 10, 48x64, bf16) with the RoboNet action space
# (x, y, z, theta, grasp: 4 stored, the autograsp column imputed), masks
# as model input and the dontcare loss
RAW_TRAIN = dict(experiment="train_sawyer_multiview", action_dim=5,
                 robot_dim=5, robot_joint_dim=7, model_use_mask=True,
                 reconstruction_loss="dontcare_l1", preprocess_action="raw")


def raw_episode(rng: np.random.RandomState, T: int, hw=STORED_HW,
                ncam: int = 1, adim: int = 4, robot: str = "sawyer"):
    """(images (T, ncam, H, W, 3) uint8 of 8x8-pixel blocks, which jpg and
    mp4 keep recognisable, states, actions, qpos): sawyer states
    normalized to [0, 1], locobot's in metres inside its workspace; joints
    in [-0.6, 0.6] rad, where both robots are in view."""
    H, W = hw
    imgs = np.kron(rng.randint(0, 256, (T, ncam, H // 8, W // 8, 3)),
                   np.ones((1, 1, 8, 8, 1))).astype(np.uint8)
    states = rng.rand(T, 5).astype(np.float32)
    if robot == "locobot":
        states[:, :3] = (states[:, :3] * [0.3, 0.4, 0.2]
                         + [0.15, -0.2, 0.1]).astype(np.float32)
    actions = rng.uniform(-0.04, 0.04, (T - 1, adim)).astype(np.float32)
    qpos = rng.uniform(-0.6, 0.6, (T, 7 if robot == "sawyer" else 5))
    return imgs, states, actions, qpos.astype(np.float32)


def raw_trees(root: str, T: int = 31, hw=STORED_HW, seed: int = 0,
              encoding: str = "jpg", layout=RAW_LAYOUT, prefix: str = "traj"):
    """[(file path under `root`, viewpoint, raw tree)] of `layout`, in
    memory (raw_robonet.raw_robonet_tree), from a seed; the files are
    named <prefix><i>.hdf5."""
    rng = np.random.RandomState(seed)
    out = []
    for d, view, n in layout:
        robot = view.split("_")[0]
        for i in range(n):
            ep = raw_episode(rng, T, hw, robot=robot)
            tree = rr.raw_robonet_tree(
                *ep, SAWYER_LOW, SAWYER_HIGH, robot=robot, encoding=encoding,
                camera_configuration=view.split("_")[1])
            out.append((os.path.join(root, d, f"{prefix}{i}.hdf5"), view, tree))
    return out


def mp4_probe() -> dict:
    """Whether cv2 here writes an mp4 (mp4v) stream and reads it back, and
    what went wrong where it does not."""
    frames = np.zeros((2, 16, 16, 3), np.uint8)
    try:
        got = rr._decode_mp4(rr._encode_mp4(frames))
    except RuntimeError as e:
        return {"mp4": False, "error": str(e)}
    return {"mp4": len(got) == 2, "frames_read": len(got)}


class MaskLaunches:
    """While active, keeps the segments of every mask-kernel launch (the
    run's own inputs, copied); `check` holds the kernel to its plain
    version on each, bit for bit. Launches made by `check` are not kept."""

    def __enter__(self):
        self.segs = []
        self._orig = kernels.capsule_mask_render

        def render(segs, h, w):
            if len(segs):
                self.segs.append((segs.detach().clone(), h, w))
            return self._orig(segs, h, w)

        kernels.capsule_mask_render = render
        return self

    def __exit__(self, *exc):
        kernels.capsule_mask_render = self._orig

    def check(self) -> list:
        """[(M, S, h, w, pixels that differ)] a launch; raises
        AssertionError where any differ."""
        out = []
        for segs, h, w in self.segs:
            got = kernels.capsule_mask_render(segs, h, w)
            want = kernels.capsule_mask_render_plain(segs, h, w)
            differ = int((got != want).sum())
            out.append((*segs.shape[:2], h, w, differ))
            if differ:
                raise AssertionError(f"mask kernel differs from plain at "
                                     f"{tuple(segs.shape)} {h}x{w}: {differ}")
        return out


def raw_card_vs_cpu(dev, trees, cfg) -> dict:
    """Each raw trajectory read by the port's reader on `dev` and on the
    CPU: frames, states, actions, joints and bounds equal; the masks equal
    for locobot (the mask kernel against its plain version), and for the
    chain robots differing only within 1e-3 px of a capsule's edge
    (torch_chain_cases.edge_band). Returns {"locobot_differ",
    "chain_differ", "chain_band", "trajectories"}; raises AssertionError
    past that."""
    paths = [p for p, _, _ in trees]
    views = [v for _, v, _ in trees]
    eps = [t for _, _, t in trees]
    card = RoboNetHDF5Dataset(paths, views, cfg, episodes=eps, device=dev)
    cpu = RoboNetHDF5Dataset(paths, views, cfg, episodes=eps, device="cpu")
    out = {"locobot_differ": 0, "chain_differ": 0, "chain_band": 0,
           "trajectories": len(trees)}
    for i, (path, view, _) in enumerate(trees):
        a, b = card._load_file(i), cpu._load_file(i)
        for k in ("images", "states", "actions", "qpos", "raw_low", "raw_high"):
            if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
                raise AssertionError(f"{path}: {k} differs card vs CPU")
        differ = a["masks"] != b["masks"]
        if a["robot"] == "locobot":
            out["locobot_differ"] += int(differ.sum())
            if differ.any():
                raise AssertionError(f"{path}: locobot masks differ card vs CPU")
            continue
        env = get_mask_env(a["robot"], image_size=NATIVE_HW, camera_key=view,
                           device="cpu")
        band = edge_band(env, b["qpos"])[..., 0]
        out["chain_differ"] += int(differ.sum())
        out["chain_band"] += int(band.sum())
        if (differ & ~band).any():
            raise AssertionError(f"{path}: chain masks differ card vs CPU off "
                                 "a capsule's edge")
    return out

