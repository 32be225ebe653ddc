"""RoboNet/locobot HDF5 trajectory reader (counterpart of
`robot_aware_control_tpu/data/robonet_hdf5.py`; reference:
src/dataset/robonet/robonet_dataset.py:69-415). Numpy only; its items
equal the JAX package's bit for bit on the same resize route.

  * keys: `frames`|`observations`, `mask`|`masks`, `states`, `actions`,
    `qpos`, `low_bound`/`high_bound`, attrs `robot` (:82-130)
  * random video snippet of `video_length` (or n_past+n_future) (:92-99)
  * autograsp 5th action dim imputed from the next gripper state (:173-195)
  * states/qpos zero-padded up to robot_dim / robot_joint_dim (:209-223)
  * locobot/franka fixed workspace bounds; franka eef shifted into the
    locobot frame (:197-207, 311-317)
  * xyz + gripper-force normalization into workspace bounds (:302-334)
  * optional camera-frame state/action transforms via extrinsics
    (:225-255, 336-390)
  * uint8 HWC -> float [0,1], bilinear resize to (image_height,image_width);
    masks re-binarized after resize (:257-300)

The dataset's one RandomState is drawn in the JAX order: the snippet
start, then the crop, then the jitter. Resizes go through cv2 where it
imports, else through the C++ resize of `data/native.py`; without either
they raise (the JAX reader would sample the nearest pixels instead, which
is another image). h5py is imported by the functions that open a file, so
that the loaders import on a machine without it (record shards,
`data/records.py`, need numpy alone). The dataset also reads episodes
held in memory in the file's layout (`episodes=`, made by
`episode_arrays`): data/collect.py's route to record shards on such a
machine.

Trajectories in the public RoboNet raw layout (files, or trees in memory
made by `raw_robonet.raw_robonet_tree`) are decoded by data/raw_robonet.py
at the reference's preprocessing size, 64x85 (collect_mask_data.py:160,
174), and their masks rendered on the dataset's `device` (the GPU unless
the caller asks for the CPU): the measured kinematic chains, or the
capsule-mask kernel for locobot. A robot with no measured chain gets zero
masks, as in the JAX package; any other failure of a mask env, its kernel
build or launch among them, raises.
"""

from __future__ import annotations

import os
import re
import threading
import warnings
from typing import List, Mapping, Optional, Sequence

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except ImportError:
    _HAS_CV2 = False

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.data import calibration as calib
from robot_aware_control_tpu_torch.data.norm import (
    LOCO_FRANKA_DIFF,
    LOCOBOT_HIGH,
    LOCOBOT_LOW,
    denormalize,
    normalize,
)


def resize_route() -> str:
    """The resize the reader takes: "cv2" or "native"."""
    return "cv2" if _HAS_CV2 else "native"


def _resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    if img.shape[0] == h and img.shape[1] == w:
        return img
    if _HAS_CV2:
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    from robot_aware_control_tpu_torch.data import native

    return native.bilinear_resize(np.asarray(img, np.float32), w, h)


class RoboNetHDF5Dataset:
    """Reads one trajectory per HDF5 file; returns time-first numpy dicts."""

    def __init__(
        self,
        hdf5_list: List[str],
        robot_list: List[str],
        config: Config,
        load_snippet: bool = False,
        seed: Optional[int] = None,
        episodes: Optional[Sequence[Mapping]] = None,
        device="cuda",
    ):
        """`episodes`, where given, holds each file's episode in memory (the
        mapping `episode_arrays` makes: what `write_trajectory_hdf5` would
        have stored there; or a raw-layout tree, `raw_robonet_tree`), read
        in place of the file, which need not exist. This is an input seam
        for a machine without h5py (data/collect.py writes record shards
        through it), not a feature: both routes read the same keys and
        preprocess them alike. `device` renders the masks of raw-layout
        trajectories."""
        self._traj_names = list(hdf5_list)
        self.device = device
        # raw layout: one mask env a (robot, camera key), made on first use
        self._mask_envs: dict = {}
        self._mask_lock = threading.Lock()
        self._warned: set = set()
        self._episodes = None if episodes is None else list(episodes)
        if self._episodes is not None and len(self._episodes) != len(self._traj_names):
            raise ValueError(f"{len(self._episodes)} episodes for "
                             f"{len(self._traj_names)} files")
        self._traj_robots = list(robot_list)
        self._config = config
        self._video_length = (
            config.n_past + config.n_future if load_snippet else config.video_length
        )
        self._rng = np.random.RandomState(config.seed if seed is None else seed)
        # --preload_ram: decode every file once up-front
        self._ram: Optional[list] = None
        if config.preload_ram:
            self._ram = [self._load_file(i) for i in range(len(self._traj_names))]
        # object-movement labels for --load_movement_info/--movement_weight
        # (reference: robonet_dataset.py:36-48, trainer.py:426-429)
        self._movement = None
        if config.load_movement_info and config.world_error_dict:
            from robot_aware_control_tpu_torch.evaluation.obj_movement import (
                load_movement_metadata,
            )

            self._movement = load_movement_metadata(config.world_error_dict)

    def __len__(self):
        return len(self._traj_names)

    def _load_file(self, idx: int) -> dict:
        """Decode one full episode (used directly or RAM-preloaded): from
        the file, or from its episode in memory."""
        cfg = self._config
        name = self._traj_names[idx]
        if self._episodes is not None:
            return self._decode(self._episodes[idx], name, self._traj_robots[idx])
        import h5py

        path = (
            name
            if os.path.isabs(name) or os.path.exists(name)
            else os.path.join(cfg.data_root, name)
        )
        with h5py.File(path, "r") as hf:
            return self._decode(hf, path, self._traj_robots[idx])

    def _warn_once(self, msg: str) -> None:
        """Each distinct data-path warning once a dataset (raw multiview
        files can meet the same condition in every file)."""
        if msg not in self._warned:
            self._warned.add(msg)
            warnings.warn(msg)

    def _decode(self, hf, path: str, robot_viewpoint: str) -> dict:
        """One episode's arrays from an h5py file or from a mapping of the
        same keys (its attribute `robot` a key of the mapping), or from a
        raw-layout file or tree."""
        if "env" in hf and "policy" in hf:
            return self._load_raw(hf, path, robot_viewpoint)
        image_key = "observations" if "observations" in hf else "frames"
        mask_key = "masks" if "masks" in hf else "mask"
        ep_len = hf[image_key].shape[0]
        if ep_len < self._video_length:
            raise ValueError(f"{path}: episode {ep_len} < {self._video_length}")
        raw_low, raw_high = self._load_bounds(hf, robot_viewpoint)
        out = {
            "path": path,
            "ep_len": ep_len,
            "images": np.asarray(hf[image_key]),
            "states": self._load_states(hf, 0, ep_len),
            "actions": self._load_actions(hf, raw_low, raw_high, 0, ep_len - 1),
            "masks": np.asarray(hf[mask_key], np.float32),
            "qpos": self._load_qpos(hf, 0, ep_len),
            "raw_low": raw_low,
            "raw_high": raw_high,
        }
        robot = getattr(hf, "attrs", hf).get("robot")
        if robot is None:
            robot = "locobot" if "locobot" in robot_viewpoint else (
                "franka" if "franka" in robot_viewpoint else "unknown"
            )
        out["robot"] = robot.decode() if isinstance(robot, bytes) else robot
        return out

    def _load_raw(self, hf, path: str, robot_viewpoint: str) -> dict:
        """A trajectory in the public RoboNet raw layout (JAX
        `_load_raw_file`): frames decoded at 64x85, masks rendered from the
        qpos on the dataset's device, states kept normalized, bounds from
        the last rows of env/low_bound and env/high_bound."""
        from robot_aware_control_tpu_torch.data import raw_robonet as rr

        cfg = self._config
        md = rr.metadata_row(hf, os.path.basename(path))
        native = (64, 85)
        # the stream of a `<view>_c<k>` directory is camera k, the one the
        # view's extrinsics (and so its masks) belong to, else 0; a file
        # with fewer streams takes its last (robonet_dataloaders.py:137-208)
        cam = 0
        vp_cam = re.search(r"_c(\d+)$", robot_viewpoint)
        if vp_cam is not None:
            cam = int(vp_cam.group(1))
        ncam = int(md.get("ncam", 1))
        cam = min(cam, ncam - 1)
        # --multiview on a multi-stream file: --camera_ids are stream
        # indices, one view each; an id out of this file's range takes its
        # positional stream (with a warning). Views stack vertically, as
        # the multiview envs lay them out (envs/variants.py).
        cams = [cam]
        if cfg.multiview and ncam > 1:
            cams = []
            for i, c in enumerate(cfg.camera_ids):
                if 0 <= c < ncam:
                    cams.append(int(c))
                else:
                    fallback = min(i, ncam - 1)
                    self._warn_once(
                        f"camera id {c} out of range for {path} "
                        f"(ncam={ncam}); using stream {fallback} for "
                        f"view {i}")
                    cams.append(fallback)
        params = rr.LoaderParams(
            target_adim=cfg.action_dim,
            target_sdim=int(md["sdim"]),
            action_mismatch=rr.ACTION_MISMATCH.PAD_ZERO,
            impute_autograsp_action=cfg.impute_autograsp_action,
            img_size=native,
            cams_to_load=cams,
            load_T=0,
            check_sha256=False,
        )
        images, actions, states, qpos = rr.load_data(hf, md, params)
        T_, nv, ih, iw, _ = images.shape
        images = images.reshape(T_, nv * ih, iw, 3)
        ep_len = images.shape[0]
        if ep_len < self._video_length:
            raise ValueError(f"{path}: episode {ep_len} < {self._video_length}")
        rdim, jdim = cfg.robot_dim, cfg.robot_joint_dim
        if states.shape[-1] < rdim:
            states = np.pad(states, [(0, 0), (0, rdim - states.shape[-1])])
        if qpos.shape[-1] < jdim:
            qpos = np.pad(qpos, [(0, 0), (0, jdim - qpos.shape[-1])])
        robot = md.get("robot")
        if robot is None:
            robot = robot_viewpoint.split("_")[0]
        base_key = robot_viewpoint if "_" in robot_viewpoint else None
        per_view = []
        for c in cams:
            key = base_key
            if base_key is not None and c != cam:
                # another stream's extrinsics live under its _c<c> key (a
                # mask of the wrong camera would poison the dontcare loss)
                if re.search(r"_c\d+$", base_key):
                    key = re.sub(r"_c\d+$", f"_c{c}", base_key)
                else:
                    key = f"{base_key}_c{c}"
            env = self._raw_mask_env(str(robot), key, native)
            if env is None:
                if cfg.multiview:
                    self._warn_once(
                        f"no mask calibration for view key {key!r} "
                        f"(stream {c}) of {path}; that view's masks are "
                        "zeroed")
                m = np.zeros((ep_len,) + native + (1,), np.float32)
            else:
                m = np.asarray(env.generate_masks(qpos), np.float32)
                if m.ndim == 3:
                    m = m[..., None]
            per_view.append(m)
        masks = np.concatenate(per_view, axis=1)  # views stacked like images
        return {
            "path": path,
            "ep_len": ep_len,
            "images": images,
            "states": states.astype(np.float32),
            "actions": actions.astype(np.float32),
            "masks": masks[..., 0] if masks.shape[-1] == 1 else masks,
            "qpos": qpos.astype(np.float32),
            "raw_low": np.asarray(hf["env"]["low_bound"][-1], np.float32),
            "raw_high": np.asarray(hf["env"]["high_bound"][-1], np.float32),
            "robot": str(robot),
        }

    def _raw_mask_env(self, robot: str, camera_key, size):
        """The mask env of a raw trajectory's robot and view on the
        dataset's device, or None for a robot with no measured chain (its
        masks are zero, as in the JAX package). Errors of the env raise."""
        from robot_aware_control_tpu_torch.robot._chain_data import CHAIN_DATA
        from robot_aware_control_tpu_torch.robot.kinematic_chain import (
            get_mask_env,
        )

        cache_key = (robot, camera_key)
        with self._mask_lock:
            if cache_key not in self._mask_envs:
                known = robot == "locobot" or robot in CHAIN_DATA
                self._mask_envs[cache_key] = get_mask_env(
                    robot, image_size=size, camera_key=camera_key,
                    device=self.device) if known else None
            return self._mask_envs[cache_key]

    def __getitem__(self, idx: int) -> dict:
        cfg = self._config
        robot_viewpoint = self._traj_robots[idx]
        raw = self._ram[idx] if self._ram is not None else self._load_file(idx)
        path, ep_len = raw["path"], raw["ep_len"]
        start = 0
        if ep_len > self._video_length:
            start = int(self._rng.randint(0, ep_len - self._video_length + 1))
        end = start + self._video_length

        images = raw["images"][start:end]
        raw_low, raw_high = raw["raw_low"], raw["raw_high"]
        states = raw["states"][start:end].copy()
        actions = raw["actions"][start:end - 1].copy()
        raw_states = states.copy()
        raw_actions = actions.copy()
        masks = raw["masks"][start:end].copy()
        qpos = raw["qpos"][start:end]
        robot = raw["robot"]

        low, high = self._preprocess_bounds(raw_low, raw_high, idx)
        images, masks = self._preprocess_images_masks(images, masks)
        if cfg.img_augmentation:
            images, masks = self._augment(images, masks)
        states = self._preprocess_states(states, low, high, robot_viewpoint, idx)
        actions = self._preprocess_actions(states, actions, low, high, idx)

        folder = os.path.basename(os.path.dirname(path))
        out = {
            "images": images,
            "states": states,
            "actions": actions,
            "masks": masks,
            "robot": str(robot),
            "folder": folder,
            "file_path": path,
            "idx": idx,
            "qpos": qpos,
            "low": low,
            "high": high,
        }
        if self._movement is not None:
            out["high_movement"] = bool(self._movement.get(path, False))
        if cfg.model_use_heatmap:
            from robot_aware_control_tpu_torch.data.heatmaps import create_heatmaps

            out["heatmaps"] = create_heatmaps(
                states, low, high, str(robot), folder,
                (cfg.image_width, cfg.image_height),
            )
        if "finetune" in cfg.experiment and "camera" in cfg.preprocess_action:
            out["raw_low"], out["raw_high"] = raw_low, raw_high
            out["raw_actions"] = raw_actions
            rs = raw_states.copy()
            rs[:, :3] = normalize(rs[:, :3], raw_low[:3], raw_high[:3])
            rs[:, 4] = normalize(rs[:, 4], raw_low[4], raw_high[4])
            out["raw_states"] = rs
        return out

    # ------------------------------------------------------------------
    def _load_bounds(self, hf, robot_viewpoint):
        if "locobot" in robot_viewpoint or "franka" in robot_viewpoint:
            return LOCOBOT_LOW.copy(), LOCOBOT_HIGH.copy()
        return np.asarray(hf["low_bound"][:], np.float32), np.asarray(
            hf["high_bound"][:], np.float32
        )

    def _load_states(self, hf, start, end):
        states = np.asarray(hf["states"][start:end], np.float32)
        rdim = self._config.robot_dim
        if states.shape[-1] < rdim:
            states = np.pad(states, [(0, 0), (0, rdim - states.shape[-1])])
        return states

    def _load_qpos(self, hf, start, end):
        qpos = np.asarray(hf["qpos"][start:end], np.float32)
        jdim = self._config.robot_joint_dim
        if qpos.shape[-1] < jdim:
            qpos = np.pad(qpos, [(0, 0), (0, jdim - qpos.shape[-1])])
        return qpos

    def _load_actions(self, hf, low, high, start, end):
        actions = np.asarray(hf["actions"][:], np.float32)
        adim = actions.shape[1]
        target = self._config.action_dim
        if adim == target:
            return actions[start:end]
        if self._config.impute_autograsp_action and adim + 1 == target:
            # autograsp action: binarize next gripper force around the bound
            # midpoint (reference: robonet_dataset.py:178-193)
            next_gripper = np.asarray(hf["states"][:], np.float32)[1:, -1]
            mid = (high[-1] + low[-1]) / 2.0
            extra = np.where(next_gripper > mid, high[-1], low[-1])[:, None]
            return np.concatenate([actions, extra], -1)[start:end].astype(np.float32)
        if adim < target:
            # zero-pad to the model action space (reference pads per-robot
            # dims to the target, robonet_dataset.py:209-223)
            pad = np.zeros((actions.shape[0], target - adim), np.float32)
            return np.concatenate([actions, pad], -1)[start:end]
        raise ValueError(f"file adim {adim}, target adim {target}")

    def _preprocess_bounds(self, low, high, idx):
        low, high = low.copy(), high.copy()
        if "camera" in self._config.preprocess_action:
            w2c = calib.get_world_to_camera(self._traj_robots[idx])
            corners = np.array(
                [[low[0], low[1], low[2]], [low[0], low[1], high[2]],
                 [low[0], high[1], low[2]], [low[0], high[1], high[2]],
                 [high[0], low[1], low[2]], [high[0], low[1], high[2]],
                 [high[0], high[1], low[2]], [high[0], high[1], high[2]]]
            )
            ones = np.ones((8, 1))
            cam = (w2c @ np.concatenate([corners, ones], 1).T).T[:, :3]
            low[:3] = cam.min(0)
            high[:3] = cam.max(0)
        return low.astype(np.float32), high.astype(np.float32)

    def _preprocess_images_masks(self, images, masks):
        """uint8 -> [0,1] float before the bilinear resize (the reference's
        ToTensor-then-Resize order, robonet_dataset.py:58,294), and masks
        re-binarized as `!= 0` after the resize (the reference casts the
        resized float mask to bool, :295-299)."""
        cfg = self._config
        w, h = cfg.image_width, cfg.image_height
        arr = np.asarray(images)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        else:
            arr = arr.astype(np.float32)
            if arr.size and arr.max() > 1.5:  # float-stored [0,255] episodes
                arr = arr / 255.0
        imgs = np.stack([_resize(im, w, h) for im in arr]).astype(np.float32)
        if imgs.ndim == 3:
            imgs = imgs[..., None]
        ms = np.stack([_resize(np.asarray(m).astype(np.float32), w, h) for m in masks])
        if ms.ndim == 3:
            ms = ms[..., None]
        ms = (ms != 0).astype(np.float32)
        return imgs, ms

    def _augment(self, images, masks):
        """Episode-consistent random crop + color jitter
        (reference: robonet_dataset.py:257-300). The same crop applies to
        every frame and to the masks; jitter is color-only."""
        cfg = self._config
        h, w = images.shape[1:3]
        ch = max(int(round(cfg.random_crop_size * h / w)), 1)
        cw = cfg.random_crop_size
        if cw < w and ch < h:
            y0 = int(self._rng.randint(0, h - ch + 1))
            x0 = int(self._rng.randint(0, w - cw + 1))
            images = np.stack([
                _resize(im[y0:y0 + ch, x0:x0 + cw], w, h) for im in images
            ])
            masks = np.stack([
                _resize(m[y0:y0 + ch, x0:x0 + cw], w, h) for m in masks
            ])
            if masks.ndim == 3:
                masks = masks[..., None]
            masks = (masks != 0).astype(np.float32)  # reference bool cast :286
        r = cfg.color_jitter_range
        jitter = self._rng.uniform(1 - r, 1 + r, 3).astype(np.float32)
        shift = self._rng.uniform(-r / 2, r / 2, 3).astype(np.float32)
        images = np.clip(images * jitter + shift, 0.0, 1.0)
        return images.astype(np.float32), masks

    def _preprocess_states(self, states, low, high, robot_viewpoint, idx):
        states = states.copy()
        if "locobot" in robot_viewpoint:
            eef = states[:, :3].copy()
        elif "franka" in robot_viewpoint:
            eef = states[:, :3].copy()
            eef[:, :2] += LOCO_FRANKA_DIFF
            eef[:, 2] = 0.14  # locobot push height (reference :317)
        else:
            eef = denormalize(states[:, :3], low[:3], high[:3])
        if "camera" in self._config.preprocess_action:
            w2c = calib.get_world_to_camera(self._traj_robots[idx])
            ones = np.ones((eef.shape[0], 1))
            eef = (w2c @ np.concatenate([eef, ones], 1).T).T[:, :3]
        states[:, :3] = normalize(eef, low[:3], high[:3])
        states[:, 4] = normalize(states[:, 4], low[4], high[4])
        return states.astype(np.float32)

    def _preprocess_actions(self, states, actions, low, high, idx):
        strategy = self._config.preprocess_action
        if strategy == "raw":
            return actions.astype(np.float32)
        if strategy == "camera_raw":
            w2c = calib.get_world_to_camera(self._traj_robots[idx])
            c2w = calib.get_camera_to_world(self._traj_robots[idx])
            return self._camera_actions(states, actions, w2c, c2w, low, high)
        if strategy in ("state_infer", "camera_state_infer"):
            # eef displacements from consecutive states, which are already
            # in the target frame (world or camera) here
            eef = denormalize(states[:, :3], low[:3], high[:3])
            inferred = actions.astype(np.float32).copy()
            inferred[:, :3] = eef[1:] - eef[:-1]
            return inferred
        raise NotImplementedError(strategy)

    def _camera_actions(self, states, actions, w2c, c2w, low, high):
        """Project eef displacement into camera frame: delta = cam(s+a)-cam(s)
        (reference: robonet_dataset.py:365-390)."""
        out = np.zeros_like(actions)
        c_eef = denormalize(states[:, :3], low[:3], high[:3])
        ones = np.ones((c_eef.shape[0], 1))
        eef_w = (c2w @ np.concatenate([c_eef, ones], 1).T).T[:-1, :3]
        next_w = eef_w + actions[:, :3]
        eef_c = (w2c @ np.concatenate([eef_w, np.ones((len(eef_w), 1))], 1).T).T[:, :3]
        next_c = (w2c @ np.concatenate([next_w, np.ones((len(next_w), 1))], 1).T).T[:, :3]
        out[:, :3] = next_c - eef_c
        return out.astype(np.float32)


def episode_arrays(images, states, actions, masks, qpos,
                   robot: str = "locobot", low=None, high=None) -> dict:
    """An episode as `write_trajectory_hdf5` stores it: the datasets of the
    file, cast as the file holds them, and its `robot` attribute as a key.
    `RoboNetHDF5Dataset(..., episodes=)` reads such mappings."""
    out = {
        "observations": np.asarray(images),
        "states": np.asarray(states, np.float32),
        "actions": np.asarray(actions, np.float32),
        "masks": np.asarray(masks),
        "qpos": np.asarray(qpos, np.float32),
    }
    if low is not None:
        out["low_bound"] = np.asarray(low, np.float32)
        out["high_bound"] = np.asarray(high, np.float32)
    out["robot"] = robot
    return out


def write_trajectory_hdf5(path: str, images, states, actions, masks, qpos,
                          robot: str = "locobot", low=None, high=None):
    """Write an episode in the layout the reader (and the reference's data
    collection scripts, e.g. src/dataset/collect_locobot_table_data.py)
    produce."""
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    episode = episode_arrays(images, states, actions, masks, qpos, robot,
                             low, high)
    with h5py.File(path, "w") as hf:
        for k, v in episode.items():
            if k == "robot":
                hf.attrs["robot"] = v
            else:
                hf.create_dataset(k, data=v)
