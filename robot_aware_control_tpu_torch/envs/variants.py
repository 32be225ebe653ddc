"""Environment variants: occlusion, multiview, gym-registration style API
(counterpart of `robot_aware_control_tpu/envs/variants.py`).

Reference parity: the occlusion env, multiview pick env and gym variants
(reference: src/env/robotics/locobot_pick_env* / occlusion / `*Gym*`
wrappers). Variants compose the base env: a static occluder drawn over the
observation, more registered cameras for multiview stacking, and a
`make()` factory keyed by env id strings.
"""

from __future__ import annotations

from typing import Dict, Type

import numpy as np

from robot_aware_control_tpu_torch.data import calibration as calib
from robot_aware_control_tpu_torch.envs.base import RobotEnv, to_host
from robot_aware_control_tpu_torch.envs.clutter_push import ClutterPushEnv, FetchPushEnv
from robot_aware_control_tpu_torch.envs.locobot_pick import LocobotPickEnv
from robot_aware_control_tpu_torch.envs.locobot_push import LocobotPushEnv
from robot_aware_control_tpu_torch.envs.locobot_table import LocobotTableEnv
from robot_aware_control_tpu_torch.envs.renderer import SceneRenderer


class OcclusionMixin:
    """Draws a static occluder bar over observations (reference occlusion
    env: a scene object blocking part of the camera view). The mask is NOT
    occluded — robot-awareness must come from the model."""

    OCCLUDER = (0.55, 0.75)  # fractional x-range of the occluded column

    def _get_obs(self):
        obs = super()._get_obs()
        img = obs["observation"].copy()
        w = img.shape[1]
        x0, x1 = int(self.OCCLUDER[0] * w), int(self.OCCLUDER[1] * w)
        img[:, x0:x1] = np.array([0.35, 0.33, 0.3], np.float32)
        obs["observation"] = img
        return obs


class LocobotOcclusionEnv(OcclusionMixin, LocobotTableEnv):
    pass


class ModifiedLocobotPushEnv(LocobotPushEnv):
    """Zero-shot transfer target: same task/kinematics, visually different
    robot (thicker links, different color) — the sim analogue of swapping
    robots (reference: modified locobot variant + the paper's transfer
    experiments)."""

    arm_color = np.array([0.55, 0.30, 0.10], np.float32)  # tan arm
    arm_radii = np.array([0.060, 0.056, 0.050, 0.065], np.float32)


class MultiviewMixin:
    """Adds extra cameras; observations stack all views vertically
    (reference multiview pick env + --camera_ids flag,
    src/config/__init__.py:119, collect_pick_mv_data.py). The stacked image
    trains directly with image_height = n_views x the per-view height
    (fully convolutional models).

    --camera_ids picks the views: id 0 is the primary calibrated camera;
    other ids select preset secondary eyes (registered look-at cameras)."""

    # preset secondary camera eye positions, indexed by camera id
    CAMERA_EYES = {
        1: (0.4, -0.85, 0.65),
        2: (0.4, 0.85, 0.65),
        3: (0.85, 0.0, 0.75),
        4: (0.4, -0.85, 0.65),  # reference default ids are (0, 4)
    }

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        cfg = self._config
        ids = tuple(getattr(cfg, "camera_ids", None) or (0, 4)) if cfg else (0, 4)
        self.camera_ids = ids
        self.renderers2 = []
        for cid in ids:
            if cid == 0:
                continue  # primary camera is self.renderer
            eye = self.CAMERA_EYES.get(cid, self.CAMERA_EYES[4])
            key = f"multiview_c{cid}"
            calib.register_camera(
                key, calib.look_at(eye, (0.28, 0.0, 0.15))
            )
            self.renderers2.append(SceneRenderer(self._img_shape,
                                                 camera_key=key,
                                                 device=self.device))

    def _get_obs(self):
        obs = super()._get_obs()
        imgs, masks = [obs["observation"]], [obs["masks"]]
        for r in self.renderers2:
            img2, mask2 = to_host(*r.render_scene(
                self.state.qpos, self.state.obj_pos, self._halfs_t,
                self._colors_t))
            imgs.append(img2)
            masks.append(mask2)
        obs["observation"] = np.concatenate(imgs, axis=0)
        obs["masks"] = np.concatenate(masks, axis=0)
        return obs


class LocobotPickMultiviewEnv(MultiviewMixin, LocobotPickEnv):
    pass


_REGISTRY: Dict[str, Type[RobotEnv]] = {
    "LocobotTable": LocobotTableEnv,
    "LocobotPush": LocobotPushEnv,
    "LocobotPick": LocobotPickEnv,
    "LocobotOcclusion": LocobotOcclusionEnv,
    "ModifiedLocobotPush": ModifiedLocobotPushEnv,
    "LocobotPickMultiview": LocobotPickMultiviewEnv,
    "ClutterPush": ClutterPushEnv,
    "FetchPush": FetchPushEnv,
}


def make(env_id: str, config=None, seed=None, device="cuda") -> RobotEnv:
    """gym.make-style factory over the env registry, the env on `device`.
    --multiview upgrades any base env to its camera-stacked variant
    (reference: the mv pick env is selected by the multiview/camera_ids
    flags)."""
    if env_id not in _REGISTRY:
        raise KeyError(f"unknown env {env_id!r}; have {sorted(_REGISTRY)}")
    cls = _REGISTRY[env_id]
    if (
        config is not None and getattr(config, "multiview", False)
        and not issubclass(cls, MultiviewMixin)
    ):
        cls = type(f"Multiview{cls.__name__}", (MultiviewMixin, cls), {})
    return cls(config, seed=seed, device=device)
