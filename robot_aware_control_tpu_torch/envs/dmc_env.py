"""DeepMind Control suite wrapper, import-gated (counterpart of
`robot_aware_control_tpu/envs/dmc_env.py`; reference:
src/env/robotics/dmc_env.py). Without dm_control the constructor raises
RuntimeError; with it, reset/step give pixel observations like the other
envs."""

from __future__ import annotations

import numpy as np


class DMCEnv:
    def __init__(self, domain: str = "cartpole", task: str = "swingup",
                 image_size=(48, 64), seed: int = 0):
        try:
            from dm_control import suite
        except ImportError as e:
            raise RuntimeError(
                "dm_control is not installed; DMCEnv is an optional wrapper "
                "(reference: src/env/robotics/dmc_env.py)") from e
        self._env = suite.load(domain, task, task_kwargs={"random": seed})
        self._h, self._w = image_size

    def reset(self):
        return self._obs(self._env.reset())

    def step(self, action):
        ts = self._env.step(np.asarray(action))
        return self._obs(ts), ts.reward or 0.0, ts.last(), {}

    def _obs(self, ts):
        img = self._env.physics.render(self._h, self._w, camera_id=0)
        return {
            "observation": np.asarray(img, np.float32) / 255.0,
            "states": np.concatenate(
                [np.ravel(v) for v in ts.observation.values()]
            ).astype(np.float32),
        }
