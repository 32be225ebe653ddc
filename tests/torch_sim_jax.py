"""The JAX side of the simulation slice's CPU parity tests
(tests/test_torch_port_envs.py, tests/test_torch_port_control.py). Not a
test module.

Each JAX env jits its physics step and renders per instance, a compile of
about a second, so the tests share one JAX env per (name, config) and
reseed its generator for each use."""

from __future__ import annotations

import numpy as np

from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.envs import variants as jvariants

_ENVS: dict = {}


def jax_env(name: str, rng_seed: int = 0, **fields):
    """The shared JAX env `name` of Config(**fields), its generator seeded
    with `rng_seed` as a fresh env's would be."""
    key = (name, tuple(sorted(fields.items())))
    if key not in _ENVS:
        _ENVS[key] = jvariants.make(name, JConfig(**fields))
    env = _ENVS[key]
    env.rng = np.random.RandomState(rng_seed)
    return env


def jax_run(env, start, actions):
    """Replays actions in a JAX env from a flattened start state, as
    torch_sim_cases.run_case does in the port's."""
    env.reset()
    env.set_flattened_state(start)
    flats, imgs, masks = [env.get_flattened_state()], [], []
    for a in actions:
        obs, _, _, _ = env.step(a)
        flats.append(env.get_flattened_state())
        imgs.append(obs["observation"])
        masks.append(obs["masks"])
    return dict(flat=np.stack(flats), img=np.stack(imgs),
                mask=np.stack(masks))
