"""Demonstration episodes saved and loaded as HDF5 (counterpart of
`robot_aware_control_tpu/data/demo_io.py`; reference:
src/mbrl/episode_runner.py:84-141 and the demo collection scripts
src/dataset/collect_*.py): robot, object-only and inpainted image streams,
masks, robot states, object poses. Files written by either package read
in the other. h5py is imported by the functions that open a file; where
it is missing they raise ImportError naming it.

`demo_from_history` builds the runner's demo dict from a scripted demo of
an env (envs/*.generate_demo) in memory: on a machine without h5py, the
episode runner follows such dicts (control/episode_runner.py).
`collect_demos` writes them as HDF5 files; `make_demo` makes one as
`collect_demos` saves it.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch


def has_h5py() -> bool:
    """Whether h5py is installed. A failure to import anything else, h5py's
    own dependencies included, raises."""
    try:
        import h5py  # noqa: F401
    except ModuleNotFoundError as e:
        if e.name != "h5py":
            raise
        return False
    return True


def require_h5py():
    """The h5py module; ImportError naming it where it is not installed."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("h5py is needed to read or write HDF5 files; it is "
                          "not installed") from e
    return h5py


def save_demo(path: str, demo: Dict):
    h5py = require_h5py()

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as hf:
        for k, v in demo.items():
            arr = np.asarray(v)
            if arr.dtype.kind in "fiub":
                hf.create_dataset(k, data=arr)
            else:
                hf.attrs[k] = str(v)
        # the reference's name for the with-robot stream is "robot_demo"
        # (collect_clutter_data.py:94,130); a hard link, no extra storage
        if "observations" in hf and "robot_demo" not in hf:
            hf["robot_demo"] = hf["observations"]


def load_demo(path: str) -> Dict:
    h5py = require_h5py()

    out = {}
    with h5py.File(path, "r") as hf:
        for k in hf.keys():
            out[k] = np.asarray(hf[k])
        for k, v in hf.attrs.items():
            out[k] = v
    return out


def list_demos(demo_dir: str) -> List[str]:
    if not os.path.isdir(demo_dir):
        return []
    return sorted(
        os.path.join(demo_dir, f) for f in os.listdir(demo_dir)
        if f.endswith(".hdf5")
    )


def demo_from_history(env, history) -> Dict:
    """A scripted demo's history (envs/*.generate_demo) -> the runner's
    demo container: per-step robot images, masks, robot states, joints,
    block poses, actions and the flattened start state."""
    obs = history["obs"]
    imgs = np.stack([o["observation"] for o in obs])
    masks = np.stack([o["masks"] for o in obs])
    robot_state = np.stack([o["states"] for o in obs])
    qpos = np.stack([o["qpos"] for o in obs])
    acs = np.stack(history["ac"]) if len(history["ac"]) else np.zeros((0,))
    demo = {
        "observations": imgs,
        "masks": masks,
        "robot_state": robot_state,
        "qpos": qpos,
        "actions": acs,
        "pushed_obj": int(history.get("pushed_obj", 0)),
    }
    if "sim_start" in history:
        demo["sim_start"] = np.asarray(history["sim_start"], np.float32)
    if "obj_poses" in obs[0]:
        demo["obj_poses"] = np.stack([o["obj_poses"] for o in obs])
    if "obj_qpos" in obs[0]:
        demo["obj_qpos"] = np.stack([o["obj_qpos"] for o in obs])
    return demo


def object_only_images(env, demo: Dict):
    """The demo's frames rendered without the robot, from its joints and
    block poses (None without block poses): the object-only goal images."""
    objs = demo.get("obj_poses")
    if objs is None and "obj_qpos" in demo:
        objs = demo["obj_qpos"].reshape(len(demo["observations"]), -1, 7)[..., :3]
    if objs is None:
        return None
    dev = env.device
    imgs, _ = env.renderer.render_scene(
        torch.as_tensor(demo["qpos"], device=dev),
        torch.as_tensor(np.asarray(objs, np.float32), device=dev),
        env._halfs_t, env._colors_t, include_arm=False)
    return imgs.cpu().numpy()


def collect_demos(env, behavior: str, n: int, out_dir: str,
                  render_object_only: bool = True) -> List[str]:
    """Scripted demo collection -> HDF5 files (reference:
    src/dataset/collect_locobot_table_data.py:15-60 and siblings)."""
    require_h5py()  # before any episode runs
    paths = []
    for i in range(n):
        path = os.path.join(out_dir, f"demo_{behavior}_{i}.hdf5")
        save_demo(path, make_demo(env, behavior, render_object_only))
        paths.append(path)
    return paths


def make_demo(env, behavior: str, render_object_only: bool = True) -> Dict:
    """One scripted demo in memory, as `collect_demos` saves it."""
    demo = demo_from_history(env, env.generate_demo(behavior))
    if render_object_only:
        imgs = object_only_images(env, demo)
        if imgs is not None:
            demo["object_only_demo"] = imgs
            demo["object_inpaint_demo"] = imgs
    return demo
