"""Demonstration episodes saved and loaded as HDF5 (counterpart of
`robot_aware_control_tpu/data/demo_io.py`; reference:
src/mbrl/episode_runner.py:84-141 and the demo collection scripts
src/dataset/collect_*.py): robot, object-only and inpainted image streams,
masks, robot states, object poses. Files written by either package read
in the other. h5py is imported by the functions that open a file.

Making demos from an env's history (`demo_from_history`, `collect_demos`)
waits for the envs (ROADMAP section 1 item 8).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


def save_demo(path: str, demo: Dict):
    import h5py

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
    import h5py

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
