"""Dataset inspection and validation tools (counterpart of
`robot_aware_control_tpu/data/tools.py`; reference:
src/dataset/check_mask_data.py, locobot_data_processor.py (world-change
rate), visualize_actions.py, locobot_mask_generator.py).

h5py is imported by the functions that open a file; where it is missing
they raise ImportError naming it."""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch


def check_mask_data(paths: List[str]) -> Dict[str, Dict]:
    """Validates the mask streams of trajectory HDF5 files: present,
    binary, as long as the frames, neither empty nor covering more than 90%
    of the frame (reference: check_mask_data.py)."""
    from robot_aware_control_tpu_torch.data.demo_io import require_h5py

    h5py = require_h5py()
    report = {}
    for p in paths:
        info = {"ok": True, "problems": []}
        with h5py.File(p, "r") as hf:
            ikey = "observations" if "observations" in hf else "frames"
            mkey = "masks" if "masks" in hf else "mask"
            if mkey not in hf:
                info["ok"] = False
                info["problems"].append("no mask stream")
            else:
                masks = np.asarray(hf[mkey])
                frames = hf[ikey]
                if masks.shape[0] != frames.shape[0]:
                    info["ok"] = False
                    info["problems"].append(
                        f"length mismatch {masks.shape[0]} vs {frames.shape[0]}")
                uniq = np.unique(masks.astype(np.float32))
                if not np.all(np.isin(uniq, (0.0, 1.0))):
                    info["problems"].append("non-binary mask values")
                cover = masks.astype(np.float32).mean()
                info["mask_coverage"] = float(cover)
                if cover == 0.0:
                    info["ok"] = False
                    info["problems"].append("empty masks")
                elif cover > 0.9:
                    info["ok"] = False
                    info["problems"].append("masks cover >90% of frame")
        report[p] = info
    return report


def world_change_rate(images, masks) -> float:
    """Mean per-frame change of the world (non-robot) pixels, by which the
    reference filters static videos (locobot_data_processor.py)."""
    x = np.asarray(images, np.float32)
    if x.max() > 1.5:
        x = x / 255.0
    m = np.asarray(masks, np.float32) > 0.5
    if m.ndim == x.ndim - 1:
        m = m[..., None]
    diffs = []
    for t in range(1, len(x)):
        keep = ~(m[t] | m[t - 1])
        d = np.abs(x[t] - x[t - 1]) * keep
        denom = max(keep.sum() * x.shape[-1] / keep.shape[-1], 1.0)
        diffs.append(d.sum() / denom)
    return float(np.mean(diffs)) if diffs else 0.0


def visualize_actions(images, actions, states, out_path: str,
                      action_scale: float = 0.05):
    """Marks the eef position of each step on its frame and saves a gif
    (reference: visualize_actions.py). Returns the path; the gif is
    written where imageio imports (training/plot.py:save_gif)."""
    from robot_aware_control_tpu_torch.training.plot import save_gif

    x = np.asarray(images, np.float32).copy()
    if x.max() > 1.5:
        x = x / 255.0
    h, w = x.shape[1:3]
    frames = []
    for t in range(len(actions)):
        img = x[t].copy()
        # eef state xy in [0,1] normalized workspace -> pixel
        sx, sy = states[t][0], states[t][1]
        px = int(np.clip(0.5 + sy, 0, 1) * (w - 1))
        py = int(np.clip(1.0 - sx, 0, 1) * (h - 1))
        img[max(py - 1, 0): py + 2, max(px - 1, 0): px + 2] = (1.0, 1.0, 0.0)
        frames.append(img)
    save_gif(out_path, frames, fps=2)
    return out_path


def generate_mask_dataset(env, qpos_list, out_path: str):
    """Renders the robot masks of the configurations `qpos_list` on the
    env's renderer (one launch for all of them) and stores them beside the
    qpos (reference: locobot_mask_generator.py). An env without a
    renderer gives its current mask for each."""
    from robot_aware_control_tpu_torch.data.demo_io import require_h5py

    h5py = require_h5py()
    qpos = np.asarray(qpos_list, np.float32)
    if hasattr(env, "renderer"):
        q = torch.as_tensor(qpos, device=env.renderer.device)
        masks = env.renderer.render(q).cpu().numpy()
    else:
        masks = np.stack([env.get_robot_mask() for _ in qpos_list])
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with h5py.File(out_path, "w") as hf:
        hf.create_dataset("qpos", data=qpos)
        hf.create_dataset("masks", data=masks.astype(bool))
    return out_path
