"""Cost-visualization tools (counterpart of
`robot_aware_control_tpu/evaluation/vis_tools.py`; reference:
vis_cost_on_franka.py / vis_teaser.py, which plot the planning cost along
recorded trajectories to sanity-check cost shaping). Matplotlib-free: a
cost curve rasterized to a PNG strip with its JSON series beside it.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.planning.cost import RobotWorldCost
from robot_aware_control_tpu_torch.utils.device import resolve_device


@torch.no_grad()
def cost_along_trajectory(cfg: Config, images, masks, goal_img, goal_mask,
                          device="cuda") -> np.ndarray:
    """Per-frame reward of a recorded trajectory against a fixed goal
    (reference: vis_cost_on_franka.py workflow), computed on `device`."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(a, device=dev)
    x = np.asarray(images, np.float32)
    if x.max() > 1.5:
        x = x / 255.0
    m = np.asarray(masks, np.float32)
    if m.ndim == 3:
        m = m[..., None]
    g = np.asarray(goal_img, np.float32)
    if g.max() > 1.5:
        g = g / 255.0
    gm = np.asarray(goal_mask, np.float32).reshape(g.shape[:2] + (1,))
    vals = RobotWorldCost(cfg)(t(x), t(g), curr_mask=t(m), goal_mask=t(gm))
    return vals.cpu().numpy()


def _render_curve(values: np.ndarray, h: int = 64, w: int = 256) -> np.ndarray:
    """Rasterize a 1-D series into a (h, w, 3) image (no matplotlib)."""
    v = np.asarray(values, np.float64)
    lo, hi = float(v.min()), float(v.max())
    span = max(hi - lo, 1e-9)
    ys = ((1.0 - (v - lo) / span) * (h - 1)).astype(int)
    xs = np.linspace(0, w - 1, len(v)).astype(int)
    img = np.full((h, w, 3), 1.0, np.float32)
    for (x0, y0), (x1, y1) in zip(zip(xs[:-1], ys[:-1]), zip(xs[1:], ys[1:])):
        n = max(abs(x1 - x0), abs(y1 - y0), 1)
        for t in np.linspace(0, 1, n + 1):
            xi = int(round(x0 + t * (x1 - x0)))
            yi = int(round(y0 + t * (y1 - y0)))
            img[max(yi - 1, 0): yi + 1, xi] = (0.85, 0.2, 0.15)
    return img


def save_cost_plot(values: np.ndarray, out_path: str):
    """The JSON series at <out_path>.json and, where PIL imports, the PNG
    curve at out_path (reference: vis_teaser.py-style figures)."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path + ".json", "w") as f:
        json.dump([float(v) for v in values], f)
    try:
        from PIL import Image
    except ImportError:
        return out_path
    Image.fromarray((_render_curve(values) * 255).astype(np.uint8)).save(out_path)
    return out_path
