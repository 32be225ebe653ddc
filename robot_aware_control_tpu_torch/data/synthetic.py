"""Synthetic robot-video fixture dataset (numpy only).

A copy of `robot_aware_control_tpu/data/synthetic.py`: the same seed gives
the same arrays in both packages.

A procedurally generated stand-in for RoboNet snippets: a planar "robot"
(a bright articulated wedge anchored at the image bottom) moves under
2-D actions over a textured background with a pushable object block. Frames,
robot masks, normalized eef states, qpos, and actions are produced with the
exact tensor contract of the HDF5 pipeline (time-first, NHWC), so the
trainer, eval, planner and benchmarks run hermetically on any host.

This replaces nothing in the reference (which has no test fixtures at all —
SURVEY.md section 4); it is the foundation of the test pyramid the rebuild
adds. The data dict layout matches RoboNetDataset's output
(reference: src/dataset/robonet/robonet_dataset.py:114-171).
"""

from __future__ import annotations

import numpy as np


def _draw_robot(img, mask, px, py, w, h):
    """Draw a simple 2-segment arm from the bottom-center to (px, py).
    Coordinates normalized [0,1]. Returns nothing; mutates img/mask."""
    H, W, _ = img.shape
    base = np.array([0.5 * W, H - 1.0])
    tip = np.array([px * (W - 1), py * (H - 1)])
    elbow = (base + tip) / 2 + np.array([0.0, -0.12 * H])
    for a, b, thick in ((base, elbow, 2.5), (elbow, tip, 1.8)):
        n = max(int(np.linalg.norm(b - a)) * 2, 2)
        ts = np.linspace(0, 1, n)
        pts = a[None] + ts[:, None] * (b - a)[None]
        for x, y in pts:
            xi, yi = int(round(x)), int(round(y))
            r = int(round(thick))
            x0, x1 = max(xi - r, 0), min(xi + r + 1, W)
            y0, y1 = max(yi - r, 0), min(yi + r + 1, H)
            img[y0:y1, x0:x1] = np.array([0.85, 0.85, 0.9])
            mask[y0:y1, x0:x1] = 1.0


def _draw_block(img, bx, by, size, color):
    H, W, _ = img.shape
    xi, yi = int(bx * (W - 1)), int(by * (H - 1))
    r = size // 2
    x0, x1 = max(xi - r, 0), min(xi + r + 1, W)
    y0, y1 = max(yi - r, 0), min(yi + r + 1, H)
    img[y0:y1, x0:x1] = color


def generate_episode(rng, T, height=48, width=64, action_dim=5, robot_dim=5,
                     robot_joint_dim=5, action_scale=0.08):
    """One episode. Returns dict of numpy arrays (time-first, no batch dim)."""
    # static textured background
    bg = 0.25 + 0.1 * rng.rand(height, width, 3).astype(np.float32)
    bg += 0.08 * np.sin(
        np.linspace(0, 6, width)[None, :, None] + np.linspace(0, 4, height)[:, None, None]
    ).astype(np.float32)

    px, py = 0.3 + 0.4 * rng.rand(2)
    bx, by = 0.2 + 0.6 * rng.rand(2)
    block_color = np.array([0.9, 0.3, 0.2], np.float32)

    actions = np.zeros((T - 1, action_dim), np.float32)
    actions[:, :2] = rng.uniform(-action_scale, action_scale, (T - 1, 2))

    images = np.zeros((T, height, width, 3), np.float32)
    masks = np.zeros((T, height, width, 1), np.float32)
    states = np.zeros((T, robot_dim), np.float32)
    qpos = np.zeros((T, robot_joint_dim), np.float32)

    for t in range(T):
        img = bg.copy()
        m = np.zeros((height, width, 1), np.float32)
        _draw_block(img, bx, by, 7, block_color)
        _draw_robot(img, m, px, py, width, height)
        images[t] = np.clip(img, 0, 1)
        masks[t] = m
        states[t, :2] = (px, py)
        qpos[t, :2] = (px, py)
        if t < T - 1:
            dx, dy = actions[t, :2]
            npx, npy = np.clip(px + dx, 0.05, 0.95), np.clip(py + dy, 0.05, 0.95)
            # push the block if the tip lands in it
            if abs(npx - bx) < 0.08 and abs(npy - by) < 0.1:
                bx = np.clip(bx + dx, 0.05, 0.95)
                by = np.clip(by + dy, 0.05, 0.95)
            px, py = npx, npy

    return {
        "images": images,
        "masks": masks,
        "states": states,
        "actions": actions,
        "qpos": qpos,
        "robot": "synthetic",
        "folder": "c0",
        "file_path": "synthetic",
        "low": np.zeros(robot_dim, np.float32),
        "high": np.ones(robot_dim, np.float32),
    }


def synthetic_batch(cfg, batch_size, T, seed=0):
    """Time-first batch dict matching process_batch's layout
    (reference: robonet_dataset.py:434-451)."""
    rng = np.random.RandomState(seed)
    eps = [
        generate_episode(
            rng, T, cfg.image_height, cfg.image_width,
            cfg.action_dim, cfg.robot_dim, cfg.robot_joint_dim,
        )
        for _ in range(batch_size)
    ]
    batch = {}
    for k in ("images", "masks", "states", "actions", "qpos"):
        batch[k] = np.stack([e[k] for e in eps], axis=1)  # (T, B, ...)
    batch["robot"] = [e["robot"] for e in eps]
    batch["folder"] = [e["folder"] for e in eps]
    batch["low"] = np.stack([e["low"] for e in eps])
    batch["high"] = np.stack([e["high"] for e in eps])
    return batch


class SyntheticDataset:
    """Iterable dataset of synthetic episodes with the loader interface used
    by the trainer (infinite batches, deterministic per-epoch seeds)."""

    def __init__(self, cfg, batch_size, T=None, seed=0, num_batches=8):
        self._cfg = cfg
        self._batch_size = batch_size
        self._T = T or cfg.video_length
        self._seed = seed
        self.num_batches = num_batches

    def __iter__(self):
        for i in range(self.num_batches):
            yield synthetic_batch(
                self._cfg, self._batch_size, self._T, self._seed * 10007 + i
            )

    def infinite(self):
        epoch = 0
        while True:
            for i in range(self.num_batches):
                yield synthetic_batch(
                    self._cfg, self._batch_size, self._T,
                    (self._seed + epoch) * 10007 + i,
                )
            epoch += 1
