"""Prediction visualizations: eval gifs and image strips (counterpart of
`robot_aware_control_tpu/training/plot.py`; reference: src/utils/plot.py:
109-156 and the trainer's gifs, src/prediction/trainer.py:949-1147).

imageio (gifs) and PIL (strips) are imported where they are used; without
them nothing is written and the writers return None.
"""

from __future__ import annotations

import numpy as np


def _to_uint8(x):
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    return (x * 255).astype(np.uint8)


def save_gif(path: str, frames, fps: int = 2):
    """frames: list/array of (H, W, 3) float [0,1] images. Returns the path,
    or None without imageio."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        return None
    imageio.mimwrite(path, [_to_uint8(f) for f in frames], fps=fps)
    return path


def eval_gif(path: str, truth, preds, masks=None, max_cols: int = 8, fps: int = 2):
    """Side-by-side truth|prediction gif over time.

    truth/preds: (T, B, H, W, 3); masks optional (T, B, H, W, 1) rendered as
    a red overlay on the truth row (reference: trainer.py:1035-1076)."""
    truth = np.asarray(truth, np.float32)
    preds = np.asarray(preds, np.float32)
    T, B = truth.shape[:2]
    cols = min(B, max_cols)
    frames = []
    for t in range(T):
        row_t = np.concatenate([truth[t, b] for b in range(cols)], axis=1)
        if masks is not None:
            m = np.concatenate([masks[t, b] for b in range(cols)], axis=1)
            row_t = row_t.copy()
            row_t[..., 0] = np.where(m[..., 0] > 0.5, 1.0, row_t[..., 0])
        row_p = np.concatenate([preds[t, b] for b in range(cols)], axis=1)
        frames.append(np.concatenate([row_t, row_p], axis=0))
    return save_gif(path, frames, fps=fps)


def image_strip(path: str, images):
    """Save a horizontal strip png of (N, H, W, 3) images; None without
    PIL."""
    try:
        from PIL import Image
    except ImportError:
        return None
    strip = np.concatenate([_to_uint8(im) for im in images], axis=1)
    Image.fromarray(strip).save(path)
    return path
