"""Object-movement labels from the copy baseline (counterpart of
`robot_aware_control_tpu/evaluation/obj_movement.py`; reference:
src/prediction/measure_obj_movement.py:79-150).

The parameter-free copy model (`models/copy_model.py`) predicts each frame
of a video; its world-region error, held to a per-viewpoint threshold,
labels whether an object moved. The labels, `{file path: high movement}`
pickled as `obj_movement.pkl`, feed `--world_error_dict`,
`--load_movement_info` and `--movement_weight` (reference:
robonet_dataset.py:36-48, trainer.py:426-429).

    python -m robot_aware_control_tpu_torch.evaluation.obj_movement \\
        --data_root <tree> [--dynamics_model_ckpt ckpt_N.npz] \\
        [--device cpu] [--flags of config.py]

labels every HDF5 video under data_root; with --dynamics_model_ckpt it
evaluates that checkpoint on the high-movement videos instead, on
--device (the GPU unless --device cpu).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np
import torch

from robot_aware_control_tpu_torch.models import copy_model
from robot_aware_control_tpu_torch.ops import losses as L

# per robot_viewpoint world-error thresholds
# (reference: measure_obj_movement.py:146-168)
THRESHOLDS = {
    "sawyer_sudri0_c0": 0.114,
    "sawyer_sudri0_c1": 0.21,
    "sawyer_sudri0_c2": 0.18,
    "sawyer_vestri_table2_c0": 0.09,
    "default": 0.1,
}


def copy_world_error(images, masks) -> float:
    """Mean world-region MSE of the copy baseline over a video
    (images (T, H, W, 3), masks (T, H, W, 1)), on the CPU in float32."""
    x = torch.as_tensor(np.asarray(images, np.float32))
    m = torch.as_tensor(np.asarray(masks, np.float32))
    if x.ndim == 4:
        x, m = x[:, None], m[:, None]
    errs = []
    for t in range(1, x.shape[0]):
        pred = copy_model.step(x[t - 1], x[t], m[t])
        errs.append(float(L.world_mse_criterion(pred, x[t], m[t])))
    return float(np.mean(errs))


def make_movement_metadata(dataset, threshold: float,
                           write_path: str) -> Dict[str, bool]:
    """dataset: indexable, returning dicts with images, masks and
    file_path. Writes and returns {file_path: high_movement} (reference:
    measure_obj_movement.py:79-109)."""
    meta = {}
    for i in range(len(dataset)):
        item = dataset[i]
        err = copy_world_error(item["images"], item["masks"])
        meta[item["file_path"]] = bool(err >= threshold)
    os.makedirs(os.path.dirname(write_path) or ".", exist_ok=True)
    with open(write_path, "wb") as f:
        pickle.dump(meta, f)
    return meta


def load_movement_metadata(path: str) -> Dict[str, bool]:
    """Reads labels that `make_movement_metadata` of either package wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)


def evaluate_on_movement_set(cfg, ckpt_path: str, device="cuda"):
    """A checkpoint's eval metrics on the high-movement videos (reference:
    evaluation/evaluate_obj_movement.py:13-25): the epoch metrics over the
    test side of create_movement_loaders."""
    from robot_aware_control_tpu_torch.data.loader import create_movement_loaders
    from robot_aware_control_tpu_torch.evaluation.evaluate_checkpoint import (
        evaluate_checkpoint,
    )

    _, test_loader = create_movement_loaders(cfg)
    return evaluate_checkpoint(cfg, ckpt_path, loader=test_loader,
                               device=device)


def main(argv=None):
    """Labels every video under data_root and writes
    <data_root>/obj_movement.pkl (reference: measure_obj_movement.py
    __main__); with --dynamics_model_ckpt, evaluate_on_movement_set on
    --device."""
    import argparse
    import json

    from robot_aware_control_tpu_torch.config import argparser
    from robot_aware_control_tpu_torch.data.loader import discover_hdf5
    from robot_aware_control_tpu_torch.data.robonet_hdf5 import RoboNetHDF5Dataset

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="cuda (default) or cpu; there is no fallback")
    args, rest = pre.parse_known_args(argv)
    cfg, unparsed = argparser(rest)
    if unparsed:
        raise ValueError(f"unknown flags: {unparsed}")
    if cfg.dynamics_model_ckpt:
        metrics = evaluate_on_movement_set(cfg, cfg.dynamics_model_ckpt,
                                           args.device)
        print(json.dumps({k: round(float(v), 5) for k, v in metrics.items()}))
        return metrics
    pairs = discover_hdf5(cfg.data_root)
    ds = RoboNetHDF5Dataset([p for p, _ in pairs], [r for _, r in pairs], cfg)
    key = pairs[0][1] if pairs else "default"
    threshold = THRESHOLDS.get(key, THRESHOLDS["default"])
    write_path = os.path.join(cfg.data_root, "obj_movement.pkl")
    meta = make_movement_metadata(ds, threshold, write_path)
    print(f"{sum(meta.values())}/{len(meta)} videos above threshold "
          f"{threshold}; wrote {write_path}")
    return meta


if __name__ == "__main__":
    main()
