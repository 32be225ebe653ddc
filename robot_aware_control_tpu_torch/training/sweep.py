"""Hyperparameter sweeps (counterpart of
`robot_aware_control_tpu/training/sweep.py`; reference: the vendored
RoboNet Ray-Tune trainable, robonet/robonet/training/
trainable_interface.py:1-331, scripts/train_model.py:24-50).

A grid of configs is expanded and each trial trains in turn in this
process with the port's PredictionTrainer on `device` (the GPU unless the
caller asks for the CPU); a failed trial is retried up to `max_failures`
times (Ray's max_failures) and its errors kept in its result; the best
trial is the one whose metric, read from its run's metrics.jsonl, is least
(or greatest).
"""

from __future__ import annotations

import itertools
import json
import os
import traceback
from typing import Dict, Iterable, List, Optional, Tuple

from robot_aware_control_tpu_torch.config import Config


def expand_grid(base: Config, grid: Dict[str, Iterable]) -> List[Config]:
    keys = sorted(grid)
    configs = []
    for values in itertools.product(*(grid[k] for k in keys)):
        kw = dict(zip(keys, values))
        name = "_".join(f"{k}={v}" for k, v in kw.items())
        configs.append(base.replace(jobname=f"{base.jobname or 'sweep'}_{name}",
                                    **kw))
    return configs


def _read_metric(log_dir: str, metric: str) -> Optional[float]:
    """The metric's last value in the run's metrics.jsonl (None if absent)."""
    path = os.path.join(log_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return None
    value = None
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if metric in rec:
                value = rec[metric]
    return value


def run_sweep(base: Config, grid: Dict[str, Iterable], metric: str,
              mode: str = "min", max_failures: int = 2, device="cuda"
              ) -> Tuple[Optional[Config], List[Dict]]:
    """Returns (best config, one result a trial: {"config", "value",
    "errors"}); a trial that failed every try has value None and its
    tracebacks in "errors"."""
    from robot_aware_control_tpu_torch.training.trainer import PredictionTrainer

    results = []
    for cfg in expand_grid(base, grid):
        value, errors = None, []
        while len(errors) <= max_failures:
            try:
                trainer = PredictionTrainer(cfg, device=device)
                trainer.train()
            except Exception:  # a trial's failure is retried, then reported
                errors.append(traceback.format_exc())
                continue
            value = _read_metric(trainer.log_dir, metric)
            break
        results.append({"config": cfg, "value": value, "errors": errors})
    scored = [r for r in results if r["value"] is not None]
    if not scored:
        return None, results
    best = (min if mode == "min" else max)(scored, key=lambda r: r["value"])
    return best["config"], results
