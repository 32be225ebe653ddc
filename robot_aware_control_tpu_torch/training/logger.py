"""Run logging: console, `<log dir>/log.txt` and JSONL metrics in
`<log dir>/metrics.jsonl` (counterpart of
`robot_aware_control_tpu/training/logger.py:19-83`; reference:
src/prediction/trainer.py:70-84, 767, 1411-1461). wandb and the HTML
report are not ported yet."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional


def make_log_folder(cfg) -> str:
    """Create the run log dir `<log_dir>/<jobname>` (reference:
    trainer.py:1411-1461)."""
    name = cfg.jobname or f"{cfg.model}_{cfg.experiment}_{cfg.seed}"
    path = os.path.join(cfg.log_dir, name)
    os.makedirs(path, exist_ok=True)
    return path


class RunLogger:
    """One run's log: a logger of its own (console and log.txt) and the
    JSONL scalars. `close` releases both files."""

    def __init__(self, cfg, log_dir: Optional[str] = None):
        self.cfg = cfg
        self.dir = log_dir or make_log_folder(cfg)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._t0 = time.time()
        self.log = logging.getLogger(
            f"rac_torch.{os.path.abspath(self.dir)}")
        self.log.propagate = False
        self.log.setLevel(logging.INFO)
        for handler in list(self.log.handlers):  # an earlier run in this dir
            self.log.removeHandler(handler)
            handler.close()
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[%(asctime)s] %(message)s",
                                         "%H:%M:%S"))
        fh = logging.FileHandler(os.path.join(self.dir, "log.txt"))
        fh.setFormatter(logging.Formatter("[%(asctime)s] %(message)s"))
        self._handlers = [h, fh]
        for handler in self._handlers:
            self.log.addHandler(handler)

    def scalars(self, metrics: Dict[str, float], step: int, prefix: str = ""):
        rec = {f"{prefix}{k}": float(v) for k, v in metrics.items()}
        rec["step"] = step
        rec["wall_s"] = round(time.time() - self._t0, 2)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def info(self, msg: str):
        self.log.info(msg)

    def close(self):
        self._jsonl.close()
        for handler in self._handlers:
            self.log.removeHandler(handler)
            handler.close()
        self._handlers = []
