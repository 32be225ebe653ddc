"""Profiling and step timing (counterpart of
`robot_aware_control_tpu/utils/profiling.py`). The reference has only
wall-clock prints (src/cem/trajectory_sampler.py:81-83,176-180,
src/prediction/trainer.py:777-782).

  * `trace`: a torch.profiler chrome trace of the code inside it, written
    to `<log_dir>/profile/trace.json` (CPU activity, and the CUDA
    kernels where a card is present), viewable in chrome://tracing or
    Perfetto.
  * `StepTimer`: an EMA of the wall time of the steps inside it; where
    CUDA is initialised it waits for the device before it reads the clock,
    so a step's time includes its kernels.
  * `device_memory_stats`: each card's allocated bytes, now and at peak,
    from torch.cuda.memory_stats.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Profiles the code inside it and writes a chrome trace; yields the
    path of the trace (None when not enabled)."""
    if not enabled:
        yield None
        return
    path = os.path.join(log_dir, "profile", "trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield path
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)


class StepTimer:
    """EMA wall-clock timer of steps (`with timer: step()`)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema_s: Optional[float] = None
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self.ema_s = dt if self.ema_s is None else (
            self.alpha * dt + (1 - self.alpha) * self.ema_s)
        return False

    def throughput(self, items: int) -> float:
        """items/s at the current EMA step time."""
        if not self.ema_s:
            return 0.0
        return items / self.ema_s


def device_memory_stats() -> dict:
    """{card index: {"bytes_in_use", "peak_bytes_in_use"}} of the CUDA
    devices the process has used (empty without CUDA)."""
    out = {}
    if not torch.cuda.is_initialized():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if stats:
            out[str(i)] = {
                "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            }
    return out
