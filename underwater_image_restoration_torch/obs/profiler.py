"""Profiling hooks, the port's counterparts of the JAX package's
``obs/profiler.py``: ``profile_trace`` wraps a region in ``torch.profiler``
and writes a chrome trace (CPU, and CUDA where there is a GPU) under
``profile_dir``; ``StepTimer`` is a host wall-clock step timer that skips the
first steps.
"""
from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def profile_trace(profile_dir: str):
    """Trace the enclosed region into ``<profile_dir>/trace.json`` when
    profile_dir is non-empty; no-op else."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


class StepTimer:
    """Wall-clock per-step timer with warmup exclusion.  It times what the
    host waits for: without a synchronisation a CUDA step's time is its
    enqueue."""

    def __init__(self, skip_first: int = 1):
        self.skip = skip_first
        self.reset()

    def reset(self):
        self._n = 0
        self._total = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        if self.skip > 0:
            self.skip -= 1
        else:
            self._n += 1
            self._total += dt
        return dt

    @property
    def mean(self) -> float:
        return self._total / max(1, self._n)

    @property
    def count(self) -> int:
        return self._n
