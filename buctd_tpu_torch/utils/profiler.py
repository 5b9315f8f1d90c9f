"""Profiling helpers (SURVEY.md section 5's tracing plan).

Counterpart of buctd_tpu/utils/profiler.py.  ``trace_context`` wraps a
region in ``torch.profiler`` (CPU, and CUDA where a card is present) and
writes its Chrome trace, ``trace_<pid>_<time>.json``, under
``BUCTD_PROFILE_DIR`` or the ``log_dir`` given; with neither it does
nothing.  ``annotate`` names a sub-region (``record_function``) in that
trace.  ``StepTimer`` times steps on the host clock, after the fence it is
given (for example ``torch.cuda.synchronize``, or a read of the loss).
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path


@contextlib.contextmanager
def trace_context(log_dir: str | None = None):
    """Profile the region into a Chrome trace under ``log_dir`` or
    ``BUCTD_PROFILE_DIR`` when one is set; yields the profiler (or None)."""
    log_dir = log_dir or os.environ.get("BUCTD_PROFILE_DIR")
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named sub-region inside a trace."""
    from torch.profiler import record_function

    with record_function(name):
        yield


class StepTimer:
    """Host-clock step timer; ``stop(fence)`` calls the fence first, so the
    time includes the device's work that the fence waits for."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, fence=None):
        if fence is not None:
            fence()
        self.times.append(time.perf_counter() - self._t0)
        return self.times[-1]

    @property
    def mean(self):
        return sum(self.times) / len(self.times) if self.times else 0.0
