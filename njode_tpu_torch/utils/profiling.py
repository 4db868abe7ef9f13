"""Profiling helpers (port of ``njode_tpu.utils.profiling``).

``maybe_trace`` wraps a region in ``torch.profiler`` and writes a Chrome
trace (viewable in Perfetto or ``chrome://tracing``); ``StepTimer``
synchronizes the device before it reads the clock, so asynchronous CUDA
launches do not hide a step's time; ``compile_time`` is the seconds of a
function's first call, which builds whatever it builds at first use.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str], cuda: Optional[bool] = None):
    """Trace the region with ``torch.profiler`` when ``trace_dir`` is
    given and write ``trace_<time>_<pid>.json`` there.  ``cuda``: record
    the card's activity too; None means wherever a card is present."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}"
                                   f"_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    print(f"Profiler trace written to {trace_dir}")


def _cuda_devices(x, out: set) -> set:
    """The CUDA devices of the tensors in a (nested) container."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    return out


class StepTimer:
    """Measures a step's real time: the clock is read after the devices of
    the given results have finished their work."""

    def __init__(self):
        self.times: list[float] = []

    @contextlib.contextmanager
    def measure(self, *block_on):
        t0 = time.perf_counter()
        yield
        for device in _cuda_devices(block_on, set()):
            torch.cuda.synchronize(device)
        self.times.append(time.perf_counter() - t0)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)


def compile_time(fn, *args, **kwargs) -> float:
    """Seconds of the first call ``fn(*args, **kwargs)``, the devices of
    its inputs and results synchronized before the clock is read.

    The JAX package's ``compile_time`` lowers and compiles ``jax.jit(fn)``
    ahead of time and runs nothing.  The port traces nothing: PyTorch runs
    eagerly and a CUDA kernel's source is built at its wrapper's first
    launch (nvcc into ``ops/_build/``, or a load of that build).  So this
    counts that build (or load), the first launches, and the call's own
    work, run once; call it first in a process to see the build."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    for device in _cuda_devices((out, args, kwargs), set()):
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0
