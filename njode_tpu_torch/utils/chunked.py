"""Device programs of the Trainer's chunked route (``Trainer.train(...,
chunk_epochs=...)``, the JAX package's ``_train_chunked``,
``njode_tpu/utils/training.py:1045-1134``).

An :class:`EpochProgram` is one piece of an epoch's device work, a Python
callable that reads nothing on the host: the epoch's data, shuffle,
packing, training and validation loss, or the relative loss of a print
epoch.  Where it is not captured (the CPU, or a route left eager) each call
runs it.  On the card a capturable route's first call runs it eagerly, on
a side stream (the warm-up: a real epoch), and captures it into a CUDA
graph right after; every later call replays the graph: one graph launch an
epoch, with no host synchronisation between the chunk's start and its one
read of the losses.  Random draws come from generators the caller owns and
registers with the program; the caller reseeds them before each call
(``stream_seed``), and a replay reads the new seed, so a chunk's epoch e
draws what the per-epoch loop's epoch e draws.

The kernels' launch counters (the ``LAUNCHES*`` of
:mod:`njode_tpu_torch.ops`) count where a wrapper launches, which under
capture happens once, at capture time, when nothing runs: the program
takes the capture's counts back and adds them again at every replay.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Callable, Iterable, Optional

import torch


def _counter_modules() -> tuple:
    from ..ops import (fused_cell, fused_step, gap_scan, train_kernel,
                       walk_scan, walk_train)
    return (fused_cell, fused_step, gap_scan, train_kernel, walk_scan,
            walk_train)


def launch_counts() -> dict:
    """Every kernel launch counter of :mod:`njode_tpu_torch.ops`:
    {(module, name, mode or None): count}."""
    out = {}
    for mod in _counter_modules():
        for name, value in vars(mod).items():
            if not name.startswith("LAUNCHES"):
                continue
            if isinstance(value, dict):
                out.update({(mod.__name__, name, k): v
                            for k, v in value.items()})
            else:
                out[(mod.__name__, name, None)] = value
    return out


def add_launches(counts: dict, times: int = 1) -> None:
    """Add ``times`` x ``counts`` (keys of :func:`launch_counts`) to the
    counters."""
    for (module, name, mode), n in counts.items():
        if not n:
            continue
        mod = sys.modules[module]
        if mode is None:
            setattr(mod, name, getattr(mod, name) + times * n)
        else:
            getattr(mod, name)[mode] += times * n


@contextlib.contextmanager
def sync_debug_mode(mode):
    """``torch.cuda.set_sync_debug_mode(mode)`` within the block, the
    previous mode after it."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class EpochProgram:
    """``body()`` -> a tuple of device tensors, run eagerly or, with
    ``capture``, as a CUDA graph after one eager warm-up call (the capture
    follows the warm-up in that call).

    ``generators``: the CUDA generators ``body`` draws from, registered
    with the graph (``CUDAGraph.register_generator_state``), so a replay
    draws from each generator's seed and offset at the time of the replay.
    A capture that fails raises: the route never falls back to eager.
    After capture, ``capture_s`` holds its seconds and ``launches`` the
    kernel launches of one replay (by counter)."""

    def __init__(self, body: Callable[[], tuple], capture: bool = False,
                 generators: Iterable[torch.Generator] = (),
                 what: str = "epoch", device=None):
        self.body = body
        self.capture = capture
        self.generators = list(generators)
        self.what = what
        self.device = device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[tuple] = None
        self.launches: dict = {}
        self.capture_s: Optional[float] = None
        self.replays = 0
        self._stream = None

    def __call__(self) -> tuple:
        if not self.capture:
            return self.body()
        if self.graph is None:
            out = self._warm_up()
            self._capture()
            return out
        self.graph.replay()
        add_launches(self.launches)
        self.replays += 1
        return self.out

    def _warm_up(self) -> tuple:
        """The first call: eagerly, on the side stream the capture uses
        (lazy state such as Adam's moments and the libraries' handles is
        made here, outside the graph)."""
        current = torch.cuda.current_stream(self.device)
        self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            out = self.body()
        current.wait_stream(self._stream)
        return out

    def release(self) -> None:
        """Free the graph and its memory pool (its numbers stay).  The
        programs hold their owner's bound methods, so only the cyclic
        garbage collector would free them, and a graph freed in the middle
        of another capture invalidates that capture."""
        self.graph = self.out = None

    def _capture(self) -> None:
        """Capture ``body`` right after the warm-up (nothing runs)."""
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = launch_counts()
        t0 = time.perf_counter()
        try:
            # the capture synchronises once (torch.cuda.graph frees what it
            # can first); a caller's sync check covers the epochs around it
            with sync_debug_mode(0), torch.cuda.graph(graph,
                                                      stream=self._stream):
                out = self.body()
        except Exception as e:
            add_launches({k: before.get(k, 0) - n
                          for k, n in launch_counts().items()})
            raise RuntimeError(f"capturing the chunked route's {self.what} "
                               f"as a CUDA graph failed: {e}") from e
        self.capture_s = time.perf_counter() - t0
        after = launch_counts()
        self.launches = {k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)}
        add_launches(self.launches, -1)
        self.graph, self.out = graph, out
