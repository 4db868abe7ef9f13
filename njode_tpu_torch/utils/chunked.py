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

A capture's cost is kept on the program: its seconds, the bytes its graph's
memory pool reserved and keeps allocated, and, with
:attr:`EpochProgram.count_nodes`, the seconds of the graph's instantiation
apart and its node count.
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


def graph_nodes(graph: "torch.cuda.CUDAGraph") -> int:
    """The node count of a captured graph kept beside its executable
    (``CUDAGraph(keep_graph=True)``), from the driver
    (``cuGraphGetNodes``)."""
    import ctypes
    lib = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    err = lib.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                              ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return n.value


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
    After capture, ``capture_s`` holds its seconds (the instantiation's
    included), ``launches`` the kernel launches of one replay (by
    counter), ``pool_bytes`` the device memory the capture reserved (the
    graph's private pool) and ``held_bytes`` what stays allocated in it.
    With ``count_nodes`` (a measurement: the graph is kept beside its
    executable) ``instantiate_s`` holds the instantiation's seconds, no
    longer in ``capture_s``, and ``nodes`` the graph's node count."""

    count_nodes = False

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
        self.instantiate_s: Optional[float] = None
        self.pool_bytes: Optional[int] = None
        self.held_bytes: Optional[int] = None
        self.nodes: Optional[int] = None
        self.replays = 0
        self._stream = None

    def __call__(self, again: bool = True) -> tuple:
        """One call; ``again`` False says no later call follows, so a
        first call runs eagerly and captures nothing (a one-epoch run)."""
        if not self.capture or (self.graph is None and not again):
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
        keep = self.count_nodes
        graph = (torch.cuda.CUDAGraph(keep_graph=True) if keep
                 else torch.cuda.CUDAGraph())
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = launch_counts()
        try:
            # the capture synchronises once (torch.cuda.graph frees what it
            # can first, as here before the pool is measured); a caller's
            # sync check covers the epochs around it
            with sync_debug_mode(0):
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(self.device)
                allocated = torch.cuda.memory_allocated(self.device)
                t0 = time.perf_counter()
                with torch.cuda.graph(graph, stream=self._stream):
                    out = self.body()
        except Exception as e:
            add_launches({k: before.get(k, 0) - n
                          for k, n in launch_counts().items()})
            raise RuntimeError(f"capturing the chunked route's {self.what} "
                               f"as a CUDA graph failed: {e}") from e
        self.capture_s = time.perf_counter() - t0
        if keep:
            t0 = time.perf_counter()
            graph.instantiate()
            self.instantiate_s = time.perf_counter() - t0
            self.nodes = graph_nodes(graph)
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.held_bytes = torch.cuda.memory_allocated(self.device) - allocated
        after = launch_counts()
        self.launches = {k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)}
        add_launches(self.launches, -1)
        self.graph, self.out = graph, out
