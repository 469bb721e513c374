"""One captured CUDA graph per fixed shape: the port's counterpart of
``jax.jit``'s executable cache.

The JAX engines compile each fixed-shape entry point once and replay the
executable (``repro/serving/token_engine.py:152-168``, ``_get_fused``
``:371-389``; ``repro/serving/engine.py:37``). A ``GraphCache`` is that
cache for one engine, keyed by the entry point's static arguments (shape
buckets, ``k``, ``mode``, ``beta``, the dtypes of the state it reads).

On a CUDA device the first call of a key is its warm-up: the function runs
eagerly on a side stream, as ``torch.cuda.graph`` requires, and its result
is the call's result (the warm-up also builds and loads the kernels and
sets their attributes, none of which may happen while a stream captures).
Then the call is captured into a ``torch.cuda.CUDAGraph`` that draws its
memory from one pool per engine (``torch.cuda.graph_pool_handle()``), so
every graph of an engine shares it. Every later call of the key copies its
inputs into the key's static input tensors, replays the graph and returns
its static outputs, which the next replay of the key overwrites: callers
read or copy them first. A failed capture or replay raises; no path runs
eagerly on the card in a graph's place.

On the CPU ``run`` calls the function eagerly and still records the key,
as ``jax.jit`` still compiles on the CPU, so ``len`` and ``count`` (what
``compile_counts`` reports) agree between the CPU tests and the card.

A replay runs no Python, so the kernel wrappers' launch counts
(``kernels/counts.py``) are recorded during the capture and added again at
every replay.

What a captured function must not do: synchronise with the host
(``.item()``, ``.cpu()``, a copy from pageable host memory), change the
address or dtype of any tensor it reads between calls, or make a CUDA API
call other than launches (the kernels set their attributes once, at their
first eager launch).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import counts

__all__ = ["GraphCache"]

# one capture at a time in the process: the threaded server's engines may
# meet a new shape together, and a device-wide synchronise (which
# ``torch.cuda.graph`` makes before it captures) must not run while
# another thread's stream is capturing
_capture_lock = threading.Lock()


@dataclass
class _Captured:
    graph: "torch.cuda.CUDAGraph"
    inputs: Tuple[torch.Tensor, ...]
    outputs: Tuple[torch.Tensor, ...]
    launches: Dict[Callable, int]


def _as_tensor(x) -> torch.Tensor:
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


class GraphCache:
    """Captured graphs of one engine, by key (see the module docstring)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._graphs: Dict[Hashable, _Captured] = {}
        self._keys: Dict[Hashable, None] = {}      # insertion-ordered set
        self._pool = None
        self.capture_seconds = 0.0   # host seconds inside captures
        self.replays = 0

    def __len__(self) -> int:
        return len(self._keys)

    @property
    def captured(self) -> int:
        """Graphs captured (every key, on the card; none on the CPU)."""
        return len(self._graphs)

    def count(self, entry: str) -> int:
        """Keys of one entry point (a key's first element names it)."""
        return sum(1 for k in self._keys if k[0] == entry)

    def run(self, key: Hashable, fn: Callable[..., Sequence[torch.Tensor]],
            *inputs) -> Tuple[torch.Tensor, ...]:
        """``fn(*inputs)`` -> tuple of tensors, through the graph of
        ``key``. ``inputs`` are tensors or numpy arrays of the key's fixed
        shapes (host or device); on the card they are copied into the
        key's static inputs."""
        inputs = tuple(_as_tensor(x) for x in inputs)
        if self.device.type != "cuda":
            self._keys.setdefault(key, None)
            return tuple(fn(*inputs))
        cap = self._graphs.get(key)
        if cap is None:
            return self._capture(key, fn, inputs)
        for static, x in zip(cap.inputs, inputs):
            static.copy_(x)
        cap.graph.replay()
        counts.replayed(cap.launches)
        self.replays += 1
        return cap.outputs

    def _capture(self, key, fn, inputs) -> Tuple[torch.Tensor, ...]:
        static_in = tuple(torch.empty_like(x, device=self.device).copy_(x)
                          for x in inputs)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = tuple(fn(*static_in))
        current.wait_stream(side)
        for t in out:
            t.record_stream(current)
        with _capture_lock:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            with counts.recording() as launches:
                with torch.cuda.graph(graph, pool=self._pool,
                                      capture_error_mode="thread_local"):
                    static_out = tuple(fn(*static_in))
            self.capture_seconds += time.perf_counter() - t0
        self._graphs[key] = _Captured(graph, static_in, static_out, launches)
        self._keys.setdefault(key, None)
        return out
