"""Launch counts of the kernel wrappers, graph replays included.

Each wrapper calls ``launched(wrapper)`` where it launches its kernel; the
count is the wrapper's integer ``launches`` attribute. A CUDA graph replay
runs no Python, so ``serving/graphs.py`` captures a call inside
``recording()``: while the capturing thread records, a wrapper's launch is
only noted in the recording (a capture launches nothing), and
``replayed(recording)`` adds those launches to the counts at every replay.
The server's consumer threads launch concurrently, so every update takes
one lock; a recording belongs to the thread that captures.

A wrapper whose kernel has no backward calls ``forward_only`` before it
launches: a launch returns an output without a ``grad_fn``.

``counter()`` is the dry-run's cost counter (``profiling/trace_cost.py``
``TraceCost``) where one is active on the calling thread, else None. A
``TraceCost`` is a dispatch mode: it sits on the thread's dispatch-mode
stack, which autograd carries to the thread a backward runs on, so the
counter of a traced step reaches its backward too, and no other thread
sees it. Each wrapper asks first: under a counter it launches nothing
and hands the call to ``counter().charged``, which charges the call as
its kernel (fake tensors only); with none, one look at the stack's
length is all the wrapper adds.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Iterator

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

__all__ = ["counter", "forward_only", "launched", "recording", "replayed",
           "reset"]

_lock = threading.Lock()
_local = threading.local()


def counter():
    """The cost counter active on this thread (the innermost dispatch mode
    with ``charges_kernels`` set: a ``trace_cost.TraceCost``), else
    None."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if getattr(mode, "charges_kernels", False):
            return mode
    return None


def launched(wrapper: Callable) -> None:
    """Count one launch of ``wrapper``'s kernel (or note it in this
    thread's recording while it captures)."""
    rec = getattr(_local, "recording", None)
    if rec is not None:
        rec[wrapper] = rec.get(wrapper, 0) + 1
        return
    with _lock:
        wrapper.launches += 1


@contextlib.contextmanager
def recording() -> Iterator[Dict[Callable, int]]:
    """Note, instead of count, this thread's launches: {wrapper: n}."""
    prev = getattr(_local, "recording", None)
    rec: Dict[Callable, int] = {}
    _local.recording = rec
    try:
        yield rec
    finally:
        _local.recording = prev


def replayed(rec: Dict[Callable, int]) -> None:
    """Count the launches of one replay of a graph captured as ``rec``."""
    with _lock:
        for wrapper, n in rec.items():
            wrapper.launches += n


def reset(wrappers) -> None:
    """Zero the counts of ``wrappers``."""
    with _lock:
        for wrapper in wrappers:
            wrapper.launches = 0


def forward_only(name: str, *tensors) -> None:
    """Raise where a kernel without a backward would be launched on
    inputs that autograd is tracking: its output would carry no
    ``grad_fn`` and the gradient would be lost without a word. Only the
    serving kernels ``decode_attention``, ``top2gap`` and the SSM decode
    step's two call it; no training path reaches them
    (``flash_attention`` and ``mamba_scan`` have backward kernels)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input "
            f"requires grad; it serves only (decoding, certainty gaps), so "
            f"call it under torch.no_grad(), or run on the CPU, where the "
            f"plain version differentiates")
