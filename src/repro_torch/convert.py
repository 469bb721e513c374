"""JAX pytrees (as numpy arrays) to torch tensors, layout kept exactly.

Counterpart of the layouts built by ``repro/models/model.py:117-142``
(``init_params``) and ``:554-585`` (``init_cache``): ``params["blocks"]``
is a list with one entry per block-pattern position, each leaf stacked
over repetitions on axis 0, and the cache is ``{"blocks": [...]}`` with
``{"k", "v"}`` leaves ``(reps, B, C, KV, hd)`` for attention and
``{"conv", "ssm"}`` leaves for an SSM mixer. Every leaf keeps its dtype
(the SSM's ``A_log``, ``D``, ``dt_proj_b`` and state stay float32 under
bfloat16 weights). The caller hands over the pytree with
numpy leaves (``jax.tree.map(np.asarray, tree)``), so this module never
touches jax; bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` arrays and
are reinterpreted bit for bit.
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["to_tensor", "params_from_numpy", "cache_from_numpy",
           "opt_state_from_numpy", "to_numpy", "tensor_leaves",
           "tiny_params_from_numpy"]


def to_tensor(a, device="cuda", dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """One numpy array (float32/int/bool or bfloat16) as a tensor on
    ``device`` (the card unless the caller asks for the CPU; raises
    without one)."""
    device = resolve_device(device)
    a = np.array(a)            # a writable copy: jax hands out read-only
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def params_from_numpy(tree: Any, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Param pytree -> same-structure dict/list of tensors on ``device``
    (the card unless the caller asks for the CPU; raises without one).
    ``dtype`` casts every floating leaf; ``None`` keeps each leaf's own
    dtype (the JAX init keeps norm scales in float32 under bfloat16
    weights)."""
    device = resolve_device(device)
    return _map(tree, lambda a: to_tensor(a, device, dtype))


# the cache pytree ({"blocks": [{"k", "v"} or {"conv", "ssm"}]}) converts
# leaf by leaf exactly like the params
cache_from_numpy = params_from_numpy


def opt_state_from_numpy(tree: Any, device="cuda") -> Any:
    """The AdamW state of ``repro/training/optimizer.py`` (``{"m", "v"}``
    in the params' structure, float32, and the int32 ``step``) as tensors
    on ``device`` (the card unless the caller asks for the CPU; raises
    without one), every leaf's dtype kept."""
    device = resolve_device(device)
    return {"m": params_from_numpy(tree["m"], device),
            "v": params_from_numpy(tree["v"], device),
            "step": to_tensor(tree["step"], device)}


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> float32/int numpy array on the host (bfloat16 upcast)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def tensor_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict/list/tuple tree, in insertion order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return []


def tiny_params_from_numpy(tree: Any, device="cuda") -> Any:
    """A tiny classifier's params (``repro/serving/tinymodels.py:81-102``:
    ``embed``, ``pos``, ``head`` and ``blocks``, a list of ``{wq, wk, wv,
    wo, w1, w2}``; all float32) as float32 tensors on ``device`` (the card
    unless the caller asks for the CPU; raises without one)."""
    return params_from_numpy(tree, device, torch.float32)
