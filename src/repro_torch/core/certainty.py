"""Certainty estimation (port of ``repro/core/certainty.py``).

``cert(model, x) = score(top-1 entity) - score(top-2 entity)`` — the gap
between the highest and second-highest score (paper Appendix B, Eq. 5).
The estimators take what the reference feeds them and the card's tensors:

* a torch tensor is reduced where it lies: ``top2_gap`` goes through the
  top2gap kernel wrapper (the kernel on the card, which launches or
  raises; the plain version on the CPU), the others run as torch ops;
* a numpy array is host data (validation scores, ``run_cascade_on_scores``)
  and is reduced on the host by the plain version, as float32 (the
  reference's jnp conversion without x64), and comes back as numpy. The
  plain ``top2_gap`` subtracts the same two exact f32 values as
  ``jax.lax.top_k``, so validation certainties are bit-equal.

``StreamingCertainty`` is the host-side float64 fold, copied verbatim;
``device_fold_*`` is the same fold as (B,) float32 tensors carried through
the fused decode loop. ``threshold_grid`` and ``coverage_accuracy_curve``
are the reference's numpy calibration helpers, copied verbatim.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.top2gap import top2gap as _top2gap_kernel

__all__ = ["top2_gap", "top2_gap_softmax", "max_prob", "entropy_certainty",
           "CERTAINTY_ESTIMATORS", "predict_with_certainty",
           "StreamingCertainty", "device_fold_init", "device_fold_update",
           "device_fold_value", "device_fold_set_rows", "threshold_grid",
           "coverage_accuracy_curve"]


def _host_arrays(fn):
    """Estimator ``fn`` on tensors, extended to numpy host data: a numpy
    array is reduced as a float32 CPU tensor and the result comes back as
    numpy."""
    @functools.wraps(fn)
    def estimator(scores):
        if isinstance(scores, torch.Tensor):
            return fn(scores)
        host = torch.tensor(np.asarray(scores, np.float32))
        return fn(host).numpy()
    return estimator


@_host_arrays
def top2_gap(scores: torch.Tensor) -> torch.Tensor:
    """Eq. 5: top-1 minus top-2 along the last axis. scores (..., V)."""
    flat = scores.reshape(-1, scores.shape[-1])
    gap, _ = _top2gap_kernel(flat)
    return gap.reshape(scores.shape[:-1])


def _top2_values(x: torch.Tensor) -> torch.Tensor:
    top1 = x.max(dim=-1).values
    idx = x.argmax(dim=-1, keepdim=True)
    top2 = x.scatter(-1, idx, float("-inf")).max(dim=-1).values
    return top1 - top2


@_host_arrays
def top2_gap_softmax(scores: torch.Tensor) -> torch.Tensor:
    """Gap between the two largest softmax probabilities (scale-invariant
    variant; useful when model families are not logit-calibrated)."""
    return _top2_values(torch.softmax(scores.float(), dim=-1))


@_host_arrays
def max_prob(scores: torch.Tensor) -> torch.Tensor:
    """Max softmax probability (MSP) baseline estimator."""
    return torch.softmax(scores.float(), dim=-1).max(dim=-1).values


@_host_arrays
def entropy_certainty(scores: torch.Tensor) -> torch.Tensor:
    """Negative predictive entropy (higher = more certain)."""
    logp = torch.log_softmax(scores.float(), dim=-1)
    return torch.sum(torch.exp(logp) * logp, dim=-1)


CERTAINTY_ESTIMATORS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "top2_gap": top2_gap,
    "top2_gap_softmax": top2_gap_softmax,
    "max_prob": max_prob,
    "neg_entropy": entropy_certainty,
}


def predict_with_certainty(scores: torch.Tensor, estimator: str = "top2_gap"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(argmax prediction, certainty) for a batch of score vectors."""
    pred = torch.argmax(scores, dim=-1)
    cert = CERTAINTY_ESTIMATORS[estimator](scores)
    return pred, cert


# ---------------------------------------------------------------------------
# Streaming certainty over partial generations (token-level cascades)
# ---------------------------------------------------------------------------

class StreamingCertainty:
    """O(1)-per-token certainty estimate over a partial generation.

    Token-level cascades (DESIGN.md §13) cannot wait for the full response
    to decide whether the small model is out of its depth: the per-token
    top-2 logit gap is folded into a running statistic after EVERY decode
    step, and the cascade consults ``value`` at token boundaries. Three
    folds, selected by ``mode``:

    * ``ewma`` (default) — exponentially weighted average of the gaps
      (weight ``beta`` on the newest); tracks degradation mid-stream while
      smoothing single-token noise.
    * ``mean`` — running arithmetic mean (the full-response estimate the
      one-shot cascade would have seen, available incrementally).
    * ``min``  — weakest token so far (most conservative escalator).

    Both token executors — the real ``TokenEngine`` and the virtual-time
    token DES — drive an instance of this class with the same gap stream,
    so their escalation decisions cannot diverge (the token analogue of the
    SchedulerCore contract, DESIGN.md §2).
    """

    __slots__ = ("mode", "beta", "count", "_mean", "_min", "_ewma")

    def __init__(self, mode: str = "ewma", beta: float = 0.35):
        if mode not in ("ewma", "mean", "min"):
            raise ValueError(
                f"StreamingCertainty mode must be ewma|mean|min, got "
                f"{mode!r}")
        if not 0.0 < beta <= 1.0:
            raise ValueError(f"beta must be in (0, 1], got {beta}")
        self.mode = mode
        self.beta = beta
        self.reset()

    def reset(self) -> None:
        self.count = 0
        self._mean = 0.0
        self._min = float("inf")
        self._ewma = 0.0

    def update(self, gap: float) -> float:
        """Fold one per-token gap; returns the updated ``value``."""
        gap = float(gap)
        self.count += 1
        self._mean += (gap - self._mean) / self.count
        if gap < self._min:
            self._min = gap
        if self.count == 1:
            self._ewma = gap
        else:
            self._ewma += self.beta * (gap - self._ewma)
        return self.value

    @property
    def value(self) -> float:
        """The current certainty estimate (0.0 before any token)."""
        if self.count == 0:
            return 0.0
        if self.mode == "mean":
            return self._mean
        if self.mode == "min":
            return self._min
        return self._ewma


# ---------------------------------------------------------------------------
# Device-side streaming fold (fused decode loop)
# ---------------------------------------------------------------------------
#
# The same running statistics as ``StreamingCertainty``, as (B,) float32
# tensors carried through the fused decode loop. The host fold (float64,
# above) stays the DECISION authority; the device fold is what the step
# ships and what the speculative multi-token guard can consult.

FoldState = Dict[str, torch.Tensor]


def device_fold_init(batch: int, device="cuda") -> FoldState:
    """Fresh per-row fold state: {count, mean, min, ewma} of shape (B,),
    on ``device`` (the card unless the CPU is asked for)."""
    device = resolve_device(device)
    return {
        "count": torch.zeros((batch,), dtype=torch.int32, device=device),
        "mean": torch.zeros((batch,), dtype=torch.float32, device=device),
        "min": torch.full((batch,), float("inf"), dtype=torch.float32,
                          device=device),
        "ewma": torch.zeros((batch,), dtype=torch.float32, device=device),
    }


def device_fold_update(state: FoldState, gap: torch.Tensor, beta: float
                       ) -> FoldState:
    """Fold one per-row gap (B,) f32 — the recurrences of
    ``StreamingCertainty.update``, elementwise over the batch."""
    gap = gap.float()
    count = state["count"] + 1
    first = state["count"] == 0
    # a Python float: the product runs in f32 as with an f32 scalar tensor,
    # and no host-to-device copy enters a captured CUDA graph
    return {
        "count": count,
        "mean": state["mean"] + (gap - state["mean"]) / count.float(),
        "min": torch.minimum(state["min"], gap),
        "ewma": torch.where(first, gap,
                            state["ewma"] + float(beta)
                            * (gap - state["ewma"])),
    }


def device_fold_value(state: FoldState, mode: str) -> torch.Tensor:
    """(B,) certainty values for ``mode`` (0.0 before any token), matching
    ``StreamingCertainty.value``."""
    if mode not in ("mean", "min", "ewma"):
        raise ValueError(f"fold mode must be ewma|mean|min, got {mode!r}")
    v = state[mode]
    return torch.where(state["count"] == 0, torch.zeros_like(v), v)


def device_fold_set_rows(state: FoldState, rows: torch.Tensor,
                         gap: torch.Tensor) -> FoldState:
    """Reset ``rows`` to a one-token fold seeded with ``gap`` — the join
    path (the prefill emits each request's first token and gap). Writes
    ``state`` IN PLACE and returns it: the engine's fold tensors keep their
    addresses, which its captured decode graphs read."""
    gap = gap.float()
    state["count"][rows] = 1
    for n in ("mean", "min", "ewma"):
        state[n][rows] = gap
    return state


# ---------------------------------------------------------------------------
# Threshold calibration utilities (host-side, numpy)
# ---------------------------------------------------------------------------

def threshold_grid(certs: np.ndarray, n: int = 16) -> np.ndarray:
    """Discretise the continuous certainty range into ``n`` selectable
    thresholds (paper §4.2) — quantiles of the observed certainty
    distribution, plus 0 (= never forward)."""
    qs = np.quantile(certs, np.linspace(0.0, 1.0, n + 1)[1:-1])
    return np.unique(np.concatenate([[0.0], qs]))


def coverage_accuracy_curve(certs: np.ndarray, correct: np.ndarray,
                            thresholds: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """For each threshold: (fraction kept, accuracy on kept samples)."""
    keep_frac, acc = [], []
    for t in thresholds:
        kept = certs >= t
        keep_frac.append(kept.mean())
        acc.append(correct[kept].mean() if kept.any() else 1.0)
    return np.asarray(keep_frac), np.asarray(acc)
