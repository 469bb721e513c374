"""Verbatim copy of ``repro/core/pareto.py``,
imports rewritten to ``repro_torch``.

Pareto-front utilities over (cost-like, quality-like) points."""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, TypeVar

T = TypeVar("T")


def pareto_front(items: Sequence[T], cost: Callable[[T], float],
                 quality: Callable[[T], float]) -> List[T]:
    """Keep items not dominated by any other (lower cost AND >= quality, or
    <= cost AND higher quality)."""
    out: List[T] = []
    for a in items:
        dominated = False
        for b in items:
            if b is a:
                continue
            if (cost(b) <= cost(a) and quality(b) >= quality(a)
                    and (cost(b) < cost(a) or quality(b) > quality(a))):
                dominated = True
                break
        if not dominated:
            out.append(a)
    return out


def dominates(cost_a: float, q_a: float, cost_b: float, q_b: float) -> bool:
    """a dominates b."""
    return (cost_a <= cost_b and q_a >= q_b
            and (cost_a < cost_b or q_a > q_b))
