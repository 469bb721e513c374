"""Verbatim copy of ``repro/core/lp.py``,
imports rewritten to ``repro_torch``.

Dense two-phase simplex LP solver + the paper's load-balancing LP
(§4.4 Eq. 1-3).

Standard form solved:  min c.x  s.t.  A_ub x <= b_ub, x >= 0.
Problem sizes here are tiny (#replicas variables, #models + #devices rows),
so a dense tableau simplex with Bland's rule is plenty and keeps the repo
dependency-free.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_EPS = 1e-9


@dataclass
class LPResult:
    status: str           # "optimal" | "infeasible" | "unbounded"
    x: Optional[np.ndarray]
    objective: float


def _pivot(tab: np.ndarray, row: int, col: int) -> None:
    tab[row] /= tab[row, col]
    for r in range(tab.shape[0]):
        if r != row and abs(tab[r, col]) > _EPS:
            tab[r] -= tab[r, col] * tab[row]


def _simplex(tab: np.ndarray, basis: List[int], n_vars: int,
             max_iter: int = 10000) -> str:
    """Tableau: rows = constraints + objective (last row). Bland's rule."""
    m = tab.shape[0] - 1
    for _ in range(max_iter):
        obj = tab[-1, :n_vars]
        col = -1
        for j in range(n_vars):
            if obj[j] < -_EPS:
                col = j
                break
        if col < 0:
            return "optimal"
        ratios = []
        for i in range(m):
            if tab[i, col] > _EPS:
                ratios.append((tab[i, -1] / tab[i, col], basis[i], i))
        if not ratios:
            return "unbounded"
        _, _, row = min(ratios)
        _pivot(tab, row, col)
        basis[row] = col
    return "optimal"  # iteration cap: tiny problems never hit this


def linprog(c: np.ndarray, a_ub: np.ndarray, b_ub: np.ndarray) -> LPResult:
    """min c.x s.t. a_ub x <= b_ub, x >= 0 (two-phase simplex)."""
    c = np.asarray(c, np.float64)
    a = np.asarray(a_ub, np.float64)
    b = np.asarray(b_ub, np.float64).copy()
    m, n = a.shape
    # normalise to b >= 0
    a = a.copy()
    flip = b < 0
    a[flip] *= -1.0
    b[flip] *= -1.0
    # columns: n vars | m slack (+-1 depending on flip) | m artificial
    slack = np.diag(np.where(flip, -1.0, 1.0))
    need_art = flip  # rows with negative slack need an artificial var
    art_cols = np.where(need_art)[0]
    n_art = len(art_cols)
    width = n + m + n_art + 1
    tab = np.zeros((m + 1, width))
    tab[:m, :n] = a
    tab[:m, n:n + m] = slack
    for k, r in enumerate(art_cols):
        tab[r, n + m + k] = 1.0
    tab[:m, -1] = b
    basis: List[int] = []
    art_of_row = {r: n + m + k for k, r in enumerate(art_cols)}
    for r in range(m):
        basis.append(art_of_row[r] if need_art[r] else n + r)
    # phase 1
    if n_art:
        tab[-1, n + m:n + m + n_art] = 1.0
        for r in art_cols:  # price out artificial basics
            tab[-1] -= tab[r]
        status = _simplex(tab, basis, n + m + n_art)
        if status != "optimal" or tab[-1, -1] < -1e-7:
            return LPResult("infeasible", None, np.inf)
        # drive remaining artificial basics out
        for i in range(m):
            if basis[i] >= n + m:
                for j in range(n + m):
                    if abs(tab[i, j]) > _EPS:
                        _pivot(tab, i, j)
                        basis[i] = j
                        break
        tab = np.delete(tab, np.s_[n + m:n + m + n_art], axis=1)
    # phase 2
    tab[-1, :] = 0.0
    tab[-1, :n] = c
    for i in range(m):
        if basis[i] < n and abs(c[basis[i]]) > _EPS:
            tab[-1] -= c[basis[i]] * tab[i]
    status = _simplex(tab, basis, n + m)
    if status != "optimal":
        return LPResult(status, None, -np.inf)
    x = np.zeros(n)
    for i in range(m):
        if basis[i] < n:
            x[basis[i]] = tab[i, -1]
    return LPResult("optimal", x, float(c @ x))


# ---------------------------------------------------------------------------
# Load-balancing LP (paper Eq. 1-3)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Replica:
    model: str
    device: int          # inference-server / slice id
    runtime_per_sample: float  # runtime(r) at batch 1 (paper's definition)


def solve_load_balance(replicas: Sequence[Replica],
                       qps_per_model: Dict[str, float],
                       num_devices: int, u: float
                       ) -> Optional[np.ndarray]:
    """Feasibility LP for a fixed utilisation cap ``u``:

      min sum q_r                                    (Eq. 1)
      s.t. sum_{r in R[m]} q_r >= QPS_m              (Eq. 2)
           sum_{r in R[d]} q_r * runtime(r) <= u     (Eq. 3)
           q_r >= 0

    Returns q (len == replicas) or None if infeasible.
    """
    n = len(replicas)
    if n == 0:
        return None if any(v > 0 for v in qps_per_model.values()) \
            else np.zeros(0)
    rows: List[np.ndarray] = []
    rhs: List[float] = []
    for m_name, need in qps_per_model.items():
        row = np.zeros(n)
        for i, r in enumerate(replicas):
            if r.model == m_name:
                row[i] = -1.0       # -sum q_r <= -QPS_m
        if not row.any():
            if need > 1e-12:
                return None          # model has no replica at all
            continue
        rows.append(row)
        rhs.append(-float(need))
    for d in range(num_devices):
        row = np.zeros(n)
        for i, r in enumerate(replicas):
            if r.device == d:
                row[i] = r.runtime_per_sample
        if row.any():
            rows.append(row)
            rhs.append(float(u))
    if not rows:
        return np.zeros(n)
    res = linprog(np.ones(n), np.vstack(rows), np.asarray(rhs))
    return res.x if res.status == "optimal" else None


def min_utilization(replicas: Sequence[Replica],
                    qps_per_model: Dict[str, float], num_devices: int,
                    tol: float = 1e-3) -> Tuple[Optional[float],
                                                Optional[np.ndarray]]:
    """Paper §4.4: bisect the utilisation cap u down from 100% to the lowest
    feasible value. Returns (u_min, q) or (None, None) if even u=1 fails."""
    q = solve_load_balance(replicas, qps_per_model, num_devices, 1.0)
    if q is None:
        return None, None
    lo, hi = 0.0, 1.0
    best = q
    while hi - lo > tol:
        mid = (lo + hi) / 2
        q_mid = solve_load_balance(replicas, qps_per_model, num_devices, mid)
        if q_mid is None:
            lo = mid
        else:
            hi = mid
            best = q_mid
    return hi, best


def min_utilization_lp(replicas: Sequence[Replica],
                       qps_per_model: Dict[str, float], num_devices: int
                       ) -> Tuple[Optional[float], Optional[np.ndarray]]:
    """Direct formulation: make u a decision variable and minimise it in one
    LP (equivalent to the paper's bisection, ~10x fewer solves — used inside
    the SP3 pruning loop; ``min_utilization`` is kept as the paper-faithful
    cross-check). Returns (u_min, q) or (None, None) if u > 1 is needed."""
    n = len(replicas)
    if n == 0:
        if any(v > 1e-12 for v in qps_per_model.values()):
            return None, None
        return 0.0, np.zeros(0)
    # vars: q_0..q_{n-1}, u
    rows: List[np.ndarray] = []
    rhs: List[float] = []
    for m_name, need in qps_per_model.items():
        row = np.zeros(n + 1)
        for i, r in enumerate(replicas):
            if r.model == m_name:
                row[i] = -1.0
        if not row[:n].any():
            if need > 1e-12:
                return None, None
            continue
        rows.append(row)
        rhs.append(-float(need))
    for d in range(num_devices):
        row = np.zeros(n + 1)
        for i, r in enumerate(replicas):
            if r.device == d:
                row[i] = r.runtime_per_sample
        if row[:n].any():
            row[n] = -1.0  # ... - u <= 0
            rows.append(row)
            rhs.append(0.0)
    if not rows:
        return 0.0, np.zeros(n)
    c = np.zeros(n + 1)
    c[n] = 1.0
    c[:n] = 1e-7  # tiny tie-break: don't route more load than needed (Eq. 1)
    res = linprog(c, np.vstack(rows), np.asarray(rhs))
    if res.status != "optimal":
        return None, None
    u = float(res.x[n])
    if u > 1.0 + 1e-6:
        return None, None
    return u, res.x[:n]
