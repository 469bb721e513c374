"""Verbatim copy of ``repro/core/traces.py``,
imports rewritten to ``repro_torch``.

Workload traces and QPS priors.

The paper evaluates on (i) a Twitter-timestamp-derived diurnal trace (BERT
workload) and (ii) an Azure-Functions invocation trace (Llama workload), both
scaled to a target peak QPS, plus a simplified spiky trace for the
degradation study (Figs. 8/9). We generate statistically matched synthetic
equivalents (bursty log-normal base + diurnal modulation + Pareto spikes),
seeded and deterministic. The planner's default QPS prior is Zipfian over
QPS ranges (App. C.2).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def zipf_prior(n_ranges: int, s: float = 1.5) -> np.ndarray:
    """Weight of each QPS range (range 0 = lowest QPS = most frequent)."""
    # explicit ValueError, not assert: validation must survive python -O
    if n_ranges < 1:
        raise ValueError(f"n_ranges must be >= 1, got {n_ranges}")
    w = 1.0 / np.arange(1, n_ranges + 1, dtype=np.float64) ** s
    return w / w.sum()


def scale_to_peak(qps: np.ndarray, peak: float) -> np.ndarray:
    qps = np.asarray(qps, np.float64)
    return qps * (peak / max(qps.max(), 1e-9))


def azure_like_trace(seconds: int = 1200, peak_qps: float = 60.0,
                     seed: int = 0) -> np.ndarray:
    """Bursty serverless-style trace: log-normal base load with Pareto
    spikes and second-scale burstiness (cf. Shahrad et al. 2020)."""
    if seconds < 1:
        raise ValueError(f"trace length must be >= 1 second, got {seconds}")
    rng = np.random.default_rng(seed)
    t = np.arange(seconds, dtype=np.float64)
    # bursty base load: geometric random walk (damped so the drift stays
    # O(1) over the window) modulated by a slow oscillation
    walk = rng.normal(0.0, 0.45, seconds).cumsum() * 0.1
    base = np.exp(walk + np.sin(2 * np.pi * t / 600.0) * 0.5)
    noise = np.exp(rng.normal(0, 0.35, seconds))
    spikes = np.zeros(seconds)
    n_spikes = max(3, seconds // 240)
    for _ in range(n_spikes):
        start = rng.integers(0, max(seconds - 30, 1))
        dur = int(rng.pareto(1.5) * 5) + 5
        spikes[start:start + dur] += rng.pareto(1.2) + 1.5
    qps = base * noise * (1.0 + spikes)
    qps = np.convolve(qps, np.ones(3) / 3, mode="same")  # light smoothing
    return scale_to_peak(qps, peak_qps)


def diurnal_like_trace(seconds: int = 1200, peak_qps: float = 7600.0,
                       seed: int = 1) -> np.ndarray:
    """Twitter-style trace: diurnal curve compressed into the window plus
    heavy-tailed minute-scale bursts."""
    if seconds < 1:
        raise ValueError(f"trace length must be >= 1 second, got {seconds}")
    rng = np.random.default_rng(seed)
    t = np.arange(seconds, dtype=np.float64)
    diurnal = 0.55 + 0.45 * np.sin(2 * np.pi * t / seconds - np.pi / 2)
    bursts = np.ones(seconds)
    for _ in range(max(4, seconds // 180)):
        start = rng.integers(0, max(seconds - 20, 1))
        dur = int(rng.pareto(1.8) * 8) + 4
        bursts[start:start + dur] *= 1.0 + rng.pareto(1.4)
    noise = np.exp(rng.normal(0, 0.25, seconds))
    return scale_to_peak(diurnal * bursts * noise, peak_qps)


def spiky_trace(seconds: int = 120, base_qps: float = 400.0,
                spike_qps: float = 4000.0, spike_at: Optional[list] = None,
                spike_len: int = 10) -> np.ndarray:
    """Simplified step trace for the degradation study (Figs. 8/9):
    flat base load with rectangular spikes."""
    if seconds < 1:
        raise ValueError(f"trace length must be >= 1 second, got {seconds}")
    qps = np.full(seconds, base_qps, np.float64)
    spike_at = spike_at if spike_at is not None else [seconds // 3,
                                                      2 * seconds // 3]
    for i, s in enumerate(spike_at):
        amp = spike_qps * (0.6 if i == 0 else 1.0)
        qps[s:s + spike_len] = amp
    return qps


def ramp_trace(seconds: int = 600, start_qps: float = 100.0,
               end_qps: float = 1000.0) -> np.ndarray:
    """Linear load ramp (capacity-planning staple: find the knee)."""
    if seconds < 1:
        raise ValueError(f"trace length must be >= 1 second, got {seconds}")
    return np.linspace(start_qps, end_qps, seconds, dtype=np.float64)


def flash_crowd_trace(seconds: int = 600, base_qps: float = 200.0,
                      peak_qps: float = 2000.0, at: Optional[int] = None,
                      rise: int = 10, fall: int = 60) -> np.ndarray:
    """Flash crowd: steady base load, a steep ``rise``-second surge to
    ``peak_qps`` at ``at``, then an exponential ``fall``-second decay back
    to base (the multi-tenant bench's 2.5x surge, as a reusable shape)."""
    if seconds < 1:
        raise ValueError(f"trace length must be >= 1 second, got {seconds}")
    if rise < 1 or fall < 1:
        raise ValueError(f"rise/fall must be >= 1, got {rise}/{fall}")
    at = seconds // 3 if at is None else int(at)
    t = np.arange(seconds, dtype=np.float64)
    qps = np.full(seconds, base_qps, np.float64)
    up = (t >= at) & (t < at + rise)
    qps[up] = base_qps + (peak_qps - base_qps) * (t[up] - at + 1) / rise
    down = t >= at + rise
    qps[down] = base_qps + (peak_qps - base_qps) * np.exp(
        -(t[down] - at - rise) / fall)
    return qps


def diurnal_noise_trace(days: int = 7, day_seconds: int = 600,
                        peak_qps: float = 2000.0, trough_frac: float = 0.25,
                        noise: float = 0.15, seed: int = 0) -> np.ndarray:
    """A multi-day diurnal cycle with log-normal noise: ``days`` sinusoidal
    day curves (trough at ``trough_frac * peak``), each compressed into
    ``day_seconds`` simulated seconds — the 'simulated week' of the elastic
    provisioning study (ROADMAP: $/M-requests elastic vs static)."""
    if days < 1:
        raise ValueError(f"days must be >= 1, got {days}")
    if day_seconds < 2:
        raise ValueError(f"day_seconds must be >= 2, got {day_seconds}")
    if not 0.0 < trough_frac <= 1.0:
        raise ValueError(f"trough_frac must be in (0, 1], got {trough_frac}")
    rng = np.random.default_rng(seed)
    seconds = days * day_seconds
    t = np.arange(seconds, dtype=np.float64)
    mid = 0.5 * (1.0 + trough_frac)
    amp = 0.5 * (1.0 - trough_frac)
    diurnal = mid + amp * np.sin(2 * np.pi * t / day_seconds - np.pi / 2)
    jitter = np.exp(rng.normal(0.0, noise, seconds))
    return scale_to_peak(diurnal * jitter, peak_qps)


def measured_qps_distribution(trace: np.ndarray, n_ranges: int,
                              qps_max: float) -> np.ndarray:
    """Empirical time-in-range distribution of a trace (used to re-plan when
    the Zipf assumption deviates; App. C.2)."""
    if n_ranges < 1:
        raise ValueError(f"n_ranges must be >= 1, got {n_ranges}")
    if qps_max <= 0:
        raise ValueError(f"qps_max must be positive, got {qps_max}")
    if not len(trace):
        raise ValueError("cannot measure a QPS distribution of an empty "
                         "trace")
    width = qps_max / n_ranges
    idx = np.clip((np.asarray(trace) / width).astype(int), 0, n_ranges - 1)
    return np.bincount(idx, minlength=n_ranges) / len(trace)
