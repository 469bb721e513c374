"""The traffic generator: a closed loop of bursts, drawn from the seed.

A traffic file gives the burst size and a clipped lognormal for prompt and
for output lengths. Every burst holds the same lengths: the lognormal's
quantiles at (i + 0.5) / burst, rounded and clipped. The seed draws each
burst's order of prompt lengths and, independently, of output lengths, and
every prompt's tokens, uniform over the vocabulary. So every seed and every
burst asks for the same work in another arrangement, and the seed changes
which requests a cascade escalates, not how much they ask for.
"""
from __future__ import annotations

from statistics import NormalDist
from typing import Iterator, List, Tuple

import numpy as np

__all__ = ["lengths", "bursts", "rng"]


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream of ``seed`` (any integer >= 0)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed),
                                                         stream]))


def lengths(spec: dict, n: int) -> np.ndarray:
    """n stratified draws of a clipped lognormal ({median, sigma, min,
    max}), ascending."""
    q = (np.arange(n) + 0.5) / n
    z = np.array([NormalDist().inv_cdf(float(p)) for p in q])
    x = np.rint(spec["median"] * np.exp(spec["sigma"] * z))
    return np.clip(x, spec["min"], spec["max"]).astype(np.int64)


def bursts(traffic: dict, seed: int, vocab: int, stream: int = 1
           ) -> Iterator[List[Tuple[np.ndarray, int]]]:
    """Endless bursts of (prompt (L,) int32, max_new) pairs, from numpy
    stream ``stream`` of the seed (1: the window's; 4: calibration's)."""
    n = int(traffic["burst"])
    prompts = lengths(traffic["prompt"], n)
    outputs = lengths(traffic["output"], n)
    r = rng(seed, stream)
    while True:
        p = r.permutation(prompts)
        o = r.permutation(outputs)
        yield [(r.integers(0, vocab, int(L), dtype=np.int64)
                .astype(np.int32), int(m)) for L, m in zip(p, o)]
