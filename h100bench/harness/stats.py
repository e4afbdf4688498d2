"""The benchmark's arithmetic: rates over a window, percentiles, seeds
derived by name, and a seeded sample of a stream."""

from __future__ import annotations

import hashlib
import math
import random
from typing import Any, List, Sequence


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for the draws named ``tag`` of run ``seed``, so that
    weights, inputs and the checked sample never share a stream."""
    return int.from_bytes(hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()[:8],
                          "little") >> 1


def rate(count: float, seconds: float) -> float:
    """Work over the whole window's wall time."""
    return count / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q`` percent
    of the values at or below it."""
    xs = sorted(values)
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    from ``seed`` (Algorithm R). ``offer(make)`` calls ``make()`` only for
    an item that enters the sample."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: List[Any] = []
        self.seen = 0

    def offer(self, make) -> None:
        i, self.seen = self.seen, self.seen + 1
        if i < self.k:
            self.items.append(make())
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.items[j] = make()
