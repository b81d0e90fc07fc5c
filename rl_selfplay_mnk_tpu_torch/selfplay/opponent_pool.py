"""Host opponent pool: FIFO eviction + uniform sampling.

Counterpart of the JAX package's host ``OpponentPool`` (its device-resident
``DevicePool`` is not ported yet; the league is ``selfplay/league.py``).
Members are whatever the caller stores; the trainer stores BatchNorm-folded
model snapshots.

  * ``weighted=True``: sampling proportional to each member's weight;
  * ``eviction="adaptive"``: once full, evict the LOWEST-weight member
    instead of the oldest.
"""

from __future__ import annotations

import random
from collections import deque
from typing import Any, Optional


class OpponentPool:
    def __init__(
        self,
        max_size: int = 5,
        seed: Optional[int] = None,
        weighted: bool = False,
        eviction: str = "fifo",
    ):
        if eviction not in ("fifo", "adaptive"):
            raise ValueError(f"unknown eviction policy {eviction!r}")
        self.max_size = max_size
        self.pool: deque = deque()
        self.weights: deque = deque()
        self.weighted = weighted
        self.eviction = eviction
        self._rng = random.Random(seed)

    def add_opponent(self, opponent: Any, weight: float = 1.0) -> None:
        if len(self.pool) >= self.max_size:
            if self.eviction == "adaptive":
                drop = min(range(len(self.weights)), key=self.weights.__getitem__)
            else:
                drop = 0
            del self.pool[drop]
            del self.weights[drop]
        self.pool.append(opponent)
        self.weights.append(max(float(weight), 1e-6))

    def get_random_opponent(self) -> Optional[Any]:
        if not self.pool:
            return None
        if self.weighted:
            return self._rng.choices(list(self.pool), weights=list(self.weights))[0]
        return self._rng.choice(list(self.pool))

    def size(self) -> int:
        return len(self.pool)
