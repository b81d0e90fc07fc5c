"""League matchmaking over the opponent pool: prioritized fictitious
self-play (PFSP).

Counterpart of the JAX package's ``selfplay/league.py``, with the same
arithmetic and the same draws from a ``random.Random(seed)``. Each member
keeps an exponential moving average of the learner's score against it (0 =
the learner always loses, 1 = it always wins), and the draw weights follow
the mode:

  * ``"uniform"``: p ∝ 1;
  * ``"pfsp_hard"``: p ∝ (1 - s)^power, the members the learner still loses to;
  * ``"pfsp_even"``: p ∝ (4 s (1 - s))^power, the evenly matched ones.

A new member starts at s = 0.5. Weights are floored at 1e-3.
"""

from __future__ import annotations

import math
import random
from typing import Any, List, Optional, Tuple

MATCHMAKING_MODES = ("uniform", "pfsp_hard", "pfsp_even")


def pfsp_weight(score: float, mode: str, power: float = 2.0) -> float:
    """The draw weight of a member the learner scores ``score`` in [0, 1]
    against."""
    s = min(max(score, 0.0), 1.0)
    if mode == "pfsp_hard":
        w = (1.0 - s) ** power
    elif mode == "pfsp_even":
        w = (4.0 * s * (1.0 - s)) ** power
    elif mode == "uniform":
        w = 1.0
    else:
        raise ValueError(f"unknown matchmaking mode {mode!r}; choose from {MATCHMAKING_MODES}")
    return max(w, 1e-3)


class LeagueEntry:
    __slots__ = ("entry_id", "params", "score_ema", "games")

    def __init__(self, entry_id: int, params: Any):
        self.entry_id = entry_id
        self.params = params
        self.score_ema = 0.5
        self.games = 0


class League:
    """A FIFO roster of ``max_size`` members with PFSP draws and results.
    ``OpponentPool``'s surface plus ``get_opponent() -> (entry_id, params)``
    and ``record_result(entry_id, score)``."""

    def __init__(self, max_size: int = 5, mode: str = "pfsp_even", power: float = 2.0,
                 ema: float = 0.3, seed: Optional[int] = None):
        if mode not in MATCHMAKING_MODES:
            raise ValueError(f"unknown matchmaking mode {mode!r}; choose from {MATCHMAKING_MODES}")
        self.max_size = max_size
        self.mode = mode
        self.power = power
        self.ema = ema
        self.entries: List[LeagueEntry] = []
        self._next_id = 0
        self._rng = random.Random(seed)

    def add_opponent(self, params: Any, weight: float = 1.0) -> int:
        """Add a member at the even-match prior (``weight`` is taken for
        ``OpponentPool``'s surface and not used); the oldest goes past
        ``max_size``."""
        del weight
        entry = LeagueEntry(self._next_id, params)
        self._next_id += 1
        self.entries.append(entry)
        if len(self.entries) > self.max_size:
            self.entries.pop(0)
        return entry.entry_id

    def size(self) -> int:
        return len(self.entries)

    def get_random_opponent(self) -> Optional[Any]:
        drawn = self.get_opponent()
        return None if drawn is None else drawn[1]

    def weights(self) -> List[float]:
        return [pfsp_weight(e.score_ema, self.mode, self.power) for e in self.entries]

    def get_opponent(self) -> Optional[Tuple[int, Any]]:
        if not self.entries:
            return None
        entry = self._rng.choices(self.entries, weights=self.weights())[0]
        return entry.entry_id, entry.params

    def record_result(self, entry_id: int, score: float) -> None:
        """Fold one outcome (the learner's score in [0, 1]) into the member's
        average; an id no longer on the roster is ignored."""
        if not math.isfinite(score):
            return
        score = min(max(float(score), 0.0), 1.0)
        for e in self.entries:
            if e.entry_id == entry_id:
                e.score_ema = (1.0 - self.ema) * e.score_ema + self.ema * score
                e.games += 1
                return
