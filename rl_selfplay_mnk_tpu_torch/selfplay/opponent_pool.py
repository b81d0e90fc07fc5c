"""Opponent pools: FIFO eviction + uniform sampling (counterpart of the JAX
package's ``selfplay/opponent_pool.py``).

Two implementations:

  * ``DevicePool``: the device-resident ring buffer of the fused trainer
    (``alg/fused.py``). K state dicts stacked into (K, ...) tensors, a ring
    pointer, and per-slot weights, league scores and game counts, all on
    the device. Inserts, draws and league records are tensor operations
    that read nothing on the host, so they run inside a CUDA graph: a
    predicate is a 0-d bool tensor, a slot a 0-d integer tensor. Unlike the
    JAX package's functions, which return a new pool, these update the
    pool's tensors in place (a captured graph replays on fixed buffers);
    an insert writes only the chosen slot.
  * ``OpponentPool``: the host pool of the host loop (``train.py``).
    Members are whatever the caller stores; the trainer stores
    BatchNorm-folded model snapshots. ``weighted=True``: sampling
    proportional to each member's weight; ``eviction="adaptive"``: once
    full, evict the LOWEST-weight member instead of the oldest.

The league's host twin is ``selfplay/league.py``.
"""

from __future__ import annotations

import dataclasses
import random
from collections import deque
from typing import Any, Dict, Optional, Tuple

import torch

from .league import MATCHMAKING_MODES

EVICTION_POLICIES = ("fifo", "adaptive")


@dataclasses.dataclass
class DevicePool:
    """Ring buffer of K state dicts on the device.

    stacked:  name -> (K, ...) tensor, one per entry of the learner's
              ``state_dict()`` (parameters and BatchNorm running statistics,
              the JAX pool's ``{"params", "batch_stats"}``)
    size:     () int32, valid entries (<= K)
    next_idx: () int32, the ring's insertion slot
    weights:  (K,) float32 sampling weights (all ones = uniform)
    scores:   (K,) float32 per-slot EMA of the learner's score against the
              member (0.5 = the even-match prior); drives league draws
    games:    (K,) float32 per-slot count of recorded results
    """

    stacked: Dict[str, torch.Tensor]
    size: torch.Tensor
    next_idx: torch.Tensor
    weights: torch.Tensor
    scores: torch.Tensor
    games: torch.Tensor

    @property
    def max_size(self) -> int:
        return self.weights.shape[0]

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor of the pool by a flat name (checkpoints, tests)."""
        out = {f"stacked/{k}": v for k, v in self.stacked.items()}
        out.update(size=self.size, next_idx=self.next_idx, weights=self.weights,
                   scores=self.scores, games=self.games)
        return out


def pool_init(template: Dict[str, torch.Tensor], max_size: int) -> DevicePool:
    """An empty pool shaped like ``template`` (one state dict), on its device."""
    device = next(iter(template.values())).device
    return DevicePool(
        stacked={k: torch.zeros((max_size,) + tuple(v.shape), dtype=v.dtype, device=device)
                 for k, v in template.items()},
        size=torch.zeros((), dtype=torch.int32, device=device),
        next_idx=torch.zeros((), dtype=torch.int32, device=device),
        weights=torch.ones((max_size,), dtype=torch.float32, device=device),
        scores=torch.full((max_size,), 0.5, dtype=torch.float32, device=device),
        games=torch.zeros((max_size,), dtype=torch.float32, device=device),
    )


def _insert_slot(pool: DevicePool, eviction: str) -> torch.Tensor:
    """(1,) int64: the slot of the next insert. FIFO: the ring pointer;
    adaptive: once full, the lowest weight (the first of ties)."""
    if eviction not in EVICTION_POLICIES:
        raise ValueError(f"unknown eviction policy {eviction!r}; choose from {EVICTION_POLICIES}")
    idx = pool.next_idx
    if eviction == "adaptive":
        full = pool.size >= pool.max_size
        idx = torch.where(full, torch.argmin(pool.weights).to(torch.int32), idx)
    return idx.to(torch.int64).view(1)


def _tensor(x, like: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` as a tensor on ``like``'s device; a Python number is filled in
    on the device (no host-to-device copy, which a graph capture refuses)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return like.new_full((), x, dtype=dtype)


def _set_slot(t: torch.Tensor, idx: torch.Tensor, value, keep: Optional[torch.Tensor] = None):
    """t[idx] = value (or, with ``keep``, t[idx] where ``keep`` is True), in place."""
    value = _tensor(value, t, t.dtype)
    if keep is not None:
        value = torch.where(keep, t.index_select(0, idx)[0], value)
    t.index_copy_(0, idx, value.expand(t.shape[1:])[None])


def pool_add_if(pool: DevicePool, state: Dict[str, torch.Tensor], weight, do_insert,
                eviction: str = "fifo") -> DevicePool:
    """Insert ``state`` where the 0-d bool ``do_insert`` holds; the write
    touches only the eviction slot (``where`` on that slot, not over the
    whole pool). A fresh member starts at the even-match score prior."""
    do_insert = _tensor(do_insert, pool.size, torch.bool)
    keep = ~do_insert
    idx = _insert_slot(pool, eviction)
    for k, s in pool.stacked.items():
        _set_slot(s, idx, state[k], keep)
    _set_slot(pool.weights, idx, weight, keep)
    _set_slot(pool.scores, idx, 0.5, keep)
    _set_slot(pool.games, idx, 0.0, keep)
    k = pool.max_size
    pool.size.copy_(torch.where(do_insert, torch.clamp(pool.size + 1, max=k), pool.size))
    pool.next_idx.copy_(torch.where(do_insert, (pool.next_idx + 1) % k, pool.next_idx))
    return pool


def pool_add(pool: DevicePool, state: Dict[str, torch.Tensor], weight=1.0,
             eviction: str = "fifo") -> DevicePool:
    """Insert ``state``: overwrite the eviction slot once full (FIFO by
    default, ``deque(maxlen)`` semantics)."""
    return pool_add_if(pool, state, weight, True, eviction)


def pool_member(pool: DevicePool, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The state dict in slot ``idx`` (a 0-d integer tensor): a gather."""
    idx = idx.to(torch.int64).view(1)
    return {k: s.index_select(0, idx)[0] for k, s in pool.stacked.items()}


def sample_slot(pool: DevicePool, logits: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """int64 of ``gumbel``'s leading shape: gumbel-max over the (K,)
    ``logits`` (``jax.random.categorical``) restricted to the valid slots;
    an empty pool falls back to slot 0's logits of zero."""
    valid = torch.arange(pool.max_size, device=logits.device) < pool.size
    logits = torch.where(valid, logits, torch.full_like(logits, float("-inf")))
    logits = torch.where(pool.size > 0, logits, torch.zeros_like(logits))
    return torch.argmax(logits + gumbel, dim=-1)


def pool_logits(pool: DevicePool) -> torch.Tensor:
    """Plain draws: log of the slot weights."""
    return torch.log(torch.clamp(pool.weights, min=1e-30))


def pfsp_slot_weights(scores: torch.Tensor, mode: str, power: float = 2.0) -> torch.Tensor:
    """The league's PFSP weight of every slot (``selfplay.league.pfsp_weight``
    over the slot axis, with its 1e-3 floor)."""
    s = torch.clamp(scores, 0.0, 1.0)
    if mode == "pfsp_hard":
        w = (1.0 - s) ** power
    elif mode == "pfsp_even":
        w = (4.0 * s * (1.0 - s)) ** power
    elif mode == "uniform":
        w = torch.ones_like(s)
    else:
        raise ValueError(f"unknown matchmaking mode {mode!r}; choose from {MATCHMAKING_MODES}")
    return torch.clamp(w, min=1e-3)


def league_logits(pool: DevicePool, mode: str, power: float = 2.0) -> torch.Tensor:
    """League draws: log of the PFSP weights of the slots' scores."""
    return torch.log(pfsp_slot_weights(pool.scores, mode, power))


def draw_opponent(pool: DevicePool, u: torch.Tensor, pool_prob: float,
                  matchmaking: Optional[str] = None, power: float = 2.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused trainer's opponent draw from uniforms ``u`` of shape
    (..., 1 + K): historical where ``u[..., 0] < pool_prob`` and the pool is
    not empty, and the slot by gumbel-max (``sample_slot``) with the noise
    ``-log(-log(u[..., 1:]))`` over the plain logits (``pool_logits``) or,
    with ``matchmaking``, the league's (``league_logits``; the device twin
    of ``League.get_opponent``). Returns (historical, slot): bool and int64
    of ``u``'s leading shape."""
    if matchmaking:
        logits = league_logits(pool, matchmaking, power)
    else:
        logits = pool_logits(pool)
    gumbel = -torch.log(-torch.log(u[..., 1:].clamp(min=torch.finfo(torch.float32).tiny)))
    return (u[..., 0] < pool_prob) & (pool.size > 0), sample_slot(pool, logits, gumbel)


def pool_record_result_if(pool: DevicePool, idx: torch.Tensor, score, do_record,
                          ema: float = 0.3) -> DevicePool:
    """Fold one outcome (the learner's score in [0, 1] against slot ``idx``)
    into that slot's EMA where the 0-d bool ``do_record`` holds; a
    non-finite score records nothing (``League.record_result``)."""
    score = torch.clamp(_tensor(score, pool.scores, torch.float32), 0.0, 1.0)
    ok = _tensor(do_record, pool.scores, torch.bool) & torch.isfinite(score)
    idx = idx.to(torch.int64).view(1)
    old = pool.scores.index_select(0, idx)[0]
    _set_slot(pool.scores, idx, torch.where(ok, (1.0 - ema) * old + ema * score, old))
    played = pool.games.index_select(0, idx)[0]
    _set_slot(pool.games, idx, torch.where(ok, played + 1.0, played))
    return pool


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
