"""The ZeRO-1 sharded learner (counterpart of the JAX package's
``parallel/zero.py`` and ``alg/zero_epochs.py``).

The replicated data-parallel learner (``alg/ppo.py``) all-reduces each
minibatch's gradient and keeps the whole AdamW state on every rank. Here the
optimizer step is sharded over the ranks, with the JAX package's
collective schedule:

  * the parameters are laid out as one f32 flat vector, zero-padded to a
    multiple of the world size ``d`` (``FlatLayout``); rank ``r`` owns
    elements ``[r N/d, (r+1) N/d)``;
  * each rank's gradient (of its part of the minibatch, a local mean) is
    flattened and ``reduce_scatter``-ed: the rank receives its chunk of the
    sum, divided by ``d`` (the mean over the whole minibatch);
  * the global-norm clip is a chunk-local square sum plus one scalar
    all-reduce, with the JAX package's ``g * c / max(norm, c)`` at
    ``zero_clip_norm`` 0.5;
  * AdamW (eps 1e-5, weight decay 0.01) steps on the rank's chunk only, so
    its moments are ``2N/d`` a rank;
  * the updated chunks are ``all_gather``-ed and copied into the replicated
    parameters;
  * the watch record's per-leaf square sums and histogram counts are
    recovered from the chunk by each element's leaf (``FlatLayout.segments``)
    and summed over the ranks.

It engages where the JAX package engages it (``zero_eligible``): more than
one rank, the shard-local ``grouped`` shuffle, and no BatchNorm statistics.
The fused trainer's step dispatch runs it with its lr as a device tensor
(``lr=``); its scan dispatch is not run over ranks.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .ppo import GradWatch

# The inner optimizer's settings (the JAX package's ``optax.adamw`` there).
ADAM_EPS = 1e-5
WEIGHT_DECAY = 0.01


def zero_eligible(requested: bool, world: int, shuffle: str, has_batch_stats: bool) -> bool:
    """The JAX package's rule: ZeRO runs when it is requested, over more
    than one rank, with the grouped shuffle and no batch statistics."""
    return bool(requested) and world > 1 and shuffle == "grouped" and not has_batch_stats


class FlatLayout:
    """The flat f32 vector of a list of tensors, padded to a multiple of
    ``world``: leaf sizes, total, padded length and each rank's chunk."""

    def __init__(self, tensors, world: int):
        self.shapes = [t.shape for t in tensors]
        self.sizes = [t.numel() for t in tensors]
        self.total = sum(self.sizes)
        self.padded = -(-self.total // world) * world
        self.world = world
        self.chunk = self.padded // world

    def flatten(self, tensors) -> torch.Tensor:
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
        return torch.nn.functional.pad(flat, (0, self.padded - self.total))

    def unflatten(self, flat: torch.Tensor) -> list:
        return [c.view(shape) for c, shape in
                zip(flat[:self.total].split(self.sizes), self.shapes)]

    def bounds(self, rank: int):
        return rank * self.chunk, (rank + 1) * self.chunk

    def segments(self, rank: int, device) -> torch.Tensor:
        """Each element's leaf index on rank ``rank``'s chunk; the padding
        is leaf ``len(sizes)``."""
        ids = torch.repeat_interleave(torch.arange(len(self.sizes) + 1),
                                      torch.tensor(self.sizes + [self.padded - self.total]))
        lo, hi = self.bounds(rank)
        return ids[lo:hi].to(device)


class ZeroOptimizer:
    """The sharded clip-and-AdamW step over ``dp``'s ranks; the same
    surface as ``alg.ppo.PPOOptimizer`` (``zero_grad``, ``step(watch)``
    returning the pre-clip norm, ``count``). The lr comes from
    ``lr_schedule(count)`` or, for the fused trainer, from the 0-d device
    tensor ``lr`` that the caller sets."""

    def __init__(self, params, dp, lr_schedule: Optional[Callable[[int], float]] = None,
                 lr: Optional[float] = None, clip_norm: float = 0.5, eps: float = ADAM_EPS,
                 weight_decay: float = WEIGHT_DECAY):
        self.params = [p for p in params if p.requires_grad]
        self.dp = dp
        self.coll = dp.coll
        self.lr_schedule = lr_schedule
        self.clip_norm = clip_norm
        self.count = 0
        device = self.params[0].device
        self.layout = FlatLayout(self.params, dp.world)
        self.lo, self.hi = self.layout.bounds(dp.rank)
        self.segments = self.layout.segments(dp.rank, device)
        self.shard = torch.nn.Parameter(self.layout.flatten(self.params)[self.lo:self.hi].clone())
        if lr_schedule is None:
            self.lr = torch.full((), lr, dtype=torch.float32, device=device)
            first_lr = self.lr
        else:
            first_lr = lr_schedule(0)
        self.adamw = torch.optim.AdamW([self.shard], lr=first_lr, eps=eps,
                                       weight_decay=weight_decay, foreach=False)
        self.adamw.state[self.shard] = {
            "step": torch.zeros((), dtype=torch.float32),
            "exp_avg": torch.zeros_like(self.shard, memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(self.shard, memory_format=torch.preserve_format),
        }

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self, watch: Optional[GradWatch] = None) -> torch.Tensor:
        """Reduce-scatter, clip, step the chunk, all-gather; returns the
        pre-clip global norm."""
        coll, world = self.coll, self.dp.world
        gshard = coll.reduce_scatter(self.layout.flatten([p.grad for p in self.params]))
        gshard = gshard / world
        norm = torch.sqrt(coll.all_reduce(gshard.square().sum()))
        if watch is not None:
            watch.add_shard(gshard, self.segments, coll)
        clip = self.clip_norm
        gshard = gshard * (clip / torch.clamp(norm, min=clip))
        with torch.no_grad():
            self.shard.copy_(self.layout.flatten(self.params)[self.lo:self.hi])
        self.shard.grad = gshard
        if self.lr_schedule is not None:
            self.adamw.param_groups[0]["lr"] = self.lr_schedule(self.count)
        self.adamw.step()
        self.count += 1
        full = coll.all_gather(self.shard.detach())
        with torch.no_grad():
            for p, new in zip(self.params, self.layout.unflatten(full)):
                p.copy_(new)
        return norm.detach()

    def state_tensors(self) -> dict:
        """This rank's AdamW state (the fused trainer's ``state_tensors``)."""
        return {f"zero/{k}": v for k, v in self.adamw.state[self.shard].items()}

    def state_dict(self) -> dict:
        """AdamW's state over the whole parameter list, gathered from the
        ranks: the layout of ``torch.optim.AdamW(params).state_dict()``, so
        any world, ZeRO or replicated, resumes from it. Every rank calls it."""
        state = self.adamw.state[self.shard]
        moments = {k: self.layout.unflatten(self.coll.all_gather(state[k].detach()))
                   for k in ("exp_avg", "exp_avg_sq")}
        group = {k: v for k, v in self.adamw.param_groups[0].items() if k != "params"}
        if isinstance(group["lr"], torch.Tensor):
            group["lr"] = float(group["lr"])
        return {
            "state": {i: {"step": state["step"].detach().cpu().clone(),
                          "exp_avg": moments["exp_avg"][i].cpu().clone(),
                          "exp_avg_sq": moments["exp_avg_sq"][i].cpu().clone()}
                      for i in range(len(self.params))},
            "param_groups": [{**group, "params": list(range(len(self.params)))}],
        }

    def load_state_dict(self, saved: dict) -> None:
        """This rank's chunk of a ``state_dict`` (of any world or learner)."""
        state = self.adamw.state[self.shard]
        if not saved["state"]:
            return
        entries = [saved["state"][i] for i in range(len(self.params))]
        dev = self.shard.device
        with torch.no_grad():
            for k in ("exp_avg", "exp_avg_sq"):
                flat = self.layout.flatten([e[k].to(dev) for e in entries])
                state[k].copy_(flat[self.lo:self.hi])
            state["step"].copy_(entries[0]["step"])
