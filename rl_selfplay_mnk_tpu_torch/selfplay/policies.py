"""Policies: an ``apply`` function plus its parameters.

Counterpart of the JAX package's ``selfplay/policies.py``. A policy's act
signature is ``apply(params, obs, generator, deterministic) -> actions``
with ``obs = {"observation": (E, 2, M, N) f32, "action_mask": (E, A) bool}``
and int64 actions. A network policy's params are a frozen snapshot of a
model (``models.fold_bn.snapshot``: BatchNorm folded where the model has
it, a plain copy for a transformer); its forward is eval mode. A block
policy's params are K snapshots, each playing one contiguous block of the
env batch (``make_block_pooled_policy`` in the JAX package).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch

from ..ops.masked import mask_logits, masked_argmax, masked_sample, random_masked_actions


@dataclasses.dataclass
class Policy:
    """``apply(params, obs, generator, deterministic) -> actions``; the
    sampling noise comes from ``generator``."""

    apply: Callable[..., torch.Tensor]
    params: Any = None
    generator: Optional[torch.Generator] = None
    # A data-parallel rank's env rows (``parallel.mesh.EnvShard``): the
    # policy plays those rows of the global batch, and its sampling noise is
    # those rows of a draw over the whole batch.
    shard: Any = None

    def act(self, obs: dict, deterministic: bool = False) -> torch.Tensor:
        if self.shard is None:
            return self.apply(self.params, obs, self.generator, deterministic)
        return self.apply(self.params, obs, self.generator, deterministic, shard=self.shard)


def _shard_noise(shard, mask: torch.Tensor, generator, deterministic: bool):
    if shard is None or deterministic:
        return None
    return shard.uniform(mask.shape[1:], generator, mask.device)


def _random_act(params, obs, generator=None, deterministic=False, shard=None):
    del params
    mask = obs["action_mask"]
    return random_masked_actions(mask, generator, deterministic,
                                 _shard_noise(shard, mask, generator, deterministic))


def RandomPolicy(generator: Optional[torch.Generator] = None) -> Policy:
    """Uniform-over-legal policy."""
    return Policy(apply=_random_act, params=None, generator=generator)


@functools.lru_cache(maxsize=None)
def make_network_policy(network_apply: Callable) -> Callable:
    """Lift ``network_apply(model, observation, mask) -> (logits, value)``
    into a policy act function: mask, then sample or take the argmax."""

    def act(params, obs, generator=None, deterministic=False, shard=None):
        logits, _ = network_apply(params, obs["observation"], obs["action_mask"])
        logits = mask_logits(logits, obs["action_mask"])
        if deterministic:
            return masked_argmax(logits)
        return masked_sample(logits, generator,
                             _shard_noise(shard, obs["action_mask"], generator, deterministic))

    return act


def NNPolicy(network_apply: Callable, model, generator: Optional[torch.Generator] = None) -> Policy:
    """Policy over a network. Pass a snapshot: a model with BatchNorm that
    is not folded yet folds anew on every eval forward."""
    return Policy(apply=make_network_policy(network_apply), params=model, generator=generator)


@functools.lru_cache(maxsize=None)
def make_block_policy(network_apply: Callable, num_blocks: int) -> Callable:
    """Lift ``network_apply`` into an act function over ``num_blocks``
    snapshots: block i of the env batch, envs [i E / K, (i + 1) E / K),
    plays snapshot i in one eval forward of E / K boards; the masked logits
    are put back in env order and one sample (or argmax) is drawn over the
    whole batch. ``noise`` injects the sample's (E, A) uniforms. With
    ``shard`` the rows are a rank's part of the global batch, whose blocks
    they fall into."""

    def act(params, obs, generator=None, deterministic=False, noise=None, shard=None):
        observation, mask = obs["observation"], obs["action_mask"]
        e = observation.shape[0]
        start, total = (0, e) if shard is None else (shard.start, shard.total)
        if len(params) != num_blocks or total % num_blocks:
            raise ValueError(f"{total} envs do not split into {num_blocks} blocks over "
                             f"{len(params)} opponents")
        per = total // num_blocks
        parts = []
        for i, model in enumerate(params):
            lo, hi = max(i * per, start) - start, min((i + 1) * per, start + e) - start
            if lo < hi:
                parts.append(mask_logits(network_apply(model, observation[lo:hi],
                                                       mask[lo:hi])[0], mask[lo:hi]))
        logits = torch.cat(parts)
        if deterministic:
            return masked_argmax(logits)
        if noise is None:
            noise = _shard_noise(shard, mask, generator, deterministic)
        return masked_sample(logits, generator, noise)

    return act


def BlockPolicy(network_apply: Callable, models, generator: Optional[torch.Generator] = None) -> Policy:
    """K snapshots, each playing its own block of the env batch."""
    return Policy(apply=make_block_policy(network_apply, len(models)), params=list(models),
                  generator=generator)
