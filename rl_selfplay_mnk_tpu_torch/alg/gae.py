"""Generalized Advantage Estimation (counterpart of the JAX package's
``alg/gae.py``), as a reverse loop over time:

    delta_t = r_t + gamma * V_{t+1} * (1 - done_t) - V_t
    gae_t   = delta_t + gamma * lambda * (1 - done_t) * gae_{t+1}
    returns = advantages + values
"""

from __future__ import annotations

import torch


def compute_gae(
    rewards: torch.Tensor,  # (T, E) f32
    values: torch.Tensor,  # (T, E) f32
    dones: torch.Tensor,  # (T, E) bool
    last_values: torch.Tensor,  # (E,) f32 bootstrap
    gamma: float,
    gae_lambda: float,
):
    """Returns (advantages, returns), both (T, E) f32."""
    nonterminal = 1.0 - dones.to(torch.float32)
    advantages = torch.empty_like(values)
    gae = torch.zeros_like(last_values)
    next_value = last_values
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_value * nonterminal[t] - values[t]
        gae = delta + gamma * gae_lambda * nonterminal[t] * gae
        advantages[t] = gae
        next_value = values[t]
    return advantages, advantages + values
