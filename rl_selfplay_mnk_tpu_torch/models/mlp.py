"""Tiny MLP actor-critic (counterpart of the JAX package's ``models/mlp.py``):
the flattened (plane, m, n) observation through one orthogonal
Linear(hidden)-ReLU, then the shared heads on that single token.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .common import ActorCriticHeads, linear


class MlpActorCritic(nn.Module):
    def __init__(self, action_dim: int, obs_shape, hidden: int = 64, head_hidden: int = 64,
                 dtype=torch.float32):
        super().__init__()
        planes, m, n = obs_shape
        self.dtype = dtype
        self.dense = nn.Linear(planes * m * n, hidden)
        self.heads = ActorCriticHeads(hidden, 1, action_dim, head_hidden)

    def forward(self, obs: torch.Tensor, train: bool = False):
        """(B, 2, M, N) observation -> (logits (B, A) f32, value (B, 1) f32)."""
        del train  # no batch-dependent layers
        x = torch.relu(linear(obs.reshape(obs.shape[0], -1), self.dense, self.dtype))
        return self.heads(x[:, None, :], self.dtype)
