"""SGR (stabilized gated residual) transformer actor-critic (counterpart of
the JAX package's ``models/sgr_transformer.py``).

Each block gates both residual branches with a sigmoid gate whose weights
start at zero and bias at 2.0 (sigmoid(2) ~ 0.88: mostly open at init)::

    a = MHA(LN(x));   x = x + sigmoid(gate1(a)) * a
    h = MLP(LN(x));   x = x + sigmoid(gate2(h)) * h      # MLP = Linear(4d)-GELU-Linear(d)

The GELU is the tanh approximation, which is flax's default (torch's
default is the exact one). ``attention_fn`` is as in ``models/transformer.py``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import tiny_head_attention
from .common import LAYER_NORM_EPS, ActorCriticHeads, layer_norm, linear
from .transformer import MultiHeadAttention, TokenEmbedding, dense


class SGRBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int,
                 attention_fn: Callable = tiny_head_attention):
        super().__init__()
        self.ln1 = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)
        self.attn = MultiHeadAttention(embed_dim, num_heads, embed_dim, attention_fn)
        self.gate1 = dense(embed_dim, embed_dim, "gate")
        self.ln2 = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)
        self.dense1 = dense(embed_dim, 4 * embed_dim, "lecun_normal")
        self.dense2 = dense(4 * embed_dim, embed_dim, "lecun_normal")
        self.gate2 = dense(embed_dim, embed_dim, "gate")

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        a = self.attn(layer_norm(x, self.ln1), dtype)
        x = x + torch.sigmoid(linear(a, self.gate1, dtype)) * a
        h = F.gelu(linear(layer_norm(x, self.ln2), self.dense1, dtype), approximate="tanh")
        h = linear(h, self.dense2, dtype)
        return x + torch.sigmoid(linear(h, self.gate2, dtype)) * h


class SGRTransformerActorCritic(nn.Module):
    def __init__(self, action_dim: int, obs_shape, embed_dim: int = 128, num_layers: int = 4,
                 num_heads: int = 4, head_hidden: int = 256, dtype=torch.float32,
                 attention_fn: Callable = tiny_head_attention):
        super().__init__()
        _, m, n = obs_shape
        self.dtype = dtype
        self.num_heads = num_heads
        self.embed = TokenEmbedding(obs_shape, embed_dim)
        self.layers = nn.ModuleList(
            SGRBlock(embed_dim, num_heads, attention_fn) for _ in range(num_layers)
        )
        self.heads = ActorCriticHeads(embed_dim, m * n, action_dim, head_hidden)

    def forward(self, obs: torch.Tensor, train: bool = False):
        """(B, 2, M, N) observation -> (logits (B, A) f32, value (B, 1) f32)."""
        del train  # no batch-dependent layers in the body
        x = self.embed(obs, self.dtype)
        for layer in self.layers:
            x = layer(x, self.dtype)
        return self.heads(x, self.dtype)
