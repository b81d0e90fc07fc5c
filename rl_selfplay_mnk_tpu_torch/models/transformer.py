"""Board transformer actor-critic (counterpart of the JAX package's
``models/transformer.py``).

Per-cell embedding (a Linear over the two observation planes), a learned
positional embedding, then pre-norm encoder layers::

    x = x + MHA(LN(x));  x = x + FFN(LN(x))   # FFN = Linear(ffn)-ReLU-Linear(d)

with no final norm, and the shared heads on the (B, M*N, d) token features.
``ffn_dim`` None means 4 d, 0 means no FFN block; ``qkv_features`` None
means d.

The q/k/v/out projections are plain ``F.linear`` in the compute dtype with
f32 parameters; the attention itself is the module's ``attention_fn``,
by default ``ops.attention.tiny_head_attention`` (the CUDA kernels on the
card), as flax's ``attention_fn`` in the JAX package. The body has no batch-dependent layer, so
``train`` changes nothing.

Initialisation follows the JAX package (``models/registry.py::init_network``
reads each layer's ``init_scheme``): the body at flax's defaults, the cell
and positional embeddings normal(0.02), the heads orthogonal.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn

from ..ops.attention import tiny_head_attention
from .common import LAYER_NORM_EPS, ActorCriticHeads, layer_norm, linear


def dense(in_features: int, out_features: int, init_scheme: str) -> nn.Linear:
    """A Linear tagged with how ``init_network`` initialises it."""
    layer = nn.Linear(in_features, out_features)
    layer.init_scheme = init_scheme
    return layer


class MultiHeadAttention(nn.Module):
    """Self-attention with flax ``MultiHeadDotProductAttention``'s
    parameters: query/key/value (d -> qkv) and out (qkv -> d), all biased."""

    def __init__(self, embed_dim: int, num_heads: int, qkv_features: int,
                 attention_fn: Callable = tiny_head_attention):
        super().__init__()
        self.attention_fn = attention_fn
        if qkv_features % num_heads:
            raise ValueError(f"qkv_features {qkv_features} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.head_dim = qkv_features // num_heads
        self.query = dense(embed_dim, qkv_features, "lecun_normal")
        self.key = dense(embed_dim, qkv_features, "lecun_normal")
        self.value = dense(embed_dim, qkv_features, "lecun_normal")
        self.out = dense(qkv_features, embed_dim, "lecun_normal")

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        b, l, _ = x.shape
        shape = (b, l, self.num_heads, self.head_dim)
        q = linear(x, self.query, dtype).view(shape)
        k = linear(x, self.key, dtype).view(shape)
        v = linear(x, self.value, dtype).view(shape)
        o = self.attention_fn(q, k, v)
        return linear(o.reshape(b, l, -1), self.out, dtype)


class EncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: Optional[int] = None,
                 qkv_features: Optional[int] = None,
                 attention_fn: Callable = tiny_head_attention):
        super().__init__()
        self.ln1 = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)
        self.attn = MultiHeadAttention(embed_dim, num_heads, qkv_features or embed_dim,
                                       attention_fn)
        ffn = 4 * embed_dim if ffn_dim is None else ffn_dim
        self.has_ffn = ffn > 0
        if self.has_ffn:
            self.ln2 = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)
            self.dense1 = dense(embed_dim, ffn, "lecun_normal")
            self.dense2 = dense(ffn, embed_dim, "lecun_normal")

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        x = x + self.attn(layer_norm(x, self.ln1), dtype)
        if not self.has_ffn:
            return x
        h = torch.relu(linear(layer_norm(x, self.ln2), self.dense1, dtype))
        return x + linear(h, self.dense2, dtype)


class TokenEmbedding(nn.Module):
    """(B, 2, M, N) observation -> (B, M*N, d) tokens: per-cell embedding
    plus the positional embedding."""

    def __init__(self, obs_shape, embed_dim: int):
        super().__init__()
        planes, m, n = obs_shape
        self.cell_embed = dense(planes, embed_dim, "normal_0.02")
        self.pos_embed = nn.Parameter(torch.zeros(1, m * n, embed_dim))

    def forward(self, obs: torch.Tensor, dtype) -> torch.Tensor:
        b, c, m, n = obs.shape
        tokens = obs.permute(0, 2, 3, 1).reshape(b, m * n, c)
        return linear(tokens, self.cell_embed, dtype) + self.pos_embed.to(dtype)


class TransformerActorCritic(nn.Module):
    def __init__(self, action_dim: int, obs_shape, embed_dim: int = 128, num_layers: int = 4,
                 num_heads: int = 4, head_hidden: int = 256, dtype=torch.float32,
                 ffn_dim: Optional[int] = None, qkv_features: Optional[int] = None,
                 attention_fn: Callable = tiny_head_attention):
        super().__init__()
        _, m, n = obs_shape
        self.dtype = dtype
        self.num_heads = num_heads
        self.embed = TokenEmbedding(obs_shape, embed_dim)
        self.layers = nn.ModuleList(
            EncoderLayer(embed_dim, num_heads, ffn_dim, qkv_features, attention_fn)
            for _ in range(num_layers)
        )
        self.heads = ActorCriticHeads(embed_dim, m * n, action_dim, head_hidden)

    def forward(self, obs: torch.Tensor, train: bool = False):
        """(B, 2, M, N) observation -> (logits (B, A) f32, value (B, 1) f32)."""
        del train  # no batch-dependent layers in the body
        x = self.embed(obs, self.dtype)
        for layer in self.layers:
            x = layer(x, self.dtype)
        return self.heads(x, self.dtype)
