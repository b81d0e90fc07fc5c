"""LFM2-MoE (Liquid AI's ``lfm2_moe``) as a board actor-critic: one chip's
share of a layer whose experts are spread over several chips.

The body follows the published layer equations over the board's cells as
tokens: a cell embedding (a Linear over the two observation planes, its
bias drawn as an embedding row) plus a learned position embedding, as in
the board transformer (no vocabulary), then layers of::

    h = x + op(RMSNorm(x));   out = h + ffn(RMSNorm(h))

where ``op`` is the layer's type in ``layer_types``:

  * ``conv``: the gated short convolution, ``out_proj(C * conv_K(B * x'))``
    with ``B, C, x' = split3(in_proj(x))`` (``ops/short_conv.py``; causal
    over the cells in row-major order, K = ``conv_L_cache``, no biases);
  * ``full_attention``: q/k/v/out projections without bias, RMSNorm of each
    head of q and k, RoPE over the positions 0..L-1 in row-major order, and
    attention of ``num_heads`` query heads over ``num_kv_heads`` shared key
    and value heads (each KV head serves ``num_heads / num_kv_heads``
    consecutive query heads; k and v are repeated to every query head before
    the call). Attention is bidirectional over the board, as in every board
    network of the port: the published causal mask belongs to next-token
    prediction.

The position embedding is a departure: the published model places tokens
by its short convolutions and RoPE alone, which serve a vocabulary of
thousands of tokens. A board has three cell states, so without it every
empty cell embeds alike and stays nearly alike up to the first attention
layer; such a group of tokens takes the same experts and, near a tie of
the router's scores, leaves them together under a rounding, which moves a
board's outputs as much as float8 rounding does (PERF.md).

and ``ffn`` is a dense SwiGLU ``w2(silu(w1 x) * w3 x)`` in the first
``num_dense_layers`` layers and the expert layer after them
(``ops/moe.py``): a sigmoid router over all ``num_experts``, the top
``top_k`` by score plus ``expert_bias`` (a buffer that enters selection
only; its update rule is not published, so it stays 0), weights normalised
over the picks, and SwiGLU experts of which this chip holds
``experts_held = (first, count)``. A final RMSNorm feeds the shared heads.

Compute as in the board transformer: products and the residual stream in
the module's ``dtype`` (bf16 on the card) with f32 parameters; norm
statistics, the router and its weights, and the combine in f32.

A snapshot (an opponent, a pool entry, the benchmark) holds the matrices
that the bf16 products read in bf16 (``compact``); norms, biases, taps and
the router stay f32: the same bits in its forward, half the bytes.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import tiny_head_attention
from ..ops.layer_norm import rms_norm
from ..ops.moe import held_experts
from ..ops.short_conv import short_conv
from ..utils.tracing import span
from .common import ActorCriticHeads
from .transformer import dense


def proj(in_features: int, out_features: int) -> nn.Linear:
    layer = nn.Linear(in_features, out_features, bias=False)
    layer.init_scheme = "lecun_normal"
    return layer


def matmul(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype))


class RMSNorm(nn.Module):
    def __init__(self, width: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator) -> None:
    """flax's default kernel init with a stated fan-in (registry.py)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


class ShortConv(nn.Module):
    def __init__(self, d: int, taps: int):
        super().__init__()
        self.in_proj = proj(d, 3 * d)
        self.conv_weight = nn.Parameter(torch.zeros(d, taps))
        self.out_proj = proj(d, d)

    def init_weights(self, generator) -> None:
        _lecun_normal_(self.conv_weight, self.conv_weight.shape[1], generator)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        with span("short_conv"):
            y = short_conv(matmul(x, self.in_proj, dtype), self.conv_weight)
            return matmul(y, self.out_proj, dtype)


def rope_tables(length: int, head_dim: int, theta: float, device=None):
    """(cos, sin) (L, Dh) f32 of the default RoPE at positions 0..L-1, made
    on ``device`` (no copy from the host)."""
    f64 = dict(dtype=torch.float64, device=device)
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, **f64) / head_dim)
    freqs = torch.arange(length, **f64)[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(torch.float32), emb.sin().to(torch.float32)


def apply_rope(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """t (B, L, H, Dh) rotated in f32, rounded to t's dtype once."""
    tf = t.to(torch.float32)
    half = tf.shape[-1] // 2
    rotated = torch.cat([-tf[..., half:], tf[..., :half]], dim=-1)
    return (tf * cos[:, None, :] + rotated * sin[:, None, :]).to(t.dtype)


class GroupedQueryAttention(nn.Module):
    def __init__(self, d: int, heads: int, kv_heads: int, head_dim: int, theta: float,
                 eps: float):
        super().__init__()
        if heads % kv_heads:
            raise ValueError(f"{heads} query heads do not share {kv_heads} KV heads evenly")
        self.heads, self.kv_heads, self.head_dim, self.theta = heads, kv_heads, head_dim, theta
        self.q_proj = proj(d, heads * head_dim)
        self.k_proj = proj(d, kv_heads * head_dim)
        self.v_proj = proj(d, kv_heads * head_dim)
        self.out_proj = proj(heads * head_dim, d)
        self.q_layernorm = RMSNorm(head_dim, eps)
        self.k_layernorm = RMSNorm(head_dim, eps)
        self._rope = {}

    def rope(self, length: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (length, str(device))
        if key not in self._rope:
            self._rope[key] = rope_tables(length, self.head_dim, self.theta, device)
        return self._rope[key]

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        b, l, _ = x.shape
        dh = self.head_dim
        q = self.q_layernorm(matmul(x, self.q_proj, dtype).view(b, l, self.heads, dh))
        k = self.k_layernorm(matmul(x, self.k_proj, dtype).view(b, l, self.kv_heads, dh))
        v = matmul(x, self.v_proj, dtype).view(b, l, self.kv_heads, dh)
        cos, sin = self.rope(l, x.device)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        group = self.heads // self.kv_heads
        k, v = (t.repeat_interleave(group, dim=2) for t in (k, v))
        o = tiny_head_attention(q, k, v)
        return matmul(o.reshape(b, l, -1), self.out_proj, dtype)


class SwiGLU(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.w1 = proj(d, hidden)
        self.w3 = proj(d, hidden)
        self.w2 = proj(hidden, d)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        return matmul(F.silu(matmul(x, self.w1, dtype)) * matmul(x, self.w3, dtype), self.w2,
                      dtype)


class HeldExperts(nn.Module):
    """The router over all ``num_experts`` and the SwiGLU experts
    ``first .. first + count - 1`` of them, stacked: w1, w3 (count, F, D),
    w2 (count, D, F)."""

    def __init__(self, d: int, hidden: int, num_experts: int, held: Tuple[int, int],
                 top_k: int, scale: float):
        super().__init__()
        first, count = held
        if not (0 <= first and first + count <= num_experts and 1 <= top_k <= num_experts):
            raise ValueError(f"experts {first}..{first + count - 1} of {num_experts}, top {top_k}")
        self.first, self.top_k, self.scale = first, top_k, scale
        self.gate = proj(d, num_experts)
        self.w1 = nn.Parameter(torch.zeros(count, hidden, d))
        self.w3 = nn.Parameter(torch.zeros(count, hidden, d))
        self.w2 = nn.Parameter(torch.zeros(count, d, hidden))
        self.register_buffer("expert_bias", torch.zeros(num_experts))

    def init_weights(self, generator) -> None:
        for w in (self.w1, self.w3, self.w2):
            _lecun_normal_(w, w.shape[-1], generator)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        with span("moe"):
            shape = x.shape
            out = held_experts(x.reshape(-1, shape[-1]).to(dtype), self.gate.weight,
                               self.expert_bias, self.w1, self.w3, self.w2, self.first,
                               self.top_k, self.scale)
            return out.view(shape)


class Lfm2Layer(nn.Module):
    def __init__(self, kind: str, d: int, ffn: nn.Module, heads: int, kv_heads: int,
                 head_dim: int, taps: int, theta: float, eps: float):
        super().__init__()
        self.operator_norm = RMSNorm(d, eps)
        if kind == "conv":
            self.conv = ShortConv(d, taps)
        elif kind == "full_attention":
            self.self_attn = GroupedQueryAttention(d, heads, kv_heads, head_dim, theta, eps)
        else:
            raise ValueError(f"unknown layer type {kind!r}")
        self.kind = kind
        self.ffn_norm = RMSNorm(d, eps)
        self.feed_forward = ffn

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        op = self.conv if self.kind == "conv" else self.self_attn
        h = x + op(self.operator_norm(x), dtype)
        return h + self.feed_forward(self.ffn_norm(h), dtype)


class Lfm2ActorCritic(nn.Module):
    def __init__(self, action_dim: int, obs_shape, hidden_size: int,
                 layer_types: Sequence[str], num_dense_layers: int, intermediate_size: int,
                 moe_intermediate_size: int, num_experts: int, experts_held: Tuple[int, int],
                 num_experts_per_tok: int, num_heads: int, num_kv_heads: int, head_dim: int,
                 conv_L_cache: int, rope_theta: float, norm_eps: float, head_hidden: int,
                 routed_scaling_factor: float = 1.0, dtype=torch.float32):
        super().__init__()
        planes, m, n = obs_shape
        d = hidden_size
        self.dtype = dtype
        self.num_heads = num_heads
        self.embed = nn.Module()
        self.embed.cell_embed = dense(planes, d, "embedding")
        self.embed.pos_embed = nn.Parameter(torch.zeros(1, m * n, d))
        layers = []
        for i, kind in enumerate(layer_types):
            if i < num_dense_layers:
                ffn = SwiGLU(d, intermediate_size)
            else:
                ffn = HeldExperts(d, moe_intermediate_size, num_experts, tuple(experts_held),
                                  num_experts_per_tok, routed_scaling_factor)
            layers.append(Lfm2Layer(kind, d, ffn, num_heads, num_kv_heads, head_dim,
                                    conv_L_cache, rope_theta, norm_eps))
        self.layers = nn.ModuleList(layers)
        self.final_norm = RMSNorm(d, norm_eps)
        self.heads = ActorCriticHeads(d, m * n, action_dim, head_hidden)

    def forward(self, obs: torch.Tensor, train: bool = False):
        """(B, 2, M, N) observation -> (logits (B, A) f32, value (B, 1) f32)."""
        del train  # no batch-dependent layers
        b, c, m, n = obs.shape
        tokens = obs.permute(0, 2, 3, 1).reshape(b, m * n, c)
        cell = self.embed.cell_embed
        x = F.linear(tokens.to(self.dtype), cell.weight.to(self.dtype), cell.bias.to(self.dtype))
        x = x + self.embed.pos_embed.to(self.dtype)
        for layer in self.layers:
            x = layer(x, self.dtype)
        return self.heads(self.final_norm(x), self.dtype)

    @torch.no_grad()
    def compact(self) -> "Lfm2ActorCritic":
        """Hold the matrices that the products read in the compute dtype
        (the projections', the dense and expert SwiGLUs' and the heads'
        weights), in place; the router, norms, biases and taps stay f32.
        Only where the compute dtype is narrower than f32, whose forward
        then gives the same bits."""
        if self.dtype == torch.float32:
            return self
        f32 = {id(layer.feed_forward.gate.weight) for layer in self.layers
               if isinstance(layer.feed_forward, HeldExperts)}
        for name, p in self.named_parameters():
            if p.dim() >= 2 and id(p) not in f32 and not name.endswith("conv_weight"):
                p.data = p.data.to(self.dtype)
        return self
