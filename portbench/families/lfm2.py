"""LFM2-MoE (``lfm2_moe``) over the board's cells, one chip's share of its
expert layers (``rl_selfplay_mnk_tpu_torch/models/lfm2.py``): a linear cell
embedding plus a learned position embedding (as in the board transformer;
the published model has a vocabulary instead), then layers ``h = x + op(RMSNorm(x))``, ``out = h +
ffn(RMSNorm(h))`` with op the gated short convolution or grouped-query
attention (per-head RMSNorm of q and k, RoPE, bidirectional over the
board), ffn a dense SwiGLU in the leading ``num_dense_layers`` layers and
the expert layer after them, and a final RMSNorm.

The expert layer routes over all ``num_experts_published`` experts (sigmoid
scores in float32, the top ``num_experts_per_tok`` by score plus
``expert_bias``, weights normalised over the picks) and adds the part of
the result that the ``num_experts`` experts held here (``experts_held_from``
on) give; a pick of an expert held elsewhere adds nothing. The router is
float32 on both sides (the program computes it so), outside ``prec``.
Nothing mixes boards.

Kernels: K8/K9, the packed attention pair, at (boards, 81, heads, 64) with
k and v repeated to every query head before the call; RMSNorm (the
LayerNorm pair's RMS mode), the short convolution pair, the expert layer's
dispatch and combine, and its grouped products.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import reference as ref
from .. import yardstick

BATCH_COUPLED = False


def _moe_layers(cfg: dict) -> list:
    return [i >= cfg["num_dense_layers"] for i in range(len(cfg["layer_types"]))]


def body_shapes(cfg: dict):
    d = cfg["hidden_size"]
    hd = cfg["head_dim"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    f, fe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    held, routed = cfg["num_experts"], cfg["num_experts_published"]
    m, n, _ = cfg["mnk"]
    # the bias an embedding row too: no cell embeds to the zero vector
    out = {"embed.pos_embed": ((1, m * n, d), "embed"),
           "embed.cell_embed.weight": ((d, 2), "embed"), "embed.cell_embed.bias": ((d,), "embed")}
    for i, (kind, moe) in enumerate(zip(cfg["layer_types"], _moe_layers(cfg))):
        p = f"layers.{i}"
        out[f"{p}.operator_norm.weight"] = ((d,), "one")
        if kind == "conv":
            out[f"{p}.conv.conv_weight"] = ((d, cfg["conv_L_cache"]), "kernel")
            out[f"{p}.conv.in_proj.weight"] = ((3 * d, d), "kernel")
            out[f"{p}.conv.out_proj.weight"] = ((d, d), "kernel")
        else:
            out[f"{p}.self_attn.q_proj.weight"] = ((h * hd, d), "kernel")
            out[f"{p}.self_attn.k_proj.weight"] = ((kv * hd, d), "kernel")
            out[f"{p}.self_attn.v_proj.weight"] = ((kv * hd, d), "kernel")
            out[f"{p}.self_attn.out_proj.weight"] = ((d, h * hd), "kernel")
            out[f"{p}.self_attn.q_layernorm.weight"] = ((hd,), "one")
            out[f"{p}.self_attn.k_layernorm.weight"] = ((hd,), "one")
        out[f"{p}.ffn_norm.weight"] = ((d,), "one")
        q = f"{p}.feed_forward"
        if moe:
            out[f"{q}.w1"] = ((held, fe, d), ("kernel", d))
            out[f"{q}.w3"] = ((held, fe, d), ("kernel", d))
            out[f"{q}.w2"] = ((held, d, fe), ("kernel", fe))
            out[f"{q}.expert_bias"] = ((routed,), "buffer_zero")
            out[f"{q}.gate.weight"] = ((routed, d), "kernel")
        else:
            out[f"{q}.w1.weight"] = ((f, d), "kernel")
            out[f"{q}.w3.weight"] = ((f, d), "kernel")
            out[f"{q}.w2.weight"] = ((d, f), "kernel")
    out["final_norm.weight"] = ((d,), "one")
    return out, d


def _mm(x, w, prec):
    return prec.product(F.linear(prec.operand(x), prec.operand(w)))


def _rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _short_conv(bcx, w):
    b, c, x = bcx.chunk(3, dim=-1)
    bx = b * x
    k, length = w.shape[1], bx.shape[1]
    padded = F.pad(bx, (0, 0, k - 1, 0))
    z = padded[:, 0:length] * w[:, 0]
    for j in range(1, k):
        z = z + padded[:, j:j + length] * w[:, j]
    return c * z


def _rope(t, theta):
    """t (B, L, H, Dh) rotated at positions 0..L-1 (rotate-half form)."""
    length, dh = t.shape[1], t.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float64) / dh)
    freqs = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = (e.to(torch.float32).to(t.device)[:, None, :] for e in (emb.cos(), emb.sin()))
    half = dh // 2
    return t * cos + torch.cat([-t[..., half:], t[..., :half]], dim=-1) * sin


def _swiglu(x, w1, w3, w2, prec):
    return _mm(F.silu(_mm(x, w1, prec)) * _mm(x, w3, prec), w2, prec)


def _experts(cfg, p, q, x, prec):
    """The held experts' part of the expert layer for x (N, D)."""
    scores = torch.sigmoid(F.linear(x, p[f"{q}.gate.weight"]))
    picks = torch.topk(scores + p[f"{q}.expert_bias"], cfg["num_experts_per_tok"], dim=-1).indices
    w = scores.gather(1, picks)
    w = w / (w.sum(-1, keepdim=True) + 1e-6) * cfg["routed_scaling_factor"]
    out = torch.zeros_like(x)
    first = cfg["experts_held_from"]
    for e in range(cfg["num_experts"]):
        hit = picks == first + e
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel():
            y = _swiglu(x[rows], p[f"{q}.w1"][e], p[f"{q}.w3"][e], p[f"{q}.w2"][e], prec)
            out = out.index_add(0, rows, y * (w * hit)[rows].sum(-1, keepdim=True))
    return out


def body(cfg, p, obs, train, prec):
    eps = cfg["norm_eps"]
    b, c, m, n = obs.shape
    h, kv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    tokens = obs.permute(0, 2, 3, 1).reshape(b, m * n, c)
    x = ref._linear(tokens, p["embed.cell_embed.weight"], p["embed.cell_embed.bias"], prec)
    x = x + p["embed.pos_embed"]
    for i, (kind, moe) in enumerate(zip(cfg["layer_types"], _moe_layers(cfg))):
        pre = f"layers.{i}"
        y = _rms_norm(x, p[f"{pre}.operator_norm.weight"], eps)
        if kind == "conv":
            bcx = _mm(y, p[f"{pre}.conv.in_proj.weight"], prec)
            y = _short_conv(bcx, p[f"{pre}.conv.conv_weight"])
            x = x + _mm(y, p[f"{pre}.conv.out_proj.weight"], prec)
        else:
            a = f"{pre}.self_attn"
            q = _rms_norm(_mm(y, p[f"{a}.q_proj.weight"], prec).view(b, m * n, h, hd),
                          p[f"{a}.q_layernorm.weight"], eps)
            k = _rms_norm(_mm(y, p[f"{a}.k_proj.weight"], prec).view(b, m * n, kv, hd),
                          p[f"{a}.k_layernorm.weight"], eps)
            v = _mm(y, p[f"{a}.v_proj.weight"], prec).view(b, m * n, kv, hd)
            q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
            k, v = (t.repeat_interleave(h // kv, dim=2) for t in (k, v))
            o = ref._attention(q, k, v, prec).reshape(b, m * n, h * hd)
            x = x + _mm(o, p[f"{a}.out_proj.weight"], prec)
        y = _rms_norm(x, p[f"{pre}.ffn_norm.weight"], eps)
        q = f"{pre}.feed_forward"
        if moe:
            y = _experts(cfg, p, q, y.reshape(-1, y.shape[-1]), prec).view(y.shape)
        else:
            y = _swiglu(y, p[f"{q}.w1.weight"], p[f"{q}.w3.weight"], p[f"{q}.w2.weight"], prec)
        x = x + y
    return _rms_norm(x, p["final_norm.weight"], eps)


def expert_share(cfg: dict) -> float:
    """Experts a token runs here on average: its picks times the share of
    the experts held here."""
    return cfg["num_experts_per_tok"] * cfg["num_experts"] / cfg["num_experts_published"]


def body_flops(cfg: dict) -> float:
    """Model FLOPs of one board's body; an expert layer counts its router
    and the held experts' expected share of a token (``expert_share``)."""
    m, n, _ = cfg["mnk"]
    cells = m * n
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    total = 2 * cells * 2 * d
    for kind, moe in zip(cfg["layer_types"], _moe_layers(cfg)):
        if kind == "conv":
            total += 2 * cells * d * 3 * d + 2 * cells * d * d
        else:
            total += 2 * cells * d * (2 * h * hd + 2 * kv * hd)
            total += 2 * (2 * cells * cells * h * hd)
        if moe:
            total += 2 * cells * d * cfg["num_experts_published"]
            total += expert_share(cfg) * 3 * 2 * cells * d * cfg["moe_intermediate_size"]
        else:
            total += 3 * 2 * cells * d * cfg["intermediate_size"]
    return float(total)


def _passes(traffic: dict) -> tuple:
    """(boards through forwards without a gradient, boards through the
    update's forward and backward) in one iteration."""
    envs, steps = traffic["num_envs"], traffic["n_steps"]
    return (2 * steps + 1) * envs, traffic["ppo_epochs"] * envs * steps


def kernel_work(cfg: dict, traffic: dict) -> dict:
    """The least seconds one iteration's calls need of each kernel, at the
    bytes and operations its inputs need (bf16 activations, f32 norm
    weights and taps): K8 the forwards without a gradient and the update's
    forward, K9 the update's backward, at (boards, 81, heads, 64) with k and
    v repeated to every query head; ``rmsnorm`` every RMSNorm (2 + 2 a
    layer + 1 at width D, 2 heads' at 64 in an attention layer), forward x
    read and y written, backward x and dy read and dx written (the sum of
    dgamma's partials over blocks, ``ln_cols_sum``, which LayerNorm shares,
    neither timed nor counted);
    ``shortconv`` (B, C, x') read and y written forward, those and dy read
    and their gradient written backward; ``moe_dispatch`` (the ``moe_*``
    kernels) the router's top k over its logits, the sort of the pairs, the
    gather of the tokens into the held pairs' rows, the SwiGLU between the
    grouped products (recomputed once in the backward) and the weighted
    combine, forward and backward, at the held experts' expected share of
    the pairs (``expert_share``); ``expert_gemm`` (the library's grouped GEMM,
    ``GroupProblemShape`` in its symbol) the held experts' products: 3 a
    forward, 6 a backward."""
    m, n, _ = cfg["mnk"]
    cells = m * n
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    h = cfg["num_attention_heads"]
    fe = cfg["moe_intermediate_size"]
    bf = yardstick.BF16
    eval_boards, train_boards = _passes(traffic)
    mb = traffic["batch_size"]
    updates = train_boards // mb
    kinds = cfg["layer_types"]
    attn = sum(k == "full_attention" for k in kinds)
    convs = sum(k == "conv" for k in kinds)
    moes = sum(_moe_layers(cfg))
    held_experts, share = cfg["num_experts"], expert_share(cfg)
    boards = eval_boards + train_boards

    def attention(b, backward):
        return yardstick.attention_bound_s(b, cells, h, hd, backward=backward)

    # K8: one call a layer a forward pass (steps and the bootstrap, 2 sides; updates)
    k8 = attn * (2 * traffic["n_steps"] + 1) * attention(traffic["num_envs"], False)
    k8 += attn * updates * attention(mb, False)
    k9 = attn * updates * attention(mb, True)
    # RMSNorm: rows of width d and of width hd, forward over every board, backward over the update's
    wide = 2 * len(kinds) + 1
    narrow = attn * (h + cfg["num_key_value_heads"])

    def rms(rows, width, backward):
        nbytes = (3 if backward else 2) * rows * width * bf + width * 4
        return yardstick.bound_s(nbytes, (6 if backward else 4) * rows * width, "float32")

    rms_s = sum(rms(b * cells * count, width, bwd)
                for b, bwd in ((boards, False), (train_boards, True))
                for count, width in ((wide, d), (narrow, hd)))
    conv_fwd = boards * cells * convs * (4 * d * bf)
    conv_bwd = train_boards * cells * convs * (7 * d * bf)
    taps = cfg["conv_L_cache"]
    conv_ops = (boards + 2 * train_boards) * cells * convs * d * (2 * taps + 2)
    conv_s = yardstick.bound_s(conv_fwd + conv_bwd, conv_ops, "float32")
    # moe_* kernels: the router's top k (logits read, picks written), the sort,
    # the gather, the SwiGLU between the grouped products and the combine
    k = cfg["num_experts_per_tok"]
    routed = cfg["num_experts_published"]
    tokens = boards * cells * moes
    train_tokens = train_boards * cells * moes
    fwd = tokens * (bf * (share * (3 * d + 3 * fe) + d) + routed * 4 + k * 32)
    bwd = train_tokens * (bf * (share * (4 * d + 8 * fe) + d) + routed * 4 + k * 8)
    disp_s = yardstick.bound_s(fwd + bwd, 0.0, "bfloat16")
    gemm_ops = (tokens + 2 * train_tokens) * share * 3 * 2 * d * fe
    # the held experts' matrices: 3 read a forward call, 3 read and 3 written a backward
    calls = 2 * traffic["n_steps"] + 1
    gemm_bytes = moes * held_experts * d * fe * bf * (3 * calls + 9 * updates)
    gemm_bytes += (tokens + 2 * train_tokens) * share * (2 * d + 3 * fe) * bf
    gemm_s = yardstick.bound_s(gemm_bytes, gemm_ops, "bfloat16")
    return {
        "K8": ("attn_packed_fwd", k8),
        "K9": ("attn_packed_bwd", k9),
        "rmsnorm": ("ln_rows_rms", rms_s),
        "shortconv": ("short_conv_", conv_s),
        "moe_dispatch": ("moe_", disp_s),
        "expert_gemm": ("GroupProblemShape", gemm_s),
    }
