"""The pre-LN board transformer: a linear cell embedding plus a learned
position embedding, then layers of LayerNorm, multi-head attention over
the board's cells and a ReLU FFN (``rl_selfplay_mnk_tpu_torch/models/
transformer.py``). Nothing mixes boards. K5 is the program's attention
without a gradient (rollout, bootstrap), K3/K4 the update's forward and
backward."""

from __future__ import annotations

import torch

from .. import reference as ref
from .. import yardstick

BATCH_COUPLED = False


def body_shapes(cfg: dict):
    m, n, _ = cfg["mnk"]
    cells = m * n
    d, f = cfg["embed_dim"], cfg["ffn_dim"]
    out = {}
    out["embed.pos_embed"] = ((1, cells, d), "embed")
    out["embed.cell_embed.weight"] = ((d, 2), "embed")
    out["embed.cell_embed.bias"] = ((d,), "zero")
    qkv = cfg["num_heads"] * cfg["head_dim"]
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}"
        out[f"{p}.ln1.weight"] = ((d,), "one")
        out[f"{p}.ln1.bias"] = ((d,), "zero")
        for name, shape in (("query", (qkv, d)), ("key", (qkv, d)), ("value", (qkv, d)),
                            ("out", (d, qkv))):
            out[f"{p}.attn.{name}.weight"] = (shape, "kernel")
            out[f"{p}.attn.{name}.bias"] = ((shape[0],), "zero")
        if f:
            out[f"{p}.ln2.weight"] = ((d,), "one")
            out[f"{p}.ln2.bias"] = ((d,), "zero")
            out[f"{p}.dense1.weight"] = ((f, d), "kernel")
            out[f"{p}.dense1.bias"] = ((f,), "zero")
            out[f"{p}.dense2.weight"] = ((d, f), "kernel")
            out[f"{p}.dense2.bias"] = ((d,), "zero")
    return out, d


def body(cfg, p, obs, train, prec):
    eps = cfg["layernorm_eps"]
    b, c, m, n = obs.shape
    h_, dh = cfg["num_heads"], cfg["head_dim"]
    tokens = obs.permute(0, 2, 3, 1).reshape(b, m * n, c)
    x = ref._linear(tokens, p["embed.cell_embed.weight"], p["embed.cell_embed.bias"], prec)
    x = x + p["embed.pos_embed"]
    for i in range(cfg["num_layers"]):
        pre = f"layers.{i}"
        y = ref._layer_norm(x, p[f"{pre}.ln1.weight"], p[f"{pre}.ln1.bias"], eps)
        q, k, v = (ref._linear(y, p[f"{pre}.attn.{t}.weight"], p[f"{pre}.attn.{t}.bias"], prec)
                   .view(b, m * n, h_, dh) for t in ("query", "key", "value"))
        o = ref._attention(q, k, v, prec).reshape(b, m * n, h_ * dh)
        x = x + ref._linear(o, p[f"{pre}.attn.out.weight"], p[f"{pre}.attn.out.bias"], prec)
        if cfg["ffn_dim"]:
            y = ref._layer_norm(x, p[f"{pre}.ln2.weight"], p[f"{pre}.ln2.bias"], eps)
            y = torch.relu(ref._linear(y, p[f"{pre}.dense1.weight"], p[f"{pre}.dense1.bias"],
                                       prec))
            x = x + ref._linear(y, p[f"{pre}.dense2.weight"], p[f"{pre}.dense2.bias"], prec)
    return x


def body_flops(cfg: dict) -> float:
    m, n, _ = cfg["mnk"]
    cells = m * n
    d = cfg["embed_dim"]
    qkv = cfg["num_heads"] * cfg["head_dim"]
    layer = 2 * cells * d * qkv * 3 + 2 * cells * qkv * d  # projections
    layer += 2 * (2 * cells * cells * qkv)  # q k^T and p v
    layer += 2 * (2 * cells * d * cfg["ffn_dim"])
    return float(2 * cells * 2 * d + cfg["num_layers"] * layer)


def kernel_work(cfg: dict, traffic: dict) -> dict:
    """K5: the learner's, the opponent's and the bootstrap's attention
    without a gradient; K3/K4: the update's attention forward and backward
    a minibatch."""
    mnk = cfg["mnk"]
    envs, steps = traffic["num_envs"], traffic["n_steps"]
    updates = traffic["ppo_epochs"] * envs * steps // traffic["batch_size"]
    length = mnk[0] * mnk[1]
    shape = (length, cfg["num_heads"], cfg["head_dim"])
    layers = cfg["num_layers"]
    return {
        "K5": ("attn_lane_slice_fwd", (2 * steps + 1) * layers
               * yardstick.attention_bound_s(envs, *shape, backward=False)),
        "K3": ("attn_folded_fwd", updates * layers
               * yardstick.attention_bound_s(traffic["batch_size"], *shape, backward=False)),
        "K4": ("attn_folded_bwd", updates * layers
               * yardstick.attention_bound_s(traffic["batch_size"], *shape, backward=True)),
    }
