"""The benchmark's arithmetic: the card's published peaks, the least time a
kernel's work needs, and the model FLOPs of an iteration.

The peaks and the byte and operation counts are copied from
``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``PEAK_OPS``, ``bound``, the K2 and
attention counts of ``time_resblock`` and ``time_attention``) and
``rl_selfplay_mnk_tpu_torch/utils/env_step_study.py`` (``k1_bytes``): each
input byte read once and each output byte written once, at the shapes the
cell's inputs give, whatever implements the kernel. A network family's body
FLOPs and kernels are counted in its own file (``families/<family>.py``);
the heads' FLOPs and K1's work, which every family shares, here.
"""

from __future__ import annotations

from . import spec

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor-core bf16; f32 outside
PEAK_MODEL_FLOPS = PEAK_OPS["bfloat16"]
BF16 = 2  # bytes


def bound_s(nbytes: float, ops: float, dtype: str) -> float:
    """The least seconds a call can take: the larger of its bytes over the
    memory's bandwidth and its operations over the peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype])


def num_lines(m: int, n: int, k: int) -> int:
    rows = m * max(n - k + 1, 0) + n * max(m - k + 1, 0)
    return rows + 2 * max(m - k + 1, 0) * max(n - k + 1, 0)


def k1_bound_s(mnk, envs: int) -> float:
    """The env step over ``envs`` boards: the planes, player, move count,
    action (int64) and active flag read; the planes, player, move count,
    reward, done and mask written."""
    m, n, k = mnk
    mn = m * n
    nbytes = envs * (2 * mn * 4 + 4 + 4 + 8 + 1) + envs * (2 * mn * 4 + 4 + 4 + 4 + 1 + mn)
    ops = envs * (2 * mn + num_lines(m, n, k) * k + 8)  # placement, line sums, flags
    return bound_s(nbytes, ops, "float32")


def k2_bound_s(mnk, boards: int, channels: int) -> float:
    """One BN-folded residual block over ``boards`` boards: x read and y
    written in bf16, both 3x3 convs' weights (bf16) and biases (f32)."""
    cells = mnk[0] * mnk[1]
    x = boards * cells * channels
    w = 9 * channels * channels
    nbytes = 2 * x * BF16 + 2 * w * BF16 + 2 * channels * 4
    ops = 2 * (2 * boards * cells * 9 * channels * channels)
    return bound_s(nbytes, ops, "bfloat16")


def attention_bound_s(boards: int, length: int, heads: int, head_dim: int,
                      backward: bool) -> float:
    """Attention over (boards, length, heads, head_dim) in bf16. Forward:
    q, k, v read, o written, q k^T and p v. Backward: q, k, v, dO read, dq,
    dk, dv written, s recomputed, dV, dP, dQ, dK."""
    elements = boards * length * heads * head_dim
    nbytes = (7 if backward else 4) * elements * BF16
    ops = (10 if backward else 4) * boards * heads * length * length * head_dim
    return bound_s(nbytes, ops, "bfloat16")


def forward_flops(cfg: dict) -> float:
    """Model FLOPs of one board's forward (2 a multiply-add): every conv,
    linear and attention product; norms and activations not counted. The
    body's are the family's (``body_flops``), the heads' are counted here."""
    m, n, _ = cfg["mnk"]
    cells = m * n
    h = cfg["head_hidden"]
    family = spec.family(cfg)
    c = family.body_shapes(cfg)[1]
    heads = 2 * cells * c * 3  # the two plane projections (2 planes and 1)
    heads += 2 * (2 * cells) * h + 2 * cells * h  # first dense layers
    heads += 2 * h * cells + 2 * h  # last dense layers
    return float(family.body_flops(cfg) + heads)


def iteration_flops(cfg: dict, traffic: dict) -> float:
    """Model FLOPs of one training iteration: the learner's and the
    opponent's forward over every env at every step, the bootstrap
    forward, and forward plus backward (3 forwards) of every sample in
    every epoch. Nothing recomputed is counted."""
    f = forward_flops(cfg)
    envs, steps = traffic["num_envs"], traffic["n_steps"]
    rollout = (2 * steps + 1) * envs
    update = 3 * traffic["ppo_epochs"] * envs * steps
    return f * (rollout + update)


def kernel_work(cfg: dict, traffic: dict) -> dict:
    """kernel -> (substring of its symbol, least seconds of the calls one
    iteration needs). K1: two env steps a rollout step; the family's own
    kernels (``families/<family>.py``: K2 for the ResNet's residual blocks;
    K5, K3, K4 for the transformer's attention)."""
    steps = traffic["n_steps"]
    out = {"K1": ("env_step", 2 * steps * k1_bound_s(cfg["mnk"], traffic["num_envs"]))}
    out.update(spec.family(cfg).kernel_work(cfg, traffic))
    return out
