"""The plain reference of the benchmark: what a self-play PPO iteration
computes, written in plain PyTorch float32 from the configuration files
alone.

It imports nothing of the program (``rl_selfplay_mnk_tpu_torch``) nor of
the JAX package, and takes no weights, scales or tables from either. It
holds:

  * the weights' layout and the benchmark's weights (``param_shapes``,
    ``make_weights``), made on the device from the seed in one call;
  * the MNK rules (``line_matrix``, ``wins``) and the self-play transition
    check (``replay_env``);
  * the networks as functions of a dict of tensors in the state-dict
    naming (``forward``), in train mode (BatchNorm over the batch) and eval
    mode (BatchNorm over the running statistics): the body of each family
    in a file of its own (``families/<family>.py``, found by the
    configuration's ``family``: ResNet, board transformer), over the heads
    and the layers' helpers here, which every family shares;
  * the masked categorical, GAE, the clipped-surrogate loss and AdamW after
    a global-norm clip (``ppo_steps``), in blocks of as many boards as the
    body's features fit in ``BLOCK_BYTES`` (``row_blocks``).

Taken from the port's plain versions and the JAX package's semantics:
``rl_selfplay_mnk_tpu_torch/env/lines.py`` (the lines), ``env/mnk_env.py``
and ``selfplay/wrapper.py`` (the rules and the self-play transition),
``models/common.py``, ``models/resnet.py`` and ``models/transformer.py``
(the networks), ``ops/masked.py``, ``alg/gae.py`` and ``alg/ppo.py`` (the
update), frozen here so that a change to the program cannot move them.

``Precision`` chooses how products are rounded: ``FP32`` is the reference;
``FP8`` (operands of every product in float8 e4m3, the gradient flowing into
a product in e5m2, each with a per-tensor scale) is the control that the
comparison in ``check.py`` has to refuse; ``BF16`` (operands and those
gradients in bfloat16, as the program's products take them) is a witness
of what rounding alone does to each number (``control.py --look``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from . import spec


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


def _round_to(x: torch.Tensor, dtype, scaled: bool) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back; a float8 type under a
    per-tensor scale that puts the largest magnitude at its top."""
    if not scaled:
        return x.to(dtype).to(torch.float32)
    amax = x.detach().abs().amax()
    if not torch.isfinite(amax) or float(amax) == 0.0:
        return x
    scale = amax / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Operand(torch.autograd.Function):
    """Forward: round to the operand type. Backward: the gradient as it is."""

    @staticmethod
    def forward(ctx, x, dtype, scaled):
        return _round_to(x, dtype, scaled)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Product(torch.autograd.Function):
    """Forward: the product as it is. Backward: the gradient into the
    product rounded to the gradient type."""

    @staticmethod
    def forward(ctx, y, dtype, scaled):
        ctx.dtype, ctx.scaled = dtype, scaled
        return y

    @staticmethod
    def backward(ctx, g):
        return _round_to(g, ctx.dtype, ctx.scaled), None, None


class Precision:
    """Where a product rounds its operands; float32 rounds nothing."""

    name = "float32"

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def product(self, y: torch.Tensor) -> torch.Tensor:
        return y


class Rounded(Precision):
    """Every product's operands rounded to ``operand_dtype`` and the
    gradient flowing into it to ``grad_dtype``."""

    def __init__(self, name: str, operand_dtype, grad_dtype, scaled: bool):
        self.name, self.operand_dtype, self.grad_dtype = name, operand_dtype, grad_dtype
        self.scaled = scaled

    def operand(self, x):
        return _Operand.apply(x, self.operand_dtype, self.scaled)

    def product(self, y):
        return _Product.apply(y, self.grad_dtype, self.scaled)


FP32 = Precision()
FP8 = Rounded("float8", torch.float8_e4m3fn, torch.float8_e5m2, True)
BF16 = Rounded("bfloat16", torch.bfloat16, torch.bfloat16, False)


def strict_float32() -> None:
    """No TF32 anywhere: the reference's products are float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def _head_shapes(prefix: str, channels: int, cells: int, planes: int, hidden: int, out: int):
    return {
        f"{prefix}.plane_proj.weight": ((planes, channels), "kernel"),
        f"{prefix}.plane_proj.bias": ((planes,), "zero"),
        f"{prefix}.ln1.weight": ((cells * planes,), "one"),
        f"{prefix}.ln1.bias": ((cells * planes,), "zero"),
        f"{prefix}.dense1.weight": ((hidden, cells * planes), "kernel"),
        f"{prefix}.dense1.bias": ((hidden,), "zero"),
        f"{prefix}.ln2.weight": ((hidden,), "one"),
        f"{prefix}.ln2.bias": ((hidden,), "zero"),
        f"{prefix}.dense2.weight": ((out, hidden), "kernel"),
        f"{prefix}.dense2.bias": ((out,), "zero"),
    }


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """name -> (shape, init) of every parameter and buffer, in the
    state-dict naming: the family's body, then the heads. init is "kernel"
    (normal, variance 1 / fan_in, the fan-in the product of the shape past
    the first axis), ("kernel", fan_in) (the same with the fan-in stated,
    for a stacked tensor such as experts' (E, out, in)), "embed" (normal,
    std 0.02), "zero", "one" or "buffer_zero" / "buffer_one" (BatchNorm
    running statistics)."""
    m, n, _ = cfg["mnk"]
    cells, actions = m * n, m * n
    body, width = spec.family(cfg).body_shapes(cfg)
    out: Dict[str, tuple] = dict(body)
    h = cfg["head_hidden"]
    out.update(_head_shapes("heads.policy_head", width, cells, 2, h, actions))
    out.update(_head_shapes("heads.value_head", width, cells, 1, h, 1))
    return out


def init_kind(init) -> tuple:
    """(kind, stated fan-in or None) of an init of ``param_shapes``."""
    return (init[0], init[1]) if isinstance(init, tuple) else (init, None)


def is_parameter(init) -> bool:
    return not init_kind(init)[0].startswith("buffer")


def parameter_count(cfg: dict) -> int:
    return sum(math.prod(shape) for shape, init in param_shapes(cfg).values()
               if is_parameter(init))


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The benchmark's weights, float32 on ``device``: one normal draw from
    a generator on the device seeded with ``seed``, cut into the kernels
    and embeddings and scaled; constants for the rest."""
    shapes = {k: (s, *init_kind(i)) for k, (s, i) in param_shapes(cfg).items()}
    drawn = [s for s, kind, _ in shapes.values() if kind in ("kernel", "embed")]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for s in drawn), generator=gen, device=device)
    out, at = {}, 0
    for name, (shape, kind, fan_in) in shapes.items():
        if kind in ("kernel", "embed"):
            size = math.prod(shape)
            fan_in = math.prod(shape[1:]) if fan_in is None else fan_in
            std = 0.02 if kind == "embed" else 1.0 / math.sqrt(fan_in)
            out[name] = (flat[at:at + size] * std).view(shape)
            at += size
        elif kind in ("one", "buffer_one"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------


def _linear(x, w, b, prec: Precision):
    return prec.product(F.linear(prec.operand(x), prec.operand(w))) + b


def _conv(x, w, b, prec: Precision):
    y = prec.product(F.conv2d(prec.operand(x), prec.operand(w), padding=1))
    return y + b[None, :, None, None]


def _layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def _batch_norm(x, p: dict, name: str, train: bool, eps: float):
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    mul = torch.rsqrt(var + eps) * p[f"{name}.weight"]
    return (x - mean[None, :, None, None]) * mul[None, :, None, None] + p[f"{name}.bias"][
        None, :, None, None]


def _head(p, prefix, feats, eps, prec):
    x = _linear(feats, p[f"{prefix}.plane_proj.weight"], p[f"{prefix}.plane_proj.bias"], prec)
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(_layer_norm(x, p[f"{prefix}.ln1.weight"], p[f"{prefix}.ln1.bias"], eps))
    x = _linear(x, p[f"{prefix}.dense1.weight"], p[f"{prefix}.dense1.bias"], prec)
    x = torch.relu(_layer_norm(x, p[f"{prefix}.ln2.weight"], p[f"{prefix}.ln2.bias"], eps))
    return _linear(x, p[f"{prefix}.dense2.weight"], p[f"{prefix}.dense2.bias"], prec)


def _attention(q, k, v, prec):
    """(B, L, H, Dh) -> (B, L, H, Dh): softmax(q k^T / sqrt(Dh)) v per head."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    s = prec.product(prec.operand(q) @ prec.operand(k).transpose(-1, -2))
    p = torch.softmax(s / math.sqrt(q.shape[-1]), dim=-1)
    o = prec.product(prec.operand(p) @ prec.operand(v))
    return o.transpose(1, 2)


def forward(cfg: dict, p: dict, obs: torch.Tensor, train: bool, prec: Precision = FP32):
    """(B, 2, M, N) float32 observation -> (logits (B, A), value (B,)): the
    family's body, then the policy and value heads."""
    feats = spec.family(cfg).body(cfg, p, obs, train, prec)
    eps = cfg["layernorm_eps"]
    logits = _head(p, "heads.policy_head", feats, eps, prec)
    value = torch.tanh(_head(p, "heads.value_head", feats, eps, prec))[:, 0]
    return logits, value


def masked_log_softmax(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """log pi over the legal cells (-inf elsewhere); a row with no legal
    cell is uniform."""
    masked = logits.masked_fill(~mask, float("-inf"))
    masked = torch.where(~mask.any(-1, keepdim=True), torch.zeros_like(logits), masked)
    return torch.log_softmax(masked, dim=-1)


def entropy(logp: torch.Tensor) -> torch.Tensor:
    p = logp.exp()
    return -(p * torch.where(p > 0, logp, torch.zeros_like(logp))).sum(-1)


# ---------------------------------------------------------------------------
# the game
# ---------------------------------------------------------------------------


def line_matrix(m: int, n: int, k: int, device) -> torch.Tensor:
    """(M*N, lines) incidence of every K-in-a-row line."""
    lines = []
    for r in range(m):
        for c in range(n):
            for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
                cells = [(r + i * dr, c + i * dc) for i in range(k)]
                if all(0 <= rr < m and 0 <= cc < n for rr, cc in cells):
                    lines.append([rr * n + cc for rr, cc in cells])
    mat = torch.zeros((m * n, len(lines)), dtype=torch.float32)
    for j, cells in enumerate(lines):
        mat[cells, j] = 1.0
    return mat.to(device)


def wins(plane: torch.Tensor, lines: torch.Tensor, k: int) -> torch.Tensor:
    """(E, M*N) 0/1 stones -> (E,) True where they hold K in a row."""
    return (plane @ lines >= k - 0.5).any(-1)


def replay_env(mnk, obs: torch.Tensor, final_obs: torch.Tensor, mask: torch.Tensor,
               actions: torch.Tensor, rewards: torch.Tensor, dones: torch.Tensor) -> dict:
    """Check one rollout's record against the self-play rules.

    ``obs`` (T, E, 2, M, N) is what the learner saw at each step (its own
    stones in plane 0), ``final_obs`` (E, 2, M, N) what it saw after the
    last; the envs start fresh at step 0. A step after a terminal resets the
    board: the learner's action is ignored and the opponent opens where it
    plays Black. Otherwise the learner's stone goes on a free cell; a line
    of K wins (+1); a full board draws; else the opponent puts one stone on
    a free cell, and its line of K loses (-1). Returns the rows that break
    a rule (``mismatch``, a count), the rewards and dones the rules give,
    and the opponent's moves (board as the opponent sees it, its mask, its
    cell) for the opponent check."""
    m, n, k = mnk
    t_len, e = actions.shape
    mn = m * n
    lines = line_matrix(m, n, k, obs.device)
    flat = obs.reshape(t_len, e, 2, mn).float()
    after = torch.cat([flat[1:], final_obs.reshape(1, e, 2, mn).float()])
    bad = torch.zeros((t_len, e), dtype=torch.bool, device=obs.device)
    ref_rew = torch.zeros((t_len, e), device=obs.device)
    ref_done = torch.zeros((t_len, e), dtype=torch.bool, device=obs.device)
    opp_boards, opp_masks, opp_cells = [], [], []
    cells = torch.arange(mn, device=obs.device)
    fresh0 = (flat[0, :, 0].sum(-1) == 0) & (flat[0, :, 1].sum(-1) <= 1)
    bad[0] |= ~fresh0
    for t in range(t_len):
        me, opp = flat[t, :, 0], flat[t, :, 1]
        me2, opp2 = after[t, :, 0], after[t, :, 1]
        empty = (me + opp) == 0
        want_mask = torch.where(empty.any(-1, keepdim=True), empty, cells[None, :] == 0)
        reset = dones[t - 1] if t > 0 else torch.zeros_like(dones[0])
        # the reset path: a fresh board, the opponent's opening where it is Black
        opened = (opp2.sum(-1) == 1) & (me2.sum(-1) == 0)
        fresh = (me2.sum(-1) == 0) & ((opp2.sum(-1) == 0) | opened)
        opp_boards.append(torch.stack([torch.zeros_like(opp2), torch.zeros_like(me2)], 1)[opened & reset])
        opp_masks.append(torch.ones_like(empty)[opened & reset])
        opp_cells.append(opp2.argmax(-1)[opened & reset])
        # the learner's move
        a = actions[t].long()
        legal = empty.gather(1, a.clamp(0, mn - 1)[:, None])[:, 0] & (a >= 0) & (a < mn)
        placed = me + (cells[None, :] == a[:, None]).float()
        won = wins(placed, lines, k)
        full = (placed + opp).sum(-1) >= mn
        ended = won | full
        # the opponent's reply where the game goes on
        new_opp = opp2 - opp
        one_stone = (new_opp >= 0).all(-1) & (new_opp.sum(-1) == 1)
        on_free = ((new_opp > 0) & ~(placed + opp == 0)).sum(-1) == 0
        lost = wins(opp2, lines, k)
        full2 = (placed + opp2).sum(-1) >= mn
        reply = ~reset & ~ended
        want_rew = torch.where(reset, 0.0, torch.where(won, 1.0, torch.where(reply & lost, -1.0, 0.0)))
        want_done = ~reset & (ended | lost | full2)
        row_bad = mask[t] != want_mask
        row_bad = row_bad.any(-1)
        row_bad |= reset & ~fresh
        row_bad |= ~reset & ~legal
        row_bad |= ~reset & ended & ~((me2 == placed).all(-1) & (opp2 == opp).all(-1))
        row_bad |= reply & ~((me2 == placed).all(-1) & one_stone & on_free)
        row_bad |= rewards[t] != want_rew
        row_bad |= dones[t] != want_done
        bad[t] |= row_bad
        ref_rew[t], ref_done[t] = want_rew, want_done
        ok_reply = reply & one_stone & on_free
        opp_boards.append(torch.stack([opp, placed], 1)[ok_reply])
        opp_masks.append((placed + opp == 0)[ok_reply])
        opp_cells.append(new_opp.argmax(-1)[ok_reply])
    return {"mismatch": int(bad.sum()), "rewards": ref_rew, "dones": ref_done,
            "opp_obs": torch.cat(opp_boards).reshape(-1, 2, m, n),
            "opp_mask": torch.cat(opp_masks), "opp_cell": torch.cat(opp_cells)}


# ---------------------------------------------------------------------------
# the update
# ---------------------------------------------------------------------------


def gae(rewards, values, dones, last_values, gamma: float, lam: float):
    """(advantages, returns), both (T, E)."""
    nonterminal = 1.0 - dones.float()
    adv = torch.empty_like(values)
    running = torch.zeros_like(last_values)
    next_value = last_values
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_value * nonterminal[t] - values[t]
        running = delta + gamma * lam * nonterminal[t] * running
        adv[t] = running
        next_value = values[t]
    return adv, adv + values


def lr_at(cfg: dict, traffic: dict, count: int) -> float:
    """The learning rate of update ``count``: a linear warm-up from 0.01x
    over the warm-up's iterations, then constant (or a decay to 0.1x)."""
    per_iter = traffic["num_envs"] * traffic["n_steps"]
    updates = traffic["ppo_epochs"] * per_iter // traffic["batch_size"]
    total = max(1, cfg["total_environment_steps"] // per_iter)
    warm = max(1, cfg["lr_warmup_steps"] // per_iter) if cfg["lr_warmup_steps"] > 0 else 0
    it = float(count // updates)
    if it < warm:
        return cfg["learning_rate"] * (0.01 + 0.99 * min(max(it / warm, 0.0), 1.0))
    if cfg["lr_decay"]:
        frac = min(max((it - warm) / max(1, total - warm), 0.0), 1.0)
        return cfg["learning_rate"] * (1.0 - 0.9 * frac)
    return cfg["learning_rate"]


def entropy_coef_at(cfg: dict, traffic: dict, iteration: int) -> float:
    sched = cfg["entropy_coef_schedule"]
    c0 = cfg["entropy_coef"]
    if iteration <= 0 or sched["type"] == "constant":
        return c0
    if sched["type"] != "linear":
        raise ValueError(f"entropy schedule {sched['type']!r} is not in the reference")
    steps = iteration * traffic["num_envs"] * traffic["n_steps"]
    prm = sched["params"]
    if steps >= prm["total_steps"]:
        return prm["final_coef"]
    frac = steps / prm["total_steps"]
    return c0 * (1 - frac) + prm["final_coef"] * frac


def ppo_loss(cfg, p, obs, mask, actions, old_logp, adv, returns, ent_coef, prec):
    """The clipped surrogate, 0.5 * the value MSE and the entropy bonus,
    over one minibatch. Returns (total, actor, critic, entropy loss)."""
    logits, value = forward(cfg, p, obs, True, prec)
    logp_all = masked_log_softmax(logits, mask)
    logp = logp_all.gather(1, actions[:, None])[:, 0]
    ratio = torch.exp(logp - old_logp)
    clip = cfg["clip_range"]
    actor = -torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv).mean()
    critic = ((value - returns) ** 2).mean()
    ent_loss = -entropy(logp_all).mean()
    total = actor + cfg["value_coef"] * critic + ent_coef * ent_loss
    return total, actor, critic, ent_loss


# One float32 activation of the body's width over a block of boards stays
# under this: a graph that keeps some tens of them fits the card beside what
# the run has left on it. Today's cells (at most 8192 boards of 81 cells at
# width 56) fit one block.
BLOCK_BYTES = 1 << 28


def row_blocks(cfg: dict, rows: int, most=None, train: bool = False) -> list:
    """Consecutive slices over ``rows`` rows, each of at most ``most`` rows
    and of as many boards as the body's features (cells x width in float32)
    fit in ``BLOCK_BYTES``. ``train``: the rows are one train-mode batch,
    which a ``BATCH_COUPLED`` family (BatchNorm over the batch) cannot split,
    so more than one block is refused for it."""
    fam = spec.family(cfg)
    m, n, _ = cfg["mnk"]
    size = max(1, min(BLOCK_BYTES // (m * n * fam.body_shapes(cfg)[1] * 4), most or rows, rows))
    if train and size < rows and fam.BATCH_COUPLED:
        raise ValueError(f"family {cfg['family']!r} mixes boards in train mode (BatchNorm), and "
                         f"{rows} boards of {cfg.get('name', 'this configuration')} do not fit "
                         f"one block of the reference ({size} boards)")
    return [slice(i, i + size) for i in range(0, rows, size)]


def _loss_and_grad(cfg, p, leaves, batch, rows, ent_coef, prec):
    """A minibatch's loss terms and gradient over consecutive blocks of its
    rows (``row_blocks``): each block's mean terms weighted by its share of
    the rows, its gradient summed in float32. One block gives the single
    graph's bits."""
    terms = grads = None
    for part in row_blocks(cfg, rows.shape[0], train=True):
        mb = {k: v[rows[part]] for k, v in batch.items()}
        share = mb["obs"].shape[0] / rows.shape[0]
        out = ppo_loss(cfg, p, mb["obs"], mb["mask"], mb["actions"], mb["old_logp"], mb["adv"],
                       mb["returns"], ent_coef, prec)
        g = torch.autograd.grad(out[0] * share, leaves)
        t = [float(x.detach()) * share for x in out]
        if grads is None:
            terms, grads = t, list(g)
        else:
            terms = [a + b for a, b in zip(terms, t)]
            grads = [a + b for a, b in zip(grads, g)]
    return terms, grads


def ppo_steps(cfg: dict, traffic: dict, weights: dict, batch: dict, minibatches,
              prec: Precision = FP32) -> dict:
    """The first ``len(minibatches)`` updates from ``weights``: each a loss,
    a backward, a clip to the global norm and an AdamW step. ``batch`` holds
    the flat (rows, ...) obs, mask, actions, old_logp, adv, returns;
    ``minibatches`` each update's row ids. Returns each update's loss terms
    and pre-clip global gradient norm, the first update's clipped gradient
    and the parameters after the last, by name. Each update's loss and
    gradient are taken over blocks of its rows (``_loss_and_grad``)."""
    names = [k for k, (_, i) in param_shapes(cfg).items() if is_parameter(i)]
    params = {k: weights[k].detach().clone().requires_grad_(True) for k in names}
    buffers = {k: v for k, v in weights.items() if k not in params}
    b1, b2 = cfg["adam_betas"]
    exp_avg = {k: torch.zeros_like(v) for k, v in params.items()}
    exp_sq = {k: torch.zeros_like(v) for k, v in params.items()}
    ent_coef = entropy_coef_at(cfg, traffic, 0)
    losses, first_grad, norms = [], None, []
    for step, rows in enumerate(minibatches, start=1):
        p = {**params, **buffers}
        terms, grads = _loss_and_grad(cfg, p, [params[k] for k in names], batch, rows, ent_coef,
                                      prec)
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        norms.append(float(norm))
        scale = cfg["max_grad_norm"] / norm if norm >= cfg["max_grad_norm"] else 1.0
        grads = [g * scale for g in grads]
        if first_grad is None:
            first_grad = dict(zip(names, (g.detach() for g in grads)))
        lr = lr_at(cfg, traffic, step - 1)
        with torch.no_grad():
            for k, g in zip(names, grads):
                w = params[k]
                w.mul_(1 - lr * cfg["weight_decay"])
                exp_avg[k].mul_(b1).add_(g, alpha=1 - b1)
                exp_sq[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (exp_sq[k] / (1 - b2 ** step)).sqrt() + cfg["adam_eps"]
                w.addcdiv_(exp_avg[k], denom, value=-lr / (1 - b1 ** step))
        losses.append(terms)
    return {"losses": losses, "first_grad": first_grad, "grad_norms": norms,
            "params": {k: v.detach() for k, v in params.items()}, "ent_coef": ent_coef}
