"""PPO self-play learner: rollout, GAE and the clipped-surrogate update.

Counterpart of the JAX package's ``alg/ppo.py``, on one device or as one
rank of a data-parallel world (below):

  * ``rollout_impl``: ``n_steps`` train-mode forwards (batch-statistic
    BatchNorm, running statistics updated in place), masked gumbel-max
    sampling, self-play steps; observations stored as uint8; the per-env
    episode accumulators carry across ``learn`` calls.
  * ``_update_prepare_impl``: bootstrap value (train-mode forward), GAE,
    advantage normalisation over the whole buffer (ddof=1), and the
    minibatch layout flatten.
  * ``_minibatch_indices``: the ``global`` row shuffle, the ``grouped``
    shuffle of contiguous ``group_size`` chunks (time-major flatten; with
    ``shard_groups`` d > 1 shard-major, each shard permuting its own
    groups), and the ``tiled`` shuffle (row permutations within each of d
    env blocks).
  * the epoch loss: clipped surrogate, 0.5 * value MSE, entropy bonus, with
    clip fraction, approx-KL and explained variance.
  * ``PPOOptimizer``: global-norm clip 0.5, then AdamW (eps 1e-5, weight
    decay 0.01) with the lr schedule evaluated at the update count;
    ``DeviceOptimizer`` the same with the lr and step counts on the device
    (the fused trainer's, ``alg/fused.py``).
  * ``rollout_step`` and ``minibatch_update``: one self-play step and one
    minibatch, the pieces that ``rollout_impl`` and the epochs loop repeat
    and that the fused trainer replays.
  * the watch (``run.watch`` in the reference): on an iteration that asks
    for it, ``GradWatch`` accumulates every update's pre-clip gradients on
    the device (each leaf's squared L2 norm and, with ``watch_hist_bins``,
    a signed-log histogram) and ``learn`` fetches them once, as RMS norms
    and counts under the JAX package's keys; ``param_stats`` gives the
    parameters' norms and histograms.
  * ``fin_blocks`` > 0: the finished-episode sums come back per block of
    ``num_envs / fin_blocks`` envs, the layout of
    ``selfplay.policies.make_block_policy``, as ``block_rewards``.

Every stochastic step takes its draws from an explicit ``torch.Generator``
or from the caller: sampling noise and side draws (``rollout_impl``'s
``draws``) and minibatch indices (``epoch_indices``).

Data parallel (``dp``, a ``parallel.mesh.DataParallel``, for a world of
more than one rank; the JAX package's env-sharded mesh): a rank holds
envs ``dp.shard`` and computes what GSPMD computes for the whole batch.
Draws and injected draws are global tensors of which the rank keeps its
rows (its columns of the minibatch indices); BatchNorm's statistics are
the ranks' (``models.common.BatchNorm.stat_sync``); the advantage
normalisation is over the whole buffer (ddof=1); each minibatch's
gradient is all-reduced once as one flat vector and averaged over the
ranks before the unchanged clip and AdamW (or, with ``zero_update``,
reduce-scattered: ``alg/zero_epochs.py``); the metrics are global (the
explained variance from the minibatch's global variance of the returns);
the finished-episode sums (or the per-block sums) are all-reduced once a
rollout. ``shard_groups`` (the layout) is a multiple of the world size: a
world of one rank given the layout of d trains as d ranks do.

Timing: ``rollout_time`` and ``learn_time`` are the device seconds of the
``rollout`` span (sampling and env stepping) and the ``update`` span
(bootstrap, GAE and the epochs), read after the iteration's one host read
(``utils/tracing.py``; the host's seconds on the CPU); ``fps = n_steps *
num_envs / rollout_time``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ..env.mnk_env import EnvConfig
from ..models.common import BatchNorm
from ..models.convert import flax_param_paths
from ..models.registry import train_apply
from ..ops.masked import entropy as masked_entropy
from ..ops.masked import log_prob, mask_logits, masked_sample
from ..selfplay.wrapper import selfplay_reset, selfplay_step
from ..utils.tracing import Interval, span
from .gae import compute_gae


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """PPO hyperparameters (defaults as in the JAX package).

    ``shuffle``: "global" = one row permutation of the (num_envs * n_steps)
    batch per epoch; "grouped" = a permutation of contiguous groups of
    ``group_size`` samples (adjacent envs at one timestep), each minibatch
    gathering ``batch_size / group_size`` whole groups; with ``shard_groups``
    d > 1 the flatten is shard-major and each of the d env blocks permutes
    its own groups, a minibatch taking ``batch_size / group_size / d`` of
    each; "tiled" (d > 1) = independent row permutations within each of
    the d env blocks, a minibatch taking ``batch_size / d`` rows of each.
    ``num_envs`` and ``batch_size`` are global; ``zero_update`` selects the
    ZeRO-1 learner (``alg/zero_epochs.py``) with its clip ``zero_clip_norm``.
    """

    env: EnvConfig
    num_envs: int
    n_steps: int
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_range: float = 0.2
    ppo_epochs: int = 4
    batch_size: int = 64
    value_coef: float = 0.5
    shuffle: str = "global"
    shard_groups: int = 1
    group_size: int = 128
    zero_update: bool = False
    zero_clip_norm: float = 0.5
    # Signed-log gradient histograms on watch iterations: this many
    # magnitude bins a sign plus a near-zero bin; 0 = norms only.
    watch_hist_bins: int = 0
    # > 0: per-block finished-episode sums over this many env blocks.
    fin_blocks: int = 0

    @property
    def total_batch(self) -> int:
        return self.num_envs * self.n_steps

    @property
    def num_minibatches(self) -> int:
        if self.total_batch % self.batch_size:
            raise ValueError(
                "num_envs * n_steps must be divisible by batch_size "
                f"({self.total_batch} % {self.batch_size})"
            )
        return self.total_batch // self.batch_size

    @property
    def updates_per_iteration(self) -> int:
        return self.ppo_epochs * self.num_minibatches


def pick_group_size(batch_size: int, target: int = 128) -> int:
    """Largest power-of-two divisor of ``batch_size`` not above ``target``."""
    g = 1
    while g * 2 <= target and batch_size % (g * 2) == 0:
        g *= 2
    return g


@dataclasses.dataclass
class TrainingMetrics:
    """Per-iteration metrics, the JAX package's fields: the reference's
    twelve, ``layer_grad_norms`` on a watch iteration (``{"gradients/<leaf>/
    norm": ..., "gradients/<leaf>/hist": {...}}``) and, with ``fin_blocks``,
    ``block_rewards`` (each block's mean finished-episode reward, None for a
    block that finished none)."""

    mean_reward: float
    mean_length: float
    actor_loss: float
    critic_loss: float
    entropy_loss: float
    grad_norm: float
    clip_fraction: float
    explained_variance: float
    approx_kl: float
    fps: float
    rollout_time: float
    learn_time: float
    layer_grad_norms: Optional[dict] = None
    block_rewards: Optional[list] = None

    def scalars(self) -> dict:
        """The twelve per-iteration numbers."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name not in ("layer_grad_norms", "block_rewards")}


# Signed-log gradient histograms (the JAX package's layout): magnitude bins
# over |g| in [1e-10, 1e2), values below 1e-10 in the central bin, values
# above 1e2 in the outermost bin of their sign.
_GRAD_HIST_LO = -10.0
_GRAD_HIST_HI = 2.0


def grad_hist_edges(bins_per_sign: int) -> list:
    """Bin edges in value space: [-10^HI ... -10^LO, 10^LO ... 10^HI]."""
    step = (_GRAD_HIST_HI - _GRAD_HIST_LO) / bins_per_sign
    mags = [10.0 ** (_GRAD_HIST_LO + i * step) for i in range(bins_per_sign + 1)]
    return [-m for m in reversed(mags)] + mags


def grad_hist_index(g: torch.Tensor, bins_per_sign: int) -> torch.Tensor:
    """Each element's bin (int64, 0 .. 2 * bins_per_sign), with the JAX
    package's arithmetic: the log10 magnitude's bin clipped to the range,
    the near-zero bin in the middle, negative values mirrored."""
    x = g.to(torch.float32)
    mag = torch.log10(torch.clamp(x.abs(), min=1e-30))
    k = torch.clamp(
        torch.floor((mag - _GRAD_HIST_LO) / (_GRAD_HIST_HI - _GRAD_HIST_LO) * bins_per_sign),
        0, bins_per_sign - 1,
    ).to(torch.int64)
    return torch.where(mag < _GRAD_HIST_LO, bins_per_sign,
                       torch.where(x < 0.0, bins_per_sign - 1 - k, bins_per_sign + 1 + k))


class GradWatch:
    """One iteration's gradient statistics, kept on the device: each leaf's
    sum of squared L2 norms over the updates and, with ``bins`` > 0, its
    signed-log histogram counts. ``add`` takes an update's pre-clip
    gradients in a few launches for all leaves at once (one concatenation,
    the bin arithmetic, one scatter-add at precomputed leaf offsets);
    ``fetch`` brings everything to the host once."""

    def __init__(self, names, params, bins: int):
        device = params[0].device
        self.names, self.bins, self.updates = list(names), bins, 0
        self.sq = torch.zeros((len(params),), dtype=torch.float32, device=device)
        if bins:
            nb = 2 * bins + 1
            sizes = torch.tensor([p.numel() for p in params])
            self.offsets = torch.repeat_interleave(torch.arange(len(params)) * nb, sizes).to(device)
            self.ones = torch.ones_like(self.offsets)
            self.hist = torch.zeros((len(params) * nb,), dtype=torch.int64, device=device)

    def add(self, grads, norms) -> None:
        self.sq += torch.stack(norms).square()
        if self.bins:
            flat = torch.cat([g.reshape(-1) for g in grads])
            self.hist.index_add_(0, grad_hist_index(flat, self.bins) + self.offsets, self.ones)
        self.updates += 1

    def add_shard(self, gshard: torch.Tensor, segments: torch.Tensor, coll) -> None:
        """The ZeRO learner's update: ``gshard`` is this rank's chunk of the
        flat gradient, ``segments`` each element's leaf (``len(names)`` for
        the padding); the leaves' square sums and counts are summed over
        the ranks."""
        n = len(self.names)
        sq = torch.zeros((n + 1,), dtype=torch.float32, device=gshard.device)
        sq.index_add_(0, segments, gshard.square())
        self.sq += coll.all_reduce(sq)[:n]
        if self.bins:
            nb = 2 * self.bins + 1
            hist = torch.zeros(((n + 1) * nb,), dtype=torch.int64, device=gshard.device)
            idx = grad_hist_index(gshard, self.bins) + segments * nb
            hist.index_add_(0, idx, torch.ones_like(idx))
            self.hist += coll.all_reduce(hist)[:n * nb]
        self.updates += 1

    def fetch(self) -> dict:
        """``gradients/<leaf>/norm``: the RMS over the updates of the leaf's
        gradient norm; ``gradients/<leaf>/hist``: the counts over every
        update."""
        norms = (self.sq / max(self.updates, 1)).sqrt().tolist()
        out = {f"gradients/{name}/norm": v for name, v in zip(self.names, norms)}
        if self.bins:
            edges = grad_hist_edges(self.bins)
            counts = self.hist.view(len(self.names), -1).tolist()
            for name, c in zip(self.names, counts):
                out[f"gradients/{name}/hist"] = {"_type": "histogram", "counts": c, "edges": edges}
        return out


def histogram(x: torch.Tensor, bins: int):
    """``jnp.histogram(x, bins)`` on a flat f32 tensor: ``bins`` equal bins
    from min to max (+-0.5 around a constant), the last including its right
    edge. Returns (counts, edges) as lists."""
    lo, hi = (float(v) for v in torch.stack([x.min(), x.max()]).tolist())
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    edges = torch.linspace(lo, hi, bins + 1, dtype=torch.float32, device=x.device)
    idx = torch.clamp(torch.bucketize(x, edges, right=True) - 1, 0, bins - 1)
    counts = torch.zeros((bins,), dtype=torch.int64, device=x.device)
    counts.index_add_(0, idx, torch.ones_like(idx))
    return counts.tolist(), edges.tolist()


class PPOOptimizer:
    """Global-norm clip, then AdamW with a scheduled lr (the JAX package's
    ``optax.chain(clip_by_global_norm(0.5), adamw(schedule, eps=1e-5,
    weight_decay=0.01))``)."""

    def __init__(self, params, lr_schedule: Callable[[int], float],
                 max_grad_norm: float = 0.5, eps: float = 1e-5, weight_decay: float = 0.01):
        self.params = [p for p in params if p.requires_grad]
        self.lr_schedule = lr_schedule
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.dp = None  # a DataParallel: gradients averaged over its ranks
        self.adamw = torch.optim.AdamW(
            self.params, lr=lr_schedule(0), eps=eps, weight_decay=weight_decay
        )

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def reduce_grads(self) -> None:
        """Data parallel: each gradient becomes the mean over the ranks, by
        one all-reduce of the flat gradient."""
        grads = [p.grad for p in self.params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.dp.coll.all_reduce(flat).div_(self.dp.world)
        for g, f in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(f.view_as(g))

    def clip(self, watch: Optional[GradWatch] = None) -> torch.Tensor:
        """Scale the gradients to the global norm ``max_grad_norm`` where
        they exceed it; returns the pre-clip norm. ``watch`` takes the
        gradients before the clip (and after the ranks' mean)."""
        if self.dp is not None:
            self.reduce_grads()
        grads = [p.grad for p in self.params]
        norms = torch._foreach_norm(grads)
        if watch is not None:
            watch.add(grads, norms)
        norm = torch.linalg.vector_norm(torch.stack(norms))
        # optax: g if norm < max else g / norm * max
        clipped = norm >= self.max_grad_norm
        scale = torch.where(clipped, self.max_grad_norm / norm, torch.ones_like(norm))
        torch._foreach_mul_(grads, scale)
        return norm

    def step(self, watch: Optional[GradWatch] = None) -> torch.Tensor:
        """Clip, step, advance the update count; returns the pre-clip norm."""
        norm = self.clip(watch)
        for group in self.adamw.param_groups:
            group["lr"] = self.lr_schedule(self.count)
        self.adamw.step()
        self.count += 1
        return norm.detach()


class DeviceOptimizer(PPOOptimizer):
    """The fused trainer's optimizer: the same clip and AdamW, with the lr
    and the step counts on the device. The lr is the 0-d float32 tensor
    ``lr``, which the caller sets on the device (``alg/fused.py``, from the
    iteration counter through ``schedules.make_lr_fn``); on the card AdamW
    is ``capturable``, so a CUDA graph replays the whole step. AdamW's
    state is made here, as its first step would make it, so that
    checkpoints and graph captures copy into tensors that stay put."""

    def __init__(self, params, lr: float, max_grad_norm: float = 0.5, eps: float = 1e-5,
                 weight_decay: float = 0.01):
        self.params = [p for p in params if p.requires_grad]
        self.max_grad_norm = max_grad_norm
        self.dp = None
        device = self.params[0].device
        capturable = device.type == "cuda"
        self.lr = torch.full((), lr, dtype=torch.float32, device=device)
        self.adamw = torch.optim.AdamW(self.params, lr=self.lr, eps=eps,
                                       weight_decay=weight_decay, capturable=capturable)
        for p in self.params:
            self.adamw.state[p] = {
                "step": torch.zeros((), dtype=torch.float32,
                                    device=device if capturable else "cpu"),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
            }

    def state_tensors(self) -> dict:
        """AdamW's state by a flat name (parameter index / field)."""
        return {f"{i}/{k}": v for i, p in enumerate(self.params)
                for k, v in self.adamw.state[p].items()}

    def step(self, watch: Optional[GradWatch] = None) -> torch.Tensor:
        norm = self.clip(watch)
        self.adamw.step()
        return norm.detach()


# ---------------------------------------------------------------------------
# rollout and update
# ---------------------------------------------------------------------------


def rollout_buffers(config: PPOConfig, device, num_envs: Optional[int] = None):
    """The trajectory buffers, a dict of (T, E, ...) tensors (E =
    ``num_envs``, a rank's envs, default all), and the finished-episode
    sums: (3,), or (3, fin_blocks)."""
    t_len, e = config.n_steps, num_envs or config.num_envs
    m, n, a = config.env.m, config.env.n, config.env.num_actions
    traj = {
        "obs": torch.empty((t_len, e, 2, m, n), dtype=torch.uint8, device=device),
        "mask": torch.empty((t_len, e, a), dtype=torch.bool, device=device),
        "actions": torch.empty((t_len, e), dtype=torch.int64, device=device),
        "log_probs": torch.empty((t_len, e), dtype=torch.float32, device=device),
        "rewards": torch.empty((t_len, e), dtype=torch.float32, device=device),
        "values": torch.empty((t_len, e), dtype=torch.float32, device=device),
        "dones": torch.empty((t_len, e), dtype=torch.bool, device=device),
    }
    blocks = config.fin_blocks
    fin = torch.zeros((3, blocks) if blocks else (3,), dtype=torch.float32, device=device)
    return traj, fin


def _write_row(buf: torch.Tensor, t, value: torch.Tensor) -> None:
    """buf[t] = value; ``t`` an int, or a (1,) int64 tensor on the device."""
    if isinstance(t, int):
        buf[t] = value
    else:
        buf.index_copy_(0, t, value.to(buf.dtype)[None])


@torch.no_grad()
def rollout_step(model, config: PPOConfig, opponent, sp_state, obs: dict, ep_rew: torch.Tensor,
                 ep_len: torch.Tensor, traj: dict, fin: torch.Tensor, t,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None, sides: Optional[torch.Tensor] = None,
                 shard=None):
    """One step of ``rollout_impl``: writes row ``t`` of ``traj`` (an int, or
    a (1,) int64 tensor on the device, the fused trainer's step counter) and
    adds the episodes that finished to ``fin``, in place. ``noise`` (E, A)
    and ``sides`` (E,) inject the step's draws (this rank's rows). With
    ``shard`` (a rank's ``EnvShard``) the draws are the rank's rows of draws
    over the whole batch, and the block sums go to the global blocks.
    Returns (sp_state, obs, ep_rew, ep_len)."""
    blocks = config.fin_blocks

    def finsum(x):  # block i = envs [i E / blocks, (i + 1) E / blocks)
        if not blocks:
            return x.sum()
        if shard is None:
            return x.reshape(blocks, -1).sum(1)
        per, out = shard.total // blocks, x.new_zeros((blocks,))
        for i in range(blocks):
            lo, hi = max(i * per, shard.start), min((i + 1) * per, shard.stop)
            if lo < hi:
                out[i] = x[lo - shard.start:hi - shard.start].sum()
        return out

    logits, value = train_apply(model, obs["observation"])
    mlogits = mask_logits(logits, obs["action_mask"])
    if shard is not None:
        if noise is None:
            noise = shard.uniform(mlogits.shape[1:], generator, mlogits.device)
        if sides is None:
            sides = shard.sides(generator, mlogits.device)
    actions = masked_sample(mlogits, generator, noise)
    logp = log_prob(mlogits, actions)
    _write_row(traj["obs"], t, obs["observation"])
    _write_row(traj["mask"], t, obs["action_mask"])
    sp_state, obs, rewards, dones = selfplay_step(
        config.env, opponent, sp_state, actions, generator, sides
    )
    ep_rew = ep_rew + rewards
    ep_len = ep_len + 1.0
    d = dones.to(torch.float32)
    fin += torch.stack([finsum(ep_rew * d), finsum(ep_len * d), finsum(d)])
    ep_rew = ep_rew * (1.0 - d)
    ep_len = ep_len * (1.0 - d)
    _write_row(traj["actions"], t, actions)
    _write_row(traj["log_probs"], t, logp)
    _write_row(traj["rewards"], t, rewards)
    _write_row(traj["values"], t, value[:, 0])
    _write_row(traj["dones"], t, dones)
    return sp_state, obs, ep_rew, ep_len


@torch.no_grad()
def rollout_impl(
    model,
    config: PPOConfig,
    opponent,
    sp_state,
    obs: dict,
    ep_rew: torch.Tensor,
    ep_len: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    draws: Optional[dict] = None,
    dp=None,
):
    """Collect ``n_steps`` self-play steps (``dp``: this rank's envs, the
    sums all-reduced).

    ``draws`` optionally injects the step's randomness: ``"noise"``
    (T, E, A) uniforms for the agent's sampling and ``"sides"`` (T, E) side
    draws for auto-resets, over the whole batch.

    Returns (sp_state, obs, traj, fin, (ep_rew, ep_len)): traj is a dict of
    (T, E, ...) tensors, fin = (finished reward sum, finished length sum,
    finished count), a (3,) tensor, or (3, fin_blocks) with a sum for each
    block of envs.
    """
    traj, fin = rollout_buffers(config, ep_rew.device, ep_rew.shape[0])
    shard = None if dp is None else dp.shard
    rows = (lambda x: x) if shard is None else shard.take
    for t in range(config.n_steps):
        sp_state, obs, ep_rew, ep_len = rollout_step(
            model, config, opponent, sp_state, obs, ep_rew, ep_len, traj, fin, t, generator,
            rows(draws["noise"][t]) if draws is not None else None,
            rows(draws["sides"][t]) if draws is not None else None,
            shard,
        )
    if dp is not None:
        dp.coll.all_reduce(fin)
    return sp_state, obs, traj, fin, (ep_rew, ep_len)


def _minibatch_indices(
    config: PPOConfig, generator: Optional[torch.Generator], device, world: int = 1,
    rank: int = 0,
) -> torch.Tensor:
    """One epoch's shuffled indices, drawn over the whole batch, as
    ``rank_indices`` gives rank ``rank`` of ``world`` its part of them.

    Over the whole batch: (num_minibatches, batch_size) rows for "global"
    and "tiled" (env-major row ids), (num_minibatches, batch_size //
    group_size) groups for "grouped", and (num_minibatches, d, batch_size //
    group_size // d) each shard's own group ids for "grouped" over
    ``shard_groups`` d > 1 (the JAX package's layouts)."""
    d = config.shard_groups
    nm = config.num_minibatches
    if config.shuffle == "grouped":
        n_groups = config.total_batch // config.group_size
        mb_groups = config.batch_size // config.group_size
        if d > 1:
            if n_groups % d or mb_groups % d:
                raise ValueError(f"grouped shuffle over {d} shards needs group counts divisible "
                                 f"by the shard count (total {n_groups}, per minibatch "
                                 f"{mb_groups})")
            per = n_groups // d
            perms = torch.stack([torch.randperm(per, generator=generator, device=device)
                                 for _ in range(d)])
            idx = perms.reshape(d, nm, mb_groups // d).transpose(0, 1)
        else:
            perm = torch.randperm(n_groups, generator=generator, device=device)
            idx = perm.reshape(nm, mb_groups)
    elif config.shuffle == "tiled" and d > 1:
        n = config.total_batch
        if n % d or config.batch_size % d:
            raise ValueError(f"tiled shuffle over {d} blocks needs the batch sizes divisible by "
                             f"it ({n}, {config.batch_size})")
        per_group = n // d
        perms = torch.stack([torch.randperm(per_group, generator=generator, device=device)
                             for _ in range(d)])
        perms = perms + torch.arange(d, device=device)[:, None] * per_group
        idx = perms.reshape(d, nm, config.batch_size // d).transpose(0, 1).reshape(
            nm, config.batch_size)
    elif config.shuffle in ("global", "tiled"):
        perm = torch.randperm(config.total_batch, generator=generator, device=device)
        idx = perm.reshape(nm, config.batch_size)
    else:
        raise ValueError(f"unknown shuffle {config.shuffle!r}")
    return rank_indices(config, idx, world, rank)


def rank_indices(config: PPOConfig, idx: torch.Tensor, world: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s part of an epoch's indices over the whole batch
    (``_minibatch_indices``' layouts), in its own rows: its shards' columns
    for the sharded "grouped" (num_minibatches, d / world, groups), its
    blocks' rows, less its first row, for "tiled" (num_minibatches,
    batch_size / world). One rank keeps them all."""
    if world == 1:
        return idx
    d = config.shard_groups
    if d % world:
        raise ValueError(f"shard_groups ({d}) must be a multiple of the world size ({world})")
    if config.shuffle == "grouped" and d > 1:
        k = d // world
        return idx[:, rank * k:(rank + 1) * k]
    if config.shuffle == "tiled" and d > 1:
        cols = config.batch_size // world
        return idx[:, rank * cols:(rank + 1) * cols] - rank * (config.total_batch // world)
    raise ValueError(f"the {config.shuffle!r} shuffle over one shard draws rows from every "
                     f"rank: use 'grouped' or 'tiled' over {world} ranks")


@torch.no_grad()
def _update_prepare_impl(model, config: PPOConfig, traj: dict, final_obs: dict,
                         dp=None) -> dict:
    """Bootstrap value, GAE, buffer-global advantage normalisation and the
    minibatch-layout flatten (of this rank's envs, with ``dp``)."""
    _, last_value = train_apply(model, final_obs["observation"])
    advantages, returns = compute_gae(
        traj["rewards"], traj["values"], traj["dones"], last_value[:, 0],
        config.gamma, config.gae_lambda,
    )
    world = 1 if dp is None else dp.world
    t_len, e = traj["rewards"].shape
    if config.shuffle == "grouped":
        if config.total_batch % config.group_size or config.batch_size % config.group_size:
            raise ValueError("grouped shuffle: group_size must divide the batch sizes")
        n_groups = t_len * e // config.group_size
        shards = config.shard_groups // world

        if shards > 1:

            def flat(x):  # shard-major, then time-major within each shard
                y = x.reshape((t_len, shards, e // shards) + tuple(x.shape[2:])).transpose(0, 1)
                return y.reshape((n_groups, config.group_size) + tuple(x.shape[2:]))
        else:

            def flat(x):  # time-major: a group = adjacent envs at one timestep
                return x.reshape((n_groups, config.group_size) + tuple(x.shape[2:]))
    else:

        def flat(x):  # env-major rows, as the JAX package flattens them
            return x.transpose(0, 1).reshape((t_len * e,) + tuple(x.shape[2:]))

    if dp is None:
        advantages = (advantages - advantages.mean()) / (advantages.std() + 1e-8)
    else:  # over every rank's buffer, ddof=1
        mean = dp.mean(advantages.mean())
        sq = dp.coll.all_reduce(((advantages - mean) ** 2).sum())
        advantages = (advantages - mean) / (torch.sqrt(sq / (config.total_batch - 1)) + 1e-8)
    return {
        "obs": flat(traj["obs"]),
        "mask": flat(traj["mask"]),
        "actions": flat(traj["actions"]),
        "old_logp": flat(traj["log_probs"]),
        "returns": flat(returns),
        "adv": flat(advantages),
    }


_METRIC_KEYS = (
    "actor_loss",
    "critic_loss",
    "entropy_loss",
    "grad_norm",
    "clip_fraction",
    "approx_kl",
    "explained_variance",
)


def gather_minibatch(x: torch.Tensor, rows: torch.Tensor, grouped: bool) -> torch.Tensor:
    """A minibatch of a flat buffer: ``rows`` are row ids, group ids, or
    (shards, groups) each shard's own group ids over a shard-major buffer;
    groups come back as rows."""
    if rows.dim() == 2:
        xs = x.reshape((rows.shape[0], -1) + tuple(x.shape[1:]))
        picked = xs[torch.arange(rows.shape[0], device=rows.device)[:, None], rows]
    else:
        picked = x[rows]
    if grouped:
        picked = picked.reshape((-1,) + tuple(x.shape[2:]))
    return picked


def minibatch_update(model, config: PPOConfig, optimizer: PPOOptimizer, flats: dict,
                     rows: torch.Tensor, entropy_coef, watch: Optional[GradWatch] = None,
                     dp=None) -> torch.Tensor:
    """One minibatch update on the ``rows`` (or groups) of ``flats``;
    returns its metrics, a (7,) tensor in ``_METRIC_KEYS`` order.
    ``entropy_coef`` is a float or a 0-d tensor; ``watch`` takes the
    pre-clip gradients. With ``dp`` the rows are this rank's part of the
    minibatch (its shards' (shards, groups) for the sharded "grouped"
    shuffle) and the metrics are the whole minibatch's."""
    def take(x):
        return gather_minibatch(x, rows, config.shuffle == "grouped")

    obs, mask, actions = take(flats["obs"]), take(flats["mask"]), take(flats["actions"])
    old_logp, rets, adv = take(flats["old_logp"]), take(flats["returns"]), take(flats["adv"])

    logits, value = train_apply(model, obs)
    mlogits = mask_logits(logits, mask)
    new_logp = log_prob(mlogits, actions)
    ent = masked_entropy(mlogits).mean()

    log_ratio = new_logp - old_logp
    ratio = torch.exp(log_ratio)
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1.0 - config.clip_range, 1.0 + config.clip_range) * adv
    actor_loss = -torch.minimum(surr1, surr2).mean()
    critic_loss = torch.mean((value[:, 0] - rets) ** 2)
    entropy_loss = -ent
    total = actor_loss + config.value_coef * critic_loss + entropy_coef * entropy_loss

    optimizer.zero_grad()
    total.backward()
    grad_norm = optimizer.step(watch)

    with torch.no_grad():
        clip_frac = ((ratio - 1.0).abs() > config.clip_range).to(torch.float32).mean()
        approx_kl = ((ratio - 1.0) - log_ratio).mean()
        if dp is None:
            rvar = rets.var()
        else:  # each mean over the whole minibatch: one all-reduce
            g = dp.mean(torch.stack([actor_loss, critic_loss, entropy_loss, clip_frac,
                                     approx_kl, rets.mean(), (rets * rets).mean()]))
            actor_loss, critic_loss, entropy_loss, clip_frac, approx_kl = g[:5]
            b = config.batch_size
            rvar = (g[6] - g[5] * g[5]) * (b / (b - 1.0))
        explained_var = torch.where(
            rvar > 1e-8, 1.0 - critic_loss / rvar, torch.zeros_like(rvar)
        )
        return torch.stack([
            actor_loss, critic_loss, entropy_loss, grad_norm,
            clip_frac, approx_kl, explained_var,
        ]).detach()


def _update_epochs_impl(
    model,
    config: PPOConfig,
    optimizer: PPOOptimizer,
    flats: dict,
    entropy_coef: float,
    epoch_indices: Sequence[torch.Tensor],
    watch: Optional[GradWatch] = None,
    dp=None,
) -> dict:
    """Minibatch SGD over the given epochs' indices (this rank's, with
    ``dp``); returns the per-update mean of each metric as a 0-d tensor.
    ``watch`` takes every update's pre-clip gradients."""
    sums = torch.zeros((len(_METRIC_KEYS),), dtype=torch.float32, device=flats["adv"].device)
    n_updates = 0
    for idx in epoch_indices:
        for rows in idx:
            sums += minibatch_update(model, config, optimizer, flats, rows, entropy_coef, watch,
                                     dp)
            n_updates += 1
    return dict(zip(_METRIC_KEYS, sums / max(n_updates, 1)))


def attach_batch_stat_sync(model, dp) -> None:
    """Every BatchNorm of ``model`` takes its train-mode statistics over
    ``dp``'s ranks."""
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.stat_sync = dp.batch_stats


# ---------------------------------------------------------------------------
# host-side orchestration
# ---------------------------------------------------------------------------


class PPOLearner:
    """Owns the model, optimizer, env state and generator; ``learn`` runs
    one training iteration against a given opponent policy. The last
    ``rollout`` and ``update`` are measured into ``rollout_interval`` and
    ``update_interval``."""

    def __init__(self, model, config: PPOConfig, optimizer: PPOOptimizer,
                 generator: torch.Generator, device, dp=None):
        self.model = model
        self.config = config
        self.generator = generator
        self.device = torch.device(device)
        self.dp = dp
        if dp is not None:
            if config.shuffle == "global" or config.shard_groups % dp.world:
                raise ValueError(f"{dp.world} ranks need the 'grouped' or 'tiled' shuffle over "
                                 f"a multiple of {dp.world} shards (shuffle={config.shuffle!r}, "
                                 f"shard_groups={config.shard_groups})")
            attach_batch_stat_sync(model, dp)
        self.optimizer = optimizer
        self._sp_state = None
        self._obs = None
        self._ep_rew = None
        self._ep_len = None
        self.rollout_interval = Interval(self.device)
        self.update_interval = Interval(self.device)

    @property
    def optimizer(self):
        return self._optimizer

    @optimizer.setter
    def optimizer(self, optimizer) -> None:
        self._optimizer = optimizer
        if self.dp is not None and not self.config.zero_update:
            optimizer.dp = self.dp

    @property
    def num_envs(self) -> int:
        """This rank's envs (all of them on one rank)."""
        return self.config.num_envs if self.dp is None else self.dp.shard.size

    def reset_envs(self, opponent, agent_side: Optional[torch.Tensor] = None) -> None:
        """Fresh envs; ``agent_side`` injects the sides (this rank's)."""
        e = self.num_envs
        if agent_side is None and self.dp is not None:
            agent_side = self.dp.shard.sides(self.generator, self.device)
        self._sp_state, self._obs = selfplay_reset(
            self.config.env, opponent, e, self.device, self.generator, agent_side
        )
        self._ep_rew = torch.zeros((e,), dtype=torch.float32, device=self.device)
        self._ep_len = torch.zeros((e,), dtype=torch.float32, device=self.device)

    def rollout(self, opponent, draws: Optional[dict] = None):
        with span("rollout", self.rollout_interval):
            if self._sp_state is None:
                self.reset_envs(opponent)
            (self._sp_state, self._obs, traj, fin, (self._ep_rew, self._ep_len)) = rollout_impl(
                self.model, self.config, opponent, self._sp_state, self._obs,
                self._ep_rew, self._ep_len, self.generator, draws, self.dp,
            )
        return traj, fin

    def update(self, traj: dict, entropy_coef: float,
               epoch_indices: Optional[Sequence[torch.Tensor]] = None,
               watch: Optional[GradWatch] = None) -> dict:
        """Prepare + ``ppo_epochs`` epochs (indices drawn unless injected;
        injected ones are over the whole batch)."""
        with span("update", self.update_interval):
            with span("update.prepare"):
                flats = _update_prepare_impl(self.model, self.config, traj, self._obs, self.dp)
                world, rank = (1, 0) if self.dp is None else (self.dp.world, self.dp.rank)
                if epoch_indices is None:
                    epoch_indices = [
                        _minibatch_indices(self.config, self.generator, self.device, world, rank)
                        for _ in range(self.config.ppo_epochs)
                    ]
                else:
                    epoch_indices = [rank_indices(self.config, idx, world, rank)
                                     for idx in epoch_indices]
            with span("update.epochs"):
                return _update_epochs_impl(
                    self.model, self.config, self.optimizer, flats, entropy_coef, epoch_indices,
                    watch, self.dp,
                )

    def leaf_names(self) -> list:
        """The optimizer's parameters by their path in the JAX package's
        ``params`` tree, in the optimizer's order."""
        named = [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]
        paths = flax_param_paths(n for n, _ in named)
        return [paths[n] for n, _ in named]

    def grad_watch(self) -> GradWatch:
        return GradWatch(self.leaf_names(), self.optimizer.params, self.config.watch_hist_bins)

    def learn(self, opponent, entropy_coef: float, watch: bool = False) -> TrainingMetrics:
        """One training iteration; ``watch`` also gathers the update's
        gradient statistics (``layer_grad_norms``)."""
        cfg = self.config
        traj, fin = self.rollout(opponent)
        grad_watch = self.grad_watch() if watch else None
        metrics = self.update(traj, entropy_coef, watch=grad_watch)
        with span("read"):
            host = torch.cat([torch.stack(list(metrics.values())), fin.reshape(-1)]).tolist()
            layer_grad_norms = grad_watch.fetch() if watch else None
        rollout_time = self.rollout_interval.device_s
        learn_time = self.update_interval.device_s
        metrics_host = dict(zip(metrics, host))
        fin_host = host[len(metrics):]
        block_rewards = None
        if cfg.fin_blocks:
            k = cfg.fin_blocks
            rew, cnt = fin_host[:k], fin_host[2 * k:]
            block_rewards = [r / c if c else None for r, c in zip(rew, cnt)]
            fin_host = [sum(fin_host[i * k:(i + 1) * k]) for i in range(3)]
        fin_rew, fin_len, fin_cnt = fin_host
        total_steps = cfg.n_steps * cfg.num_envs
        return TrainingMetrics(
            mean_reward=fin_rew / fin_cnt if fin_cnt else 0.0,
            mean_length=fin_len / fin_cnt if fin_cnt else 0.0,
            actor_loss=metrics_host["actor_loss"],
            critic_loss=metrics_host["critic_loss"],
            entropy_loss=metrics_host["entropy_loss"],
            grad_norm=metrics_host["grad_norm"],
            clip_fraction=metrics_host["clip_fraction"],
            explained_variance=metrics_host["explained_variance"],
            approx_kl=metrics_host["approx_kl"],
            fps=total_steps / rollout_time if rollout_time > 0 else 0.0,
            rollout_time=rollout_time,
            learn_time=learn_time,
            layer_grad_norms=layer_grad_norms,
            block_rewards=block_rewards,
        )

    @torch.no_grad()
    def param_stats(self, histogram_bins: int = 0) -> dict:
        """``parameters/<leaf>/norm`` for every parameter and, with
        ``histogram_bins`` > 0, ``parameters/<leaf>/hist`` (``jnp.histogram``
        of its values): the parameter half of the watch."""
        params = [p.detach().to(torch.float32) for p in self.optimizer.params]
        names = self.leaf_names()
        norms = torch.stack(torch._foreach_norm(params)).tolist()
        out = {f"parameters/{name}/norm": v for name, v in zip(names, norms)}
        if histogram_bins:
            for name, p in zip(names, params):
                counts, edges = histogram(p.reshape(-1), histogram_bins)
                out[f"parameters/{name}/hist"] = {"_type": "histogram", "counts": counts,
                                                  "edges": edges}
        return out
