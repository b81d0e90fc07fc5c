"""PPO self-play learner: rollout, GAE and the clipped-surrogate update.

Counterpart of the JAX package's ``alg/ppo.py`` for one device:

  * ``rollout_impl``: ``n_steps`` train-mode forwards (batch-statistic
    BatchNorm, running statistics updated in place), masked gumbel-max
    sampling, self-play steps; observations stored as uint8; the per-env
    episode accumulators carry across ``learn`` calls.
  * ``_update_prepare_impl``: bootstrap value (train-mode forward), GAE,
    advantage normalisation over the whole buffer (ddof=1), and the
    minibatch layout flatten.
  * ``_minibatch_indices``: the ``global`` row shuffle and the ``grouped``
    shuffle of contiguous ``group_size`` chunks (time-major flatten).
  * the epoch loss: clipped surrogate, 0.5 * value MSE, entropy bonus, with
    clip fraction, approx-KL and explained variance.
  * ``PPOOptimizer``: global-norm clip 0.5, then AdamW (eps 1e-5, weight
    decay 0.01) with the lr schedule evaluated at the update count.

Every stochastic step takes its draws from an explicit ``torch.Generator``
or from the caller: sampling noise and side draws (``rollout_impl``'s
``draws``) and minibatch indices (``epoch_indices``).

Timing: ``rollout_time`` covers sampling and env stepping, ``learn_time``
bootstrap + GAE + update; ``fps = n_steps * num_envs / rollout_time``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import torch

from ..env.mnk_env import EnvConfig
from ..models.registry import train_apply
from ..ops.masked import entropy as masked_entropy
from ..ops.masked import log_prob, mask_logits, masked_sample
from ..selfplay.wrapper import selfplay_reset, selfplay_step
from .gae import compute_gae


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """PPO hyperparameters (defaults as in the JAX package).

    ``shuffle``: "global" = one row permutation of the (num_envs * n_steps)
    batch per epoch; "grouped" = a permutation of contiguous groups of
    ``group_size`` samples (adjacent envs at one timestep), each minibatch
    gathering ``batch_size / group_size`` whole groups.
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
    group_size: int = 128

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
    """Per-iteration metrics (the JAX package's fields on this path)."""

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
        self.adamw = torch.optim.AdamW(
            self.params, lr=lr_schedule(0), eps=eps, weight_decay=weight_decay
        )

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip, step, advance the update count; returns the pre-clip norm."""
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # optax: g if norm < max else g / norm * max
        clipped = norm >= self.max_grad_norm
        scale = torch.where(clipped, self.max_grad_norm / norm, torch.ones_like(norm))
        torch._foreach_mul_(grads, scale)
        for group in self.adamw.param_groups:
            group["lr"] = self.lr_schedule(self.count)
        self.adamw.step()
        self.count += 1
        return norm.detach()


# ---------------------------------------------------------------------------
# rollout and update
# ---------------------------------------------------------------------------


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
):
    """Collect ``n_steps`` self-play steps.

    ``draws`` optionally injects the step's randomness: ``"noise"``
    (T, E, A) uniforms for the agent's sampling and ``"sides"`` (T, E) side
    draws for auto-resets.

    Returns (sp_state, obs, traj, fin, (ep_rew, ep_len)): traj is a dict of
    (T, E, ...) tensors, fin = (finished reward sum, finished length sum,
    finished count) as 0-d tensors.
    """
    t_len, e = config.n_steps, config.num_envs
    device = ep_rew.device
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
    fin = torch.zeros((3,), dtype=torch.float32, device=device)
    for t in range(t_len):
        logits, value = train_apply(model, obs["observation"])
        mlogits = mask_logits(logits, obs["action_mask"])
        noise = draws["noise"][t] if draws is not None else None
        actions = masked_sample(mlogits, generator, noise)
        logp = log_prob(mlogits, actions)
        traj["obs"][t] = obs["observation"]
        traj["mask"][t] = obs["action_mask"]
        sides = draws["sides"][t] if draws is not None else None
        sp_state, obs, rewards, dones = selfplay_step(
            config.env, opponent, sp_state, actions, generator, sides
        )
        ep_rew = ep_rew + rewards
        ep_len = ep_len + 1.0
        d = dones.to(torch.float32)
        fin += torch.stack([(ep_rew * d).sum(), (ep_len * d).sum(), d.sum()])
        ep_rew = ep_rew * (1.0 - d)
        ep_len = ep_len * (1.0 - d)
        traj["actions"][t] = actions
        traj["log_probs"][t] = logp
        traj["rewards"][t] = rewards
        traj["values"][t] = value[:, 0]
        traj["dones"][t] = dones
    return sp_state, obs, traj, fin, (ep_rew, ep_len)


def _minibatch_indices(
    config: PPOConfig, generator: Optional[torch.Generator], device
) -> torch.Tensor:
    """One epoch's shuffled indices: (num_minibatches, batch_size) rows for
    "global", (num_minibatches, batch_size // group_size) groups for
    "grouped"."""
    if config.shuffle == "grouped":
        n_groups = config.total_batch // config.group_size
        perm = torch.randperm(n_groups, generator=generator, device=device)
        return perm.reshape(config.num_minibatches, config.batch_size // config.group_size)
    if config.shuffle != "global":
        raise ValueError(f"unsupported shuffle {config.shuffle!r} on one device")
    perm = torch.randperm(config.total_batch, generator=generator, device=device)
    return perm.reshape(config.num_minibatches, config.batch_size)


@torch.no_grad()
def _update_prepare_impl(model, config: PPOConfig, traj: dict, final_obs: dict) -> dict:
    """Bootstrap value, GAE, buffer-global advantage normalisation and the
    minibatch-layout flatten."""
    _, last_value = train_apply(model, final_obs["observation"])
    advantages, returns = compute_gae(
        traj["rewards"], traj["values"], traj["dones"], last_value[:, 0],
        config.gamma, config.gae_lambda,
    )
    if config.shuffle == "grouped":
        if config.total_batch % config.group_size or config.batch_size % config.group_size:
            raise ValueError("grouped shuffle: group_size must divide the batch sizes")
        n_groups = config.total_batch // config.group_size

        def flat(x):  # time-major: a group = adjacent envs at one timestep
            return x.reshape((n_groups, config.group_size) + tuple(x.shape[2:]))
    else:

        def flat(x):  # env-major rows, as the JAX package flattens them
            return x.transpose(0, 1).reshape((config.total_batch,) + tuple(x.shape[2:]))

    advantages = (advantages - advantages.mean()) / (advantages.std() + 1e-8)
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


def _update_epochs_impl(
    model,
    config: PPOConfig,
    optimizer: PPOOptimizer,
    flats: dict,
    entropy_coef: float,
    epoch_indices: Sequence[torch.Tensor],
) -> dict:
    """Minibatch SGD over the given epochs' indices; returns the per-update
    mean of each metric as a 0-d tensor."""
    grouped = config.shuffle == "grouped"
    sums = torch.zeros((len(_METRIC_KEYS),), dtype=torch.float32, device=flats["adv"].device)
    n_updates = 0
    for idx in epoch_indices:
        for rows in idx:
            def take(x):
                picked = x[rows]
                if grouped:
                    picked = picked.reshape((config.batch_size,) + tuple(x.shape[2:]))
                return picked

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
            grad_norm = optimizer.step()

            with torch.no_grad():
                clip_frac = ((ratio - 1.0).abs() > config.clip_range).to(torch.float32).mean()
                approx_kl = ((ratio - 1.0) - log_ratio).mean()
                rvar = rets.var()
                explained_var = torch.where(
                    rvar > 1e-8, 1.0 - critic_loss / rvar, torch.zeros_like(rvar)
                )
                sums += torch.stack([
                    actor_loss, critic_loss, entropy_loss, grad_norm,
                    clip_frac, approx_kl, explained_var,
                ]).detach()
            n_updates += 1
    return dict(zip(_METRIC_KEYS, sums / max(n_updates, 1)))


# ---------------------------------------------------------------------------
# host-side orchestration
# ---------------------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PPOLearner:
    """Owns the model, optimizer, env state and generator; ``learn`` runs
    one training iteration against a given opponent policy."""

    def __init__(self, model, config: PPOConfig, optimizer: PPOOptimizer,
                 generator: torch.Generator, device):
        self.model = model
        self.config = config
        self.optimizer = optimizer
        self.generator = generator
        self.device = torch.device(device)
        self._sp_state = None
        self._obs = None
        self._ep_rew = None
        self._ep_len = None

    def reset_envs(self, opponent, agent_side: Optional[torch.Tensor] = None) -> None:
        e = self.config.num_envs
        self._sp_state, self._obs = selfplay_reset(
            self.config.env, opponent, e, self.device, self.generator, agent_side
        )
        self._ep_rew = torch.zeros((e,), dtype=torch.float32, device=self.device)
        self._ep_len = torch.zeros((e,), dtype=torch.float32, device=self.device)

    def rollout(self, opponent, draws: Optional[dict] = None):
        if self._sp_state is None:
            self.reset_envs(opponent)
        (self._sp_state, self._obs, traj, fin, (self._ep_rew, self._ep_len)) = rollout_impl(
            self.model, self.config, opponent, self._sp_state, self._obs,
            self._ep_rew, self._ep_len, self.generator, draws,
        )
        return traj, fin

    def update(self, traj: dict, entropy_coef: float,
               epoch_indices: Optional[Sequence[torch.Tensor]] = None) -> dict:
        """Prepare + ``ppo_epochs`` epochs (indices drawn unless injected)."""
        flats = _update_prepare_impl(self.model, self.config, traj, self._obs)
        if epoch_indices is None:
            epoch_indices = [
                _minibatch_indices(self.config, self.generator, self.device)
                for _ in range(self.config.ppo_epochs)
            ]
        return _update_epochs_impl(
            self.model, self.config, self.optimizer, flats, entropy_coef, epoch_indices
        )

    def learn(self, opponent, entropy_coef: float) -> TrainingMetrics:
        """One training iteration."""
        cfg = self.config
        t0 = time.perf_counter()
        traj, fin = self.rollout(opponent)
        _sync(self.device)
        rollout_time = time.perf_counter() - t0
        t1 = time.perf_counter()
        metrics = self.update(traj, entropy_coef)
        host = torch.stack(list(metrics.values()) + list(fin)).tolist()
        learn_time = time.perf_counter() - t1
        metrics_host = dict(zip(metrics, host))
        fin_rew, fin_len, fin_cnt = host[len(metrics):]
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
        )
