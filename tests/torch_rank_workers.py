"""What the ranks run in the data-parallel tests of the port
(``tests/test_torch_distributed.py``, ``tests/test_torch_zero.py``), one
process a rank through ``rl_selfplay_mnk_tpu_torch.parallel.launch``.

Each function takes numpy inputs over the whole batch, runs the port's
data-parallel pieces on this rank's rows, and returns numpy results. This
module imports no JAX: the ranks run the port alone."""

import os

import numpy as np
import torch

torch.set_num_threads(1)

from rl_selfplay_mnk_tpu_torch import env as tenv  # noqa: E402
from rl_selfplay_mnk_tpu_torch.alg import ppo as tppo  # noqa: E402
from rl_selfplay_mnk_tpu_torch.alg.zero_epochs import ZeroOptimizer  # noqa: E402
from rl_selfplay_mnk_tpu_torch.models import (  # noqa: E402
    create_model_from_architecture,
    flax_to_state_dict,
    state_dict_to_flax,
)
from rl_selfplay_mnk_tpu_torch.parallel.mesh import data_parallel  # noqa: E402
from rl_selfplay_mnk_tpu_torch.selfplay import Policy  # noqa: E402
from rl_selfplay_mnk_tpu_torch.selfplay.wrapper import selfplay_reset  # noqa: E402


def first_legal(params, obs, generator=None, deterministic=False, shard=None):
    return torch.argmax(obs["action_mask"].to(torch.int32), -1)


def _tensors(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _model(arch, variables, mnk):
    m, n, _ = mnk
    model, _ = create_model_from_architecture(arch, (2, m, n), m * n)
    model.load_state_dict(flax_to_state_dict(variables))
    return model


def _flax(model):
    return state_dict_to_flax({k: v.detach() for k, v in model.state_dict().items()},
                              getattr(model, "num_heads", None))


def rollout(arch, variables, mnk, num_envs, n_steps, noise, sides, first_sides):
    """One rollout with train-mode BatchNorm over the ranks: this rank's
    trajectory rows, the finished-episode sums and the running statistics."""
    cfg = tppo.PPOConfig(env=tenv.EnvConfig(*mnk), num_envs=num_envs, n_steps=n_steps,
                         batch_size=num_envs * n_steps, shuffle="tiled", shard_groups=2)
    dp = data_parallel(num_envs, "cpu")
    model = _model(arch, variables, mnk)
    tppo.attach_batch_stat_sync(model, dp)
    opponent = Policy(apply=first_legal)
    sp, obs = selfplay_reset(cfg.env, opponent, dp.shard.size, "cpu",
                             agent_side=dp.shard.take(torch.from_numpy(first_sides)))
    zeros = torch.zeros((dp.shard.size,))
    _, _, traj, fin, _ = tppo.rollout_impl(
        model, cfg, opponent, sp, obs, zeros, zeros.clone(), None,
        {"noise": torch.from_numpy(noise), "sides": torch.from_numpy(sides)}, dp)
    return {"traj": {k: v.numpy() for k, v in traj.items()}, "fin": fin.numpy(),
            "start": dp.shard.start, "variables": _flax(model)}


def update(arch, variables, mnk, traj, final, epoch_indices, shuffle, batch_size, lr,
           zero=False, watch_bins=0):
    """Prepare + the given epochs over the ranks from the same parameters,
    trajectory and (whole-batch) indices: the replicated learner, or the
    ZeRO-1 learner with ``zero``; returns the parameters, the metrics and,
    with ``watch_bins``, the watch record."""
    t_len, e = traj["rewards"].shape
    cfg = tppo.PPOConfig(env=tenv.EnvConfig(*mnk), num_envs=e, n_steps=t_len,
                         batch_size=batch_size, ppo_epochs=len(epoch_indices), shuffle=shuffle,
                         shard_groups=2, group_size=4 if shuffle == "grouped" else 128,
                         zero_update=zero, watch_hist_bins=watch_bins)
    dp = data_parallel(e, "cpu")
    model = _model(arch, variables, mnk)
    if zero:
        opt = ZeroOptimizer(model.parameters(), dp, lambda c: lr)
    else:
        opt = tppo.PPOOptimizer(model.parameters(), lambda c: lr)
    learner = tppo.PPOLearner(model, cfg, opt, torch.Generator(), "cpu", dp)
    learner._obs = {k: v[dp.shard.start:dp.shard.stop] for k, v in _tensors(final).items()}
    local = {k: v[:, dp.shard.start:dp.shard.stop] for k, v in _tensors(traj).items()}
    watch = learner.grad_watch() if watch_bins else None
    metrics = learner.update(local, 0.04, [torch.from_numpy(i) for i in epoch_indices], watch)
    out = {"variables": _flax(model), "metrics": {k: float(v) for k, v in metrics.items()},
           "count": opt.count, "moments": None}
    if watch is not None:
        out["watch"] = watch.fetch()
    if zero:
        state = opt.adamw.state[opt.shard]
        out["moments"] = int(state["exp_avg"].numel() + state["exp_avg_sq"].numel())
        out["padded"] = opt.layout.padded
    return out


def train(workdir, runs):
    """``train_mnk`` (or ``train_mnk_fused``) once for each config in
    ``runs``, from a directory of this rank's own (exports and metric
    streams are relative; checkpoints go where the config says); returns
    each run's summary without the model, and its final parameters."""
    from rl_selfplay_mnk_tpu_torch.train import train_mnk
    from rl_selfplay_mnk_tpu_torch.train_fused import train_mnk_fused
    from rl_selfplay_mnk_tpu_torch.parallel.mesh import process_index

    own = os.path.join(workdir, f"rank{process_index()}")
    os.makedirs(own, exist_ok=True)
    os.chdir(own)
    out = []
    for config in runs:
        fused = config.pop("fused", False)
        summary = (train_mnk_fused if fused else train_mnk)(config, device="cpu")
        model = summary.pop("model")
        summary["params"] = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
        out.append(summary)
    return out


def rollout_and_update(rollout_kwargs, update_kwargs):
    """``rollout`` then ``update`` in one group of ranks."""
    return rollout(**rollout_kwargs), update(**update_kwargs)
