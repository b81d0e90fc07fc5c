"""Self-play PPO training loop (counterpart of the JAX package's
``train.py``, its single-device host loop).

  * opponent schedule: 15% a historical snapshot from the pool, 85% the
    current network, drawn from a host ``random.Random(seed)``; every
    opponent is a frozen snapshot (``models.fold_bn.snapshot``: BatchNorm
    folded where the model has it), taken once when it is drawn; with
    ``opponents_per_iteration`` K > 1 one draw for each of K blocks of the
    env batch (``selfplay.policies.BlockPolicy``);
  * a pool insert every 20 iterations, FIFO eviction (``pool_eviction``
    "adaptive": the lowest weight; ``pool_weighted``: draws by weight); or,
    with ``matchmaking``, a ``selfplay.league.League`` whose members are
    scored on the episodes played against them (per block with K > 1);
  * every ``watch_interval`` iterations the watch record: per-leaf gradient
    RMS norms and signed-log histograms over the iteration's updates, and
    the parameters' norms (and 16-bin histograms with ``watch_histograms``);
  * every ``checkpoint_interval`` iterations a checkpoint of the whole
    train state (``utils/checkpoint.py``); ``resume`` continues from the
    newest one with the draws of the run that wrote it, and drops the
    records that run logged past it;
  * validation against the benchmark every ``validation_interval``
    iterations; the benchmark (first the untrained network) is replaced by
    a new snapshot when the score rate exceeds 0.60; the learner is
    exported after every validation (marked as a benchmark breaker when it
    was promoted) and once more at the end, under ``<export_dir>/<run>/``;
  * per-iteration fault handling: log the error and continue, except for
    a kernel that fails to build, load or launch (``KernelError``), which
    ends the run;
  * data parallel (``multihost``, ``parallel/mesh.py``): every rank drives
    this same loop on its envs, with the same seeds, so the pool, the
    validation and the promotion decide alike on every rank; the update's
    reductions are the ranks' (``alg/ppo.py``), or with
    ``zero_sharded_optimizer`` the ZeRO-1 learner (``alg/zero_epochs.py``)
    where the JAX package's rule engages it; exports, metric streams,
    stdout and checkpoints belong to rank 0, and a checkpoint holds the
    whole env batch, so a run saved under one world size resumes under
    another.

Runs on the card unless ``device="cpu"`` (``--device cpu``) is asked for.
Usage::

    python -m rl_selfplay_mnk_tpu_torch.train --total-steps 589824 --device cuda
    python -m rl_selfplay_mnk_tpu_torch.train --arch transformer_b_s_w --mnk 13 13 5 --batch-size 4096
    python -m rl_selfplay_mnk_tpu_torch.train --run-name r1 --checkpoint-interval 10 [--resume]
    python -m rl_selfplay_mnk_tpu_torch.train --matchmaking pfsp_even --watch-interval 5
    python -m rl_selfplay_mnk_tpu_torch.train --fused  # train_fused.train_mnk_fused
    # one command a rank (N ranks; gloo on the CPU, nccl with a card a rank):
    python -m rl_selfplay_mnk_tpu_torch.train --multihost --run-name r2 \
        --coordinator-address localhost:29500 --num-processes N --process-id i [--zero-opt]

``--arch`` also sets the family's learning rate and entropy schedule
(``apply_family_hparams``). On the command line, and only there, ``--mnk 13
13 5`` also brings the big-board horizons (``big_board_horizons``: 600M env
steps, the entropy schedule over 300M; ``--total-steps`` still overrides the
first), so the second line is the JAX package's full 13x13 recipe.
"""

from __future__ import annotations

import argparse
import os
import random as _random
import traceback
from typing import Any, Dict, Optional

import torch

from .alg.ppo import PPOConfig, PPOLearner, PPOOptimizer, TrainingMetrics, pick_group_size
from .alg.schedules import entropy_coef_at, make_lr_schedule
from .alg.zero_epochs import ZeroOptimizer, zero_eligible
from .env.mnk_env import EnvConfig, EnvState
from .models.common import BatchNorm
from .models.fold_bn import snapshot, snapshot_from_state_dict
from .ops.cuda_build import KernelError
from .models.registry import create_model_from_architecture, eval_apply, init_network
from .parallel.mesh import (
    data_parallel,
    init_distributed,
    is_coordinator,
    process_index,
    rank_device,
    replicate,
    shard_batched,
    world_size,
)
from .selfplay.league import MATCHMAKING_MODES, League
from .selfplay.opponent_pool import OpponentPool
from .selfplay.policies import BlockPolicy, NNPolicy
from .selfplay.validation import validate
from .selfplay.wrapper import SelfPlayState
from .utils.checkpoint import restore_checkpoint, save_checkpoint
from .utils.hardware import HardwareConfig, detect_hardware_config
from .utils.metrics import MetricsLogger, NullMetricsLogger
from .utils.tracing import span
from .utils.model_export import ModelExporter, NullModelExporter


def get_default_config() -> Dict[str, Any]:
    """The JAX package's defaults for the keys this path reads."""
    return {
        "mnk": (9, 9, 5),
        # lr
        "learning_rate": 5e-4,
        "lr_warmup_steps": 5_000_000,
        "lr_decay": False,
        # entropy
        "entropy_coef": 0.04,
        "entropy_coef_schedule": {
            "type": "linear",
            "params": {"final_coef": 0.001, "total_steps": 125_000_000},
        },
        # ppo
        "gamma": 0.99,
        "clip_range": 0.2,
        "batch_size": 8192,
        "n_steps": 256,
        "ppo_epochs": 4,
        "total_environment_steps": 300_000_000,
        "num_envs": 384,
        # validation
        "benchmark_update_threshold_score": 0.60,
        "validation_interval": 5,
        "validation_episodes": 256,
        # selfplay
        "opponent_pool": 20,
        "architecture_name": "resnet_b_s",
        "seed": 0,
        "pool_weighted": False,
        "pool_eviction": "fifo",
        "checkpoint_interval": 0,  # iterations; 0 = none
        "checkpoint_dir": None,  # None = checkpoints/<run_name>
        "resume": False,
        "matchmaking": None,  # None = the pool; or one of MATCHMAKING_MODES
        "opponents_per_iteration": 1,
        "watch_interval": 20,  # iterations; 0 = no watch record
        "watch_histograms": False,  # 16-bin parameter histograms in it
        "watch_grad_hist_bins": 6,  # signed-log gradient bins a sign; 0 = none
        "zero_sharded_optimizer": False,  # the ZeRO-1 learner, where eligible
        "device": None,  # None = cuda (a rank's own card)
    }


def apply_family_hparams(config: Dict[str, Any], arch: str) -> Dict[str, Any]:
    """Per-family learning rate and entropy settings, as the JAX package's
    ``train_all.apply_family_hparams``; LFM2, which the JAX package has
    not, takes the transformers' entropy schedule at lr 1e-4."""
    if arch.startswith("lfm2"):
        config["entropy_coef_schedule"]["params"]["final_coef"] = 0.01
        config["entropy_coef"] = 0.10
        config["learning_rate"] = 1e-4
    elif "transformer" in arch:
        config["entropy_coef_schedule"]["params"]["final_coef"] = 0.01
        config["entropy_coef"] = 0.10
        config["learning_rate"] = 12e-4
    elif "resnet" in arch:
        config["entropy_coef_schedule"]["params"]["final_coef"] = 0.001
        config["entropy_coef"] = 0.05
        config["learning_rate"] = 8e-4
    elif "cnn" in arch:
        config["entropy_coef_schedule"]["params"]["final_coef"] = 0.001
        config["entropy_coef"] = 0.04
        config["learning_rate"] = 6e-4
    return config


def big_board_horizons(config: Dict[str, Any]) -> Dict[str, Any]:
    """The horizons of the JAX package's 13x13x5 recipe
    (``tools/run_full13.py``): 600M env steps, the entropy schedule over 300M."""
    config["total_environment_steps"] = 600_000_000
    config["entropy_coef_schedule"]["params"]["total_steps"] = 300_000_000
    return config


def build_config(arch: Optional[str] = None, mnk=None, batch_size: Optional[int] = None,
                 total_steps: Optional[int] = None) -> Dict[str, Any]:
    """The default config with a named architecture's family settings, a
    board, a minibatch size and a length; what is not given stays at the
    default."""
    config = get_default_config()
    if arch:
        config["architecture_name"] = arch
        apply_family_hparams(config, arch)
    if mnk is not None:
        config["mnk"] = tuple(mnk)
    if batch_size:
        config["batch_size"] = batch_size
    if total_steps:
        config["total_environment_steps"] = total_steps
    return config


def create_learner(config: Dict[str, Any], hw: HardwareConfig, dp=None):
    """Network + optimizer + PPO learner on ``hw.device``, data-parallel
    over ``dp``'s ranks when given. Returns ``(learner, env_cfg,
    lr_schedule, arch_params)``.

    As in the JAX package: ``shuffle`` "auto" is "grouped" on the card,
    "tiled" over several CPU ranks and "global" on one; the layout's
    ``shard_groups`` is the world size (``config["shard_groups"]`` may set
    a multiple of it: one rank given the layout of d trains as d ranks do);
    ``group_size = pick_group_size(batch_size // shard_groups)``; the ZeRO-1
    learner engages where ``zero_eligible`` says."""
    m, n, k = config["mnk"]
    env_cfg = EnvConfig(m, n, k).validate()
    obs_shape = (2, m, n)
    module, arch_params = create_model_from_architecture(
        config["architecture_name"], obs_shape, m * n, dtype=hw.compute_dtype
    )
    # Initialise on the CPU from the seed, so both devices start alike.
    init_network(module, torch.Generator().manual_seed(config["seed"]))
    module.to(hw.device)
    blocks = int(config.get("opponents_per_iteration", 1))
    world = 1 if dp is None else dp.world
    shard_groups = int(config.get("shard_groups") or world)

    shuffle = config.get("shuffle", "auto")
    if shuffle == "auto":
        if hw.is_accelerator:
            shuffle = "grouped"
        else:
            shuffle = "tiled" if shard_groups > 1 else "global"
    has_batch_stats = any(isinstance(m, BatchNorm) for m in module.modules())
    requested = bool(config.get("zero_sharded_optimizer"))
    zero = zero_eligible(requested, world, shuffle, has_batch_stats)
    say = print if is_coordinator() else (lambda *a, **k: None)
    if zero:
        say(f"ZeRO sharded learner engaged: moments sharded over {world} ranks "
            "(reduce-scatter/all-gather epoch path)")
    elif requested:
        say("zero_sharded_optimizer requested but ineligible "
            f"(devices={world}, shuffle={shuffle!r}, batch_stats={has_batch_stats}): "
            "the ZeRO epoch path needs a >1-device mesh, the grouped shuffle, and a "
            "batch-stat-free architecture — using the replicated data-parallel learner instead")
    ppo_cfg = PPOConfig(
        env=env_cfg,
        num_envs=config["num_envs"],
        n_steps=config["n_steps"],
        gamma=config["gamma"],
        gae_lambda=0.95,
        clip_range=config["clip_range"],
        ppo_epochs=config["ppo_epochs"],
        batch_size=config["batch_size"],
        shuffle=shuffle,
        shard_groups=shard_groups,
        group_size=pick_group_size(config["batch_size"] // shard_groups),
        zero_update=zero,
        watch_hist_bins=config.get("watch_grad_hist_bins", 0),
        fin_blocks=blocks if blocks > 1 else 0,
    )
    lr_schedule = make_lr_schedule(
        base_lr=config["learning_rate"],
        warmup_env_steps=config["lr_warmup_steps"],
        total_env_steps=config["total_environment_steps"],
        num_envs=config["num_envs"],
        n_steps=config["n_steps"],
        updates_per_iteration=ppo_cfg.updates_per_iteration,
        decay=config["lr_decay"],
    )
    if dp is not None:  # every rank starts from rank 0's weights
        replicate(list(module.parameters()) + list(module.buffers()), dp.coll)
    if zero:
        optimizer = ZeroOptimizer(module.parameters(), dp, lr_schedule,
                                  clip_norm=ppo_cfg.zero_clip_norm)
    else:
        optimizer = PPOOptimizer(module.parameters(), lr_schedule)
    generator = torch.Generator(device=hw.device).manual_seed(config["seed"] + 1)
    learner = PPOLearner(module, ppo_cfg, optimizer, generator, hw.device, dp)
    return learner, env_cfg, lr_schedule, arch_params


def join_process_group(config: Dict[str, Any], device: Optional[str] = None):
    """The multi-process start, before any logger or exporter: join the
    process group when ``config["multihost"]``, and check that the ranks
    share a run name. Returns the rank's device name."""
    if config.get("multihost"):
        if not config.get("run_name"):
            # A timestamp default could differ between ranks, which would
            # split the checkpoint and export paths.
            raise ValueError("multihost training needs config['run_name'] (all processes "
                             "must agree on checkpoint/export paths)")
        init_distributed(config.get("coordinator_address"), config.get("num_processes"),
                         config.get("process_id"), device or config.get("device"))
    name = device or config.get("device")
    if world_size() > 1:
        name = str(rank_device(name))
    return name


def rank_io(logger, config: Dict[str, Any]):
    """Rank 0's logger, or a ``NullMetricsLogger`` of the same run on the
    other ranks. Returns (logger, owns_logger, say): ``say`` prints on rank
    0 only."""
    coordinator = is_coordinator()
    own = logger is None
    if own:
        logger = (MetricsLogger(run_name=config.get("run_name"), config=config) if coordinator
                  else NullMetricsLogger(run_name=config.get("run_name"), config=config))
    elif not coordinator:
        logger = NullMetricsLogger(run_name=logger.run_name, config=config)
    say = print if coordinator else (lambda *a, **k: None)
    return logger, own, say


def make_exporter(logger, config: Dict[str, Any]):
    cls = ModelExporter if is_coordinator() else NullModelExporter
    return cls(logger.run_name, base_dir=config.get("export_dir", "models"))


def train_mnk(
    config: Dict[str, Any],
    logger: Optional[MetricsLogger] = None,
    device: Optional[str] = None,
) -> Dict[str, Any]:
    """The training loop. Returns a summary: per-iteration metrics and
    opponent sources, the validation results, the errors that the loop
    logged and skipped, the iteration it started at (past 0 when resumed),
    the directory of the exports (``export_dir``) and the trained
    ``model``."""
    k_opponents = int(config.get("opponents_per_iteration", 1))
    if config["num_envs"] % k_opponents:
        raise ValueError(f"{config['num_envs']} envs do not split into {k_opponents} opponent blocks")
    device = join_process_group(config, device)
    logger, own_logger, say = rank_io(logger, config)
    hw = detect_hardware_config(device)
    dp = data_parallel(config["num_envs"], hw.device)
    learner, env_cfg, lr_schedule, arch_params = create_learner(config, hw, dp)
    logger.log({"learner/zero_sharded": int(learner.config.zero_update)}, step=0)
    exporter = make_exporter(logger, config)
    policy_generator = torch.Generator(device=hw.device).manual_seed(config["seed"] + 2)
    shard = None if dp is None else dp.shard

    def network_policy(frozen, generator=policy_generator, rows=shard):
        policy = NNPolicy(eval_apply, frozen, generator)
        policy.shard = rows
        return policy

    # The benchmark starts as the untrained network; the pool is seeded with
    # the same snapshot. Opponents only run eval forwards, so all are frozen
    # snapshots (BatchNorm folded where there is any).
    benchmark = snapshot(learner.model)
    matchmaking = config.get("matchmaking")
    if matchmaking:
        pool = League(max_size=config["opponent_pool"], mode=matchmaking, seed=config["seed"])
    else:
        pool = OpponentPool(
            max_size=config["opponent_pool"],
            seed=config["seed"],
            weighted=config.get("pool_weighted", False),
            eviction=config.get("pool_eviction", "fifo"),
        )
    pool.add_opponent(benchmark)
    last_score_rate = 1.0

    steps_per_iteration = config["num_envs"] * config["n_steps"]
    total_iterations = config["total_environment_steps"] // steps_per_iteration
    host_rng = _random.Random(config["seed"])
    learner.reset_envs(network_policy(benchmark))
    ckpt_dir = config.get("checkpoint_dir") or os.path.join(
        "checkpoints", config.get("run_name") or logger.run_name)
    ckpt_interval = config.get("checkpoint_interval", 0)
    watch_interval = config.get("watch_interval", 0)

    start_iteration = 0
    if config.get("resume"):
        state, _ = restore_checkpoint(ckpt_dir)
        if state is None:
            say(f"No checkpoint under {ckpt_dir}: starting at iteration 0")
        else:
            m, n, _ = config["mnk"]

            def rebuild(state_dict):
                model, _ = create_model_from_architecture(
                    config["architecture_name"], (2, m, n), m * n, dtype=hw.compute_dtype)
                return snapshot_from_state_dict(model.to(hw.device), state_dict)

            # After reset_envs, which drew from both generators: the restored
            # states carry on where the checkpointed run was.
            benchmark, last_score_rate = restore_train_state(
                state, learner, pool, host_rng, policy_generator, rebuild)
            start_iteration = state["iteration"] + 1
            dropped = logger.drop_after(state["env_steps"])
            say(f"Resumed from checkpoint at iteration {start_iteration} "
                f"({dropped} records past it dropped from {logger.jsonl_path})")

    summary: Dict[str, Any] = {"iterations": [], "opponent_sources": [], "validations": [],
                               "errors": [], "start_iteration": start_iteration,
                               "jsonl_path": logger.jsonl_path,
                               "export_dir": exporter.export_dir}

    say(f"Starting training for {total_iterations} iterations")
    current_env_steps = start_iteration * steps_per_iteration
    for i in range(start_iteration, total_iterations):
        try:
            with span("iteration"):
                with span("opponent"):
                    # Per opponent block: 15% a pool member, 85% the current network.
                    def draw_opponent():
                        if host_rng.random() < 0.15:
                            if matchmaking:
                                entry_id, member = pool.get_opponent()
                                return member, "historical", entry_id
                            return pool.get_random_opponent(), "historical", None
                        return None, "current_agent", None

                    draws = [draw_opponent() for _ in range(k_opponents)]
                    current = (snapshot(learner.model) if any(d[0] is None for d in draws)
                               else None)
                    opponents = [current if d[0] is None else d[0] for d in draws]
                    block_ids = [d[2] for d in draws]  # the league member playing each block
                    drawn_ids = [x for x in block_ids if x is not None]
                    source = ",".join(d[1] for d in draws)
                    logger.log({"training/opponent_source": source},
                               step=(i + 1) * steps_per_iteration)
                    if k_opponents > 1:
                        opponent = BlockPolicy(eval_apply, opponents, policy_generator)
                        opponent.shard = shard
                    else:
                        opponent = network_policy(opponents[0])

                ent_coef = entropy_coef_at(
                    config["entropy_coef"], config["entropy_coef_schedule"], i,
                    config["num_envs"], config["n_steps"],
                )
                watch_now = bool(watch_interval) and i % watch_interval == 0
                metrics = learner.learn(opponent, ent_coef, watch=watch_now)
                current_env_steps = (i + 1) * steps_per_iteration

                # The league scores each drawn member on the episodes played
                # against it: its own block's with K > 1 (nothing for a block that
                # finished none), else the iteration's.
                if matchmaking and drawn_ids:
                    if metrics.block_rewards is not None:
                        for entry_id, reward in zip(block_ids, metrics.block_rewards):
                            if entry_id is not None and reward is not None:
                                pool.record_result(entry_id, (reward + 1.0) / 2.0)
                    else:
                        for entry_id in drawn_ids:
                            pool.record_result(entry_id, (metrics.mean_reward + 1.0) / 2.0)

                current_lr = lr_schedule((i + 1) * learner.config.updates_per_iteration - 1)
                log_training_metrics(logger, metrics, i, current_env_steps, ent_coef, current_lr,
                                     echo=is_coordinator())
                summary["iterations"].append(metrics.scalars())
                summary["opponent_sources"].append(source)

                if watch_now:
                    record = dict(metrics.layer_grad_norms)
                    record.update(learner.param_stats(16 if config.get("watch_histograms") else 0))
                    logger.log(record, step=current_env_steps)

                if i % 20 == 0:
                    pool.add_opponent(snapshot(learner.model), weight=last_score_rate)

            if i > 0 and i % config["validation_interval"] == 0:
                say(f"--- Running validation at step {i} ({current_env_steps:,} env steps) ---")
                generator = torch.Generator(device=hw.device).manual_seed(
                    config["seed"] * 1_000_003 + i
                )
                validation_res = validate(  # the same episodes on every rank
                    env_cfg,
                    network_policy(snapshot(learner.model), generator, None),
                    network_policy(benchmark, generator, None),
                    config["validation_episodes"],
                    hw.device,
                    generator,
                )
                logger.log(validation_res, step=current_env_steps)
                summary["validations"].append(validation_res)

                score_rate = validation_res["validation/vs_benchmark/score_rate"]
                last_score_rate = max(score_rate, 1e-3)
                say(
                    f"Score: {score_rate:.2f} | "
                    f"W: {validation_res['validation/vs_benchmark/win_rate']:.2f} | "
                    f"D: {validation_res['validation/vs_benchmark/draw_rate']:.2f} | "
                    f"L: {validation_res['validation/vs_benchmark/loss_rate']:.2f}"
                )
                promoted = score_rate > config["benchmark_update_threshold_score"]
                if promoted:
                    say(f"--- New benchmark agent at step {i}! ---")
                    benchmark = snapshot(learner.model)
                exporter.export_model(learner.model, config["architecture_name"], arch_params, i,
                                      is_benchmark_breaker=promoted)
                if promoted:
                    logger.log({"validation/new_benchmark_step": 1}, step=current_env_steps)

            if ckpt_interval and i > 0 and i % ckpt_interval == 0:
                state = checkpoint_state(learner, benchmark, pool, host_rng, policy_generator,
                                         last_score_rate, i, current_env_steps)
                if is_coordinator():
                    save_checkpoint(ckpt_dir, i, state)
        except KernelError:
            raise
        except Exception as e:  # log and continue, as the JAX trainer does
            handle_training_error(logger, e, i, current_env_steps)
            summary["errors"].append(f"iteration {i}: {e!r}")
            continue
    exporter.export_model(learner.model, config["architecture_name"], arch_params,
                          total_iterations, is_benchmark_breaker=False)
    if own_logger:
        logger.finish()
    summary["model"] = learner.model
    return summary


def gather_envs(tree, dp):
    """The whole env batch of a nest of per-rank (E / d, ...) tensors,
    gathered from every rank in rank order (every rank calls it)."""
    if dp is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_envs(v, dp) for k, v in tree.items()}
    return None if tree is None else dp.gather_rows(tree)


def checkpoint_state(learner: PPOLearner, benchmark, pool, host_rng: _random.Random,
                     policy_generator: torch.Generator, last_score_rate: float,
                     iteration: int, env_steps: int) -> Dict[str, Any]:
    """The whole train state after ``iteration`` (the JAX checkpoint's keys
    and the port's generators): snapshots as state_dicts, the self-play
    state as tensors of the whole env batch, random states as plain values.
    Every rank calls it (the env rows and a ZeRO state are gathered)."""
    if isinstance(pool, League):
        members = [{"model": e.params.state_dict(), "weight": e.score_ema, "id": e.entry_id,
                    "games": e.games} for e in pool.entries]
        next_id = pool._next_id
    else:
        members = [{"model": model.state_dict(), "weight": w}
                   for model, w in zip(pool.pool, pool.weights)]
        next_id = 0
    sp, dp = learner._sp_state, learner.dp
    optimizer = (learner.optimizer.state_dict() if learner.config.zero_update
                 else learner.optimizer.adamw.state_dict())
    return {
        "model": learner.model.state_dict(),
        "optimizer": optimizer,
        "optimizer_count": learner.optimizer.count,
        "benchmark": benchmark.state_dict(),
        "pool": members,
        "pool_next_id": next_id,
        "host_rng_state": host_rng.getstate(),
        "pool_rng_state": pool._rng.getstate(),
        "last_score_rate": float(last_score_rate),
        "sp_state": gather_envs({"env": sp.env._asdict(), "agent_side": sp.agent_side,
                                 "pending_resets": sp.pending_resets}, dp),
        "obs": gather_envs(learner._obs, dp),
        "ep_rew": gather_envs(learner._ep_rew, dp),
        "ep_len": gather_envs(learner._ep_len, dp),
        "generator": learner.generator.get_state(),
        "policy_generator": policy_generator.get_state(),
        "iteration": iteration,
        "env_steps": env_steps,
    }


def restore_train_state(state: Dict[str, Any], learner: PPOLearner, pool, host_rng: _random.Random,
                        policy_generator: torch.Generator, rebuild):
    """Put ``checkpoint_state``'s ``state`` back; ``rebuild(state_dict)``
    makes a snapshot. Returns (benchmark, last_score_rate). A rank takes
    its rows of the saved env batch, whatever world saved it."""
    dev = learner.device
    dp = learner.dp
    e = learner.config.num_envs

    def rows(x):
        if x is None or dp is None:
            return x
        return shard_batched(x, dp.world, dp.rank, batch_size=e)

    def on_device(tree):
        return {k: None if v is None else rows(v).to(dev) for k, v in tree.items()}

    learner.model.load_state_dict(state["model"])
    if learner.config.zero_update:
        learner.optimizer.load_state_dict(state["optimizer"])
    else:
        learner.optimizer.adamw.load_state_dict(state["optimizer"])
    learner.optimizer.count = state["optimizer_count"]
    if isinstance(pool, League):
        pool.entries.clear()
        for member in state["pool"]:
            pool.add_opponent(rebuild(member["model"]))
            entry = pool.entries[-1]
            entry.entry_id, entry.score_ema, entry.games = member["id"], member["weight"], member["games"]
        pool._next_id = state["pool_next_id"]
    else:
        pool.pool.clear()
        pool.weights.clear()
        for member in state["pool"]:
            pool.add_opponent(rebuild(member["model"]), weight=member["weight"])
    host_rng.setstate(state["host_rng_state"])
    pool._rng.setstate(state["pool_rng_state"])
    sp = state["sp_state"]
    learner._sp_state = SelfPlayState(env=EnvState(**on_device(sp["env"])),
                                      agent_side=rows(sp["agent_side"]).to(dev),
                                      pending_resets=rows(sp["pending_resets"]).to(dev))
    learner._obs = on_device(state["obs"])
    learner._ep_rew = rows(state["ep_rew"]).to(dev)
    learner._ep_len = rows(state["ep_len"]).to(dev)
    learner.generator.set_state(state["generator"])
    policy_generator.set_state(state["policy_generator"])
    return rebuild(state["benchmark"]), state["last_score_rate"]


def log_training_metrics(
    logger: MetricsLogger,
    metrics: TrainingMetrics,
    iteration: int,
    env_steps: int,
    entropy_coef: float,
    current_lr: float,
    echo: bool = True,
) -> None:
    """Stdout line (with ``echo``) + logger record, with the JAX package's
    keys."""
    if echo:
        print(
            f"Iter {iteration} | {env_steps:,} steps | "
            f"reward: {metrics.mean_reward:.3f} | "
            f"length: {metrics.mean_length:.1f} | "
            f"entropy: {metrics.entropy_loss:.4f} | "
            f"entropy_coef: {entropy_coef:.4f} | "
            f"lr: {current_lr:.6f} | "
            f"grad_norm: {metrics.grad_norm:.3f} | "
            f"clip: {metrics.clip_fraction:.3f} | "
            f"explained_var: {metrics.explained_variance:.3f} | "
            f"approx_kl: {metrics.approx_kl:.4f} | "
            f"fps: {metrics.fps:.1f} | "
            f"rollout_time: {metrics.rollout_time:.3f}s | "
            f"learn_time: {metrics.learn_time:.3f}s"
        )
    logger.log(
        {
            "training/mean_reward": metrics.mean_reward,
            "training/mean_length": metrics.mean_length,
            "training/actor_loss": metrics.actor_loss,
            "training/critic_loss": metrics.critic_loss,
            "training/entropy_loss": metrics.entropy_loss,
            "training/entropy_coef": entropy_coef,
            "training/learning_rate": current_lr,
            "training/grad_norm": metrics.grad_norm,
            "training/clip_fraction": metrics.clip_fraction,
            "training/explained_variance": metrics.explained_variance,
            "training/approx_kl": metrics.approx_kl,
            "training/fps": metrics.fps,
        },
        step=env_steps,
    )


def handle_training_error(logger: MetricsLogger, error: Exception, iteration: int,
                          env_steps: int) -> None:
    print(f"Error in iteration {iteration} (rank {process_index()}): {error}")
    traceback.print_exc()
    logger.log(
        {
            "error/iteration": iteration,
            "error/message": str(error),
            "error/traceback": traceback.format_exc(),
        },
        step=env_steps,
    )


def config_from_args(argv=None) -> Dict[str, Any]:
    """The command line's config. ``--mnk 13 13 5`` is the big-board recipe:
    it also sets ``big_board_horizons``."""
    parser = argparse.ArgumentParser(description="Train self-play PPO on MNK (PyTorch port)")
    parser.add_argument("--arch", default=None, help="architecture registry name")
    parser.add_argument("--mnk", type=int, nargs=3, default=None, metavar=("M", "N", "K"))
    parser.add_argument("--num-envs", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--total-steps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--run-name", default=None)
    parser.add_argument("--export-dir", default=None,
                        help="exports go to <dir>/<run>/ (default: models)")
    parser.add_argument("--device", default="cuda", type=device_name,
                        help="cuda (a rank's own card), cuda:N or cpu")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the newest checkpoint of the run")
    parser.add_argument("--checkpoint-interval", type=int, default=None,
                        help="checkpoint the train state every N iterations (0 = never)")
    parser.add_argument("--matchmaking", choices=MATCHMAKING_MODES, default=None,
                        help="league matchmaking over the opponent pool (selfplay/league.py)")
    parser.add_argument("--pool-eviction", choices=["fifo", "adaptive"], default=None,
                        help="once the pool is full: fifo = drop the oldest, adaptive = "
                        "drop the lowest weight")
    parser.add_argument("--pool-weighted", action="store_true",
                        help="draw pool members by their score rate at insertion")
    parser.add_argument("--watch-interval", type=int, default=None,
                        help="log gradient and parameter norms every N iterations (0 = never)")
    parser.add_argument("--watch-histograms", action="store_true",
                        help="also log 16-bin parameter histograms at the watch cadence")
    parser.add_argument("--fused", action="store_true",
                        help="device-resident iteration loop (train_fused): opponent pool, "
                        "draws and schedules on the card, CUDA graphs a validation block")
    parser.add_argument("--zero-opt", action="store_true",
                        help="ZeRO-1 sharded learner: AdamW's moments and step sharded over "
                        "the ranks (reduce-scatter gradients, all-gather updates); needs "
                        "more than one rank")
    parser.add_argument("--multihost", action="store_true",
                        help="join a process group of ranks (the three flags below)")
    parser.add_argument("--coordinator-address", default=None, help="host:port of rank 0")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    args = parser.parse_args(argv)
    if args.multihost and not args.run_name:
        parser.error("--multihost needs --run-name (all processes must agree on "
                     "export/checkpoint paths; a timestamp default could differ between ranks)")

    config = build_config(args.arch, args.mnk, args.batch_size)
    if config["mnk"] == (13, 13, 5):
        big_board_horizons(config)
    if args.total_steps:
        config["total_environment_steps"] = args.total_steps
    if args.num_envs:
        config["num_envs"] = args.num_envs
    if args.seed is not None:
        config["seed"] = args.seed
    config["run_name"] = args.run_name
    if args.export_dir:
        config["export_dir"] = args.export_dir
    config["device"] = args.device
    if args.resume:
        config["resume"] = True
    if args.checkpoint_interval is not None:
        config["checkpoint_interval"] = args.checkpoint_interval
    if args.matchmaking:
        config["matchmaking"] = args.matchmaking
    if args.pool_eviction is not None:
        config["pool_eviction"] = args.pool_eviction
    if args.pool_weighted:
        config["pool_weighted"] = True
    if args.watch_interval is not None:
        config["watch_interval"] = args.watch_interval
    if args.watch_histograms:
        config["watch_histograms"] = True
    if args.fused:
        config["fused"] = True
    if args.zero_opt:
        config["zero_sharded_optimizer"] = True
    if args.multihost:
        config.update(multihost=True, coordinator_address=args.coordinator_address,
                      num_processes=args.num_processes, process_id=args.process_id)
    return config


def device_name(name: str) -> str:
    """``cuda``, ``cuda:N`` or ``cpu``."""
    if name in ("cuda", "cpu") or (name.startswith("cuda:") and name[5:].isdigit()):
        return name
    raise argparse.ArgumentTypeError(f"unknown device {name!r}: cuda, cuda:N or cpu")


def main(argv=None) -> None:
    config = config_from_args(argv)
    fused = config.pop("fused", False)
    join_process_group(config)  # before any logger: only rank 0 opens the stream
    logger_cls = MetricsLogger if is_coordinator() else NullMetricsLogger
    with logger_cls(run_name=config["run_name"], config=config, group="main_run_small_board",
                    tags=["main_experiment"]) as logger:
        if fused:
            from .train_fused import train_mnk_fused

            train_mnk_fused(config, logger)
        else:
            train_mnk(config, logger)


if __name__ == "__main__":
    main()
