"""Fused-block training driver: the device-resident iteration loop
(counterpart of the JAX package's ``train_fused.py``).

The same training semantics as ``train.train_mnk``: 15% of the iterations
play a pool member, the rest the live network; a pool insert every 20
iterations; validation against the benchmark, promotion above 0.60, an
export after every validation and at the end; checkpoints and resume. But
the iterations run as fused blocks (``alg/fused.py``): the opponent pool
is a ``DevicePool`` on the card, draws, inserts, league records and the
entropy and lr schedules run on the device, and the host reads the
metrics once a block. A block ends after an iteration ``i`` with ``i %
validation_interval == 0`` (``_block_end``), so validation, promotion and
export fall at the host loop's iteration numbers.

Dispatch, ``config["fused_dispatch"]``:

  * ``"scan"``: each piece of an iteration captured once as a CUDA graph,
    a block replayed (needs the card; raises elsewhere);
  * ``"step"``: the same pieces run eagerly, with no host read inside a
    block;
  * ``"auto"`` (the default): ``"scan"`` on the card, ``"step"`` off it.
    Unlike the JAX driver, whose XLA scan costs grew with the iteration's
    work, each piece here is captured once whatever ``n_steps``, and the
    graphs were no slower at any width measured on the card (PERF.md §5:
    384 envs and the bench's 8192).

Deviations from the host loop, as in the JAX driver:

  * the draws come from the learner's device generator, not a host
    ``random.Random``: the same distribution, another stream;
  * fault handling is per block: an error in a step-dispatch block is
    logged, the train state is put back to the block's start (a copy on
    the device, ``FusedTrainer.save_state``), and the next block runs; a
    ``KernelError``, and any error of a graph capture or replay, ends the
    run;
  * checkpoints are written at block ends (the first at or after the
    configured interval) and carry the pool, the env state, the episode
    accumulators and the generators, so a resume continues bit-exactly;
  * the watch record is off (``watch_interval`` forced to 0), and mixed
    opponent batches (``opponents_per_iteration`` > 1) are refused;
  * ``update_chunks`` splits an update under a TPU RPC deadline and is not
    applicable here: refused.

Over the ranks of a data-parallel world (``multihost``, as in
``train.train_mnk``) each rank runs the blocks on its envs with the
replicated learner or, with ``zero_sharded_optimizer`` where the JAX
package's rule engages it, the ZeRO-1 learner; rank 0 alone writes.
Only the step dispatch runs there: ``"auto"`` resolves to ``"step"``
(and says so) and ``"scan"`` is refused, since a gloo collective cannot be
captured in a CUDA graph and one card cannot show NCCL's capture across
ranks. Checkpoints hold the whole env batch (``FusedTrainer.global_state``).

Runs on the card unless ``device="cpu"`` is asked for. Usage::

    python -m rl_selfplay_mnk_tpu_torch.train --fused --total-steps 589824
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from .alg.fused import METRIC_KEYS, FusedTrainer, train_block
from .alg.ppo import DeviceOptimizer, TrainingMetrics
from .alg.schedules import make_entropy_coef_fn, make_lr_fn
from .alg.zero_epochs import ZeroOptimizer
from .models.fold_bn import snapshot, snapshot_from_state_dict
from .models.registry import create_model_from_architecture, eval_apply
from .ops.cuda_build import KernelError
from .selfplay.league import MATCHMAKING_MODES
from .selfplay.opponent_pool import EVICTION_POLICIES, pool_add, pool_init
from .selfplay.policies import NNPolicy
from .selfplay.validation import validate
from .parallel.mesh import data_parallel, is_coordinator, world_size
from .train import (
    create_learner,
    handle_training_error,
    join_process_group,
    log_training_metrics,
    make_exporter,
    rank_io,
)
from .utils.checkpoint import restore_checkpoint, save_checkpoint
from .utils.hardware import detect_hardware_config
from .utils.metrics import MetricsLogger
from .utils.tracing import span

POOL_PROB = 0.15  # the share of iterations that play a pool member
POOL_INSERT_INTERVAL = 20  # iterations between pool inserts
DISPATCHES = ("auto", "step", "scan")


def _block_end(start: int, validation_interval: int, total: int) -> int:
    """Last iteration of the block starting at ``start``: the next multiple
    of ``validation_interval`` (so validation runs after it), clamped to the
    run's end."""
    next_boundary = ((start // validation_interval) + 1) * validation_interval
    return min(next_boundary, total - 1)


def resolve_dispatch(dispatch: str, device: torch.device, world: int = 1) -> str:
    """``"auto"`` -> ``"scan"`` on the card with one rank, else ``"step"``;
    ``"scan"`` off the card or over several ranks raises."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown fused_dispatch {dispatch!r}; choose from {DISPATCHES}")
    if world > 1:
        if dispatch == "scan":
            raise ValueError(f"fused_dispatch='scan' is not run over {world} ranks: a gloo "
                             "collective cannot be captured in a CUDA graph, and NCCL's capture "
                             "across ranks is not verified; use 'step' or 'auto'")
        if dispatch == "auto" and is_coordinator():
            print(f"fused_dispatch 'auto' over {world} ranks: 'step' (the scan dispatch is not "
                  "run over ranks)")
        return "step"
    if dispatch == "auto":
        dispatch = "scan" if device.type == "cuda" else "step"
    if dispatch == "scan" and device.type != "cuda":
        raise ValueError(f"fused_dispatch='scan' replays CUDA graphs and needs the card, not "
                         f"{device}; use 'step' or 'auto'")
    return dispatch


def check_fused_config(config: Dict[str, Any]) -> None:
    """The configs the fused driver refuses, as the JAX driver does."""
    if config.get("opponents_per_iteration", 1) > 1:
        raise ValueError("fused training does not implement mixed-opponent batches "
                         "(opponents_per_iteration > 1). Drop --fused or the option.")
    matchmaking = config.get("matchmaking")
    if matchmaking and matchmaking not in MATCHMAKING_MODES:
        raise ValueError(f"unknown matchmaking mode {matchmaking!r}; choose from "
                         f"{MATCHMAKING_MODES}")
    eviction = config.get("pool_eviction", "fifo")
    if eviction not in EVICTION_POLICIES:
        raise ValueError(f"unknown pool_eviction {eviction!r}; choose from {EVICTION_POLICIES}")
    if config.get("update_chunks", 1) > 1:
        raise ValueError("update_chunks splits the update into programs under a TPU RPC "
                         "deadline, which does not apply to the port: drop the option")


def create_fused_trainer(config: Dict[str, Any], hw, max_block: int = 1, dp=None):
    """The learner of ``create_learner`` (over ``dp``'s ranks when given)
    with its lr on the device (a ``DeviceOptimizer``, or the
    ``ZeroOptimizer`` where ZeRO engages), its envs reset against the
    untrained network, a ``DevicePool`` seeded with that network, and the
    ``FusedTrainer`` over them. Returns (trainer, env_cfg, lr_schedule,
    arch_params, benchmark): ``lr_schedule`` is the host schedule that the
    metrics log, ``benchmark`` the untrained snapshot."""
    learner, env_cfg, lr_schedule, arch_params = create_learner(config, hw, dp)
    cfg = learner.config
    if cfg.zero_update:
        learner.optimizer = ZeroOptimizer(learner.model.parameters(), dp, lr=lr_schedule(0),
                                          clip_norm=cfg.zero_clip_norm)
    else:
        learner.optimizer = DeviceOptimizer(learner.model.parameters(), lr_schedule(0))
    lr_fn = make_lr_fn(config["learning_rate"], config["lr_warmup_steps"],
                       config["total_environment_steps"], cfg.num_envs, cfg.n_steps,
                       cfg.updates_per_iteration, config["lr_decay"])
    entropy_fn = make_entropy_coef_fn(config["entropy_coef"], config["entropy_coef_schedule"],
                                      cfg.num_envs, cfg.n_steps)
    policy_generator = torch.Generator(device=hw.device).manual_seed(config["seed"] + 2)
    benchmark = snapshot(learner.model)
    first = NNPolicy(eval_apply, benchmark, policy_generator)
    first.shard = None if dp is None else dp.shard
    learner.reset_envs(first)
    state = learner.model.state_dict()
    pool = pool_add(pool_init(state, config["opponent_pool"]), state, 1.0)
    trainer = FusedTrainer(
        learner, pool, policy_generator, entropy_fn, lr_fn, POOL_PROB, POOL_INSERT_INTERVAL,
        config.get("matchmaking") or None, float(config.get("pfsp_power", 2.0)),
        float(config.get("league_ema", 0.3)), config.get("pool_eviction", "fifo"), max_block)
    return trainer, env_cfg, lr_schedule, arch_params, benchmark


def run_block(trainer: FusedTrainer, dispatch: str, it0: int, block_len: int,
              insert_weight: float) -> torch.Tensor:
    """Iterations [it0, it0 + block_len) by ``dispatch``; returns the
    stacked metrics, read on the host (the block's one read). The ``block``
    span is measured into ``trainer.block_interval``."""
    with span("block", trainer.block_interval):
        if dispatch == "scan":
            stacked = train_block(trainer, it0, block_len, insert_weight)
        else:
            trainer.begin_block(it0, insert_weight, block_len)
            for _ in range(block_len):
                trainer.iteration()
            stacked = trainer.stacked[:block_len]
        with span("read"):
            return stacked.cpu()


def train_mnk_fused(
    config: Dict[str, Any],
    logger: Optional[MetricsLogger] = None,
    device: Optional[str] = None,
) -> Dict[str, Any]:
    """The fused training loop. Returns ``train_mnk``'s summary, plus the
    ``dispatch`` taken, the ``graph_replays``, each block's wall time
    (``block_walls``: iterations, seconds of the ``block`` span) and under
    scan the ``capture`` span's seconds (``capture_s``)."""
    check_fused_config(config)
    if config.get("watch_interval"):
        config = {**config, "watch_interval": 0}
    device = join_process_group(config, device)
    logger, own_logger, say = rank_io(logger, config)
    hw = detect_hardware_config(device)
    dispatch = resolve_dispatch(config.get("fused_dispatch", "auto"), hw.device, world_size())
    dp = data_parallel(config["num_envs"], hw.device)
    vint = config["validation_interval"]
    trainer, env_cfg, lr_schedule, arch_params, benchmark = create_fused_trainer(
        config, hw, max_block=vint + 1, dp=dp)
    logger.log({"learner/zero_sharded": int(trainer.config.zero_update)}, step=0)
    model = trainer.model
    exporter = make_exporter(logger, config)
    last_score_rate = 1.0

    steps_per_iteration = config["num_envs"] * config["n_steps"]
    total_iterations = config["total_environment_steps"] // steps_per_iteration
    ckpt_dir = config.get("checkpoint_dir") or os.path.join(
        "checkpoints", config.get("run_name") or logger.run_name)
    ckpt_interval = config.get("checkpoint_interval", 0)

    start_iteration = 0
    if config.get("resume"):
        state, _ = restore_checkpoint(ckpt_dir)
        if state is None:
            say(f"No checkpoint under {ckpt_dir}: starting at iteration 0")
        else:
            trainer.load_global_state(state["trainer"])
            m, n, _ = config["mnk"]
            fresh, _ = create_model_from_architecture(
                config["architecture_name"], (2, m, n), m * n, dtype=hw.compute_dtype)
            benchmark = snapshot_from_state_dict(fresh.to(hw.device), state["benchmark"])
            last_score_rate = state["last_score_rate"]
            start_iteration = state["iteration"] + 1
            dropped = logger.drop_after(state["env_steps"])
            say(f"Resumed from checkpoint at iteration {start_iteration} "
                f"({dropped} records past it dropped from {logger.jsonl_path})")

    summary: Dict[str, Any] = {"iterations": [], "opponent_sources": [], "validations": [],
                               "errors": [], "start_iteration": start_iteration,
                               "jsonl_path": logger.jsonl_path,
                               "export_dir": exporter.export_dir, "dispatch": dispatch,
                               "block_walls": []}
    if dispatch == "scan":
        # outside any handler: a capture that fails ends the run
        summary["capture_s"] = trainer.capture()
    say(f"Starting fused training for {total_iterations} iterations "
        f"(validation every {vint}, dispatch={dispatch})")

    i = start_iteration
    last_ckpt = start_iteration - 1
    while i < total_iterations:
        end = _block_end(i, vint, total_iterations)
        block_len = end - i + 1
        current_env_steps = (end + 1) * steps_per_iteration
        insert_weight = max(last_score_rate, 1e-3) if config.get("pool_weighted") else 1.0
        if dispatch == "scan":
            stacked = run_block(trainer, dispatch, i, block_len, insert_weight)
        else:
            saved = trainer.save_state(hw.device)
            try:
                stacked = run_block(trainer, dispatch, i, block_len, insert_weight)
            except KernelError:
                raise
            except Exception as e:  # log the block and go on, as the JAX driver does
                trainer.load_state(saved)  # the block leaves no trace, as JAX's carry does
                handle_training_error(logger, e, i, current_env_steps)
                summary["errors"].append(f"block {i}-{end}: {e!r}")
                i = end + 1
                continue
        summary["block_walls"].append((block_len, trainer.block_interval.host_s))
        try:
            rows = [dict(zip(METRIC_KEYS, r)) for r in stacked.tolist()]
            for j, row in enumerate(rows):
                it = i + j
                cnt = row["fin_count"]
                rollout_s, learn_s = (t.device_s for t in trainer.phase_times[j])
                metrics = TrainingMetrics(
                    mean_reward=row["fin_reward"] / cnt if cnt else 0.0,
                    mean_length=row["fin_length"] / cnt if cnt else 0.0,
                    actor_loss=row["actor_loss"],
                    critic_loss=row["critic_loss"],
                    entropy_loss=row["entropy_loss"],
                    grad_norm=row["grad_norm"],
                    clip_fraction=row["clip_fraction"],
                    explained_variance=row["explained_variance"],
                    approx_kl=row["approx_kl"],
                    fps=steps_per_iteration / rollout_s if rollout_s > 0 else 0.0,
                    rollout_time=rollout_s,
                    learn_time=learn_s,
                )
                env_steps = (it + 1) * steps_per_iteration
                source = "historical" if row["historical_opponent"] else "current_agent"
                logger.log({"training/opponent_source": source}, step=env_steps)
                current_lr = lr_schedule((it + 1) * trainer.config.updates_per_iteration - 1)
                log_training_metrics(logger, metrics, it, env_steps, row["entropy_coef"],
                                     current_lr, echo=is_coordinator())
                summary["iterations"].append(metrics.scalars())
                summary["opponent_sources"].append(source)

            if end > 0 and end % vint == 0:
                say(f"--- Running validation at step {end} ({current_env_steps:,} env steps) ---")
                generator = torch.Generator(device=hw.device).manual_seed(
                    config["seed"] * 1_000_003 + end)
                validation_res = validate(
                    env_cfg,
                    NNPolicy(eval_apply, snapshot(model), generator),
                    NNPolicy(eval_apply, benchmark, generator),
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
                    say(f"--- New benchmark agent at step {end}! ---")
                    benchmark = snapshot(model)
                exporter.export_model(model, config["architecture_name"], arch_params, end,
                                      is_benchmark_breaker=promoted)
                if promoted:
                    logger.log({"validation/new_benchmark_step": 1}, step=current_env_steps)

            if ckpt_interval and end - last_ckpt >= ckpt_interval:
                trainer_state = trainer.global_state()
                if is_coordinator():
                    save_checkpoint(ckpt_dir, end, {
                        "trainer": trainer_state,
                        "benchmark": benchmark.state_dict(),
                        "last_score_rate": float(last_score_rate),
                        "iteration": end,
                        "env_steps": current_env_steps,
                    })
                last_ckpt = end
        except KernelError:
            raise
        except Exception as e:  # log and go on, as the host loop does
            handle_training_error(logger, e, end, current_env_steps)
            summary["errors"].append(f"block {i}-{end}: {e!r}")
        i = end + 1

    exporter.export_model(model, config["architecture_name"], arch_params, total_iterations,
                          is_benchmark_breaker=False)
    if own_logger:
        logger.finish()
    summary["graph_replays"] = trainer.graph_replays
    summary["model"] = model
    return summary

