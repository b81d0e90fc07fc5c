"""Self-play PPO training loop (counterpart of the JAX package's
``train.py``, single-device and non-league path).

  * opponent schedule: 15% a historical snapshot from the pool, 85% the
    current network, drawn from a host ``random.Random(seed)``; every
    opponent is a frozen snapshot (``models.fold_bn.snapshot``: BatchNorm
    folded where the model has it), taken once when it is drawn;
  * a pool insert every 20 iterations, FIFO eviction;
  * validation against the benchmark every ``validation_interval``
    iterations; the benchmark (first the untrained network) is replaced by
    a new snapshot when the score rate exceeds 0.60; the learner is
    exported after every validation (marked as a benchmark breaker when it
    was promoted) and once more at the end, under ``<export_dir>/<run>/``;
  * per-iteration fault handling: log the error and continue, except for
    a kernel that fails to build, load or launch (``KernelError``), which
    ends the run.

Runs on the card unless ``device="cpu"`` (``--device cpu``) is asked for.
Usage::

    python -m rl_selfplay_mnk_tpu_torch.train --total-steps 589824 --device cuda
    python -m rl_selfplay_mnk_tpu_torch.train --arch transformer_b_s_w --mnk 13 13 5 --batch-size 4096

``--arch`` also sets the family's learning rate and entropy schedule
(``apply_family_hparams``). On the command line, and only there, ``--mnk 13
13 5`` also brings the big-board horizons (``big_board_horizons``: 600M env
steps, the entropy schedule over 300M; ``--total-steps`` still overrides the
first), so the second line is the JAX package's full 13x13 recipe.
"""

from __future__ import annotations

import argparse
import dataclasses
import random as _random
import traceback
from typing import Any, Dict, Optional

import torch

from .alg.ppo import PPOConfig, PPOLearner, PPOOptimizer, TrainingMetrics, pick_group_size
from .alg.schedules import entropy_coef_at, make_lr_schedule
from .env.mnk_env import EnvConfig
from .models.fold_bn import snapshot
from .ops.cuda_build import KernelError
from .models.registry import create_model_from_architecture, eval_apply, init_network
from .selfplay.opponent_pool import OpponentPool
from .selfplay.policies import NNPolicy
from .selfplay.validation import validate
from .utils.hardware import HardwareConfig, detect_hardware_config
from .utils.metrics import MetricsLogger
from .utils.model_export import ModelExporter


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
        "device": None,  # None = cuda
    }


def apply_family_hparams(config: Dict[str, Any], arch: str) -> Dict[str, Any]:
    """Per-family learning rate and entropy settings, as the JAX package's
    ``train_all.apply_family_hparams``."""
    if "transformer" in arch:
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


def create_learner(config: Dict[str, Any], hw: HardwareConfig):
    """Network + optimizer + PPO learner on ``hw.device``. Returns
    ``(learner, env_cfg, lr_schedule, arch_params)``."""
    m, n, k = config["mnk"]
    env_cfg = EnvConfig(m, n, k).validate()
    obs_shape = (2, m, n)
    module, arch_params = create_model_from_architecture(
        config["architecture_name"], obs_shape, m * n, dtype=hw.compute_dtype
    )
    # Initialise on the CPU from the seed, so both devices start alike.
    init_network(module, torch.Generator().manual_seed(config["seed"]))
    module.to(hw.device)

    shuffle = config.get("shuffle", "auto")
    if shuffle == "auto":
        shuffle = "grouped" if hw.is_accelerator else "global"
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
        group_size=pick_group_size(config["batch_size"]),
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
    optimizer = PPOOptimizer(module.parameters(), lr_schedule)
    generator = torch.Generator(device=hw.device).manual_seed(config["seed"] + 1)
    learner = PPOLearner(module, ppo_cfg, optimizer, generator, hw.device)
    return learner, env_cfg, lr_schedule, arch_params


def train_mnk(
    config: Dict[str, Any],
    logger: Optional[MetricsLogger] = None,
    device: Optional[str] = None,
) -> Dict[str, Any]:
    """The training loop. Returns a summary: per-iteration metrics, the
    validation results, the errors that the loop logged and skipped, the
    directory of the exports (``export_dir``) and the trained ``model``."""
    hw = detect_hardware_config(device or config.get("device"))
    own_logger = logger is None
    if own_logger:
        logger = MetricsLogger(run_name=config.get("run_name"), config=config)
    learner, env_cfg, lr_schedule, arch_params = create_learner(config, hw)
    exporter = ModelExporter(logger.run_name, base_dir=config.get("export_dir", "models"))
    policy_generator = torch.Generator(device=hw.device).manual_seed(config["seed"] + 2)

    def network_policy(frozen, generator=policy_generator):
        return NNPolicy(eval_apply, frozen, generator)

    # The benchmark starts as the untrained network; the pool is seeded with
    # the same snapshot. Opponents only run eval forwards, so all are frozen
    # snapshots (BatchNorm folded where there is any).
    benchmark = snapshot(learner.model)
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
    summary: Dict[str, Any] = {"iterations": [], "validations": [], "errors": [],
                               "jsonl_path": logger.jsonl_path,
                               "export_dir": exporter.export_dir}

    print(f"Starting training for {total_iterations} iterations")
    current_env_steps = 0
    for i in range(total_iterations):
        try:
            if host_rng.random() < 0.15:
                opponent, source = pool.get_random_opponent(), "historical"
            else:
                opponent, source = snapshot(learner.model), "current_agent"
            logger.log({"training/opponent_source": source}, step=(i + 1) * steps_per_iteration)

            ent_coef = entropy_coef_at(
                config["entropy_coef"], config["entropy_coef_schedule"], i,
                config["num_envs"], config["n_steps"],
            )
            metrics = learner.learn(network_policy(opponent), ent_coef)
            current_env_steps = (i + 1) * steps_per_iteration
            current_lr = lr_schedule((i + 1) * learner.config.updates_per_iteration - 1)
            log_training_metrics(logger, metrics, i, current_env_steps, ent_coef, current_lr)
            summary["iterations"].append(dataclasses.asdict(metrics))

            if i % 20 == 0:
                pool.add_opponent(snapshot(learner.model), weight=last_score_rate)

            if i > 0 and i % config["validation_interval"] == 0:
                print(f"--- Running validation at step {i} ({current_env_steps:,} env steps) ---")
                generator = torch.Generator(device=hw.device).manual_seed(
                    config["seed"] * 1_000_003 + i
                )
                validation_res = validate(
                    env_cfg,
                    network_policy(snapshot(learner.model), generator),
                    network_policy(benchmark, generator),
                    config["validation_episodes"],
                    hw.device,
                    generator,
                )
                logger.log(validation_res, step=current_env_steps)
                summary["validations"].append(validation_res)

                score_rate = validation_res["validation/vs_benchmark/score_rate"]
                last_score_rate = max(score_rate, 1e-3)
                print(
                    f"Score: {score_rate:.2f} | "
                    f"W: {validation_res['validation/vs_benchmark/win_rate']:.2f} | "
                    f"D: {validation_res['validation/vs_benchmark/draw_rate']:.2f} | "
                    f"L: {validation_res['validation/vs_benchmark/loss_rate']:.2f}"
                )
                promoted = score_rate > config["benchmark_update_threshold_score"]
                if promoted:
                    print(f"--- New benchmark agent at step {i}! ---")
                    benchmark = snapshot(learner.model)
                exporter.export_model(learner.model, config["architecture_name"], arch_params, i,
                                      is_benchmark_breaker=promoted)
                if promoted:
                    logger.log({"validation/new_benchmark_step": 1}, step=current_env_steps)
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


def log_training_metrics(
    logger: MetricsLogger,
    metrics: TrainingMetrics,
    iteration: int,
    env_steps: int,
    entropy_coef: float,
    current_lr: float,
) -> None:
    """Stdout line + logger record, with the JAX package's keys."""
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
    print(f"Error in iteration {iteration}: {error}")
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
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

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
    return config


def main(argv=None) -> None:
    config = config_from_args(argv)
    with MetricsLogger(run_name=config["run_name"], config=config) as logger:
        train_mnk(config, logger)


if __name__ == "__main__":
    main()
