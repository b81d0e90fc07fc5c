"""BASELINE config 1 through the port: 3x3x3 tic-tac-toe, 64 envs,
``mlp_tiny``, PPO against a uniform-random opponent for 500 iterations on
one rank, then 512 validation episodes against random (the JAX package's
``tools/configs_matrix.py`` entry 1 and its ``run_vs_random``).

Prints one JSON line with the JAX runner's keys: ``iterations``,
``env_steps``, ``steps_per_sec`` (after the first iteration),
``compile_plus_first_iter_s`` (here the first iteration with the kernels'
build), ``win_rate_vs_random``, ``score_rate_vs_random`` and
``final_mean_reward``. Runs on the card unless ``--device cpu``::

    python -m rl_selfplay_mnk_tpu_torch.baseline_config1 [--iters 500] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .selfplay.policies import NNPolicy, RandomPolicy
from .selfplay.validation import validate
from .models.fold_bn import snapshot
from .models.registry import eval_apply
from .train import create_learner, get_default_config
from .utils.hardware import detect_hardware_config

CONFIG_1 = {"mnk": (3, 3, 3), "num_envs": 64, "architecture_name": "mlp_tiny", "iters": 500}


def run_vs_random(iters: int = CONFIG_1["iters"], seed: int = 0, device: str = "cuda") -> dict:
    """PPO against the random policy, no pool; returns the JAX runner's
    record."""
    config = get_default_config()
    config.update(mnk=CONFIG_1["mnk"], num_envs=CONFIG_1["num_envs"],
                  architecture_name=CONFIG_1["architecture_name"], seed=seed,
                  total_environment_steps=iters * CONFIG_1["num_envs"] * config["n_steps"])
    hw = detect_hardware_config(device)
    learner, env_cfg, _, _ = create_learner(config, hw)
    opponent = RandomPolicy(torch.Generator(device=hw.device).manual_seed(seed + 2))

    t_first = time.perf_counter()
    metrics = learner.learn(opponent, config["entropy_coef"])
    first_s = time.perf_counter() - t_first
    t0 = time.perf_counter()
    for _ in range(iters - 1):
        metrics = learner.learn(opponent, config["entropy_coef"])
    wall = time.perf_counter() - t0
    steps_per_iter = CONFIG_1["num_envs"] * config["n_steps"]

    generator = torch.Generator(device=hw.device).manual_seed(seed + 1)
    res = validate(env_cfg, NNPolicy(eval_apply, snapshot(learner.model), generator),
                   RandomPolicy(generator), 512, hw.device, generator)
    return {
        "iterations": iters,
        "env_steps": iters * steps_per_iter,
        "steps_per_sec": round((iters - 1) * steps_per_iter / wall, 1) if iters > 1 else 0.0,
        "compile_plus_first_iter_s": round(first_s, 1),
        "win_rate_vs_random": round(res["validation/vs_benchmark/win_rate"], 4),
        "score_rate_vs_random": round(res["validation/vs_benchmark/score_rate"], 4),
        "final_mean_reward": round(float(metrics.mean_reward), 4),
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="BASELINE config 1 through the port")
    parser.add_argument("--iters", type=int, default=CONFIG_1["iters"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    record = run_vs_random(args.iters, args.seed, args.device)
    print(json.dumps({"config": 1, **record}))
    return record


if __name__ == "__main__":
    main()
