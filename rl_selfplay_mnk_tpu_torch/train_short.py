"""The sweep's short run: 80M env steps, the entropy schedule 0.04 -> 0.001
over 50M, no lr decay (counterpart of the JAX package's ``train_short.py``),
with the sweep's hyper-parameters and smaller scales as flags.

Usage::

    python -m rl_selfplay_mnk_tpu_torch.train_short --learning_rate 3e-4 --entropy_coef 0.02 \\
        --architecture_name resnet_b_s [--run-name r --device cpu --mnk 3 3 3 --num-envs 8 ...]
"""

from __future__ import annotations

import argparse

from .train import get_default_config
from .train_all import run_all


def short_config(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--learning_rate", type=float, default=None)
    parser.add_argument("--entropy_coef", type=float, default=None)
    parser.add_argument("--architecture_name", default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--run-name", default=None)
    parser.add_argument("--total-steps", type=int, default=None)
    parser.add_argument("--num-envs", type=int, default=None)
    parser.add_argument("--n-steps", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--mnk", type=int, nargs=3, default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    config = get_default_config()
    config["total_environment_steps"] = 80_000_000
    config["entropy_coef_schedule"] = {
        "type": "linear",
        "params": {"final_coef": 0.001, "total_steps": 50_000_000},
    }
    config["lr_decay"] = False
    for key in ("learning_rate", "entropy_coef", "architecture_name", "seed"):
        val = getattr(args, key)
        if val is not None:
            config[key] = val
    for key, val in (("total_environment_steps", args.total_steps), ("num_envs", args.num_envs),
                     ("n_steps", args.n_steps), ("batch_size", args.batch_size)):
        if val is not None:
            config[key] = val
    if args.mnk is not None:
        config["mnk"] = tuple(args.mnk)
    return config, {"project": "mnk_b_sweeps", "run_name": args.run_name}, args.device


def main(argv=None) -> None:
    config, logger_args, device = short_config(argv)
    run_all([(config, logger_args)], device)


if __name__ == "__main__":
    main()
