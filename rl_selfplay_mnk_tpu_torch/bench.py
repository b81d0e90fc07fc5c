"""Benchmarks of the port: env-steps/s of whole training iterations, and
the win rate against random after a short training run (counterpart of the
JAX package's root ``bench.py``, its host-loop modes).

``--mode throughput`` (the default): 9x9x5 ``resnet_b_s`` self-play PPO at
8192 envs, n_steps 256, batch 8192, 4 epochs, against a snapshot of the
learner taken once (the steady-state workload of the opponent schedule).
``--warmup`` iterations, one iteration for the phase split (rollout and
update times), then ``--iters`` iterations timed as a whole. It prints a
``#`` line with the card's name and power limit and one with the phase
split on stderr, then one JSON line: ``env_steps_per_sec`` with
``vs_baseline`` (over the reference's 273 env-steps/s, measured by the JAX
package's ``tools/reference_baseline.py`` on its host) and
``vs_north_star`` (over 10M).

``--mode learning``: the default training config (9x9x5, 384 envs, n_steps
256, batch 8192) for ``--learn-iters`` iterations with the lr schedule, the
opponent schedule (15% from the pool, an insert every 20 iterations) and
the linear entropy schedule, then the win rate against the random policy
over 1024 episodes: ``win_rate_vs_random_<iters>iters``. The throughput
mode's flags are refused there when moved off their defaults: it would
ignore them.

``--fused`` runs either mode through the device-resident trainer
(``alg/fused.py``, ``train_fused.py``; the JAX bench's ``run_bench_fused``
and ``run_learning_bench_fused``): the opponent pool, its draws and
inserts, and the schedules on the card, the metrics read once a block.
Both take the driver's ``"auto"`` dispatch (CUDA graphs on the card)
unless ``--dispatch step|scan`` asks for the eager pieces or the graphs. The throughput mode runs
``max(warmup, 1)`` warm-up blocks
of ``--iters`` iterations, then times one block whose window includes the
read of its stacked metrics; it is the 9x9x5 headline only, so ``--mnk``
and ``--batch-size`` are refused beside it. The learning mode runs blocks
of 25 iterations at 384 envs.

Not ported, refused with a message: ``--update-chunks`` (a TPU runtime's
deadline) and ``--use-pallas`` (the env step is always the kernel here).

Runs on the card unless ``--device cpu``. Usage::

    python -m rl_selfplay_mnk_tpu_torch.bench [--arch transformer_b_s]
    python -m rl_selfplay_mnk_tpu_torch.bench --mode learning [--learn-iters 100]
    python -m rl_selfplay_mnk_tpu_torch.bench --fused [--mode learning] [--dispatch scan]
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time

import torch

from .alg.schedules import entropy_coef_at
from .models.fold_bn import snapshot
from .models.registry import eval_apply
from .selfplay.opponent_pool import OpponentPool
from .selfplay.policies import NNPolicy, RandomPolicy
from .selfplay.validation import validate
from .train import create_learner, get_default_config
from .train_fused import create_fused_trainer, resolve_dispatch, run_block
from .utils.hardware import detect_hardware_config

REFERENCE_MEASURED_STEPS_PER_SEC = 273.0  # the JAX package's tools/reference_baseline.py
NORTH_STAR_STEPS_PER_SEC = 10_000_000.0
THROUGHPUT_DEFAULTS = {"--mnk": (9, 9, 5), "--batch-size": 8192, "--num-envs": 8192,
                       "--n-steps": 256, "--iters": 3, "--warmup": 1}
LEARNING_BLOCK = 25  # iterations a block in the fused learning mode, as the JAX bench's
NOT_PORTED = {
    "--update-chunks": "it splits one XLA program under a TPU runtime's deadline",
    "--use-pallas": "the env step always runs its kernel here",
}


def bench_config(arch, mnk, num_envs, n_steps, batch_size, seed=0, **overrides):
    """The trainer's config for a bench run: AdamW at lr 5e-4 whatever the
    family (clip 0.5, eps 1e-5, weight decay 0.01, ``create_learner``'s),
    4 epochs, the network initialised from ``seed``."""
    config = get_default_config()
    config.update(architecture_name=arch, mnk=tuple(mnk), num_envs=num_envs, n_steps=n_steps,
                  batch_size=batch_size, learning_rate=5e-4, seed=seed, **overrides)
    return config


def run_bench(num_envs: int, n_steps: int, iters: int, warmup: int, arch: str, mnk=(9, 9, 5),
              batch_size: int = 8192, device=None) -> dict:
    hw = detect_hardware_config(device)
    # No warm-up of the lr: the JAX bench's constant 5e-4.
    learner, _, _, _ = create_learner(
        bench_config(arch, mnk, num_envs, n_steps, batch_size, lr_warmup_steps=0), hw)
    opponent = NNPolicy(eval_apply, snapshot(learner.model),
                        torch.Generator(device=hw.device).manual_seed(2))

    for _ in range(warmup):
        learner.learn(opponent, 0.01)
    # one iteration for the phase split...
    m = learner.learn(opponent, 0.01)
    # ...then the throughput over ``iters`` whole iterations
    steps_per_iter = num_envs * n_steps
    t0 = time.perf_counter()
    for _ in range(iters):
        learner.learn(opponent, 0.01)
    if hw.device.type == "cuda":
        torch.cuda.synchronize(hw.device)
    total = time.perf_counter() - t0
    return {
        "throughput": steps_per_iter * iters / total,
        "rollout_fps": m.fps,
        "rollout_time_per_iter": m.rollout_time,
        "learn_time_per_iter": m.learn_time,
        "steps_per_iter": steps_per_iter,
    }


def run_learning_bench(iters: int, arch: str, seed: int = 0, device=None) -> dict:
    hw = detect_hardware_config(device)
    num_envs, n_steps = 384, 256
    # The lr warms up over 5M env steps, as the default config's.
    learner, env_cfg, _, _ = create_learner(
        bench_config(arch, (9, 9, 5), num_envs, n_steps, 8192, seed,
                     total_environment_steps=iters * num_envs * n_steps), hw)
    policy_generator = torch.Generator(device=hw.device).manual_seed(seed + 2)
    pool = OpponentPool(max_size=20, seed=seed)
    pool.add_opponent(snapshot(learner.model))
    ent_schedule = {"type": "linear", "params": {"final_coef": 0.001, "total_steps": 125_000_000}}
    host_rng = random.Random(seed)

    t0 = time.perf_counter()
    for i in range(iters):
        opponent = (pool.get_random_opponent() if host_rng.random() < 0.15
                    else snapshot(learner.model))
        ent = entropy_coef_at(0.04, ent_schedule, i, num_envs, n_steps)
        m = learner.learn(NNPolicy(eval_apply, opponent, policy_generator), ent)
        if i % 20 == 0:
            pool.add_opponent(snapshot(learner.model))
        if i % 25 == 0:
            print(f"# iter {i}: reward {m.mean_reward:+.3f} len {m.mean_length:.1f} "
                  f"ent {-m.entropy_loss:.3f} ({time.perf_counter() - t0:.0f}s)", file=sys.stderr)
    train_time = time.perf_counter() - t0

    generator = torch.Generator(device=hw.device).manual_seed(seed + 99)
    res = validate(env_cfg, NNPolicy(eval_apply, snapshot(learner.model), generator),
                   RandomPolicy(generator), 1024, hw.device, generator)
    return {
        "win_rate": res["validation/vs_benchmark/win_rate"],
        "score_rate": res["validation/vs_benchmark/score_rate"],
        "train_time": train_time,
        "iters": iters,
    }


def run_bench_fused(num_envs: int, n_steps: int, iters: int, warmup: int, arch: str,
                    device=None, dispatch: str = "auto") -> dict:
    """Throughput of the fused trainer: the constant lr 5e-4 and entropy
    coefficient 0.01 of ``run_bench``, the pool's draws and inserts on."""
    hw = detect_hardware_config(device)
    config = bench_config(arch, (9, 9, 5), num_envs, n_steps, 8192, lr_warmup_steps=0,
                          entropy_coef=0.01, entropy_coef_schedule=None)
    dispatch = resolve_dispatch(dispatch, hw.device)
    trainer = create_fused_trainer(config, hw, max_block=iters)[0]
    it0 = 0
    t0 = time.perf_counter()
    for _ in range(max(warmup, 1)):  # the first captures the graphs under "scan"
        run_block(trainer, dispatch, it0, iters, 1.0)
        it0 += iters
    warmup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_block(trainer, dispatch, it0, iters, 1.0)  # the read of the metrics is in the window
    total = time.perf_counter() - t0
    return {
        "throughput": num_envs * n_steps * iters / total,
        "time_per_iter": total / iters,
        "steps_per_iter": num_envs * n_steps,
        "dispatch": dispatch,
        "warmup_s": warmup_s,
    }


def run_learning_bench_fused(iters: int, arch: str, seed: int = 0, device=None,
                             dispatch: str = "auto") -> dict:
    """``run_learning_bench`` through the fused trainer, in blocks of
    ``LEARNING_BLOCK`` iterations."""
    block = LEARNING_BLOCK
    hw = detect_hardware_config(device)
    num_envs, n_steps = 384, 256
    config = bench_config(arch, (9, 9, 5), num_envs, n_steps, 8192, seed,
                          total_environment_steps=iters * num_envs * n_steps)
    dispatch = resolve_dispatch(dispatch, hw.device)
    trainer, env_cfg, _, _, _ = create_fused_trainer(config, hw, max_block=block)
    t0 = time.perf_counter()
    i = 0
    while i < iters:
        length = min(block, iters - i)
        rows = run_block(trainer, dispatch, i, length, 1.0)
        i += length
        fin = rows[:, -3:].sum(0)
        print(f"# fused iters {i}: mean reward {float(fin[0]) / max(float(fin[2]), 1.0):+.3f} "
              f"({time.perf_counter() - t0:.0f}s)", file=sys.stderr)
    train_time = time.perf_counter() - t0

    generator = torch.Generator(device=hw.device).manual_seed(seed + 99)
    res = validate(env_cfg, NNPolicy(eval_apply, snapshot(trainer.model), generator),
                   RandomPolicy(generator), 1024, hw.device, generator)
    return {
        "win_rate": res["validation/vs_benchmark/win_rate"],
        "score_rate": res["validation/vs_benchmark/score_rate"],
        "train_time": train_time,
        "iters": iters,
    }


def card_line(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them; the CPU
    says so."""
    if device == "cpu":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mode", choices=["throughput", "learning"], default="throughput")
    parser.add_argument("--num-envs", type=int, default=8192)
    parser.add_argument("--n-steps", type=int, default=256)
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--warmup", type=int, default=1)
    parser.add_argument("--arch", default="resnet_b_s")
    parser.add_argument("--learn-iters", type=int, default=500,
                        help="training iterations for --mode learning")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--mnk", type=int, nargs=3, default=[9, 9, 5], metavar=("M", "N", "K"),
                        help="board (throughput mode only)")
    parser.add_argument("--batch-size", type=int, default=8192,
                        help="PPO minibatch (throughput mode only)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--fused", action="store_true",
                        help="the device-resident fused trainer (train_fused.py)")
    parser.add_argument("--dispatch", choices=["auto", "step", "scan"], default="auto",
                        help="the fused trainer's dispatch (--fused only)")
    parser.add_argument("--update-chunks", type=int, default=None, help="not ported: refused")
    parser.add_argument("--use-pallas", action="store_true", help="not ported: refused")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Run the benchmark; prints its lines and returns the JSON line's record."""
    args = parse_args(argv)
    given = [flag for flag in NOT_PORTED
             if getattr(args, flag[2:].replace("-", "_")) not in (None, False)]
    if given:
        sys.exit("; ".join(f"{flag} is not ported: {NOT_PORTED[flag]}" for flag in given))
    if args.dispatch != "auto" and not args.fused:
        sys.exit("--dispatch picks the fused trainer's dispatch; add --fused")

    if args.mode == "learning":
        values = {"--mnk": tuple(args.mnk), "--batch-size": args.batch_size,
                  "--num-envs": args.num_envs, "--n-steps": args.n_steps, "--iters": args.iters,
                  "--warmup": args.warmup}
        ignored = [flag for flag, default in THROUGHPUT_DEFAULTS.items() if values[flag] != default]
        if ignored:
            sys.exit("--mode learning is the fixed 9x9x5 default workload; "
                     f"{', '.join(ignored)} are throughput-mode flags and would be ignored")
        if args.fused:
            res = run_learning_bench_fused(args.learn_iters, args.arch, args.seed, args.device,
                                           args.dispatch)
        else:
            res = run_learning_bench(args.learn_iters, args.arch, seed=args.seed,
                                     device=args.device)
        print(f"# card: {card_line(args.device)}", file=sys.stderr)
        print(f"# trained {res['iters']} iters in {res['train_time']:.0f}s; "
              f"score_rate vs random {res['score_rate']:.3f}", file=sys.stderr)
        record = {"metric": f"win_rate_vs_random_{res['iters']}iters",
                  "value": round(res["win_rate"], 4), "unit": "fraction",
                  "vs_baseline": round(res["win_rate"], 4)}
        print(json.dumps(record), flush=True)
        return record

    if args.fused:
        if tuple(args.mnk) != (9, 9, 5) or args.batch_size != 8192:
            sys.exit("--fused bench is the 9x9x5 headline only; drop --mnk/--batch-size")
        res = run_bench_fused(args.num_envs, args.n_steps, args.iters, args.warmup, args.arch,
                              args.device, args.dispatch)
        print(f"# card: {card_line(args.device)}", file=sys.stderr)
        print(f"# fused dispatch {res['dispatch']} | {res['time_per_iter']:.3f}s per iter "
              f"({res['steps_per_iter']} steps) | warm-up {res['warmup_s']:.1f}s",
              file=sys.stderr)
    else:
        res = run_bench(args.num_envs, args.n_steps, args.iters, args.warmup, args.arch,
                        tuple(args.mnk), args.batch_size, args.device)
        print(f"# card: {card_line(args.device)}", file=sys.stderr)
        print(f"# rollout fps {res['rollout_fps']:.0f} | rollout {res['rollout_time_per_iter']:.3f}s"
              f" | learn {res['learn_time_per_iter']:.3f}s per iter ({res['steps_per_iter']} steps)",
              file=sys.stderr)
    record = {
        "metric": "env_steps_per_sec",
        "value": round(res["throughput"], 1),
        "unit": "steps/s",
        "vs_baseline": round(res["throughput"] / REFERENCE_MEASURED_STEPS_PER_SEC, 2),
        "vs_north_star": round(res["throughput"] / NORTH_STAR_STEPS_PER_SEC, 4),
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
