"""Random-search sweep over the short run (counterpart of the JAX package's
``sweep.py``): the search space of ``sweep_config.yaml`` (log-uniform lr in
[1e-5, 2e-3] and entropy in [0.001, 0.2], an architecture of
``transformer_b_s``, ``resnet_b_s``, ``cnn_b_s``), sampled from
``random.Random(--seed)`` as the JAX sweep samples it, each trial a
``train_short`` run ``sweep_<seed>_<t>`` seeded ``seed * 1000 + t``. Flags it
does not know go on to ``train_short`` (scale overrides, ``--device``).
``--eval-episodes N`` scores each trial's last export against the random
policy and writes a ranked summary.

``--wandb`` runs the trials under the wandb sweep agent instead; it needs
the ``wandb`` package and a network, and exits with a message without them.

Usage::

    python -m rl_selfplay_mnk_tpu_torch.sweep --trials 8 --seed 0 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import random

import torch

from .train_short import main as train_short_main

SEARCH_SPACE = {
    "learning_rate": ("log_uniform", 1e-5, 2e-3),
    "entropy_coef": ("log_uniform", 0.001, 0.2),
    "architecture_name": ("choice", ["transformer_b_s", "resnet_b_s", "cnn_b_s"]),
}


def sample_config(rng: random.Random) -> dict:
    out = {}
    for key, spec in SEARCH_SPACE.items():
        if spec[0] == "log_uniform":
            out[key] = math.exp(rng.uniform(math.log(spec[1]), math.log(spec[2])))
        elif spec[0] == "choice":
            out[key] = rng.choice(spec[1])
    return out


def evaluate_vs_random(run_name: str, mnk, episodes: int, seed: int, device: str) -> dict:
    """A trial's last export against the random policy: its win and score
    rates, comparable across trials."""
    from .env.mnk_env import EnvConfig
    from .models.registry import eval_apply
    from .selfplay.policies import NNPolicy, RandomPolicy
    from .selfplay.validation import validate
    from .utils.model_export import get_models_from_directory, load_any_model

    model_dir = os.path.join("models", run_name)
    latest = get_models_from_directory(model_dir)[-1]["model_id"]
    model, _ = load_any_model(model_dir, latest, device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    res = validate(EnvConfig(*mnk).validate(), NNPolicy(eval_apply, model, generator),
                   RandomPolicy(generator), episodes, device, generator)
    return {
        "win_rate_vs_random": round(res["validation/vs_benchmark/win_rate"], 4),
        "score_rate_vs_random": round(res["validation/vs_benchmark/score_rate"], 4),
    }


def _wandb_trial() -> None:
    """One trial under the wandb agent: the hyper-parameters come in
    ``run.config``."""
    import wandb

    cfg = dict(wandb.init().config)
    train_short_main([
        "--learning_rate", str(cfg.get("learning_rate", 5e-4)),
        "--entropy_coef", str(cfg.get("entropy_coef", 0.04)),
        "--architecture_name", cfg.get("architecture_name", "resnet_b_s"),
    ])


def run_wandb_agent(trials: int, sweep_id: str | None = None) -> str:
    """``wandb agent`` over ``sweep_config.yaml``; returns the sweep id."""
    try:
        import wandb
        import yaml
    except ImportError as e:
        raise SystemExit(f"--wandb needs the wandb package ({e}); run the local sweep "
                         "(no --wandb) without it")
    if sweep_id is None:
        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        with open(os.path.join(here, "sweep_config.yaml")) as f:
            sweep_id = wandb.sweep(yaml.safe_load(f), project="mnk_b_sweeps")
    wandb.agent(sweep_id, function=_wandb_trial, count=trials)
    return sweep_id


def main(argv=None) -> list:
    """Run the sweep; returns each trial's row."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trials", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--wandb", action="store_true",
                        help="run under the wandb sweep agent (sweep_config.yaml)")
    parser.add_argument("--sweep-id", default=None, help="join this wandb sweep")
    parser.add_argument("--eval-episodes", type=int, default=0,
                        help="score each trial's last export against random, write a summary")
    parser.add_argument("--summary-out", default=None,
                        help="summary path (default runs/sweep_<seed>_summary.json)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args, extra = parser.parse_known_args(argv)

    if args.wandb:
        # The agent's trials take their config from the wandb sweep: a local
        # flag would be ignored, so each is refused.
        local = list(extra) + [flag for flag, on in (("--eval-episodes", args.eval_episodes),
                                                     ("--summary-out", args.summary_out),
                                                     ("--seed", args.seed)) if on]
        if local:
            raise SystemExit(f"--wandb runs its trials from the wandb sweep; {', '.join(local)} "
                             "would be ignored: drop them or run the local sweep (no --wandb)")
        run_wandb_agent(args.trials, args.sweep_id)
        return []

    mnk = (9, 9, 5)
    if "--mnk" in extra:
        i = extra.index("--mnk")
        mnk = tuple(int(x) for x in extra[i + 1:i + 4])

    rng = random.Random(args.seed)
    results = []
    for t in range(args.trials):
        trial = sample_config(rng)
        print(f"\n=== sweep trial {t}: {trial} ===")
        run_name = f"sweep_{args.seed}_{t}"
        train_short_main([
            "--learning_rate", str(trial["learning_rate"]),
            "--entropy_coef", str(trial["entropy_coef"]),
            "--architecture_name", trial["architecture_name"],
            "--seed", str(args.seed * 1000 + t),
            "--run-name", run_name,
            "--device", args.device,
        ] + extra)
        row = {
            "trial": t,
            "run_name": run_name,
            "learning_rate": round(trial["learning_rate"], 8),
            "entropy_coef": round(trial["entropy_coef"], 6),
            "architecture_name": trial["architecture_name"],
        }
        if args.eval_episodes:
            row.update(evaluate_vs_random(run_name, mnk, args.eval_episodes,
                                          args.seed * 1000 + t, args.device))
            print(f"trial {t} outcome: {row}")
        results.append(row)

    if args.eval_episodes:
        results.sort(key=lambda r: -r["score_rate_vs_random"])
        out = args.summary_out or f"runs/sweep_{args.seed}_summary.json"
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump({"search_space": {k: list(map(str, v)) for k, v in SEARCH_SPACE.items()},
                       "trials": results}, f, indent=1)
            f.write("\n")
        print(f"\nsweep summary (best first) -> {out}")
        for r in results:
            print(r)
    return results


if __name__ == "__main__":
    main()
