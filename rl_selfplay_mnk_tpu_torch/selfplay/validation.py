"""Benchmark validation: play N self-play episodes to completion.

Counterpart of the JAX package's ``selfplay/validation.py``: a fresh env
batch of ``n_episodes``, sides forced half Black (first half) and half
White, stochastic actions, each env's FIRST terminal reward recorded, and
win/loss/draw/score rates under ``validation/vs_benchmark/*``. The JAX
``while_loop`` is a Python loop that stops when no env is active. The
games run inside the ``validation`` span (``utils/tracing.py``); each turn
ends in a host read, so the span's host wall is the work.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..env.mnk_env import EnvConfig
from ..utils.hardware import resolve_device
from ..utils.tracing import span
from .policies import Policy
from .wrapper import selfplay_reset, selfplay_step


def validate(
    cfg: EnvConfig,
    agent: Policy,
    opponent: Policy,
    n_episodes: int,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> dict:
    """Win/loss/draw/score rates of ``agent`` against ``opponent``.
    ``device`` None = the card."""
    device = resolve_device(device)
    with span("validation"):
        sides = torch.cat([
            torch.zeros((n_episodes // 2,), dtype=torch.int32),
            torch.ones((n_episodes - n_episodes // 2,), dtype=torch.int32),
        ]).to(device)
        state, obs = selfplay_reset(cfg, opponent, n_episodes, device, generator, agent_side=sides)
        finished = torch.zeros((n_episodes,), dtype=torch.float32, device=device)
        active = torch.ones((n_episodes,), dtype=torch.bool, device=device)
        # Every game ends within M*N moves, half of them the agent's.
        for _ in range(cfg.num_actions + 1):
            if not bool(active.any()):
                break
            actions = agent.act(obs)
            state, obs, rewards, terminated = selfplay_step(cfg, opponent, state, actions,
                                                            generator)
            finished = torch.where(terminated & active, rewards, finished)
            active = active & ~terminated
        if bool(active.any()):
            raise RuntimeError("validation games did not finish within the board's move count")
        wins = int((finished == 1.0).sum())
        losses = int((finished == -1.0).sum())
        draws = int((finished == 0.0).sum())
    return {
        "validation/vs_benchmark/win_rate": wins / n_episodes,
        "validation/vs_benchmark/loss_rate": losses / n_episodes,
        "validation/vs_benchmark/draw_rate": draws / n_episodes,
        "validation/vs_benchmark/score_rate": (wins + 0.5 * draws) / n_episodes,
        "validation/vs_benchmark/games_played": n_episodes,
    }
