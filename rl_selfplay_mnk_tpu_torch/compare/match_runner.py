"""Tournament match runner (counterpart of the JAX package's
``compare/match_runner.py``).

Round-robin over all model pairs, each pairing playing ``games_per_pair``
split half as Black and half as White, stochastic policies, one result row
(a dict) per match.

All games of a half-pairing advance together: BOTH policies run densely on
the whole batch each turn and the turn mask selects per game, as in the JAX
package's ``while_loop``. Here the loop is a Python loop that ends when no
game is active, which costs one host synchronisation a turn.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..env.constants import PLAYER_WHITE
from ..env.mnk_env import EnvConfig, make_env_state, observe, step
from ..selfplay.wrapper import flip_channels
from ..utils.hardware import resolve_device
from .model_loader import ModelInfo


@dataclass
class GameConfig:
    m: int = 9
    n: int = 9
    k: int = 5


def play_batch_games(
    cfg: EnvConfig,
    p1_apply: Callable,
    p2_apply: Callable,
    p1_params,
    p2_params,
    n_games: int,
    p1_side: int,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Tuple[int, int, int]:
    """Play ``n_games`` two-policy games to completion; returns
    (p1_wins, p1_losses, draws). Stochastic actions, each mover sees the
    board canonical to its color. ``device`` None = the card."""
    device = resolve_device(device)
    state = make_env_state(cfg, n_games, device)
    active = torch.ones((n_games,), dtype=torch.bool, device=device)
    wins = torch.zeros((), dtype=torch.int64, device=device)
    losses = torch.zeros_like(wins)
    draws = torch.zeros_like(wins)
    # Every game ends within M*N moves.
    for _ in range(cfg.num_actions):
        if not bool(active.any()):
            break
        raw = observe(state)
        observation = flip_channels(raw["observation"], state.current_player == PLAYER_WHITE)
        obs = {"observation": observation, "action_mask": raw["action_mask"]}
        a1 = p1_apply(p1_params, obs, generator, False)
        a2 = p2_apply(p2_params, obs, generator, False)
        p1_turn = state.current_player == p1_side
        state, rewards, dones = step(cfg, state, torch.where(p1_turn, a1, a2), active)
        just = dones & active
        won = just & (rewards == 1.0)
        wins = wins + (won & p1_turn).sum()
        losses = losses + (won & ~p1_turn).sum()
        draws = draws + (just & (rewards == 0.0)).sum()
        active = active & ~dones
    return int(wins), int(losses), int(draws)


class MatchRunner:
    def __init__(self, config: GameConfig, seed: int = 0, device=None):
        self.config = config
        self.env_cfg = EnvConfig(config.m, config.n, config.k)
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def run_tournament_batched(
        self, models: List[ModelInfo], games_per_pair: int, batch_size: int = 8
    ) -> List[Dict]:
        """All-pairs round robin; one row per pairing. ``batch_size`` bounds
        how many models stay loaded at once: an LRU over the loaded entries."""
        all_results: List[Dict] = []
        if len(models) < 2:
            return all_results

        loaded: List[ModelInfo] = []  # LRU order: oldest first

        def ensure_loaded(m: ModelInfo, keep: Optional[ModelInfo]) -> None:
            if m in loaded:
                loaded.remove(m)
                loaded.append(m)
                return
            # Evict BEFORE loading so the bound is never exceeded, and never
            # evict the current pair's other member.
            while len(loaded) >= max(2, batch_size):
                victim = next((x for x in loaded if x is not keep), None)
                if victim is None:
                    break
                loaded.remove(victim)
                victim.unload_model(hard=True)
            m.load_model()
            loaded.append(m)

        total = len(models) * (len(models) - 1) // 2
        for i, model1 in enumerate(models):
            for model2 in models[i + 1:]:
                ensure_loaded(model1, keep=None)
                ensure_loaded(model2, keep=model1)
                r = self._play_match(model1, model2, games_per_pair)
                all_results.append(r)
                print(
                    f"[{len(all_results)}/{total}] {model1.unique_id} vs {model2.unique_id}: "
                    f"{r['player1_wins']}-{r['player2_wins']}-{r['draws']}"
                )
            if model1 in loaded:
                loaded.remove(model1)
            model1.unload_model(hard=True)  # its row is finished
        for m in loaded:
            m.unload_model(hard=True)
        return all_results

    def _play_match(self, model1: ModelInfo, model2: ModelInfo, games_per_pair: int) -> Dict:
        """Half the games with model1 as Black, half as White."""
        params1, act1 = model1.load_model()
        params2, act2 = model2.load_model()

        games_as_first = games_per_pair // 2
        games_as_second = games_per_pair - games_as_first
        w1, l1, d1 = play_batch_games(self.env_cfg, act1, act2, params1, params2,
                                      games_as_first, 0, self.generator, self.device)
        w2, l2, d2 = play_batch_games(self.env_cfg, act1, act2, params1, params2,
                                      games_as_second, 1, self.generator, self.device)
        player1_wins, player2_wins, draws = w1 + w2, l1 + l2, d1 + d2
        return {
            "player1_unique_id": model1.unique_id,
            "player2_unique_id": model2.unique_id,
            "player1_run_name": model1.run_name,
            "player2_run_name": model2.run_name,
            "player1_iteration": model1.iteration,
            "player2_iteration": model2.iteration,
            "total_games": games_per_pair,
            "player1_wins": player1_wins,
            "player2_wins": player2_wins,
            "draws": draws,
            "player1_score": (player1_wins + 0.5 * draws) / max(1, games_per_pair),
            "player2_score": (player2_wins + 0.5 * draws) / max(1, games_per_pair),
        }
