"""Interactive play CLI: human / random / trained model against the same
(counterpart of the JAX package's ``play.py``).

``--p1/--p2 {human,random,path}``, board size flags, an ANSI board renderer
with cell indices, the canonical channel flip for the White-side policy,
move-history export and ``--import_game`` replay; a model argument is a file
or a directory, whose latest export is taken. ``--device {cuda,cpu}``,
default the card.

Usage:
    python -m rl_selfplay_mnk_tpu_torch.play --p1 human --p2 models/run/ --m 9 --n 9 --k 5
    python -m rl_selfplay_mnk_tpu_torch.play --import_game game_123.json
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional, Tuple

import torch

from .env.constants import PLAYER_WHITE
from .env.mnk_env import EnvConfig, EnvState, make_env_state, observe, step
from .models.fold_bn import snapshot
from .models.registry import eval_apply
from .selfplay.policies import NNPolicy, RandomPolicy
from .utils.hardware import resolve_device
from .utils.model_export import get_models_from_directory, load_any_model

RESET = "\033[0m"
RED = "\033[91m"
BLUE = "\033[94m"
DIM = "\033[2m"


def print_board(state: EnvState, m: int, n: int) -> None:
    """ANSI board with cell indices on empty squares."""
    boards = state.boards[0].cpu().numpy()
    width = len(str(m * n - 1))
    print()
    for r in range(m):
        row = []
        for c in range(n):
            idx = r * n + c
            if boards[0, r, c] > 0.5:
                row.append(f"{RED}{'X':>{width}}{RESET}")
            elif boards[1, r, c] > 0.5:
                row.append(f"{BLUE}{'O':>{width}}{RESET}")
            else:
                row.append(f"{DIM}{idx:>{width}}{RESET}")
        print("  " + " ".join(row))
    print()


class HumanPolicy:
    """Reads a cell index from stdin."""

    def act(self, obs, deterministic=False):
        mask = obs["action_mask"][0].cpu().numpy()
        while True:
            try:
                a = int(input("Your move (cell index): ").strip())
            except (ValueError, EOFError):
                print("Enter a number.")
                continue
            if 0 <= a < mask.shape[0] and mask[a]:
                return torch.tensor([a], dtype=torch.int64, device=obs["action_mask"].device)
            print("Illegal move, try again.")


def load_policy_from_arg(arg: str, board: tuple, device=None,
                         generator: Optional[torch.Generator] = None):
    """'human' | 'random' | model file or directory -> (policy, name). The
    policy draws its sampling noise from ``generator``; a model loads onto
    ``device`` (None = the card)."""
    if arg == "human":
        return HumanPolicy(), "human"
    if arg == "random":
        return RandomPolicy(generator), "random"
    if os.path.isdir(arg):
        listing = get_models_from_directory(arg)
        if not listing:
            raise FileNotFoundError(f"No exported models in {arg}")
        model_id = listing[-1]["model_id"]  # latest iteration
        model_dir = arg
    else:
        model_dir = os.path.dirname(arg) or "."
        base = os.path.basename(arg)
        model_id = base[: -len(".msgpack")] if base.endswith(".msgpack") else base
    device = resolve_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model, metadata = load_any_model(model_dir, model_id, dtype, device)
    m, n = board
    model_mn = tuple(metadata.architecture_params.get("obs_shape", ())[1:])
    if model_mn and model_mn != (m, n):
        raise ValueError(
            f"model {metadata.run_name}/{model_id} was trained for a "
            f"{model_mn[0]}x{model_mn[1]} board but --m/--n select "
            f"{m}x{n}; pass the board the model was trained on"
        )
    return NNPolicy(eval_apply, snapshot(model), generator), f"{metadata.run_name}/{model_id}"


def _policy_action(policy, obs, mover_is_white: bool):
    """Run a policy for the current mover, with the canonical view for White."""
    if mover_is_white:
        obs = {"observation": obs["observation"].flip(1), "action_mask": obs["action_mask"]}
    return policy.act(obs, deterministic=False)


def play_game(cfg: EnvConfig, p1, p2, names: Tuple[str, str],
              device=None) -> Tuple[List[int], Optional[int]]:
    """Drive one game; returns (move_history, winner 0/1/None). ``device``
    None = the card."""
    state = make_env_state(cfg, 1, device)
    history: List[int] = []
    print_board(state, cfg.m, cfg.n)
    winner = None
    while True:
        player = int(state.current_player[0])
        policy = p1 if player == 0 else p2
        actions = _policy_action(policy, observe(state), player == PLAYER_WHITE)
        a = int(actions[0])
        mark = "X" if player == 0 else "O"
        print(f"{names[player]} ({mark}) plays {a}")
        history.append(a)
        state, rewards, dones = step(cfg, state, actions)
        print_board(state, cfg.m, cfg.n)
        if bool(dones[0]):
            if float(rewards[0]) == 1.0:
                winner = player
                print(f"{names[player]} ({mark}) wins!")
            else:
                print("Draw!")
            break
    return history, winner


def export_game(history: List[int], winner: Optional[int], cfg: EnvConfig,
                names: Tuple[str, str]) -> str:
    path = f"game_{int(time.time())}.json"
    with open(path, "w") as f:
        json.dump(
            {"mnk": [cfg.m, cfg.n, cfg.k], "players": list(names), "moves": history,
             "winner": winner},
            f,
        )
    print(f"Game exported to {path}")
    return path


def replay_game(path: str, delay: float = 0.5, device=None) -> None:
    """Replay an exported game move by move."""
    with open(path) as f:
        record = json.load(f)
    m, n, k = record["mnk"]
    cfg = EnvConfig(m, n, k)
    state = make_env_state(cfg, 1, device)
    print_board(state, m, n)
    for a in record["moves"]:
        player = int(state.current_player[0])
        mark = "X" if player == 0 else "O"
        print(f"{record['players'][player]} ({mark}) plays {a}")
        action = torch.tensor([a], dtype=torch.int64, device=state.boards.device)
        state, rewards, dones = step(cfg, state, action)
        print_board(state, m, n)
        if delay:
            time.sleep(delay)
        if bool(dones[0]):
            if float(rewards[0]) == 1.0:
                print(f"{record['players'][player]} ({mark}) wins!")
            else:
                print("Draw!")
            return


def main(argv=None) -> Optional[Tuple[List[int], Optional[int]]]:
    """Play or replay one game; returns the played game's (move_history,
    winner), None after a replay."""
    parser = argparse.ArgumentParser(description="Play MNK games")
    parser.add_argument("--p1", default="human", help="human | random | model path")
    parser.add_argument("--p2", default="random", help="human | random | model path")
    parser.add_argument("--m", type=int, default=9)
    parser.add_argument("--n", type=int, default=9)
    parser.add_argument("--k", type=int, default=5)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--export", action="store_true", help="save move history")
    parser.add_argument("--import_game", default=None, help="replay a saved game")
    parser.add_argument("--delay", type=float, default=0.5)
    parser.add_argument("--device", "-d", choices=["cuda", "cpu"], default="cuda",
                        help="device to play on (default: cuda)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    if args.import_game:
        replay_game(args.import_game, args.delay, device)
        return None

    cfg = EnvConfig(args.m, args.n, args.k).validate()
    seed = args.seed if args.seed is not None else int(time.time()) % 2**31
    generator = torch.Generator(device=device).manual_seed(seed)
    p1, n1 = load_policy_from_arg(args.p1, (args.m, args.n), device, generator)
    p2, n2 = load_policy_from_arg(args.p2, (args.m, args.n), device, generator)
    history, winner = play_game(cfg, p1, p2, (n1, n2), device)
    if args.export:
        export_game(history, winner, cfg, (n1, n2))
    return history, winner


if __name__ == "__main__":
    main()
