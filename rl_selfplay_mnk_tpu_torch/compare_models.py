"""Tournament CLI: round-robin + ELO + CSVs + charts (counterpart of the JAX
package's ``compare_models.py``).

Positional model paths (files, directories or globs), ``--games``, ``--board
M N K``, ``--output``, ``--device {cuda,cpu}`` (default the card; it raises
without one); writes ``elo_ratings.csv`` and ``match_results.csv`` under a
timestamped directory, with the JAX package's columns, and the ELO charts
(``compare/visualizer.py``: the HTML page, and the PNG where matplotlib
imports).

Usage:
    python -m rl_selfplay_mnk_tpu_torch.compare_models models/runA models/runB \\
        --games 64 --board 9 9 5
"""

from __future__ import annotations

import argparse
import csv
import os
from datetime import datetime
from typing import Dict, List, Optional, Sequence

from .compare.elo import RATING_COLUMNS, ELOTracker
from .compare.match_runner import GameConfig, MatchRunner
from .compare.model_loader import ModelLoader
from .compare.visualizer import ResultsVisualizer
from .utils.hardware import resolve_device

MATCH_COLUMNS = (
    "player1_unique_id", "player2_unique_id", "player1_run_name", "player2_run_name",
    "player1_iteration", "player2_iteration", "total_games", "player1_wins", "player2_wins",
    "draws", "player1_score", "player2_score",
)


def write_csv(path: str, columns: Sequence[str], rows: List[Dict]) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(columns), lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)


def main(argv=None) -> Optional[str]:
    """Run the tournament; returns the directory the results were saved to
    (None when there were fewer than two models)."""
    parser = argparse.ArgumentParser(description="Compare trained MNK models")
    parser.add_argument("paths", nargs="+", help="model files, directories, or globs")
    parser.add_argument("--games", "-g", type=int, default=50,
                        help="games per pairing (default: 50)")
    parser.add_argument("--board", "-b", type=int, nargs=3, default=[9, 9, 5],
                        metavar=("M", "N", "K"),
                        help="board dimensions M x N and win condition K (default: 9 9 5)")
    parser.add_argument("--device", "-d", choices=["cuda", "cpu"], default="cuda",
                        help="device to run matches on (default: cuda)")
    parser.add_argument("--output", "-o", default="comparison_results",
                        help="output directory for results (default: comparison_results)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    models = ModelLoader(device).load_from_paths(args.paths)
    print(f"Loaded {len(models)} models")
    if len(models) < 2:
        print("Need at least 2 models to compare")
        return None

    m, n, k = args.board
    runner = MatchRunner(GameConfig(m=m, n=n, k=k), seed=args.seed, device=device)
    results = runner.run_tournament_batched(models, args.games)
    ratings = ELOTracker().calculate_ratings(results)

    out_dir = os.path.join(args.output, datetime.now().strftime("%Y%m%d_%H%M%S"))
    os.makedirs(out_dir, exist_ok=True)
    write_csv(os.path.join(out_dir, "elo_ratings.csv"), RATING_COLUMNS, ratings)
    write_csv(os.path.join(out_dir, "match_results.csv"), MATCH_COLUMNS, results)
    print(f"Results saved to {out_dir}")
    width = max(len(row["unique_id"]) for row in ratings)
    print(f"{'unique_id':<{width}}  rating  games  wins  draws  losses  win_rate")
    for row in ratings:
        print(f"{row['unique_id']:<{width}} {row['rating']:7.2f} {row['games_played']:6d} "
              f"{row['wins']:5d} {row['draws']:6d} {row['losses']:7d} {row['win_rate']:9.4f}")
    ResultsVisualizer(out_dir).create_all_visualizations(ratings)
    return out_dir


if __name__ == "__main__":
    main()
