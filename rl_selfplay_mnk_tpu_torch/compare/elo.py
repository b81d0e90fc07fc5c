"""Convergent batch ELO over tournament results (counterpart of the JAX
package's ``compare/elo.py``), in float64 on the host.

K = 32, initial rating 1500; the match list is replayed, Gauss-Seidel style,
for at most 50 passes until the mean absolute per-update rating change drops
below 0.1; then per-player W/D/L and win_rate are aggregated.

The sweep is computed by wavefront scheduling: the match list is cut into an
ordered sequence of waves such that no player appears twice inside a wave and
every earlier match of either player lands in a strictly earlier wave. Within
a wave the sequential sweep's reads all see the ratings as of the end of the
previous wave and its writes touch disjoint players, so one numpy update per
wave reproduces the sequential float64 arithmetic exactly (same values, same
per-player operation order).

Match results come in and ratings go out as lists of dicts (one per match,
one per player), with the JAX package's column names.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

_ELO_SCALE = 400.0
RATING_COLUMNS = ("unique_id", "rating", "run_name", "iteration", "games_played", "wins",
                  "draws", "losses", "win_rate")


def wavefront_schedule(p1: np.ndarray, p2: np.ndarray, n_players: int):
    """Assign each match the earliest wave respecting player dependencies.

    Match i goes to wave 1 + max(wave of the previous match of p1[i], wave of
    the previous match of p2[i]). Returns (order, bounds): ``order`` permutes
    match indices wave by wave (stable within a wave) and
    ``bounds[w]:bounds[w+1]`` slices wave w.
    """
    n = p1.shape[0]
    next_free = np.zeros(n_players, dtype=np.int64)
    wave = np.empty(n, dtype=np.int64)
    for i in range(n):
        a, b = p1[i], p2[i]
        w = max(next_free[a], next_free[b])
        wave[i] = w
        next_free[a] = w + 1
        next_free[b] = w + 1
    order = np.argsort(wave, kind="stable")
    n_waves = int(wave.max()) + 1 if n else 0
    bounds = np.zeros(n_waves + 1, dtype=np.int64)
    np.add.at(bounds, wave + 1, 1)
    np.cumsum(bounds, out=bounds)
    return order, bounds


def _sweep_to_convergence(
    p1: np.ndarray,
    p2: np.ndarray,
    s1: np.ndarray,
    s2: np.ndarray,
    n_players: int,
    initial: float,
    k: float,
    max_passes: int = 50,
    tol: float = 0.1,
) -> np.ndarray:
    """Run the convergent rating sweep; returns final per-player ratings."""
    order, bounds = wavefront_schedule(p1, p2, n_players)
    waves = []
    for w in range(len(bounds) - 1):
        sel = order[bounds[w]:bounds[w + 1]]
        waves.append((sel, p1[sel], p2[sel], s1[sel], s2[sel]))

    n = p1.shape[0]
    ratings = np.full(n_players, initial, dtype=np.float64)
    denom = 2.0 * max(1, n)
    contrib = np.zeros(n, dtype=np.float64)
    for _ in range(max_passes):
        for sel, a, b, sa, sb in waves:
            ra = ratings[a]
            rb = ratings[b]
            expected_a = 1.0 / (1.0 + np.power(10.0, (rb - ra) / _ELO_SCALE))
            da = k * (sa - expected_a)
            db = k * (sb - (1.0 - expected_a))
            new_a = ra + da
            new_b = rb + db
            self_rows = a == b
            if self_rows.any():
                # A self-match gets BOTH updates on its single entry,
                # (r + da) + db; a plain fancy-index write would drop da.
                new_b = np.where(self_rows, new_a + db, new_b)
            ratings[a] = new_a
            ratings[b] = new_b
            contrib[sel] = np.abs(da) + np.abs(db)
        # The sequential sweep adds the changes in match order, left to
        # right; numpy's pairwise sum would differ by ULPs and can flip a
        # pass count at the tolerance.
        total_change = 0.0
        for t in contrib.tolist():
            total_change += t
        if total_change / denom < tol:
            break
    return ratings


class ELOTracker:
    """``calculate_ratings(match_rows) -> rating_rows``, best first."""

    def __init__(self, initial_rating: float = 1500.0, k_factor: float = 32.0):
        self.initial_rating = float(initial_rating)
        self.k_factor = float(k_factor)

    def calculate_ratings(self, match_results: List[Dict]) -> List[Dict]:
        if not match_results:
            return []

        def column(name: str, dtype=None) -> np.ndarray:
            return np.array([row[name] for row in match_results], dtype=dtype)

        n_matches = len(match_results)
        ids = list(column("player1_unique_id")) + list(column("player2_unique_id"))
        players = list(dict.fromkeys(ids))  # in order of first appearance
        code = {player: i for i, player in enumerate(players)}
        n_players = len(players)
        p1 = np.array([code[x] for x in ids[:n_matches]], dtype=np.int64)
        p2 = np.array([code[x] for x in ids[n_matches:]], dtype=np.int64)

        ratings = _sweep_to_convergence(
            p1, p2, column("player1_score", np.float64), column("player2_score", np.float64),
            n_players, self.initial_rating, self.k_factor,
        )

        def count(col_as_p1: str, col_as_p2: str) -> np.ndarray:
            return (np.bincount(p1, column(col_as_p1, np.float64), n_players)
                    + np.bincount(p2, column(col_as_p2, np.float64), n_players))

        games = count("total_games", "total_games")
        wins = count("player1_wins", "player2_wins")
        draws = count("draws", "draws")
        losses = count("player2_wins", "player1_wins")

        # A player's run metadata comes from its first appearance, the p1
        # seat preferred.
        positions = np.arange(n_matches, dtype=np.int64)
        first_p1 = np.full(n_players, n_matches, dtype=np.int64)
        first_p2 = np.full(n_players, n_matches, dtype=np.int64)
        np.minimum.at(first_p1, p1, positions)
        np.minimum.at(first_p2, p2, positions)

        rounded = np.round(ratings, 2)
        rows = []
        for i, player in enumerate(players):
            seat, at = (1, first_p1[i]) if first_p1[i] < n_matches else (2, first_p2[i])
            source = match_results[int(at)]
            rows.append({
                "unique_id": player,
                "rating": float(rounded[i]),
                "run_name": source[f"player{seat}_run_name"],
                "iteration": source[f"player{seat}_iteration"],
                "games_played": int(games[i]),
                "wins": int(wins[i]),
                "draws": int(draws[i]),
                "losses": int(losses[i]),
                "win_rate": float(wins[i] / max(games[i], 1)) if games[i] > 0 else 0.0,
            })
        rows.sort(key=lambda row: -row["rating"])
        return rows
