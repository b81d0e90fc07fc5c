"""The port's tournament charts (``compare/visualizer.py``) against the JAX
package's: the HTML page byte for byte from the same ratings (the JAX side
from a pandas frame, the port's from the rating rows), the PNG where
matplotlib imports, the page alone where neither pandas nor matplotlib
does, and ``compare_models`` writing both beside its CSVs."""

import sys

import numpy as np
import pandas as pd
import pytest

from rl_selfplay_mnk_tpu.compare.visualizer import ResultsVisualizer as JaxVisualizer
from rl_selfplay_mnk_tpu_torch import compare_models
from rl_selfplay_mnk_tpu_torch.compare.elo import RATING_COLUMNS
from rl_selfplay_mnk_tpu_torch.compare.visualizer import ResultsVisualizer

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def rating_rows(n_runs, seed=0):
    """Rating rows of ``n_runs`` runs, in no order, with the ELO tracker's
    columns."""
    rng = np.random.default_rng(seed)
    rows = []
    for r in range(n_runs):
        for it in rng.permutation([5, 10, 15, 20, 30])[: 2 + r % 4]:
            games = int(rng.integers(10, 40))
            wins = int(rng.integers(0, games))
            draws = int(rng.integers(0, games - wins + 1))
            rows.append({"unique_id": f"run{r}/model_{it:05d}",
                         "rating": float(np.round(rng.normal(1500, 80), 2)),
                         "run_name": f"run{(7 * r) % n_runs}", "iteration": int(it),
                         "games_played": games, "wins": wins, "draws": draws,
                         "losses": games - wins - draws, "win_rate": wins / games})
    rng.shuffle(rows)
    return rows


@pytest.mark.parametrize("n_runs", [3, 11])
def test_html_equals_the_jax_visualizers(n_runs, tmp_path):
    """The same page for the same ratings; 11 runs reach the folded gray
    series with their dashes."""
    rows = rating_rows(n_runs, seed=n_runs)
    JaxVisualizer(str(tmp_path / "jax")).create_all_visualizations(
        pd.DataFrame(rows, columns=RATING_COLUMNS))
    ResultsVisualizer(str(tmp_path / "port")).create_all_visualizations(rows)
    want = (tmp_path / "jax" / "elo_progression.html").read_text()
    assert (tmp_path / "port" / "elo_progression.html").read_text() == want


def test_png_where_matplotlib_imports_and_the_page_alone_without_it(tmp_path, monkeypatch):
    rows = rating_rows(2)
    ResultsVisualizer(str(tmp_path / "with")).create_all_visualizations(rows)
    assert (tmp_path / "with" / "elo_progression.png").read_bytes()[:8] == PNG_MAGIC
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "pandas", None)
    ResultsVisualizer(str(tmp_path / "without")).create_all_visualizations(rows)
    assert sorted(p.name for p in (tmp_path / "without").iterdir()) == ["elo_progression.html"]
    ResultsVisualizer(str(tmp_path / "empty")).create_all_visualizations([])
    assert list((tmp_path / "empty").iterdir()) == []


def test_compare_models_writes_the_charts_beside_its_csvs(tmp_path, monkeypatch):
    """``compare_models.main`` (its loader and tournament stood in for, the
    ELO tracker real) writes the page the JAX visualizer writes for the
    ratings in its own ``elo_ratings.csv``."""
    class Loader:
        def __init__(self, device):
            pass

        def load_from_paths(self, paths):
            return ["a", "b", "c"]

    class Runner:
        def __init__(self, *args, **kwargs):
            pass

        def run_tournament_batched(self, models, games):
            def match(i, j, w1, w2):
                run = ["r1", "r1", "r2"]
                it = [5, 10, 5]
                return {"player1_unique_id": f"{run[i]}/m{it[i]}",
                        "player2_unique_id": f"{run[j]}/m{it[j]}",
                        "player1_run_name": run[i], "player2_run_name": run[j],
                        "player1_iteration": it[i], "player2_iteration": it[j],
                        "total_games": games, "player1_wins": w1, "player2_wins": w2,
                        "draws": games - w1 - w2, "player1_score": (w1 + (games - w1 - w2) / 2)
                        / games, "player2_score": (w2 + (games - w1 - w2) / 2) / games}
            return [match(0, 1, 3, 5), match(0, 2, 4, 4), match(1, 2, 6, 1)]

    monkeypatch.setattr(compare_models, "ModelLoader", Loader)
    monkeypatch.setattr(compare_models, "MatchRunner", Runner)
    out_dir = compare_models.main(["x", "--games", "8", "--device", "cpu",
                                   "--output", str(tmp_path / "out")])
    ratings = pd.read_csv(f"{out_dir}/elo_ratings.csv")
    JaxVisualizer(str(tmp_path / "jax")).create_all_visualizations(ratings)
    want = (tmp_path / "jax" / "elo_progression.html").read_text()
    with open(f"{out_dir}/elo_progression.html") as f:
        assert f.read() == want
    with open(f"{out_dir}/elo_progression.png", "rb") as f:
        assert f.read(8) == PNG_MAGIC
