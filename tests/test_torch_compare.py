"""The port's serving side against the JAX package's: the two-policy game
loop with deterministic policies injected on both sides, the ELO sweep on
the committed tournament and on random match lists, the loader, the round
robin and its LRU bound, the tournament and play command lines end to end
at 3x3x3, and the parameter accounting of all 19 names. On the CPU."""

import csv
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from rl_selfplay_mnk_tpu import count_params as jax_count_params
from rl_selfplay_mnk_tpu.compare import elo as jax_elo
from rl_selfplay_mnk_tpu.compare.match_runner import play_batch_games as jax_play_batch_games
from rl_selfplay_mnk_tpu.env import EnvConfig as JaxEnvConfig
from rl_selfplay_mnk_tpu.models import create_model_from_architecture as jax_create
from rl_selfplay_mnk_tpu.models import init_network as jax_init
from rl_selfplay_mnk_tpu.models import make_apply_fns as jax_apply_fns
from rl_selfplay_mnk_tpu.selfplay.policies import make_network_policy as jax_network_policy
from rl_selfplay_mnk_tpu_torch import compare_models, count_params, play
from rl_selfplay_mnk_tpu_torch.compare import elo
from rl_selfplay_mnk_tpu_torch.compare.match_runner import GameConfig, MatchRunner, play_batch_games
from rl_selfplay_mnk_tpu_torch.compare.model_loader import ModelInfo, ModelLoader
from rl_selfplay_mnk_tpu_torch.env import EnvConfig
from rl_selfplay_mnk_tpu_torch.models import (
    ARCHITECTURE_REGISTRY,
    create_model_from_architecture,
    eval_apply,
    flax_to_state_dict,
    init_network,
)
from rl_selfplay_mnk_tpu_torch.selfplay.policies import RandomPolicy, make_network_policy
from rl_selfplay_mnk_tpu_torch.utils.model_export import ModelExporter

# One intra-op thread: the tensors here are tiny, and several test processes
# with a thread pool each spend their time waiting on one another.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
MATCHES_CSV = REPO / "evidence" / "full13_tbsw_matches.csv"
ELO_CSV = REPO / "evidence" / "full13_tbsw_elo.csv"
BOARDS = [(3, 3, 3), (5, 5, 4)]


# ---------------------------------------------------------------------------
# play_batch_games: the same deterministic policies on both sides
# ---------------------------------------------------------------------------


def legal_cell_policies(offset):
    """A deterministic policy in both packages' signatures: game e at move t
    takes its ((e + offset * t) mod legal cells)-th legal cell, so the games
    of a batch differ. With offset 0 and e = 0 it is the first legal cell."""

    def jax_act(params, rng, obs, deterministic=False):
        mask = obs["action_mask"]
        stones = obs["observation"].sum((1, 2, 3)).astype(jnp.int32)
        rank = (jnp.arange(mask.shape[0]) + offset * stones) % jnp.maximum(mask.sum(1), 1)
        hit = mask & (jnp.cumsum(mask.astype(jnp.int32), 1) - 1 == rank[:, None])
        return hit.astype(jnp.int32).argmax(1)

    def torch_act(params, obs, generator=None, deterministic=False):
        mask = obs["action_mask"]
        stones = obs["observation"].sum((1, 2, 3)).to(torch.int64)
        rank = (torch.arange(mask.shape[0]) + offset * stones) % mask.sum(1).clamp(min=1)
        hit = mask & (torch.cumsum(mask.to(torch.int64), 1) - 1 == rank[:, None])
        return hit.to(torch.int64).argmax(1)

    return jax_act, torch_act


def first_legal_cell_policies():
    def jax_act(params, rng, obs, deterministic=False):
        return obs["action_mask"].astype(jnp.int32).argmax(1)

    def torch_act(params, obs, generator=None, deterministic=False):
        return obs["action_mask"].to(torch.int32).argmax(1)

    return jax_act, torch_act


def both(cfg, jax_acts, torch_acts, jax_params, torch_params, n_games, side):
    m, n, k = cfg
    want = jax_play_batch_games(JaxEnvConfig(m, n, k), jax_acts[0], jax_acts[1], *jax_params,
                                n_games, side, jax.random.PRNGKey(0))
    got = play_batch_games(EnvConfig(m, n, k), torch_acts[0], torch_acts[1], *torch_params,
                           n_games, side, None, "cpu")
    return tuple(int(x) for x in want), got


@pytest.mark.parametrize("side", [0, 1])
@pytest.mark.parametrize("cfg", BOARDS, ids=lambda c: "x".join(map(str, c)))
def test_play_batch_games_matches_jax_with_scripted_policies(cfg, side):
    n_games = 24
    first_j, first_t = first_legal_cell_policies()
    want, got = both(cfg, (first_j, first_j), (first_t, first_t), (None, None), (None, None),
                     n_games, side)
    assert got == want and sum(got) == n_games
    # First legal cell against itself: every game is the same game.
    assert max(got) == n_games and got[2] == 0

    (a_j, a_t), (b_j, b_t) = legal_cell_policies(3), legal_cell_policies(5)
    want, got = both(cfg, (a_j, b_j), (a_t, b_t), (None, None), (None, None), n_games, side)
    assert got == want and sum(got) == n_games
    assert sum(x > 0 for x in got) >= 2  # the games of the batch do differ


@pytest.mark.parametrize("cfg", BOARDS, ids=lambda c: "x".join(map(str, c)))
def test_play_batch_games_matches_jax_with_argmax_networks(cfg):
    """Two networks on converted weights, each taking its best legal move."""
    m, n, k = cfg
    module, _ = jax_create("mlp_tiny", (2, m, n), m * n)
    jax_eval, _ = jax_apply_fns(module)
    lifted_j, lifted_t = jax_network_policy(jax_eval), make_network_policy(eval_apply)

    def jax_act(params, rng, obs, deterministic=False):
        return lifted_j(params, rng, obs, True)

    def torch_act(params, obs, generator=None, deterministic=False):
        return lifted_t(params, obs, generator, True)

    jax_params, torch_params = [], []
    for seed in (1, 2):
        variables = jax_init(module, (2, m, n), jax.random.PRNGKey(seed))
        rng = np.random.default_rng(seed)
        variables = jax.tree.map(
            lambda x: (np.asarray(x) + 0.3 * rng.normal(size=x.shape)).astype(np.float32), variables)
        model, _ = create_model_from_architecture("mlp_tiny", (2, m, n), m * n)
        model.load_state_dict(flax_to_state_dict(variables))
        jax_params.append(variables)
        torch_params.append(model)
    for side in (0, 1):
        want, got = both(cfg, (jax_act, jax_act), (torch_act, torch_act), jax_params, torch_params,
                         6, side)
        assert got == want and sum(got) == 6 and max(got) == 6  # one game, six times


def test_play_batch_games_random_policies_and_sides():
    cfg = EnvConfig(3, 3, 3)
    act = RandomPolicy().apply
    as_black = play_batch_games(cfg, act, act, None, None, 256, 0,
                                torch.Generator().manual_seed(1), "cpu")
    as_white = play_batch_games(cfg, act, act, None, None, 256, 1,
                                torch.Generator().manual_seed(1), "cpu")
    assert sum(as_black) == 256 and sum(as_white) == 256
    # The first mover's advantage on 3x3, from either seat.
    assert as_black[0] > as_black[1] and as_white[1] > as_white[0]


# ---------------------------------------------------------------------------
# ELO
# ---------------------------------------------------------------------------


def read_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def typed_matches(rows):
    ints = ("player1_iteration", "player2_iteration", "total_games", "player1_wins",
            "player2_wins", "draws")
    floats = ("player1_score", "player2_score")
    return [{**row, **{k: int(row[k]) for k in ints}, **{k: float(row[k]) for k in floats}}
            for row in rows]


def random_matches(n_matches, n_players, seed, self_rows=0):
    rng = np.random.default_rng(seed)
    p1 = rng.integers(0, n_players, n_matches)
    p2 = (p1 + 1 + rng.integers(0, n_players - 1, n_matches)) % n_players
    p2[:self_rows] = p1[:self_rows]
    w1 = rng.integers(0, 11, n_matches)
    d = rng.integers(0, 11 - w1)
    w2 = 10 - w1 - d
    s2 = (w2 + 0.5 * d) / 10
    s2[:self_rows] = 0.9  # asymmetric, so that both updates of a self-match show
    return [{
        "player1_unique_id": f"P{a}", "player2_unique_id": f"P{b}",
        "player1_run_name": f"run{a % 3}", "player2_run_name": f"run{b % 3}",
        "player1_iteration": int(a), "player2_iteration": int(b), "total_games": 10,
        "player1_wins": int(x), "player2_wins": int(y), "draws": int(z),
        "player1_score": float((x + 0.5 * z) / 10), "player2_score": float(s),
    } for a, b, x, y, z, s in zip(p1, p2, w1, w2, d, s2)]


@pytest.fixture(params=["native", "wavefront"])
def jax_elo_path(request, monkeypatch):
    """The JAX package's tracker through its C sweep and through numpy."""
    if request.param == "wavefront":
        monkeypatch.setattr(jax_elo, "_native_tried", True)
        monkeypatch.setattr(jax_elo, "_native_lib", None)
    elif jax_elo._load_native() is None:
        pytest.skip("no C compiler available")
    return request.param


def assert_ratings_equal(rows, frame):
    assert list(frame.columns) == list(elo.RATING_COLUMNS)
    want = frame.set_index("unique_id")
    assert sorted(row["unique_id"] for row in rows) == sorted(want.index)
    assert [row["rating"] for row in rows] == sorted((row["rating"] for row in rows), reverse=True)
    for row in rows:
        assert list(row) == list(elo.RATING_COLUMNS)
        for key, value in row.items():
            if key != "unique_id":
                assert value == want.loc[row["unique_id"], key], (row["unique_id"], key)


def test_elo_equals_jax_on_the_committed_tournament(jax_elo_path):
    matches = typed_matches(read_rows(MATCHES_CSV))
    rows = elo.ELOTracker().calculate_ratings(matches)
    assert_ratings_equal(rows, jax_elo.ELOTracker().calculate_ratings(pd.DataFrame(matches)))
    # And the committed ratings of that tournament, to the last digit written.
    committed = read_rows(ELO_CSV)
    assert [row["unique_id"] for row in rows] == [row["unique_id"] for row in committed]
    for row, want in zip(rows, committed):
        assert row["rating"] == float(want["rating"]) and row["win_rate"] == float(want["win_rate"])
        assert (row["games_played"], row["wins"], row["losses"]) == (
            int(want["games_played"]), int(want["wins"]), int(want["losses"]))


@pytest.mark.parametrize("n_matches,n_players,seed,self_rows",
                         [(300, 17, 3, 0), (60, 8, 5, 6), (40, 6, 0, 0)])
def test_elo_sweep_equals_jax_as_float64(jax_elo_path, n_matches, n_players, seed, self_rows):
    """The unrounded float64 ratings of the sweep, bit for bit those of the
    JAX package's numpy sweep, and the tracker's rows from either of its
    sweeps, on random match lists with self-matches among them."""
    matches = random_matches(n_matches, n_players, seed, self_rows)
    codes = {p: i for i, p in enumerate(dict.fromkeys(
        [r["player1_unique_id"] for r in matches] + [r["player2_unique_id"] for r in matches]))}
    p1 = np.array([codes[r["player1_unique_id"]] for r in matches], np.int64)
    p2 = np.array([codes[r["player2_unique_id"]] for r in matches], np.int64)
    s1 = np.array([r["player1_score"] for r in matches], np.float64)
    s2 = np.array([r["player2_score"] for r in matches], np.float64)
    got = elo._sweep_to_convergence(p1, p2, s1, s2, len(codes), 1500.0, 32.0)
    want = jax_elo._sweep_to_convergence(p1, p2, s1, s2, len(codes), 1500.0, 32.0)
    assert got.dtype == np.float64
    if jax_elo_path == "wavefront":
        assert np.array_equal(got, want)
    else:  # the C sweep's own last bits move with its compiler; the rounded ratings are the same
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert_ratings_equal(elo.ELOTracker().calculate_ratings(matches),
                         jax_elo.ELOTracker().calculate_ratings(pd.DataFrame(matches)))


def test_wavefront_schedule_equals_jax_and_tracker_edges():
    rng = np.random.default_rng(2)
    p1 = rng.integers(0, 9, 200)
    p2 = (p1 + 1 + rng.integers(0, 8, 200)) % 9
    for got, want in zip(elo.wavefront_schedule(p1, p2, 9), jax_elo.wavefront_schedule(p1, p2, 9)):
        np.testing.assert_array_equal(got, want)
    assert elo.ELOTracker().calculate_ratings([]) == []
    order, bounds = elo.wavefront_schedule(np.zeros(0, np.int64), np.zeros(0, np.int64), 3)
    assert len(order) == 0 and list(bounds) == [0]


# ---------------------------------------------------------------------------
# loader, round robin, command lines
# ---------------------------------------------------------------------------


@pytest.fixture
def exported_models(tmp_path):
    """Two runs of 3x3 exports written by the port: a CNN (BatchNorm to
    fold), and a transformer (attention through the dispatch) with an MLP."""
    paths = []
    for run, entries in [("runA", (("cnn_b_s", 0), ("cnn_b_s", 1))),
                         ("runB", (("transformer_b_s", 2), ("mlp_tiny", 3)))]:
        exporter = ModelExporter(run, base_dir=str(tmp_path / "models"))
        for iteration, (name, seed) in enumerate(entries):
            model, arch_params = create_model_from_architecture(name, (2, 3, 3), 9)
            init_network(model, torch.Generator().manual_seed(seed))
            exporter.export_model(model, name, arch_params, iteration)
        paths.append(str(tmp_path / "models" / run))
    return paths


def test_loader_takes_directories_files_and_globs(exported_models, tmp_path):
    run_a, run_b = exported_models
    models = ModelLoader("cpu").load_from_paths(exported_models)
    assert [m.unique_id for m in models] == ["runA/model_00000", "runA/model_00001",
                                             "runB/model_00000", "runB/model_00001"]
    assert [m.architecture_name for m in models] == ["cnn_b_s", "cnn_b_s", "transformer_b_s",
                                                    "mlp_tiny"]
    # A file, a glob, and the directory again: duplicates are dropped.
    mixed = ModelLoader("cpu").load_from_paths(
        [os.path.join(run_a, "model_00001.msgpack"), str(tmp_path / "models" / "run*"), run_b])
    assert sorted(m.unique_id for m in mixed) == [m.unique_id for m in models]
    with open(os.path.join(run_a, "config.json"), "w") as f:
        json.dump({"lr": 3e-4}, f)
    assert len(ModelLoader("cpu").load_from_paths([run_a])) == 2
    assert ModelLoader("cpu").load_from_paths([str(tmp_path / "nowhere")]) == []

    info = models[0]
    assert info._loaded is None and info.metadata is None
    frozen, act = info.load_model()
    assert info.load_model()[0] is frozen  # cached until unloaded
    assert frozen.folded and frozen.dtype == torch.float32 and info.metadata.iteration == 0
    assert not any(p.requires_grad for p in frozen.parameters())
    assert act is make_network_policy(eval_apply)
    info.unload_model(hard=True)
    assert info._loaded is None


def test_tournament_rows_and_lru_bound(exported_models, monkeypatch):
    models = ModelLoader("cpu").load_from_paths(exported_models)
    peak = {"n": 0}
    original = ModelInfo.load_model

    def counting_load(self):
        out = original(self)
        peak["n"] = max(peak["n"], sum(1 for m in models if m._loaded is not None))
        return out

    monkeypatch.setattr(ModelInfo, "load_model", counting_load)
    runner = MatchRunner(GameConfig(3, 3, 3), seed=0, device="cpu")
    results = runner.run_tournament_batched(models, games_per_pair=6, batch_size=2)
    assert len(results) == 6 and peak["n"] <= 2
    assert all(m._loaded is None for m in models)
    for row in results:
        assert list(row) == list(compare_models.MATCH_COLUMNS)
        assert row["total_games"] == 6
        assert row["player1_wins"] + row["player2_wins"] + row["draws"] == 6
        assert row["player1_score"] + row["player2_score"] == 1.0
    assert [(r["player1_unique_id"], r["player2_unique_id"]) for r in results[:3]] == [
        ("runA/model_00000", other) for other in
        ("runA/model_00001", "runB/model_00000", "runB/model_00001")]
    ratings = elo.ELOTracker().calculate_ratings(results)
    assert len(ratings) == 4 and sum(r["games_played"] for r in ratings) == 6 * 6 * 2
    # The same seed plays the same tournament.
    again = MatchRunner(GameConfig(3, 3, 3), seed=0, device="cpu").run_tournament_batched(models, 6)
    assert again == results
    assert MatchRunner(GameConfig(3, 3, 3), device="cpu").run_tournament_batched(models[:1], 6) == []


def test_compare_models_cli_writes_the_jax_package_s_csvs(exported_models, tmp_path, capsys):
    out_dir = compare_models.main([*exported_models, "--games", "4", "--board", "3", "3", "3",
                                   "--device", "cpu", "--output", str(tmp_path / "results")])
    assert os.path.dirname(out_dir) == str(tmp_path / "results")
    # The CSVs and, since the charts are ported, the ELO page and (where
    # matplotlib imports, as here) its PNG.
    assert sorted(os.listdir(out_dir)) == ["elo_progression.html", "elo_progression.png",
                                           "elo_ratings.csv", "match_results.csv"]
    matches, ratings = read_rows(f"{out_dir}/match_results.csv"), read_rows(f"{out_dir}/elo_ratings.csv")
    assert list(matches[0]) == list(read_rows(MATCHES_CSV)[0])
    assert list(ratings[0]) == list(read_rows(ELO_CSV)[0])
    assert len(matches) == 6 and len(ratings) == 4
    for row in matches:
        assert int(row["player1_wins"]) + int(row["player2_wins"]) + int(row["draws"]) == 4
    # The files hold what the tracker makes of the matches, best first.
    want = elo.ELOTracker().calculate_ratings(typed_matches(matches))
    assert [(r["unique_id"], float(r["rating"])) for r in ratings] == [
        (r["unique_id"], r["rating"]) for r in want]
    # pandas reads them back as the JAX package's own files.
    frame = pd.read_csv(f"{out_dir}/match_results.csv")
    assert_ratings_equal(want, jax_elo.ELOTracker().calculate_ratings(frame))
    out = capsys.readouterr().out
    assert "Loaded 4 models" in out and "[6/6]" in out and "Results saved to" in out
    assert compare_models.main([exported_models[0] + "/model_00000.msgpack", "--device", "cpu",
                                "--output", str(tmp_path / "none")]) is None
    assert not (tmp_path / "none").exists()


def test_play_cli_random_game_export_and_replay(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    history, winner = play.main(["--p1", "random", "--p2", "random", "--m", "3", "--n", "3",
                                 "--k", "3", "--seed", "0", "--export", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "plays" in out and ("wins!" in out or "Draw!" in out)
    games = [f for f in os.listdir(tmp_path) if f.startswith("game_")]
    assert len(games) == 1
    record = json.loads((tmp_path / games[0]).read_text())
    assert record == {"mnk": [3, 3, 3], "players": ["random", "random"], "moves": history,
                      "winner": winner}
    assert 5 <= len(history) <= 9 and len(set(history)) == len(history)
    again = play.main(["--p1", "random", "--p2", "random", "--m", "3", "--n", "3", "--k", "3",
                       "--seed", "0", "--device", "cpu"])
    assert again == (history, winner)  # the seed fixes the game
    capsys.readouterr()
    assert play.main(["--import_game", str(tmp_path / games[0]), "--delay", "0",
                      "--device", "cpu"]) is None
    replay = capsys.readouterr().out
    assert replay.count("plays") == len(history)
    assert ("wins!" in replay) == (winner is not None)


def test_play_cli_model_human_and_board_mismatch(exported_models, monkeypatch, capsys):
    run_a = exported_models[0]
    history, winner = play.main(["--p1", run_a, "--p2", "random", "--m", "3", "--n", "3", "--k", "3",
                                 "--seed", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "runA/model_00001 (X) plays" in out  # the directory's latest export
    assert winner in (0, 1, None) and 5 <= len(history) <= 9
    policy, name = play.load_policy_from_arg(os.path.join(run_a, "model_00000.msgpack"), (3, 3), "cpu")
    assert name == "runA/model_00000" and policy.params.folded
    with pytest.raises(ValueError, match="trained for a 3x3 board"):
        play.load_policy_from_arg(run_a, (5, 5), "cpu")
    with pytest.raises(FileNotFoundError, match="No exported models"):
        play.load_policy_from_arg(os.path.dirname(run_a), (3, 3), "cpu")

    # A human who first types nonsense, then an occupied cell, then legal moves.
    typed = iter(["x", "99", "4", "4", "0", "1", "2", "3", "5", "6", "7", "8"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(typed))
    history, winner = play.main(["--p1", "human", "--p2", "human", "--m", "3", "--n", "3",
                                 "--k", "3", "--seed", "2", "--device", "cpu"])
    assert history == [4, 0, 1, 2, 3, 5, 6, 7, 8] and winner is None  # a draw
    out = capsys.readouterr().out
    assert "Enter a number." in out and "Illegal move" in out


# ---------------------------------------------------------------------------
# parameter accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(ARCHITECTURE_REGISTRY))
def test_count_params_equals_jax(name):
    """The same paths with the same counts, for every registry name."""
    m, n = (13, 13) if name.endswith("_w") else (9, 9)
    assert count_params.param_counts(name, m, n) == jax_count_params.param_counts(name, m, n)


def test_count_params_cli(capsys):
    count_params.main(["--arch", "resnet_b_s", "--m", "9", "--n", "9"])
    out = capsys.readouterr().out
    assert "resnet_b_s @ 9x9: 118,203 parameters" in out and "ActorCriticHeads_0" in out
    count_params.main(["--all", "--m", "3", "--n", "3"])
    out = capsys.readouterr().out
    assert all(name in out for name in ARCHITECTURE_REGISTRY)
