"""The port's league against the JAX package's ``selfplay/league.py``: the
PFSP weights, the roster's FIFO and result tracking, the hard mode's
preference, the same draws and score averages from the same seeds, and the
trainer's league runs with per-block attribution (the JAX package's
``tests/test_league.py``)."""

import json

import pytest
import torch

from rl_selfplay_mnk_tpu.selfplay import league as jleague
from rl_selfplay_mnk_tpu_torch.selfplay.league import MATCHMAKING_MODES, League, pfsp_weight
from rl_selfplay_mnk_tpu_torch.train import get_default_config, train_mnk
from rl_selfplay_mnk_tpu_torch.utils.metrics import MetricsLogger

# One intra-op thread: the tensors here are tiny, and several test processes
# with a thread pool each spend their time waiting on one another.
torch.set_num_threads(1)


def test_pfsp_weights_equal_jax():
    assert MATCHMAKING_MODES == jleague.MATCHMAKING_MODES
    for mode in MATCHMAKING_MODES:
        for power in (1.0, 2.0, 3.0):
            for score in (-0.5, 0.0, 0.1, 0.25, 0.5, 0.73, 0.9, 1.0, 1.5):
                assert pfsp_weight(score, mode, power) == jleague.pfsp_weight(score, mode, power)
    hard = [pfsp_weight(s, "pfsp_hard") for s in (0.0, 0.25, 0.5, 0.75, 1.0)]
    assert hard == sorted(hard, reverse=True) and hard[0] == pytest.approx(1.0)
    assert pfsp_weight(0.5, "pfsp_even") == pytest.approx(1.0)
    assert pfsp_weight(1.0, "pfsp_even") == pytest.approx(1e-3)
    with pytest.raises(ValueError):
        pfsp_weight(0.5, "nope")
    with pytest.raises(ValueError):
        League(mode="nope")


def test_league_fifo_and_result_tracking():
    league = League(max_size=2, mode="pfsp_hard", seed=0)
    a = league.add_opponent("A")
    b = league.add_opponent("B")
    assert league.size() == 2
    c = league.add_opponent("C")  # evicts A
    assert [e.params for e in league.entries] == ["B", "C"]
    league.record_result(b, 1.0)
    league.record_result(a, 0.0)  # evicted: ignored
    league.record_result(b, float("nan"))  # not finite: ignored
    entry_b = next(e for e in league.entries if e.entry_id == b)
    assert entry_b.games == 1 and entry_b.score_ema > 0.5
    league.record_result(c, 0.0)
    assert next(e for e in league.entries if e.entry_id == c).score_ema < 0.5


def test_pfsp_hard_prefers_unbeaten_members():
    league = League(max_size=3, mode="pfsp_hard", power=2.0, ema=1.0, seed=1)
    beaten = league.add_opponent("beaten")
    nemesis = league.add_opponent("nemesis")
    league.record_result(beaten, 1.0)
    league.record_result(nemesis, 0.0)
    draws = [league.get_opponent()[1] for _ in range(300)]
    assert draws.count("nemesis") > 250


@pytest.mark.parametrize("mode", MATCHMAKING_MODES)
def test_league_draws_and_score_averages_equal_jax(mode):
    """The same seed, members, results and draws: the same members drawn,
    the same ids, and the same averages and game counts, exactly."""
    ours, theirs = League(max_size=4, mode=mode, seed=7), jleague.League(max_size=4, mode=mode, seed=7)
    drawn = ([], [])
    for step in range(60):
        if step % 7 == 0:
            assert ours.add_opponent(f"m{step}") == theirs.add_opponent(f"m{step}")
        for league, out in zip((ours, theirs), drawn):
            entry_id, params = league.get_opponent()
            out.append((entry_id, params))
            league.record_result(entry_id, ((step * 37) % 11) / 10.0)
        assert ours.get_random_opponent() == theirs.get_random_opponent()
    assert drawn[0] == drawn[1]
    assert [(e.entry_id, e.params, e.score_ema, e.games) for e in ours.entries] == \
           [(e.entry_id, e.params, e.score_ema, e.games) for e in theirs.entries]
    assert ours.weights() == theirs.weights()


def league_config(tmp_path, **kw):
    config = get_default_config()
    config.update(mnk=(3, 3, 3), num_envs=16, n_steps=8, batch_size=32, ppo_epochs=1,
                  total_environment_steps=16 * 8 * 30, validation_interval=100, lr_warmup_steps=0,
                  architecture_name="cnn_b_s", opponent_pool=3, entropy_coef_schedule=None,
                  matchmaking="pfsp_even", opponents_per_iteration=2, seed=0,
                  export_dir=str(tmp_path / "models"))
    config.update(kw)
    return config


def test_train_mnk_league_per_block_attribution(tmp_path, monkeypatch):
    """Two opponent blocks an iteration: each drawn member is scored on its
    own block's episodes, so distinct blocks record distinct scores, never
    one aggregate folded into every member; blocks of the current network
    record nothing (the JAX package's test, same config)."""
    calls = []
    original = League.record_result

    def spy(self, entry_id, score):
        calls.append((entry_id, score))
        return original(self, entry_id, score)

    monkeypatch.setattr(League, "record_result", spy)
    config = league_config(tmp_path)
    with MetricsLogger(run_name="lgblk", config=config, out_dir=str(tmp_path / "runs")) as logger:
        summary = train_mnk(config, logger, device="cpu")
    assert summary["errors"] == []
    historical = sum(s.split(",").count("historical") for s in summary["opponent_sources"])
    assert calls and len(calls) <= historical
    assert all(0.0 <= score <= 1.0 for _, score in calls)
    assert len({round(score, 9) for _, score in calls}) > 1


def test_train_mnk_league_micro_with_resume(tmp_path, monkeypatch):
    """A league run with checkpoints, then resumed to two more iterations
    (the JAX package's ``test_train_mnk_league_micro``): no errors, and the
    resumed stream starts past the checkpoint."""
    monkeypatch.chdir(tmp_path)
    config = league_config(tmp_path, num_envs=8, total_environment_steps=8 * 8 * 5,
                           opponent_pool=2, opponents_per_iteration=1, checkpoint_interval=2,
                           checkpoint_dir=str(tmp_path / "ckpt"))
    with MetricsLogger(run_name="lg1", config=config, out_dir=str(tmp_path / "runs")) as logger:
        assert train_mnk(config, logger, device="cpu")["errors"] == []
    config.update(resume=True, total_environment_steps=8 * 8 * 7)
    with MetricsLogger(run_name="lg2", config=config, out_dir=str(tmp_path / "runs")) as logger:
        summary = train_mnk(config, logger, device="cpu")
    assert summary["errors"] == [] and summary["start_iteration"] == 5
    lines = [json.loads(line) for line in open(tmp_path / "runs" / "lg2.jsonl")]
    assert not any(k.startswith("error/") for rec in lines for k in rec)
    steps = [r["_step"] for r in lines if "training/mean_reward" in r]
    assert steps == [8 * 8 * 6, 8 * 8 * 7]
