"""Checkpoint and resume in the port: the checkpoint files, a run cut at a
checkpoint and resumed against the same run uninterrupted (bitwise, with
the opponent pool and with the league), the resumed metrics stream with
each step once, and the JAX package's committed 13x13 train-state
checkpoint read through the converter into the port's forward."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_selfplay_mnk_tpu.models import create_model_from_architecture as jax_create
from rl_selfplay_mnk_tpu.models.registry import make_apply_fns
from rl_selfplay_mnk_tpu.utils.checkpoint import restore_checkpoint_portable
from rl_selfplay_mnk_tpu_torch.models import create_model_from_architecture, eval_apply, flax_to_state_dict
from rl_selfplay_mnk_tpu_torch.train import get_default_config, train_mnk
from rl_selfplay_mnk_tpu_torch.utils.checkpoint import (
    latest_checkpoint_step,
    restore_checkpoint,
    save_checkpoint,
)
from rl_selfplay_mnk_tpu_torch.utils.metrics import MetricsLogger

# One intra-op thread: the tensors here are tiny, and several test processes
# with a thread pool each spend their time waiting on one another.
torch.set_num_threads(1)

FULL13 = os.path.join(os.path.dirname(__file__), "..", "evidence", "ckpt_full13_transformer_b_s_w")


def test_checkpoint_files_keep_the_newest_three(tmp_path):
    d = str(tmp_path / "ckpt")
    assert restore_checkpoint(d) == (None, None) and latest_checkpoint_step(d) is None
    gen = torch.Generator().manual_seed(5)
    for step in (2, 4, 6, 8, 10):
        save_checkpoint(d, step, {"w": torch.full((3,), float(step)), "rng": gen.get_state(),
                                  "nested": [{"a": None, "b": (1, 2.5, "x")}], "step": step})
    assert sorted(os.listdir(d)) == ["step_10.pt", "step_6.pt", "step_8.pt"]
    state, step = restore_checkpoint(d)
    assert step == 10 and state["step"] == 10 and torch.equal(state["w"], torch.full((3,), 10.0))
    assert state["nested"] == [{"a": None, "b": (1, 2.5, "x")}]
    assert torch.equal(torch.Generator().set_state(state["rng"]).get_state(), gen.get_state())
    assert restore_checkpoint(d, 6)[0]["step"] == 6


def base_config(tmp_path, iterations, league):
    config = get_default_config()
    config.update(mnk=(3, 3, 3), num_envs=8, n_steps=8, batch_size=32, ppo_epochs=1,
                  total_environment_steps=8 * 8 * iterations, validation_interval=3,
                  validation_episodes=8, lr_warmup_steps=0, architecture_name="cnn_b_s",
                  opponent_pool=2, checkpoint_interval=2, entropy_coef_schedule=None, seed=3,
                  export_dir=str(tmp_path / "models"))
    if league:
        config.update(matchmaking="pfsp_even", opponents_per_iteration=2)
    return config


def run(tmp_path, name, iterations, league, resume=False, ckpt="ckpt"):
    config = base_config(tmp_path, iterations, league)
    config.update(checkpoint_dir=str(tmp_path / ckpt), resume=resume)
    with MetricsLogger(run_name=name, config=config, out_dir=str(tmp_path / "runs")) as logger:
        summary = train_mnk(config, logger, device="cpu")
    assert summary["errors"] == []
    return summary


def assert_same(a, b, where="state"):
    """Equal nests, tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for key in a:
            assert_same(a[key], b[key], f"{where}/{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("league", [False, True], ids=["pool", "league"])
def test_resume_is_bit_exact(tmp_path, league):
    """Six iterations in one go, against four (checkpoint at iteration 2)
    and a resume to six under the same run name: the same final parameters,
    and the same checkpoint at iteration 4 (model, AdamW state and count,
    benchmark, pool or league with its weights, ids and games, random
    states, mid-episode self-play state), bit for bit. The resumed stream
    holds each iteration's records once."""
    straight = run(tmp_path, "straight", 6, league, ckpt="ckpt_a")
    run(tmp_path, "cut", 4, league, ckpt="ckpt_b")
    resumed = run(tmp_path, "cut", 6, league, resume=True, ckpt="ckpt_b")
    assert resumed["start_iteration"] == 3
    assert straight["opponent_sources"][3:] == resumed["opponent_sources"]
    if league:
        assert any("historical" in s for s in straight["opponent_sources"])
    assert_same(straight["model"].state_dict(), resumed["model"].state_dict(), "model")
    a, _ = restore_checkpoint(str(tmp_path / "ckpt_a"), 4)
    b, _ = restore_checkpoint(str(tmp_path / "ckpt_b"), 4)
    assert_same(a, b)
    assert len(a["pool"]) == 2 and a["optimizer_count"] == 5 * 2

    records = [json.loads(line) for line in open(tmp_path / "runs" / "cut.jsonl")]
    for key in ("training/mean_reward", "training/opponent_source"):
        steps = [r["_step"] for r in records if key in r]
        assert steps == [8 * 8 * (i + 1) for i in range(6)], key
    assert sum(1 for r in records if "validation/vs_benchmark/score_rate" in r) == 1


def test_resume_without_a_checkpoint_starts_at_zero(tmp_path):
    config = base_config(tmp_path, 1, False)
    config.update(resume=True, checkpoint_dir=str(tmp_path / "none"))
    with MetricsLogger(run_name="fresh", config=config, out_dir=str(tmp_path / "runs")) as logger:
        summary = train_mnk(config, logger, device="cpu")
    assert summary["start_iteration"] == 0 and len(summary["iterations"]) == 1


def test_full13_checkpoint_params_give_the_same_forward():
    """The JAX package's committed train-state checkpoint of the 13x13
    ``transformer_b_s_w`` run (iteration 4350), restored by its own
    ``restore_checkpoint_portable``, handed over as numpy through the
    converter: the port's forward equals flax's on the checkpoint's own
    mid-game boards (1e-4, the committed export's tolerance)."""
    state, step = restore_checkpoint_portable(FULL13)
    assert step == 4350
    variables = {"params": jax.tree.map(lambda x: np.asarray(x, np.float32), state["params"]),
                 "batch_stats": {}}
    obs = np.array(state["obs"]["observation"], np.float32)[:12]
    assert obs.shape == (12, 2, 13, 13) and obs.sum() > 0
    module, _ = jax_create("transformer_b_s_w", (2, 13, 13), 169)
    eval_j, _ = make_apply_fns(module)
    lj, vj = eval_j(variables, jnp.asarray(obs))
    model, _ = create_model_from_architecture("transformer_b_s_w", (2, 13, 13), 169)
    model.load_state_dict(flax_to_state_dict(variables))
    lt, vt = eval_apply(model, torch.from_numpy(obs))
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(vj), vt.numpy(), atol=1e-4, rtol=1e-4)
    assert float(np.abs(lt.numpy()).max()) > 0.1  # trained weights
