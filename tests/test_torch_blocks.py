"""Mixed-opponent blocks against the JAX package: the block policy against
``make_block_pooled_policy`` on the same weights and noise, the rollout's
per-block finished episodes, ``train_mnk`` with two opponents an iteration,
and the golden rollout replayed through the port's wrapper with the JAX
package's draws."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_selfplay_mnk_tpu.models import create_model_from_architecture as jax_create
from rl_selfplay_mnk_tpu.models import init_network as jax_init
from rl_selfplay_mnk_tpu.models.registry import make_apply_fns
from rl_selfplay_mnk_tpu.selfplay import RandomPolicy as JaxRandomPolicy
from rl_selfplay_mnk_tpu.selfplay.policies import make_block_pooled_policy
from rl_selfplay_mnk_tpu_torch import env as tenv
from rl_selfplay_mnk_tpu_torch.alg import ppo as tppo
from rl_selfplay_mnk_tpu_torch.models import (
    create_model_from_architecture,
    eval_apply,
    flax_to_state_dict,
    snapshot,
)
from rl_selfplay_mnk_tpu_torch.selfplay import BlockPolicy, Policy, selfplay_reset, selfplay_step
from rl_selfplay_mnk_tpu_torch.train import get_default_config, train_mnk
from rl_selfplay_mnk_tpu_torch.utils.metrics import MetricsLogger

# One intra-op thread: the tensors here are tiny, and several test processes
# with a thread pool each spend their time waiting on one another.
torch.set_num_threads(1)

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden_rollout.json")


def block_inputs(arch, k, e, seed=9):
    """K weight sets of ``arch`` on 3x3 boards for both packages, and a batch
    of E positions with their masks."""
    module, _ = jax_create(arch, (2, 3, 3), 9)
    sets = [jax.tree.map(np.asarray, jax_init(module, (2, 3, 3), jax.random.PRNGKey(s)))
            for s in range(k)]
    models = []
    for variables in sets:
        model, _ = create_model_from_architecture(arch, (2, 3, 3), 9)
        model.load_state_dict(flax_to_state_dict(variables))
        models.append(snapshot(model))
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, 3, size=(e, 3, 3))
    owner[:, 0, 0] = 0
    obs = {"observation": np.stack([owner == 1, owner == 2], 1).astype(np.float32),
           "action_mask": (owner == 0).reshape(e, 9)}
    return module, sets, models, obs


@pytest.mark.parametrize("arch", ["cnn_b_s", "mlp_tiny"])
def test_block_policy_matches_make_block_pooled_policy(arch):
    """Four snapshots over 16 envs: block i of the batch plays set i. The
    argmax, and the sample from the same uniforms (JAX's categorical draws
    its gumbel noise from them), equal the JAX policy's actions."""
    k, e = 4, 16
    module, sets, models, obs = block_inputs(arch, k, e)
    eval_j, _ = make_apply_fns(module)
    act_j = make_block_pooled_policy(eval_j, k)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *sets)
    obs_j = {key: jnp.asarray(v) for key, v in obs.items()}
    obs_t = {key: torch.from_numpy(v) for key, v in obs.items()}
    policy = BlockPolicy(eval_apply, models)

    want = np.asarray(act_j(stacked, jax.random.PRNGKey(1), obs_j, True))
    np.testing.assert_array_equal(policy.act(obs_t, deterministic=True).numpy(), want)
    for seed in range(3):
        key = jax.random.PRNGKey(100 + seed)
        u = np.array(jax.random.uniform(key, (e, 9), jnp.float32,
                                          minval=jnp.finfo(jnp.float32).tiny, maxval=1.0))
        want = np.asarray(act_j(stacked, key, obs_j, False))
        got = policy.apply(policy.params, obs_t, None, False, noise=torch.from_numpy(u))
        np.testing.assert_array_equal(got.numpy(), want)
    # Each block is its own set's forward: a set moved to another block
    # moves that block's actions with it.
    swapped = BlockPolicy(eval_apply, models[1:] + models[:1]).act(obs_t, deterministic=True)
    per = e // k
    alone = [eval_apply(models[(i + 1) % k], obs_t["observation"][i * per:(i + 1) * per])[0]
             for i in range(k)]
    expect = torch.cat([torch.argmax(l.masked_fill(~obs_t["action_mask"][i * per:(i + 1) * per],
                                                   float("-inf")), -1)
                        for i, l in enumerate(alone)])
    assert torch.equal(swapped, expect)
    with pytest.raises(ValueError, match="blocks"):
        BlockPolicy(eval_apply, models[:3]).act(obs_t)


def test_rollout_counts_finished_episodes_per_block():
    """With ``fin_blocks`` = 2 each block's sums are those of its own envs,
    and they add up to the sums without blocks, from the same draws."""
    cfg = dict(env=tenv.EnvConfig(3, 3, 3), num_envs=8, n_steps=12, batch_size=32)
    rng = np.random.default_rng(0)
    draws = {"noise": torch.from_numpy(rng.random((12, 8, 9)).astype(np.float32).clip(1e-7)),
             "sides": torch.from_numpy(rng.integers(0, 2, (12, 8)).astype(np.int32))}
    first_legal = Policy(apply=lambda p, obs, g=None, d=False: torch.argmax(obs["action_mask"].int(), -1))
    model, _ = create_model_from_architecture("mlp_tiny", (2, 3, 3), 9)
    fins, trajs = [], []
    for blocks in (0, 2):
        config = tppo.PPOConfig(**cfg, fin_blocks=blocks)
        state, obs = selfplay_reset(config.env, first_legal, 8, "cpu",
                                    agent_side=torch.tensor([0, 1] * 4, dtype=torch.int32))
        zeros = torch.zeros(8)
        _, _, traj, fin, _ = tppo.rollout_impl(model, config, first_legal, state, obs, zeros,
                                               zeros.clone(), None, draws)
        fins.append(fin)
        trajs.append(traj)
    assert fins[0].shape == (3,) and fins[1].shape == (3, 2)
    torch.testing.assert_close(fins[1].sum(1), fins[0], rtol=0, atol=1e-6)
    dones = trajs[1]["dones"].to(torch.float32)
    torch.testing.assert_close(fins[1][2], torch.stack([dones[:, :4].sum(), dones[:, 4:].sum()]))
    assert (fins[1][2] > 0).all()


def test_train_mnk_with_two_opponents_an_iteration(tmp_path):
    """``opponents_per_iteration`` = 2 (the JAX package's
    ``test_train_mnk_mixed_opponents``): two draws an iteration, one for
    each block; a batch that does not split into the blocks is refused."""
    config = get_default_config()
    config.update(mnk=(3, 3, 3), num_envs=8, n_steps=8, batch_size=32, ppo_epochs=1,
                  total_environment_steps=8 * 8 * 3, validation_interval=100, lr_warmup_steps=0,
                  architecture_name="cnn_b_s", opponent_pool=2, entropy_coef_schedule=None,
                  opponents_per_iteration=2, export_dir=str(tmp_path / "models"))
    with MetricsLogger(run_name="mixed", config=config, out_dir=str(tmp_path / "runs")) as logger:
        summary = train_mnk(config, logger, device="cpu")
    assert summary["errors"] == []
    lines = [json.loads(line) for line in open(tmp_path / "runs" / "mixed.jsonl")]
    assert not any(k.startswith("error/") for rec in lines for k in rec)
    sources = [r["training/opponent_source"] for r in lines if "training/opponent_source" in r]
    assert len(sources) == 3 and all(len(s.split(",")) == 2 for s in sources)
    config.update(opponents_per_iteration=3)
    with pytest.raises(ValueError, match="opponent blocks"):
        train_mnk(config, device="cpu")


def jax_draws(mask, key):
    """The JAX package's random policy on the port's mask, with ``key``."""
    act = JaxRandomPolicy().apply(None, key, {"action_mask": jnp.asarray(mask.numpy())}, False)
    return torch.from_numpy(np.asarray(act).astype(np.int64))


def test_golden_rollout_through_the_port_with_the_jax_draws():
    """``tests/golden_rollout.json`` pins the agent's actions, the rewards,
    the dones and the final board sum of a 40-step random-vs-random rollout
    on 3x3x3 (``tests/test_golden_rollout.py``). The sides and the
    opponent's moves are drawn inside JAX's ``selfplay_step``: here the same
    keys draw them through the JAX package, on the port's own masks, and the
    port's wrapper plays them."""
    with open(GOLDEN_PATH) as f:
        want = json.load(f)
    cfg, e = tenv.EnvConfig(3, 3, 3), 8
    opponent_key, calls = [], []

    def opponent_act(params, obs, generator=None, deterministic=False):
        calls.append(opponent_key[-1])
        return jax_draws(obs["action_mask"], opponent_key[-1])

    opponent = Policy(apply=opponent_act)

    rng = jax.random.PRNGKey(1234)
    rng, k = jax.random.split(rng)
    k_side, k_opp = jax.random.split(k)
    sides = np.asarray(jax.random.randint(k_side, (e,), 0, 2, dtype=jnp.int32))
    opponent_key.append(k_opp)
    state, obs = selfplay_reset(cfg, opponent, e, "cpu", agent_side=torch.from_numpy(sides))
    got = {"actions": [], "rewards": [], "dones": []}
    for _ in range(40):
        rng, k_act, k_step = jax.random.split(rng, 3)
        actions = jax_draws(obs["action_mask"], k_act)
        k_side, k_opp = jax.random.split(k_step)
        sides = np.asarray(jax.random.randint(k_side, (e,), 0, 2, dtype=jnp.int32))
        opponent_key.append(k_opp)
        state, obs, rewards, dones = selfplay_step(cfg, opponent, state, actions,
                                                   sides=torch.from_numpy(sides))
        got["actions"].append(actions.tolist())
        got["rewards"].append(rewards.tolist())
        got["dones"].append(dones.to(torch.int64).tolist())
    assert got["actions"] == want["actions"]
    assert got["dones"] == want["dones"]
    np.testing.assert_allclose(np.array(got["rewards"]), np.array(want["rewards"]), atol=1e-6)
    assert abs(float(state.env.boards.sum()) - want["final_board_sum"]) < 1e-4
    assert calls == opponent_key  # one opponent pass at the reset and one a step, each its key
