"""The port's self-play wrapper, validation and opponent pool against the
JAX package's. JAX's side draws are computed here and injected into the
port; both opponents are the same deterministic function of the board, so
every step's outputs must agree exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_selfplay_mnk_tpu import env as jenv
from rl_selfplay_mnk_tpu.selfplay import opponent_pool as jpool
from rl_selfplay_mnk_tpu.selfplay import policies as jpol
from rl_selfplay_mnk_tpu.selfplay import validation as jval
from rl_selfplay_mnk_tpu.selfplay import wrapper as jw
from rl_selfplay_mnk_tpu_torch import env as tenv
from rl_selfplay_mnk_tpu_torch.selfplay import (
    OpponentPool,
    Policy,
    RandomPolicy,
    canonical_obs,
    selfplay_reset,
    selfplay_step,
    validate,
)

# One intra-op thread: the tensors here are tiny, and several test processes
# with a thread pool each spend their time waiting on one another.
torch.set_num_threads(1)

M = N = K = 3
E = 16


def opponent_scores(seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(M * N,)).astype(np.float32), rng.normal(size=(2,)).astype(np.float32)


def jax_opponent(base, coef):
    def act(params, rng, obs, deterministic=False):
        o = obs["observation"].reshape(obs["observation"].shape[0], 2, -1)
        score = base + coef[0] * o[:, 0] + coef[1] * o[:, 1]
        return jnp.argmax(jnp.where(obs["action_mask"], score, -jnp.inf), axis=-1).astype(jnp.int32)

    return act


def torch_opponent(base, coef):
    base_t, coef_t = torch.from_numpy(base), torch.from_numpy(coef)

    def act(params, obs, generator=None, deterministic=False):
        o = obs["observation"].reshape(obs["observation"].shape[0], 2, -1)
        score = base_t + coef_t[0] * o[:, 0] + coef_t[1] * o[:, 1]
        return torch.argmax(score.masked_fill(~obs["action_mask"], float("-inf")), dim=-1)

    return Policy(apply=act)


def check_equal(sj, oj, st, ot, *extra):
    np.testing.assert_array_equal(np.asarray(sj.env.boards), st.env.boards.numpy())
    np.testing.assert_array_equal(np.asarray(sj.env.current_player), st.env.current_player.numpy())
    np.testing.assert_array_equal(np.asarray(sj.env.move_count), st.env.move_count.numpy())
    np.testing.assert_array_equal(np.asarray(sj.agent_side), st.agent_side.numpy())
    np.testing.assert_array_equal(np.asarray(sj.pending_resets), st.pending_resets.numpy())
    np.testing.assert_array_equal(np.asarray(oj["observation"]), ot["observation"].numpy())
    np.testing.assert_array_equal(np.asarray(oj["action_mask"]), ot["action_mask"].numpy())
    for a, b in zip(extra[::2], extra[1::2]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_selfplay_reset_and_step_match_jax(seed):
    cfg_j, cfg_t = jenv.EnvConfig(M, N, K), tenv.EnvConfig(M, N, K)
    base, coef = opponent_scores(seed)
    opp_j, opp_t = jax_opponent(base, coef), torch_opponent(base, coef)
    rng = np.random.default_rng(seed)
    sides = rng.integers(0, 2, size=E).astype(np.int32)
    sj, oj = jw.selfplay_reset(cfg_j, opp_j, None, E, jax.random.PRNGKey(seed), agent_side=sides)
    st, ot = selfplay_reset(cfg_t, opp_t, E, "cpu", agent_side=torch.from_numpy(sides))
    check_equal(sj, oj, st, ot)
    step_j = jax.jit(jw.selfplay_step, static_argnums=(0, 1))
    key = jax.random.PRNGKey(100 + seed)
    n_terminal = n_resets = 0
    for t in range(14):
        mask = np.asarray(oj["action_mask"])
        actions = np.where(mask, rng.random(mask.shape), -1).argmax(1).astype(np.int32)
        key, k = jax.random.split(key)
        # The JAX step's own side draws, injected into the port.
        k_side, _ = jax.random.split(k)
        new_sides = np.array(jax.random.randint(k_side, (E,), 0, 2, dtype=jnp.int32))
        n_resets += int(np.asarray(sj.pending_resets).sum())
        sj, oj, rj, tj = step_j(cfg_j, opp_j, None, sj, jnp.asarray(actions), k)
        st, ot, rt, tt = selfplay_step(cfg_t, opp_t, st, torch.from_numpy(actions),
                                       sides=torch.from_numpy(new_sides))
        check_equal(sj, oj, st, ot, rj, rt, tj, tt)
        n_terminal += int(np.asarray(tj).sum())
    assert n_terminal > 0 and n_resets > 0
    assert set(np.unique(np.asarray(rj))) <= {-1.0, 0.0, 1.0}


def test_canonical_obs_patches_degenerate_mask():
    cfg = tenv.EnvConfig(M, N, K)
    env = tenv.make_env_state(cfg, 2, "cpu")
    boards = env.boards.clone()
    boards[0, 0] = 1.0  # a full board: no legal cell
    state_env = env._replace(boards=boards, action_mask=None)  # mask from the boards
    from rl_selfplay_mnk_tpu_torch.selfplay.wrapper import SelfPlayState

    st = SelfPlayState(state_env, torch.tensor([1, 0], dtype=torch.int32), torch.zeros(2, dtype=torch.bool))
    obs = canonical_obs(st)
    assert obs["action_mask"][0].tolist() == [True] + [False] * 8
    assert obs["action_mask"][1].all()
    assert torch.equal(obs["observation"][0, 1], boards[0, 0])  # White viewer: flipped


def test_validate_keys_sides_and_rates():
    cfg = tenv.EnvConfig(M, N, K)
    g = torch.Generator().manual_seed(0)
    res = validate(cfg, RandomPolicy(g), RandomPolicy(g), 32, "cpu", g)
    cfg_j = jenv.EnvConfig(M, N, K)
    rp = jpol.RandomPolicy()
    res_j = jval.validate(cfg_j, rp.apply, None, rp.apply, None, 32, jax.random.PRNGKey(0))
    assert set(res) == set(res_j)
    assert res["validation/vs_benchmark/games_played"] == 32
    total = sum(res[f"validation/vs_benchmark/{k}_rate"] for k in ("win", "loss", "draw"))
    assert total == pytest.approx(1.0)


def test_validate_first_terminal_reward_with_scripted_players():
    """Both sides play the lowest legal cell: on 3x3, Black completes the
    left column first, so the Black half wins and the White half loses."""
    cfg = tenv.EnvConfig(M, N, K)
    first = Policy(apply=lambda p, obs, g=None, d=False: torch.argmax(obs["action_mask"].int(), -1))
    res = validate(cfg, first, first, 8, "cpu")
    assert res["validation/vs_benchmark/win_rate"] == 0.5
    assert res["validation/vs_benchmark/loss_rate"] == 0.5


@pytest.mark.parametrize("weighted,eviction", [(False, "fifo"), (True, "adaptive")])
def test_opponent_pool_matches_jax(weighted, eviction):
    pj = jpool.OpponentPool(max_size=3, seed=7, weighted=weighted, eviction=eviction)
    pt = OpponentPool(max_size=3, seed=7, weighted=weighted, eviction=eviction)
    for i, w in enumerate([0.5, 0.9, 0.2, 0.7, 0.1]):
        pj.add_opponent(i, weight=w)
        pt.add_opponent(i, weight=w)
        assert list(pj.pool) == list(pt.pool) and pj.size() == pt.size()
    assert [pj.get_random_opponent() for _ in range(20)] == [pt.get_random_opponent() for _ in range(20)]
