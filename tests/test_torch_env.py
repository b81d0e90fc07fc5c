"""The port's env against the JAX package's: line matrix, step + observe,
the plain env-step kernel against the Pallas kernel in interpret mode, and
the step-input checks. Every comparison is bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_selfplay_mnk_tpu import env as jenv
from rl_selfplay_mnk_tpu.env.lines import line_matrix as jax_line_matrix
from rl_selfplay_mnk_tpu.ops.pallas_env import fused_step as jax_fused_step
from rl_selfplay_mnk_tpu_torch import env as tenv
from rl_selfplay_mnk_tpu_torch.env.lines import line_matrix
from rl_selfplay_mnk_tpu_torch.ops.env_step import fused_step_reference

# One intra-op thread: the tensors here are tiny, and several test processes
# with a thread pool each spend their time waiting on one another.
torch.set_num_threads(1)

BOARDS = [(3, 3, 3), (5, 5, 4), (9, 9, 5), (4, 6, 3)]


def random_legal(rng, mask):
    """Uniform legal cell per row, cell 0 on a full board."""
    return np.where(mask, rng.random(mask.shape), -1.0).argmax(axis=1).astype(np.int32)


def to_torch_state(s):
    return tenv.EnvState(
        torch.from_numpy(np.asarray(s.boards).copy()),
        torch.from_numpy(np.asarray(s.current_player).copy()),
        torch.from_numpy(np.asarray(s.move_count).copy()),
    )


def assert_state_equal(jax_state, torch_state, msg=""):
    np.testing.assert_array_equal(np.asarray(jax_state.boards), torch_state.boards.numpy(), msg)
    np.testing.assert_array_equal(
        np.asarray(jax_state.current_player), torch_state.current_player.numpy(), msg
    )
    np.testing.assert_array_equal(np.asarray(jax_state.move_count), torch_state.move_count.numpy(), msg)


@pytest.mark.parametrize("mnk", BOARDS + [(13, 13, 5), (7, 5, 5)])
def test_line_matrix_matches_jax(mnk):
    np.testing.assert_array_equal(line_matrix(*mnk), jax_line_matrix(*mnk))


@pytest.mark.parametrize("mnk", BOARDS)
def test_step_and_observe_match_jax_random_playout(mnk):
    """Random legal playouts with random active masks, played on past wins
    and full boards (no resets): bitwise equal state, rewards, dones, mask."""
    m, n, k = mnk
    e, steps = 32, m * n + 4
    cfg_j, cfg_t = jenv.EnvConfig(m, n, k), tenv.EnvConfig(m, n, k)
    jstep = jax.jit(jenv.step, static_argnums=0)
    rng = np.random.default_rng(sum(mnk))
    sj = jenv.make_env_state(cfg_j, e)
    st = tenv.make_env_state(cfg_t, e, "cpu")
    for t in range(steps):
        mask = np.asarray(jenv.observe(sj)["action_mask"])
        actions = random_legal(rng, mask)
        active = rng.random(e) < 0.8
        sj, rj, dj = jstep(cfg_j, sj, jnp.asarray(actions), jnp.asarray(active))
        st, rt, dt = tenv.step(cfg_t, st, torch.from_numpy(actions), torch.from_numpy(active))
        assert_state_equal(sj, st, f"t={t}")
        np.testing.assert_array_equal(np.asarray(rj), rt.numpy())
        np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
        oj, ot = jenv.observe(sj), tenv.observe(st)
        np.testing.assert_array_equal(np.asarray(oj["observation"]), ot["observation"].numpy())
        np.testing.assert_array_equal(np.asarray(oj["action_mask"]), ot["action_mask"].numpy())


@pytest.mark.parametrize("mnk,e,tile", [((5, 5, 4), 64, 32), ((3, 3, 3), 8, 8)])
def test_plain_env_kernel_matches_pallas_interpret(mnk, e, tile):
    """The port's plain K1 against ``fused_step(..., interpret=True)`` at
    the sizes tests/test_pallas.py uses: all six outputs bitwise."""
    cfg_j, cfg_t = jenv.EnvConfig(*mnk), tenv.EnvConfig(*mnk)
    rng = np.random.default_rng(0)
    sj = jenv.make_env_state(cfg_j, e)
    for t in range(30):
        mask = np.asarray(jenv.observe(sj)["action_mask"])
        actions = random_legal(rng, mask)
        active = rng.random(e) < 0.8
        st = to_torch_state(sj)
        nj, rj, dj, mj = jax_fused_step(
            cfg_j, sj, jnp.asarray(actions), jnp.asarray(active), tile_envs=tile, interpret=True
        )
        nt, rt, dt, mt = fused_step_reference(
            cfg_t, st, torch.from_numpy(actions), torch.from_numpy(active)
        )
        assert_state_equal(nj, nt, f"t={t}")
        for a, b in ((rj, rt), (dj, dt), (mj, mt)):
            assert np.asarray(a).dtype == b.numpy().dtype
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), f"t={t}")
        sj = nj


def test_validate_step_inputs_matches_jax():
    cfg_j, cfg_t = jenv.EnvConfig(5, 5, 4), tenv.EnvConfig(5, 5, 4)
    rng = np.random.default_rng(3)
    e = 64
    sj = jenv.make_env_state(cfg_j, e)
    for _ in range(8):
        mask = np.asarray(jenv.observe(sj)["action_mask"])
        sj, _, _ = jenv.step(cfg_j, sj, jnp.asarray(random_legal(rng, mask)))
    actions = rng.integers(-3, 29, size=e).astype(np.int32)
    active = rng.random(e) < 0.7
    for act in (None, active):
        oj, cj = jenv.validate_step_inputs(
            cfg_j, sj, jnp.asarray(actions), None if act is None else jnp.asarray(act)
        )
        ot, ct = tenv.validate_step_inputs(
            cfg_t, to_torch_state(sj), torch.from_numpy(actions),
            None if act is None else torch.from_numpy(act),
        )
        np.testing.assert_array_equal(np.asarray(oj), ot.numpy())
        np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
        assert ot.any() and ct.any()


def test_reset_where_and_check_wins_match_jax():
    cfg_j, cfg_t = jenv.EnvConfig(5, 5, 4), tenv.EnvConfig(5, 5, 4)
    rng = np.random.default_rng(4)
    e = 32
    sj = jenv.make_env_state(cfg_j, e)
    for _ in range(12):
        mask = np.asarray(jenv.observe(sj)["action_mask"])
        sj, _, _ = jenv.step(cfg_j, sj, jnp.asarray(random_legal(rng, mask)))
    reset = rng.random(e) < 0.5
    st = to_torch_state(sj)
    st = st._replace(action_mask=tenv.action_mask(st))  # as a step leaves it
    rj, rt = jenv.reset_where(sj, jnp.asarray(reset)), tenv.reset_where(st, torch.from_numpy(reset))
    assert_state_equal(rj, rt)
    np.testing.assert_array_equal(np.asarray(jenv.observe(rj)["action_mask"]),
                                  tenv.observe(rt)["action_mask"].numpy())
    planes = np.array(sj.boards).reshape(e, 2, -1)[:, 0].copy()
    np.testing.assert_array_equal(
        np.asarray(jenv.check_wins(cfg_j, jnp.asarray(planes))),
        tenv.check_wins(cfg_t, torch.from_numpy(planes)).numpy(),
    )
