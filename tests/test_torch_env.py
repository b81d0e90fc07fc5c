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


def wild_actions(rng, mask, play, t):
    """Legal actions, but for ``play`` "occupied" (every other step) a third
    of the envs play a cell that holds a stone where there is one, and for
    "out_of_range" a third play an action off the board."""
    actions = random_legal(rng, mask)
    pick = (rng.random(mask.shape[0]) < 1 / 3) & (t % 2 == 1)
    if play == "occupied":
        occupied = np.where(~mask, rng.random(mask.shape), -1.0)
        actions = np.where(pick & (~mask).any(1), occupied.argmax(1), actions)
    elif play == "out_of_range":
        off = rng.choice(np.array([-1, -9, mask.shape[1], mask.shape[1] + 3, 2**31 - 1]), mask.shape[0])
        actions = np.where(pick, off, actions)
    return actions.astype(np.int32)


# The sizes tests/test_pallas.py uses, with legal moves; then the inputs the
# plain version does not reject (validate_step_inputs is off by default):
# stones on occupied cells (a cell of 2.0, or of both planes), actions off the
# board. Every case plays on past wins and full boards (no resets).
@pytest.mark.parametrize("mnk,e,tile,play", [
    pytest.param((5, 5, 4), 64, 32, "legal", id="mnk0-64-32"),
    pytest.param((3, 3, 3), 8, 8, "legal", id="mnk1-8-8"),
    pytest.param((5, 5, 4), 64, 32, "occupied", id="occupied-5x5x4-64-32"),
    pytest.param((3, 3, 3), 8, 8, "occupied", id="occupied-3x3x3-8-8"),
    pytest.param((5, 5, 4), 64, 32, "out_of_range", id="out_of_range-5x5x4-64-32"),
    pytest.param((4, 6, 3), 16, 8, "out_of_range", id="out_of_range-4x6x3-16-8"),
])
def test_plain_env_kernel_matches_pallas_interpret(mnk, e, tile, play):
    """The port's plain K1 against ``fused_step(..., interpret=True)``: all
    six outputs bitwise."""
    cfg_j, cfg_t = jenv.EnvConfig(*mnk), tenv.EnvConfig(*mnk)
    rng = np.random.default_rng(0)
    sj = jenv.make_env_state(cfg_j, e)
    odd = False
    for t in range(30):
        mask = np.asarray(jenv.observe(sj)["action_mask"])
        actions = wild_actions(rng, mask, play, t)
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
        planes = np.asarray(sj.boards)
        odd |= bool((planes > 1).any() or (planes.sum(1) > 1).any())
    # The occupied plays did leave stacked stones for the later steps to count.
    assert odd or play != "occupied"


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


def test_env_step_study_times_mid_game_boards_and_counts_the_bytes():
    """``utils/env_step_study.py``'s inputs, on the CPU (no timing): 20
    stones a board and as many moves counted, a legal action for every env,
    about half of them active, the same inputs from the same seed; and the
    bytes a call must move, which count no line table."""
    from rl_selfplay_mnk_tpu_torch.utils.env_step_study import TIMED, k1_bytes, mid_game

    assert ((9, 9, 5), 8192) in TIMED and ((9, 9, 5), 384) in TIMED and ((13, 13, 5), 384) in TIMED
    cfg = tenv.EnvConfig(13, 13, 5)
    state, actions, active = mid_game(cfg, 256, "cpu")
    assert (state.boards.sum((1, 2, 3)) == 20).all() and (state.move_count == 20).all()
    cells = state.boards.sum(1).reshape(256, -1)
    assert (cells.gather(1, actions[:, None]) == 0).all()
    assert 0.35 < active.float().mean() < 0.65
    again = mid_game(cfg, 256, "cpu")
    assert torch.equal(again[0].boards, state.boards) and torch.equal(again[1], actions)
    assert k1_bytes((9, 9, 5), 8192) == 8192 * (2 * (648 + 4 + 4) + 8 + 1 + 4 + 1 + 81)


@pytest.mark.parametrize("mnk,e,tile", [((5, 5, 4), 64, 32), ((9, 9, 5), 48, 16)])
def test_plain_env_kernel_matches_pallas_interpret_on_any_plane_values(mnk, e, tile):
    """Planes holding what a caller may put there (stacked stones, halves,
    negatives, infinities, NaN), any player number, actions on and off the
    board: the plain K1 against ``fused_step(..., interpret=True)``, all six
    outputs bitwise (NaN where the other has NaN). A line's count is the
    product's: NaN where a NaN or an infinity lies off the line."""
    m, n, k = mnk
    mn = m * n
    cfg_j, cfg_t = jenv.EnvConfig(*mnk), tenv.EnvConfig(*mnk)
    rng = np.random.default_rng(7)
    values = np.array([0.0, 1.0, 2.0, 0.5, -1.0, 3.0], np.float32)
    wins = 0
    for _ in range(6):
        planes = np.where(rng.random((e, 2, mn)) < 0.6, 0.0,
                          rng.choice(values, (e, 2, mn), p=[0.1, 0.6, 0.1, 0.1, 0.05, 0.05]))
        planes = planes.astype(np.float32)
        wild = rng.random((e, 2, mn)) < 0.004
        planes[wild] = rng.choice(np.array([np.inf, -np.inf, np.nan], np.float32), int(wild.sum()))
        player = rng.choice([0, 1, 1, 2, -1], e).astype(np.int32)
        move_count = rng.integers(0, mn + 3, e).astype(np.int32)
        actions = rng.integers(-3, mn + 3, e).astype(np.int32)
        active = rng.random(e) < 0.8
        sj = jenv.EnvState(jnp.asarray(planes.reshape(e, 2, m, n)), jnp.asarray(player),
                           jnp.asarray(move_count))
        nj, rj, dj, mj = jax_fused_step(
            cfg_j, sj, jnp.asarray(actions), jnp.asarray(active), tile_envs=tile, interpret=True
        )
        nt, rt, dt, mt = fused_step_reference(
            cfg_t, to_torch_state(sj), torch.from_numpy(actions), torch.from_numpy(active)
        )
        np.testing.assert_array_equal(np.asarray(nj.boards), nt.boards.numpy())  # NaN == NaN here
        for a, b in ((nj.current_player, nt.current_player), (nj.move_count, nt.move_count),
                     (rj, rt), (dj, dt), (mj, mt)):
            assert np.asarray(a).dtype == b.numpy().dtype
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        wins += int(rt.sum())
    assert wins > 0
