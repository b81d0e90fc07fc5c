"""Self-play wrapper: two-player env -> single-agent vector env.

Counterpart of the JAX package's ``selfplay/wrapper.py``, with the same
semantics:

  * per-env random ``agent_side``;
  * the opponent moves whenever it holds the turn, in ONE dense masked
    policy call over the whole batch (``_opponent_phase``);
  * delayed auto-reset: the step after a terminal ignores the agent's action
    and resets that env; the opponent outcomes on the reset path are
    discarded;
  * zero-sum reward: agent's winning move -> +1, opponent's winning reply
    -> -1;
  * canonical observation: channels flipped when the viewer plays White; an
    all-False action mask gets action 0 patched in.

Policies are ``selfplay.policies.Policy`` objects. Side draws come from an
explicit ``torch.Generator`` or are injected (``sides``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..env.constants import PLAYER_WHITE
from ..env.mnk_env import EnvConfig, EnvState, make_env_state, observe, reset_where, step


class SelfPlayState(NamedTuple):
    env: EnvState
    agent_side: torch.Tensor  # (E,) int32 — which color the learner plays
    pending_resets: torch.Tensor  # (E,) bool — envs to auto-reset next step


def flip_channels(observation: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Swap me/enemy planes on the selected envs."""
    return torch.where(flip[:, None, None, None], observation.flip(1), observation)


def canonical_obs(state: SelfPlayState) -> dict:
    """Observation from the learner's perspective."""
    raw = observe(state.env)
    obs = flip_channels(raw["observation"], state.agent_side == PLAYER_WHITE)
    mask = raw["action_mask"]
    invalid = ~mask.any(dim=1)
    mask = torch.cat([(mask[:, 0] | invalid)[:, None], mask[:, 1:]], dim=1)
    return {"observation": obs, "action_mask": mask}


def draw_sides(num_envs: int, device, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randint(0, 2, (num_envs,), generator=generator, device=device, dtype=torch.int32)


def _opponent_phase(
    cfg: EnvConfig,
    opponent,
    env: EnvState,
    agent_side: torch.Tensor,
    eligible: torch.Tensor,
) -> Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The opponent moves on every eligible env where it holds the turn; it
    sees the board canonical to the color it plays."""
    opp_turn = eligible & (env.current_player != agent_side)
    raw = observe(env)
    observation = flip_channels(raw["observation"], env.current_player == PLAYER_WHITE)
    actions = opponent.act({"observation": observation, "action_mask": raw["action_mask"]})
    env, rewards, dones = step(cfg, env, actions, opp_turn)
    return env, rewards, dones, opp_turn


def selfplay_reset(
    cfg: EnvConfig,
    opponent,
    num_envs: int,
    device=None,
    generator: Optional[torch.Generator] = None,
    agent_side: Optional[torch.Tensor] = None,
) -> Tuple[SelfPlayState, dict]:
    """Full reset: fresh boards, new sides (drawn unless given), and the
    opponent moves first wherever the agent is White. ``device`` None =
    the card."""
    env = make_env_state(cfg, num_envs, device)
    if agent_side is None:
        agent_side = draw_sides(num_envs, env.boards.device, generator)
    else:
        agent_side = torch.as_tensor(agent_side, dtype=torch.int32, device=env.boards.device)
    eligible = torch.ones((num_envs,), dtype=torch.bool, device=env.boards.device)
    env, _, _, _ = _opponent_phase(cfg, opponent, env, agent_side, eligible)
    state = SelfPlayState(
        env=env,
        agent_side=agent_side,
        pending_resets=torch.zeros((num_envs,), dtype=torch.bool, device=env.boards.device),
    )
    return state, canonical_obs(state)


def selfplay_step(
    cfg: EnvConfig,
    opponent,
    state: SelfPlayState,
    actions: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    sides: Optional[torch.Tensor] = None,
) -> Tuple[SelfPlayState, dict, torch.Tensor, torch.Tensor]:
    """One learner step. Returns ``(state, obs, rewards, terminated)``.

    ``sides`` are the (E,) side draws for the envs that reset this step
    (only those entries are used); drawn from ``generator`` when omitted.
    """
    e = state.env.num_envs
    device = state.env.boards.device

    # Phase 0: delayed auto-resets; reset boards, redraw sides.
    reset_mask = state.pending_resets
    play = ~reset_mask
    env = reset_where(state.env, reset_mask)
    if sides is None:
        sides = draw_sides(e, device, generator)
    agent_side = torch.where(reset_mask, torch.as_tensor(sides, dtype=torch.int32, device=device),
                             state.agent_side)

    # Phase 1: the agent moves on the envs that did not reset.
    env, r_ag, t_ag = step(cfg, env, actions, play)
    rewards = torch.where(play, r_ag, torch.zeros_like(r_ag))
    terminated = t_ag & play

    # Phase 2: one opponent pass covering the reset path and the survivors;
    # only the survivors' outcomes count.
    survivors = play & ~terminated
    eligible = reset_mask | survivors
    env, r_opp, t_opp, _ = _opponent_phase(cfg, opponent, env, agent_side, eligible)
    rewards = rewards - torch.where(survivors, r_opp, torch.zeros_like(r_opp))
    terminated = torch.where(survivors, t_opp, terminated)

    new_state = SelfPlayState(env=env, agent_side=agent_side, pending_resets=terminated)
    return new_state, canonical_obs(new_state), rewards, terminated
