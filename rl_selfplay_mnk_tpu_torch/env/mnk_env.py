"""Vectorized MNK game engine: plain functions over an ``EnvState`` of tensors.

The counterpart of the JAX package's ``env/mnk_env.py``, with the same
contract: a dense boolean ``active`` mask selects the envs that move, stone
placement is a one-hot add, and the win check counts the mover's stones on
every K-in-a-row line of the board.

``step`` is the fused env step of ``ops/env_step.py``: on a CUDA tensor it
launches the hand-written env-step kernel, on a CPU tensor it runs that
kernel's plain PyTorch version. Functions never update a state in place;
they return a new ``EnvState``.

Observation contract: ``observation`` is the raw (E, 2, M, N) float32 plane
stack (channel 0 = black, channel 1 = white); ``action_mask`` is True on
empty cells, flattened to (E, M*N).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.hardware import resolve_device
from .constants import PLAYER_BLACK
from .lines import line_matrix


class EnvConfig(NamedTuple):
    """Static board geometry."""

    m: int
    n: int
    k: int

    @property
    def num_actions(self) -> int:
        return self.m * self.n

    def validate(self) -> "EnvConfig":
        if not (self.m >= self.k and self.n >= self.k):
            raise AssertionError(
                f"Board ({self.m}x{self.n}) is too small for k={self.k}"
            )
        return self


class EnvState(NamedTuple):
    """Per-env game state, batched over the leading E axis.

    boards:         (E, 2, M, N) float32 — 1.0 where a stone of that color sits
    current_player: (E,)         int32   — 0 black, 1 white (mover)
    move_count:     (E,)         int32
    action_mask:    (E, M*N)     bool    — empty cells, as the env step wrote
                    them; None = derive from ``boards`` when observed
    """

    boards: torch.Tensor
    current_player: torch.Tensor
    move_count: torch.Tensor
    action_mask: Optional[torch.Tensor] = None

    @property
    def num_envs(self) -> int:
        return self.boards.shape[0]


def make_env_state(cfg: EnvConfig, num_envs: int, device=None) -> EnvState:
    """Fresh all-zero state; black to move. ``device`` None = the card."""
    device = resolve_device(device)
    return EnvState(
        boards=torch.zeros((num_envs, 2, cfg.m, cfg.n), dtype=torch.float32, device=device),
        current_player=torch.zeros((num_envs,), dtype=torch.int32, device=device),
        move_count=torch.zeros((num_envs,), dtype=torch.int32, device=device),
        action_mask=torch.ones((num_envs, cfg.num_actions), dtype=torch.bool, device=device),
    )


def reset_where(state: EnvState, mask: torch.Tensor) -> EnvState:
    """Reset the envs selected by the boolean ``mask``."""
    keep = (~mask).to(state.boards.dtype)
    empty = None if state.action_mask is None else state.action_mask | mask[:, None]
    return EnvState(
        boards=state.boards * keep[:, None, None, None],
        current_player=torch.where(
            mask, torch.full_like(state.current_player, PLAYER_BLACK), state.current_player
        ),
        move_count=torch.where(mask, torch.zeros_like(state.move_count), state.move_count),
        action_mask=empty,
    )


def action_mask(state: EnvState) -> torch.Tensor:
    """(E, M*N) bool — True on empty cells."""
    if state.action_mask is not None:
        return state.action_mask
    e = state.boards.shape[0]
    occupied = (state.boards != 0.0).any(dim=1)
    return ~occupied.reshape(e, -1)


def observe(state: EnvState) -> dict:
    return {"observation": state.boards, "action_mask": action_mask(state)}


def check_wins(cfg: EnvConfig, plane_flat: torch.Tensor) -> torch.Tensor:
    """True per row of ``plane_flat`` (E, M*N) iff it holds K in a row."""
    lines = torch.from_numpy(line_matrix(cfg.m, cfg.n, cfg.k)).to(plane_flat.device)
    counts = plane_flat.to(torch.float32) @ lines
    return (counts > cfg.k - 0.5).any(dim=-1)


def step(
    cfg: EnvConfig,
    state: EnvState,
    actions: torch.Tensor,
    active: Optional[torch.Tensor] = None,
):
    """Advance the selected envs by one move.

    Args:
        actions: (E,) integer flat cell indices; ignored where ``active`` is
            False.
        active: (E,) bool — which envs move. None = all.

    Returns:
        (new_state, rewards, dones): rewards (E,) float32 is +1.0 to the
        mover on a win, else 0; dones (E,) bool is win or draw this move.
        ``new_state.action_mask`` is the next action mask the step wrote.
    """
    from ..ops.env_step import fused_step  # env_step imports this module

    new_state, rewards, dones, _ = fused_step(cfg, state, actions, active)
    return new_state, rewards, dones


def validate_step_inputs(
    cfg: EnvConfig,
    state: EnvState,
    actions: torch.Tensor,
    active: Optional[torch.Tensor] = None,
):
    """Opt-in debug invariants: action bounds + cell occupancy.

    Returns (out_of_bounds, occupied): two (E,) bool tensors, True = a
    violation, always False on inactive envs.
    """
    e = state.boards.shape[0]
    if active is None:
        active = torch.ones((e,), dtype=torch.bool, device=state.boards.device)
    mn = cfg.num_actions
    actions = actions.to(torch.int64)
    oob = ((actions < 0) | (actions >= mn)) & active
    safe_actions = actions.clamp(0, mn - 1)
    boards_any = (state.boards != 0.0).any(dim=1).reshape(e, mn)
    occ = torch.gather(boards_any, 1, safe_actions[:, None])[:, 0]
    return oob, occ & active & ~oob
