from .constants import (
    CHANNEL_ENEMY,
    CHANNEL_ME,
    PLAYER_BLACK,
    PLAYER_WHITE,
    REWARD_DRAW,
    REWARD_LOSS,
    REWARD_WIN,
)
from .mnk_env import (
    EnvConfig,
    EnvState,
    action_mask,
    check_wins,
    make_env_state,
    observe,
    reset_where,
    step,
    validate_step_inputs,
)

__all__ = [
    "PLAYER_BLACK",
    "PLAYER_WHITE",
    "CHANNEL_ME",
    "CHANNEL_ENEMY",
    "REWARD_WIN",
    "REWARD_LOSS",
    "REWARD_DRAW",
    "EnvConfig",
    "EnvState",
    "make_env_state",
    "reset_where",
    "observe",
    "action_mask",
    "step",
    "check_wins",
    "validate_step_inputs",
]
