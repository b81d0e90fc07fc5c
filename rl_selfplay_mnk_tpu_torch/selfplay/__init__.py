from .opponent_pool import OpponentPool
from .policies import NNPolicy, Policy, RandomPolicy, make_network_policy
from .validation import validate
from .wrapper import (
    SelfPlayState,
    canonical_obs,
    flip_channels,
    selfplay_reset,
    selfplay_step,
)

__all__ = [
    "Policy",
    "RandomPolicy",
    "NNPolicy",
    "make_network_policy",
    "SelfPlayState",
    "flip_channels",
    "canonical_obs",
    "selfplay_reset",
    "selfplay_step",
    "validate",
    "OpponentPool",
]
