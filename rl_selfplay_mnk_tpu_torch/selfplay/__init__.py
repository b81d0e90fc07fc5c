from .opponent_pool import OpponentPool
from .league import League, pfsp_weight
from .policies import BlockPolicy, NNPolicy, Policy, RandomPolicy, make_block_policy, make_network_policy
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
    "BlockPolicy",
    "make_block_policy",
    "SelfPlayState",
    "flip_channels",
    "canonical_obs",
    "selfplay_reset",
    "selfplay_step",
    "validate",
    "OpponentPool",
    "League",
    "pfsp_weight",
]
