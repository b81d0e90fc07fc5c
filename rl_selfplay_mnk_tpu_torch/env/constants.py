"""Game constants (same values as the JAX package's ``env/constants.py``)."""

PLAYER_BLACK = 0
PLAYER_WHITE = 1

CHANNEL_ME = 0
CHANNEL_ENEMY = 1

REWARD_WIN = 1.0
REWARD_LOSS = -1.0
REWARD_DRAW = 0.0
