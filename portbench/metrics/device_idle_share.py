"""The share of one traced iteration in which no kernel ran on the card:
1 - (the union of the kernels' intervals) / (the iteration's host wall),
from a trace that records the card's activity alone (no host op is
recorded, so the eager launches keep their own pace)."""

UNIT = "fraction"
LAYER = "Device: one H100"
SOURCE = "device_trace"
MOVES = "env_steps_per_s"


def read(ctx, yardstick):
    prof = ctx["profile"]
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 1.0 - prof["busy_s"] / prof["window_s"]
