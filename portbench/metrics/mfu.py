"""The whole step's share of the card's bf16 peak: the model FLOPs of the
window's iterations and validations (the learner's and the opponent's
forwards, the bootstrap, 3 forwards a sample and epoch for the update; no
recompute) over the window's wall seconds and 989 TFLOP/s, in percent."""

UNIT = "%"
LAYER = "Whole step"
SOURCE = "host_clock"
MOVES = "env_steps_per_s"


def read(ctx, yardstick):
    win = ctx["window"]
    if not win["iterations"] or win["wall_s"] <= 0:
        return None
    flops = win["iterations"] * yardstick.iteration_flops(ctx["cfg"], ctx["traffic"])
    flops += win["validation_boards"] * yardstick.forward_flops(ctx["cfg"])
    return 100.0 * flops / win["wall_s"] / yardstick.PEAK_MODEL_FLOPS
