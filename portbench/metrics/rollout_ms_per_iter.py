"""Device milliseconds of an iteration's rollout: CUDA events around the
rollout's calls into the program (the fused trainer's step replays, the
host loop's ``PPOLearner.rollout``), summed over the window's iterations."""

UNIT = "ms"
LAYER = "Rollout: alg/ppo.py rollout_step, selfplay/, env/ and K1, the networks' forwards"
SOURCE = "program_span"
MOVES = "env_steps_per_s"


def read(ctx, yardstick):
    ms = ctx["spans_ms"].get("rollout")
    iters = ctx["window"]["iterations"]
    return ms / iters if ms and iters else None
