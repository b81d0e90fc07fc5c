"""Device milliseconds of the update a minibatch: CUDA events around the
update's calls into the program (the fused trainer's prepare and minibatch
replays, the host loop's ``PPOLearner.update``), over the window's
minibatch updates."""

UNIT = "ms"
LAYER = "PPO update: alg/ppo.py GAE, shuffle, train forward and backward, AdamW"
SOURCE = "program_span"
MOVES = "env_steps_per_s"


def read(ctx, yardstick):
    ms = ctx["spans_ms"].get("update")
    t = ctx["traffic"]
    updates = ctx["window"]["iterations"] * t["ppo_epochs"] * t["num_envs"] * t["n_steps"] \
        // t["batch_size"]
    return ms / updates if ms and updates else None
