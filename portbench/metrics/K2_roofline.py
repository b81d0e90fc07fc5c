"""K2's share of its roofline in one traced iteration: the least time of
the calls the iteration needs (the BN-folded residual block (ops/resblock.py): the opponent's blocks a rollout step; ``yardstick.kernel_work``) over the
device time of the kernels of that name in the trace, in percent. Nothing
where the trace has none."""

UNIT = "%"
LAYER = "Kernels"
SOURCE = "device_trace"
MOVES = "env_steps_per_s"
KERNEL = "K2"


def read(ctx, yardstick):
    prof = ctx["profile"]
    work = yardstick.kernel_work(ctx["cfg"], ctx["traffic"]).get(KERNEL)
    if not prof or work is None:
        return None
    match, bound = work
    device = sum(sec for name, (sec, _) in prof["kernels"].items() if match in name)
    return 100.0 * bound / device if device > 0 else None
