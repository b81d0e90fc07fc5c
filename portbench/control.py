"""The readings that the limits of ``check.py`` are set from.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ... [--control 3]
        [--fault NAME] [--look]

For each seed: the cell's set-up (iteration 0 through the window's own
call, copied by the probe; no window), then the program's numbers against
the reference and, for the first ``--control`` seeds, the control's: the
reference in float8 put in the program's place (``check.control``). With
``--fault`` the program is broken underneath first (``FAULTS``), as the
comparison must see it. With ``--look``, also the leaf numbers of two
witnesses on the same seed: the reference in bfloat16, and the program's
own float32 path. Prints one JSON line a seed and, last, the largest and
smallest reading of each number by the program and the smallest by the
control.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def fault_half_batch():
    """Each update on half of its minibatch, the mean taken over the rest."""
    from rl_selfplay_mnk_tpu_torch.alg import fused, ppo

    original = ppo.minibatch_update

    def half(model, config, optimizer, flats, rows, *a, **k):
        return original(model, config, optimizer, flats, rows[: rows.shape[0] // 2], *a, **k)

    ppo.minibatch_update = fused.minibatch_update = half


def fault_reward():
    """The self-play step's reward altered where it is produced: env 0 is
    paid +1 more on every step."""
    import torch

    from rl_selfplay_mnk_tpu_torch.alg import ppo

    original = ppo.selfplay_step

    def paid(*a, **k):
        state, obs, rewards, dones = original(*a, **k)
        bump = (torch.arange(rewards.shape[0], device=rewards.device) == 0).to(rewards.dtype)
        return state, obs, rewards + bump, dones

    ppo.selfplay_step = paid


def fault_opponent():
    """The opponent's move altered where it is produced: a uniform legal
    cell in place of its policy's draw."""
    from rl_selfplay_mnk_tpu_torch.selfplay import wrapper

    original = wrapper._opponent_phase

    class Uniform:
        def __init__(self, policy):
            self.policy = policy

        def act(self, obs, deterministic=False):
            import torch

            mask = obs["action_mask"]
            noise = torch.rand(mask.shape, device=mask.device)
            return torch.where(mask, noise, torch.full_like(noise, -1.0)).argmax(-1)

    def phase(cfg, opponent, env, agent_side, eligible):
        return original(cfg, Uniform(opponent), env, agent_side, eligible)

    wrapper._opponent_phase = phase


FAULTS = {"half_batch": fault_half_batch, "reward": fault_reward, "opponent": fault_opponent}


@contextlib.contextmanager
def program_in_float32():
    """The program's own float32 path: its compute dtype float32 where it
    asks for its hardware, and no TF32 in its products."""
    import dataclasses

    import torch

    from portbench import harness, reference
    from rl_selfplay_mnk_tpu_torch import train, train_fused

    detect = train.detect_hardware_config

    def float32(device=None):
        return dataclasses.replace(detect(device), compute_dtype=torch.float32)

    reference.strict_float32()
    with harness.patched([(train, "detect_hardware_config", float32),
                          (train_fused, "detect_hardware_config", float32)]):
        yield


def first_iteration(cell: str, seed: int, device: str, traffic_overrides=None, dispatch=None):
    """(cfg, traffic, weights, record, layout): the cell's set-up through
    iteration 0, as the probe copied it."""
    import gc

    import torch

    from portbench import harness, reference, spec

    cfg, traffic = spec.cell(cell)
    traffic = {**traffic, **(traffic_overrides or {})}
    session = harness.SESSIONS[traffic["runner"]](cfg, traffic, seed, device,
                                                  harness.Spans(False), dispatch)
    weights = reference.make_weights(cfg, seed, device)
    session.run(weights, 0.0, setup_only=True)
    record, layout = session.probe.record, session.layout
    del session
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return cfg, traffic, weights, record, layout


def readings(cell: str, seeds, n_control: int = 0, device: str = "cuda",
             traffic_overrides=None, dispatch=None, look: bool = False) -> list:
    """One record a seed: the program's numbers, the worst leaves, each
    update's gradient norm on both sides and, for the first ``n_control``
    seeds, the control's numbers. With ``look``, also the numbers of the
    bfloat16 witness (``bf16``) and of the program's own float32 path on
    the same seed (``program_f32``)."""
    from portbench import check, reference

    out = []
    limits = {k: float("inf") for k in check.NUMBERS}
    for i, seed in enumerate(seeds):
        seed = seed % (1 << 62)
        cfg, traffic, weights, record, layout = first_iteration(cell, seed, device,
                                                                traffic_overrides, dispatch)
        verdict = check.judge(cfg, traffic, weights, record, layout, limits)
        rec = {"seed": seed, "program": verdict["numbers"], "worst": verdict["worst"],
               "grad_norms": verdict["grad_norms"], "left_out": verdict["left_out"]}
        if i < n_control:
            rec["control"] = check.control(cfg, traffic, weights, record, layout)
        if look:
            rec["bf16"] = check.control(cfg, traffic, weights, record, layout, reference.BF16)
            del record
            with program_in_float32():
                cfg, traffic, weights, record, layout = first_iteration(
                    cell, seed, device, traffic_overrides, dispatch)
                verdict = check.judge(cfg, traffic, weights, record, layout, limits)
            rec["program_f32"] = {**verdict["numbers"], "worst": verdict["worst"]}
        out.append(rec)
        print(json.dumps(rec), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=0, help="seeds that also read the control")
    p.add_argument("--fault", choices=sorted(FAULTS), default=None)
    p.add_argument("--look", action="store_true",
                   help="also the bfloat16 witness and the program's float32 path")
    args = p.parse_args(argv)
    if args.fault:
        FAULTS[args.fault]()
    recs = readings(args.workload, args.seeds, args.control, look=args.look)
    summary = {"workload": args.workload, "fault": args.fault, "seeds": len(recs),
               "program_max": {k: max(r["program"][k] for r in recs)
                               for k in recs[0]["program"]},
               "program_min": {k: min(r["program"][k] for r in recs)
                               for k in recs[0]["program"]}}
    ctl = [r["control"] for r in recs if "control" in r]
    if ctl:
        summary["control_min"] = {k: min(c[k] for c in ctl) for k in ctl[0] if k != "worst"}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
