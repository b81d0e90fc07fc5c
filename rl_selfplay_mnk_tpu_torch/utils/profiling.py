"""Where one training iteration's time goes, on the card.

Runs the default training config (9x9x5, ``resnet_b_s``, 384 envs,
n_steps 256, batch 8192, 4 epochs) for ``--warmup`` iterations, then traces
one more iteration with ``torch.profiler`` and prints: the wall time of the
rollout and the update, the device's busy time (sum of kernel times; one
stream, so no overlap) and idle share for each, the launches of the port's
two CUDA kernels, and the kernels that take the most device time. The last
line is one JSON object with those numbers.

Usage::

    python -m rl_selfplay_mnk_tpu_torch.utils.profiling [--warmup 2] [--trace out.json]
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from ..alg.schedules import entropy_coef_at
from ..models.fold_bn import fold_batchnorm
from ..models.registry import eval_apply
from ..ops.env_step import fused_step
from ..ops.resblock import fused_residual_block
from ..selfplay.policies import NNPolicy
from ..train import create_learner, get_default_config
from .hardware import detect_hardware_config


def kernel_times(prof) -> dict:
    """kernel name -> (total device microseconds, launches). User
    annotations (e.g. the optimizer step's range) are spans, not kernels."""
    out = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        annotation = getattr(evt, "is_user_annotation", False)
        if evt.device_type == torch.autograd.DeviceType.CUDA and not annotation:
            rec = out[evt.name]
            rec[0] += evt.device_time_total
            rec[1] += 1
    return out


def profile_iteration(warmup: int = 2, trace: str | None = None, top: int = 15) -> dict:
    hw = detect_hardware_config("cuda")
    config = get_default_config()
    learner, _, _ = create_learner(config, hw)
    generator = torch.Generator(device=hw.device).manual_seed(1)
    ent = entropy_coef_at(config["entropy_coef"], config["entropy_coef_schedule"], 0,
                          config["num_envs"], config["n_steps"])
    for _ in range(warmup):
        learner.learn(NNPolicy(eval_apply, fold_batchnorm(learner.model), generator), ent)

    phases = {}
    kernels = {}
    launches = {}
    for phase in ("rollout", "update"):
        opponent = NNPolicy(eval_apply, fold_batchnorm(learner.model), generator)
        fused_step.launches = fused_residual_block.launches = 0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if phase == "rollout":
                traj, _ = learner.rollout(opponent)
            else:
                learner.update(traj, ent)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if trace:
            prof.export_chrome_trace(trace.replace(".json", f".{phase}.json"))
        times = kernel_times(prof)
        busy = sum(t for t, _ in times.values()) / 1e6
        phases[phase] = {"wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
                         "kernel_launches": sum(c for _, c in times.values())}
        launches[phase] = {"env_step": fused_step.launches, "resblock": fused_residual_block.launches}
        kernels[phase] = sorted(
            ({"name": k[:90], "device_ms": t / 1e3, "count": c} for k, (t, c) in times.items()),
            key=lambda r: -r["device_ms"],
        )[:top]

    for phase, rec in phases.items():
        print(f"{phase}: wall {rec['wall_s']:.3f}s, device busy {rec['device_busy_s']:.3f}s, "
              f"idle share {rec['idle_share']:.3f}, {rec['kernel_launches']} kernel launches, "
              f"port kernels {json.dumps(launches[phase])}")
        for r in kernels[phase]:
            print(f"  {r['device_ms']:9.3f} ms {r['count']:7d}x  {r['name']}")
    return {"device": torch.cuda.get_device_name(0), "phases": phases,
            "port_kernel_launches": launches, "top_kernels": kernels}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--trace", default=None, help="write Chrome traces next to this path")
    args = parser.parse_args(argv)
    print(json.dumps(profile_iteration(args.warmup, args.trace)))


if __name__ == "__main__":
    main()
