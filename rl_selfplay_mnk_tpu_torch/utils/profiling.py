"""Where one training iteration's time goes, on the card.

Runs a training config (by default 9x9x5, ``resnet_b_s``, 384 envs,
n_steps 256, batch 8192, 4 epochs; ``--arch``, ``--mnk`` and ``--batch-size``
as in ``train.py``) for ``--warmup`` iterations, then traces one more
iteration with ``torch.profiler`` and prints: the wall time of the rollout
and the update, the device's busy time (sum of kernel times; one stream, so
no overlap) and idle share for each, the launches of the port's CUDA
kernels, and the kernels that take the most device time. The last line is
one JSON object with those numbers.

Usage::

    python -m rl_selfplay_mnk_tpu_torch.utils.profiling [--warmup 2] [--trace out.json]
    python -m rl_selfplay_mnk_tpu_torch.utils.profiling --arch transformer_b_s
    python -m rl_selfplay_mnk_tpu_torch.utils.profiling --arch transformer_b_s_w --mnk 13 13 5 --batch-size 4096
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from ..alg.schedules import entropy_coef_at
from ..models.fold_bn import snapshot
from ..models.registry import eval_apply
from ..ops.attention import (
    attention_folded_bwd,
    attention_folded_fwd,
    attention_packed_bwd,
    attention_packed_fwd,
)
from ..ops.env_step import fused_step
from ..ops.resblock import fused_residual_block
from ..selfplay.policies import NNPolicy
from ..train import build_config, create_learner
from .hardware import detect_hardware_config


# The port's kernel wrappers, by the name their launch counts are reported under.
PORT_KERNELS = {
    "env_step": fused_step,
    "resblock": fused_residual_block,
    "attn_folded_fwd": attention_folded_fwd,
    "attn_folded_bwd": attention_folded_bwd,
    "attn_packed_fwd": attention_packed_fwd,
    "attn_packed_bwd": attention_packed_bwd,
}


def reset_launches() -> None:
    for wrapper in PORT_KERNELS.values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {name: wrapper.launches for name, wrapper in PORT_KERNELS.items()}


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


def profile_iteration(warmup: int = 2, trace: str | None = None, top: int = 15,
                      arch: str | None = None, mnk=None, batch_size: int | None = None) -> dict:
    hw = detect_hardware_config("cuda")
    config = build_config(arch, mnk, batch_size)
    learner, _, _ = create_learner(config, hw)
    generator = torch.Generator(device=hw.device).manual_seed(1)
    ent = entropy_coef_at(config["entropy_coef"], config["entropy_coef_schedule"], 0,
                          config["num_envs"], config["n_steps"])
    for _ in range(warmup):
        learner.learn(NNPolicy(eval_apply, snapshot(learner.model), generator), ent)

    phases = {}
    kernels = {}
    launches = {}
    for phase in ("rollout", "update"):
        opponent = NNPolicy(eval_apply, snapshot(learner.model), generator)
        reset_launches()
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
        launches[phase] = read_launches()
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
    return {"device": torch.cuda.get_device_name(0), "architecture": config["architecture_name"],
            "mnk": list(config["mnk"]), "batch_size": config["batch_size"], "phases": phases,
            "port_kernel_launches": launches, "top_kernels": kernels}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--trace", default=None, help="write Chrome traces next to this path")
    parser.add_argument("--arch", default=None, help="architecture registry name")
    parser.add_argument("--mnk", type=int, nargs=3, default=None, metavar=("M", "N", "K"))
    parser.add_argument("--batch-size", type=int, default=None)
    args = parser.parse_args(argv)
    print(json.dumps(profile_iteration(args.warmup, args.trace, arch=args.arch, mnk=args.mnk,
                                       batch_size=args.batch_size)))


if __name__ == "__main__":
    main()
