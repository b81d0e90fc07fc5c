"""The env step (K1) on the card, at the shapes where it has work.

Usage (from the repository root, one card)::

    python -m rl_selfplay_mnk_tpu_torch.utils.env_step_study [--out FILE]

At each of ``TIMED`` (9x9x5 at the main path's 384 envs and at bench.py's
8192, 13x13x5 at 384, 9x9x5 at a tournament half-pairing's 16), on mid-game
boards (20 random legal moves, then a random legal action for every env and
half of them active), it times the kernel and its plain version: device ms
a call from ``torch.profiler`` over ``ITERS`` launches, and ms a call
between CUDA events around ``ITERS`` calls after a warm-up (what a caller
pays, launch gaps included). It prints one JSON line a shape, with the bytes
the call must move (``k1_bytes``); ``--out`` also writes them to a file.
chip_smoke.py's timings phase calls ``time_k1``.

The file uses only the env, ``fused_step``, ``fused_step_reference`` and
``profiling.kernel_times``, which every version of the port's env-step
kernel has, so a copy of it in an older checkout of the package times that
checkout's kernel on the same inputs.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..env import EnvConfig, make_env_state
from ..ops.env_step import fused_step, fused_step_reference
from .profiling import kernel_times

# ((M, N, K), envs): the main path, bench.py's throughput mode, path B's
# 13x13 rollout, a tournament half-pairing.
TIMED = (((9, 9, 5), 384), ((9, 9, 5), 8192), ((13, 13, 5), 384), ((9, 9, 5), 16))
ITERS = 500
KERNEL_NAME = "env_step_kernel"


def k1_bytes(mnk, e: int) -> int:
    """What one call must move: the planes, player, move count, action
    (int64) and active flag read; the planes, player, move count, reward,
    done and mask written. No line table: the kernel reads none."""
    mn = mnk[0] * mnk[1]
    return e * (2 * mn * 4 + 4 + 4 + 8 + 1) + e * (2 * mn * 4 + 4 + 4 + 4 + 1 + mn)


def mid_game(cfg: EnvConfig, e: int, dev, seed: int = 2):
    """(state, actions, active): 20 random legal moves into every game, then
    a random legal action for each env and half of them active."""
    rng = np.random.default_rng(seed)

    def legal():
        mask = (state.boards.sum(1).reshape(e, -1) == 0).cpu().numpy()
        score = np.where(mask, rng.random(mask.shape), -1.0)
        return torch.as_tensor(score.argmax(axis=1), device=dev)

    state = make_env_state(cfg, e, dev)
    for _ in range(20):
        state = fused_step_reference(cfg, state, legal())[0]
    actions = legal()
    return state, actions, torch.as_tensor(rng.random(e) < 0.5, device=dev)


def event_ms(fn, iters: int) -> float:
    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(fn, iters: int, match: str = ""):
    """Device ms a call of the kernels whose name holds ``match``; None when
    the profiler reports no device time twice running (now and then it
    reports no events at all)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(t for name, (t, _) in kernel_times(prof).items() if match in name)
        if total_us > 0:
            return total_us / iters / 1e3
    return None


def time_k1(mnk, e: int, dev) -> dict:
    """K1 and its plain version at (M, N, K) and e envs. ``ms`` and
    ``plain_ms`` are device time (the event time where the profiler gives
    none), ``call_ms`` and ``plain_call_ms`` the event time a call."""
    cfg = EnvConfig(*mnk)
    state, actions, active = mid_game(cfg, e, dev)

    def kernel():
        fused_step(cfg, state, actions, active)

    def plain():
        fused_step_reference(cfg, state, actions, active)

    call = event_ms(kernel, ITERS)
    plain_call = event_ms(plain, 100)
    ms = profiled_ms(kernel, ITERS, KERNEL_NAME)
    plain_ms = profiled_ms(plain, 100)
    return {"shape": [*mnk, e], "ms": call if ms is None else ms, "call_ms": call,
            "plain_ms": plain_call if plain_ms is None else plain_ms,
            "plain_call_ms": plain_call, "bytes": k1_bytes(mnk, e),
            "device_time": ms is not None}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON lines to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("env_step_study: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(torch.cuda.get_device_name(0), flush=True)
    lines = [json.dumps(time_k1(mnk, e, dev)) for mnk, e in TIMED]
    for line in lines:
        print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
