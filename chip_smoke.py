#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check its kernels.

Usage (from the repository root, one card, no arguments)::

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. print the card's name and power limit (``nvidia-smi``); build the CUDA
   kernels from ``rl_selfplay_mnk_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together) and print the build time;
2. env-step kernel (K1) against its plain version over random legal
   playouts with random ``active`` masks: 3x3x3, 5x5x4 and 9x9x5 at
   E = 8192, 8191, 384 (rollout) and 256 (validation), 60 steps each; all
   six outputs bitwise equal;
3. residual-block kernel (K2) against its plain version (f32 products, TF32
   off) at B in {256, 384, 8191}, 9x9, C in {32, 64}, bf16 and f32, within the
   stated tolerances;
4. the train path: ``train_mnk`` at the default config (9x9x5,
   ``resnet_b_s``, 384 envs, n_steps 256, batch 8192, 4 epochs) for 6
   iterations, with both kernels' launch counters set to 0 just before and
   read just after; losses and explained variance finite, one validation,
   both counters above 0; then the trained network's eval forward through
   the kernels against the unfolded plain-conv f32 forward on real
   positions, beside a bf16 control without the kernels;
5. timings at the main path's shapes, after warm-up: device time per call
   from ``torch.profiler`` (``ms``, ``plain_ms``, ``library_ms``) and the
   per-call time between CUDA events (``call_ms``...) for each kernel, its
   plain version, and for K2 a two-``F.conv2d`` block as the library
   yardstick (the port never calls it); one ``kernels`` JSON line.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

K1_SHAPES = ((3, 3, 3), (5, 5, 4), (9, 9, 5))
K1_ENVS = (8192, 8191, 384, 256)  # large, odd, and the rollout and validation batches
K1_STEPS = 60
K2_CASES = [(b, c) for b in (256, 384, 8191) for c in (32, 64)]
# |kernel - plain| <= atol + rtol * |plain|
K2_TOL = {
    "float32": (1e-4, 1e-4),  # f32 sums over 9C <= 576 products, in another order
    "bfloat16": (2.0**-6, 2.0**-6),  # output rounding to bf16 plus 1-ulp flips of bf16 h
}
# Eval forward against plain f32: the larger of these and twice the bf16
# control's own error. A move probability is ~1/81 = 0.012, a value in [-1, 1].
EVAL_TOL = {"p": 1e-3, "v": 1.5e-2}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor-core bf16; f32 outside


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Per-call time between CUDA events around ``iters`` calls: what a
    caller pays, launch gaps included."""
    import torch

    for _ in range(warmup):
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


def device_ms(fn, iters: int = 50, match: str = ""):
    """Per-call device time of the kernels whose name contains ``match``
    (all kernels when empty), from ``torch.profiler``; None when the
    profiler reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rl_selfplay_mnk_tpu_torch.utils.profiling import kernel_times

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(t for name, (t, _) in kernel_times(prof).items() if match in name)
    return total_us / iters / 1e3 if total_us > 0 else None


def timed(fn, match: str = "", iters: int = 100):
    """(device ms per call, or the event time when the profiler has none;
    event ms per call)."""
    call = time_ms(fn, iters=iters)
    dev = device_ms(fn, iters=min(iters, 50), match=match)
    if dev is None:
        print("profiler reported no device time; using CUDA-event time")
    return (dev if dev is not None else call), call


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_legal_actions(rng, mask):
    """Uniform legal cell per row (cell 0 where the board is full)."""
    import numpy as np

    score = np.where(mask, rng.random(mask.shape), -1.0)
    return score.argmax(axis=1)


def phase_k1(torch, np, dev):
    from rl_selfplay_mnk_tpu_torch.env import EnvConfig, make_env_state, reset_where
    from rl_selfplay_mnk_tpu_torch.ops.env_step import fused_step, fused_step_reference

    rng = np.random.default_rng(0)
    max_err = 0.0
    for m, n, k in K1_SHAPES:
        cfg = EnvConfig(m, n, k)
        for e in K1_ENVS:
            state = make_env_state(cfg, e, dev)
            mask = np.ones((e, m * n), bool)
            for t in range(K1_STEPS):
                actions = torch.as_tensor(random_legal_actions(rng, mask), device=dev)
                active = torch.as_tensor(rng.random(e) < 0.8, device=dev)
                got = fused_step(cfg, state, actions, active)
                want = fused_step_reference(cfg, state, actions, active)
                pairs = {
                    "boards": (got[0].boards, want[0].boards),
                    "player": (got[0].current_player, want[0].current_player),
                    "move_count": (got[0].move_count, want[0].move_count),
                    "rewards": (got[1], want[1]),
                    "dones": (got[2], want[2]),
                    "mask": (got[3], want[3]),
                    "state mask": (got[0].action_mask, want[0].action_mask),
                }
                for name, (g, w) in pairs.items():
                    max_err = max(max_err, float((g.double() - w.double()).abs().max()))
                    if g.dtype != w.dtype or not torch.equal(g, w):
                        raise AssertionError(f"K1 {m}x{n}x{k} E={e} step {t}: {name} differs")
                # Half of the finished games go on being played past their end.
                again = got[2] & torch.as_tensor(rng.random(e) < 0.5, device=dev)
                state = reset_where(got[0], again)
                mask = (state.boards.sum(1).reshape(e, -1) == 0).cpu().numpy()
            print(f"K1 {m}x{n}x{k} E={e}: {K1_STEPS} steps, all six outputs bitwise equal")
    return max_err


def k2_inputs(torch, b, c, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.relu(torch.randn(b, 81, c, device=dev, generator=g)).to(dtype)
    w1 = (torch.randn(9 * c, c, device=dev, generator=g) * 0.1).to(dtype)
    w2 = (torch.randn(9 * c, c, device=dev, generator=g) * 0.1).to(dtype)
    b1 = torch.randn(c, device=dev, generator=g) * 0.1
    b2 = torch.randn(c, device=dev, generator=g) * 0.1
    return x, w1, b1, w2, b2


def phase_k2(torch, dev):
    from rl_selfplay_mnk_tpu_torch.ops.resblock import (
        fused_residual_block,
        fused_residual_block_reference,
    )

    errors = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        atol, rtol = K2_TOL[name]
        for b, c in K2_CASES:
            args = k2_inputs(torch, b, c, dtype, dev)
            got = fused_residual_block(*args, 9, 9).float()
            want = fused_residual_block_reference(*args, 9, 9).float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            max_err = float(err.max())
            worst = float((err - rtol * want.abs()).max())
            ok = bool(torch.isfinite(got).all()) and worst <= atol
            print(f"K2 {name} B={b} C={c}: max_abs_err {max_err:.3e} "
                  f"(tolerance {atol:.2e} + {rtol:.2e}*|ref|) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K2 {name} B={b} C={c} outside its tolerance")
            errors[(name, b, c)] = max_err
    return errors


def phase_train(torch, dev):
    from rl_selfplay_mnk_tpu_torch.ops.env_step import fused_step
    from rl_selfplay_mnk_tpu_torch.ops.resblock import fused_residual_block
    from rl_selfplay_mnk_tpu_torch.train import get_default_config, train_mnk

    config = get_default_config()
    config["total_environment_steps"] = 6 * config["num_envs"] * config["n_steps"]
    config["run_name"] = "chip_smoke"
    fused_step.launches = 0
    fused_residual_block.launches = 0
    t0 = time.perf_counter()
    summary = train_mnk(config, device=str(dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"env_step": fused_step.launches, "resblock": fused_residual_block.launches}

    if summary["errors"]:
        raise AssertionError(f"training iterations failed: {summary['errors']}")
    its = summary["iterations"]
    if len(its) != 6:
        raise AssertionError(f"expected 6 iterations, got {len(its)}")
    for i, m in enumerate(its):
        for key in ("actor_loss", "critic_loss", "entropy_loss", "explained_variance", "grad_norm"):
            if not math.isfinite(m[key]):
                raise AssertionError(f"iteration {i}: {key} = {m[key]}")
        print(f"train iter {i}: fps {m['fps']:.1f} rollout_time {m['rollout_time']:.3f}s "
              f"learn_time {m['learn_time']:.3f}s explained_var {m['explained_variance']:.3f}")
    if len(summary["validations"]) != 1:
        raise AssertionError(f"expected one validation, got {len(summary['validations'])}")
    keys = {"win_rate", "loss_rate", "draw_rate", "score_rate", "games_played"}
    if set(summary["validations"][0]) != {f"validation/vs_benchmark/{k}" for k in keys}:
        raise AssertionError(f"validation keys: {sorted(summary['validations'][0])}")
    print(f"validation: {json.dumps(summary['validations'][0])}")
    print(f"train: 6 iterations in {wall:.1f}s, launches {json.dumps(launches)}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the train path")
    return launches, summary["model"]


def phase_eval_check(torch, np, dev, model):
    """The trained network's eval forward (folded BN, residual blocks through
    K2, bf16) against its unfolded eval forward with plain f32 convolutions.
    The same unfolded forward in bf16, without the kernels, is the control:
    it shows what bf16 rounding alone moves."""
    from rl_selfplay_mnk_tpu_torch.env import EnvConfig, make_env_state, step
    from rl_selfplay_mnk_tpu_torch.models.common import conv3x3
    from rl_selfplay_mnk_tpu_torch.models.registry import eval_apply

    rng = np.random.default_rng(1)
    cfg = EnvConfig(9, 9, 5)
    state = make_env_state(cfg, 256, dev)
    for _ in range(12):
        mask = state.action_mask.cpu().numpy()
        state, _, _ = step(cfg, state, torch.as_tensor(random_legal_actions(rng, mask), device=dev))
    obs = state.boards

    def plain_forward(dtype):
        with torch.no_grad():
            x = torch.relu(model.bn_in(conv3x3(obs, model.conv_in, dtype), False))
            for blk in model.blocks:
                x = blk(x, False, dtype)
            return model.heads(x.permute(0, 2, 3, 1), dtype)

    ref_logits, ref_value = plain_forward(torch.float32)
    ref_p = torch.softmax(ref_logits.float(), -1)

    def errors(logits, value):
        dp = float((torch.softmax(logits.float(), -1) - ref_p).abs().max())
        return dp, float((value.float() - ref_value.float()).abs().max())

    p_err, v_err = errors(*eval_apply(model, obs))
    cp_err, cv_err = errors(*plain_forward(torch.bfloat16))
    p_tol, v_tol = max(EVAL_TOL["p"], 2 * cp_err), max(EVAL_TOL["v"], 2 * cv_err)
    print(f"eval forward (kernels, bf16) vs plain f32 forward: max |dp| {p_err:.3e}, "
          f"max |dv| {v_err:.3e}; bf16 control without kernels: max |dp| {cp_err:.3e}, "
          f"max |dv| {cv_err:.3e}; tolerance |dp| {p_tol:.3e}, |dv| {v_tol:.3e}")
    if not (p_err <= p_tol and v_err <= v_tol):
        raise AssertionError("eval forward disagrees with the plain forward")


def phase_timings(torch, np, dev, launches, k1_error, k2_errors):
    import torch.nn.functional as F

    from rl_selfplay_mnk_tpu_torch.env import EnvConfig, make_env_state
    from rl_selfplay_mnk_tpu_torch.env.lines import num_lines
    from rl_selfplay_mnk_tpu_torch.ops.env_step import fused_step, fused_step_reference
    from rl_selfplay_mnk_tpu_torch.ops.resblock import (
        fused_residual_block,
        fused_residual_block_reference,
    )

    # K1 at the main path's shape: 384 envs mid-game on 9x9x5.
    rng = np.random.default_rng(2)
    cfg, e, mn = EnvConfig(9, 9, 5), 384, 81
    state = make_env_state(cfg, e, dev)
    for _ in range(20):
        mask = (state.boards.sum(1).reshape(e, -1) == 0).cpu().numpy()
        state, _, _, _ = fused_step(cfg, state, torch.as_tensor(random_legal_actions(rng, mask), device=dev))
    mask = (state.boards.sum(1).reshape(e, -1) == 0).cpu().numpy()
    actions = torch.as_tensor(random_legal_actions(rng, mask), device=dev)
    active = torch.as_tensor(rng.random(e) < 0.5, device=dev)
    k1_ms, k1_call = timed(lambda: fused_step(cfg, state, actions, active), "env_step_kernel", 500)
    k1_plain, k1_plain_call = timed(lambda: fused_step_reference(cfg, state, actions, active))
    lines = num_lines(9, 9, 5)
    k1_bytes = (e * 2 * mn * 4 + e * (4 + 4 + 8 + 1) + lines * 5 * 4  # read
                + e * 2 * mn * 4 + e * (4 + 4 + 4 + 1) + e * mn)  # write
    k1_ops = e * (2 * mn + lines * 5 + 8)  # placement, line sums, flags
    k1_bound, k1_by = bound(k1_bytes, k1_ops, "float32")

    # K2 at the main path's shape: 384 boards, 9x9, C=32, bf16.
    b, c = 384, 32
    x, w1, b1, w2, b2 = k2_inputs(torch, b, c, torch.bfloat16, dev, seed=3)
    k2_ms, k2_call = timed(lambda: fused_residual_block(x, w1, b1, w2, b2, 9, 9), "resblock_kernel")
    k2_plain, k2_plain_call = timed(
        lambda: fused_residual_block_reference(x, w1, b1, w2, b2, 9, 9), iters=50
    )
    cw1 = w1.reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous()
    cw2 = w2.reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous()
    cb1, cb2 = b1.to(torch.bfloat16), b2.to(torch.bfloat16)
    x_nchw = x.view(b, 9, 9, c).permute(0, 3, 1, 2)

    def library_block():
        h = torch.relu(F.conv2d(x_nchw, cw1, cb1, padding=1))
        return torch.relu(F.conv2d(h, cw2, cb2, padding=1) + x_nchw)

    k2_lib, k2_lib_call = timed(library_block)
    k2_bytes = 2 * x.numel() * 2 + 2 * w1.numel() * 2 + 2 * c * 4
    k2_ops = 2 * (2 * b * 81 * 9 * c * c)
    k2_bound, k2_by = bound(k2_bytes, k2_ops, "bfloat16")

    kernels = [
        {
            "name": "env_step",
            "route": "cuda",
            "source": "rl_selfplay_mnk_tpu_torch/csrc/env_step.cu",
            "replaces": "rl_selfplay_mnk_tpu/ops/pallas_env.py:28",
            "launches": launches["env_step"],
            "max_abs_err": k1_error,
            "ms": k1_ms,
            "plain_ms": k1_plain,
            "bound_ms": k1_bound,
            "bound_by": k1_by,
            "library_ms": None,
            "call_ms": k1_call,
            "plain_call_ms": k1_plain_call,
            "library_call_ms": None,
        },
        {
            "name": "resblock",
            "route": "cuda",
            "source": "rl_selfplay_mnk_tpu_torch/csrc/resblock.cu",
            "replaces": "rl_selfplay_mnk_tpu/ops/pallas_resnet.py:67",
            "launches": launches["resblock"],
            "max_abs_err": k2_errors[("bfloat16", 384, 32)],
            "ms": k2_ms,
            "plain_ms": k2_plain,
            "bound_ms": k2_bound,
            "bound_by": k2_by,
            "library_ms": k2_lib,
            "call_ms": k2_call,
            "plain_call_ms": k2_plain_call,
            "library_call_ms": k2_lib_call,
        },
    ]
    for k in kernels:
        print(f"timing {k['name']}: device {k['ms']:.5f} ms, per call {k['call_ms']:.5f} ms; "
              f"plain device {k['plain_ms']:.5f} ms, per call {k['plain_call_ms']:.5f} ms; "
              f"library {k['library_ms']} / {k['library_call_ms']} ms; "
              f"bound {k['bound_ms']:.5f} ms by {k['bound_by']}")
    return kernels


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from rl_selfplay_mnk_tpu_torch.ops import cuda_build
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing: {exc}", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f}s for {', '.join(cuda_build.SOURCES)}")

    k1_error = phase_k1(torch, np, dev)
    k2_errors = phase_k2(torch, dev)
    launches, model = phase_train(torch, dev)
    phase_eval_check(torch, np, dev, model)
    kernels = phase_timings(torch, np, dev, launches, k1_error, k2_errors)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
