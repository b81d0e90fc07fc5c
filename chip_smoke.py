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
4. the four attention kernels (K3 folded forward, K4 folded backward, K8
   packed forward, K9 packed backward) against their plain versions, bf16
   and f32, at the shapes the train paths give them (update minibatch,
   rollout and validation batch) and at odd, small and wide ones, within
   the stated tolerances;
5. the ResNet train path: ``train_mnk`` at the default config (9x9x5,
   ``resnet_b_s``, 384 envs, n_steps 256, batch 8192, 4 epochs) for 3
   iterations with a validation after the third, every kernel's launch
   counter set to 0 just before and read just after; losses and explained
   variance finite, one validation, K1's and K2's counters above 0; then
   the trained network's eval forward through the kernels against the
   unfolded plain-conv f32 forward on real positions, beside a bf16 control
   without the kernels;
6. train path A: the same trainer with ``transformer_b_s`` and the
   transformer family's hyper-parameters (9x9x5, batch 8192) for 6
   iterations with one validation; K1's and the folded pair's counters above
   0, the packed pair's 0;
7. train path B: ``transformer_b_s_w`` on 13x13x5 (batch 4096) for 3
   iterations with one validation; K1's and the packed pair's counters
   above 0, the folded pair's 0; then the trained network's bf16 forward
   through the kernels against its f32 forward with the plain attention on
   real positions, beside a bf16 control with the plain attention;
8. timings at the paths' shapes, after warm-up: device time per call from
   ``torch.profiler`` (``ms``, ``plain_ms``, ``library_ms``) and the
   per-call time between CUDA events (``call_ms``...) for each kernel, its
   plain version and a library yardstick that the port never calls (two
   ``F.conv2d`` for K2, ``F.scaled_dot_product_attention`` for the attention
   kernels: its forward, and forward plus backward beside the backward
   kernels); each attention kernel at its update minibatch and at the
   rollout batch of 384; both attention pairs at one shape of either kind,
   transposes included, for the folded/packed threshold; one ``kernels``
   JSON line.

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
# (B, L, H, Dh). First the shapes the train paths give each pair: the update
# minibatch, the rollout batch of 384 and the validation batch of 256. Then
# an odd batch, 13x13 tokens and a 3x3 board for the folded pair; for the
# packed pair also Dh = 32, four heads of 64 (the largest head of the
# registry) and a head width that is not 16-byte aligned.
ATTN_FOLDED_SHAPES = ((8192, 81, 4, 14), (384, 81, 4, 14), (256, 81, 4, 14),
                      (383, 81, 4, 14), (64, 169, 8, 12), (8, 9, 4, 14))
ATTN_PACKED_SHAPES = ((4096, 169, 2, 64), (384, 169, 2, 64), (256, 169, 2, 64),
                      (384, 81, 3, 32), (383, 169, 2, 64), (64, 169, 4, 64), (4, 81, 4, 14))
# f32: |kernel - plain| <= 2e-5 * (1 + |plain|): sums over Dh <= 64 and
# L <= 169 terms in another order.
ATTN_F32_TOL = 2e-5
# bf16: both sides do the same f32 arithmetic up to the order of the sums, so
# an element differs only where that lands across a rounding step of the
# output (one ulp, at most 2^-7 of the value) or of a rounded p or ds (one
# term of a sum over L moves by 2^-7 of itself). Per output tensor:
# |kernel - plain| <= 2^-7 * |plain| + 2^-10 * max|plain|, and at most
# 2^-9 of the elements (plus 4, for the smallest tensors) differ at all. With inputs from randn the gradients
# are about 0.12 with a maximum of 2-4, so the limit at a typical element is
# about 3% of it. Measured on an NVIDIA H100 80GB HBM3, 700.00 W: the absolute part
# needed is at most 3.8e-4 * max|plain|, the share that differs at most 3.3e-4.
ATTN_BF16_RTOL, ATTN_BF16_ATOL_OF_MAX, ATTN_BF16_DIFFER_SHARE = 2.0**-7, 2.0**-10, 2.0**-9
# The shapes the train paths give the attention kernels: (update minibatch,
# rollout batch) x (L, H, Dh).
ATTN_PATH_SHAPES = {"folded": ((8192, 384), (81, 4, 14)), "packed": ((4096, 384), (169, 2, 64))}
ATTN_KERNELS = {
    "attn_folded_fwd": ("folded", False, "rl_selfplay_mnk_tpu/ops/pallas_attention.py:54"),
    "attn_folded_bwd": ("folded", True, "rl_selfplay_mnk_tpu/ops/pallas_attention.py:147"),
    "attn_packed_fwd": ("packed", False, "rl_selfplay_mnk_tpu/ops/pallas_attention.py:303"),
    "attn_packed_bwd": ("packed", True, "rl_selfplay_mnk_tpu/ops/pallas_attention.py:575"),
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


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


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


def timed(fn, match: str = "", iters: int = 100, warmup: int = 10):
    """(device ms per call, or the event time when the profiler has none;
    event ms per call)."""
    call = time_ms(fn, iters=iters, warmup=warmup)
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


def attn_inputs(torch, dev, dtype, b, l, h, dh, packed, n=4, seed=0):
    """q, k, v (and dO) for one attention call, in the layout of its pair."""
    g = torch.Generator(device=dev).manual_seed(seed + 7 * b + l)
    shape = (b, l, h * dh) if packed else (b * h, dh, l)
    return [torch.randn(shape, device=dev, generator=g).to(dtype) for _ in range(n)]


def attn_functions(pair):
    """(forward wrapper, backward wrapper, forward plain, backward plain)."""
    from rl_selfplay_mnk_tpu_torch.ops import attention as attn

    if pair == "packed":
        return (attn.attention_packed_fwd, attn.attention_packed_bwd,
                attn.attention_packed_reference, attn.attention_packed_bwd_reference)
    return (attn.attention_folded_fwd, attn.attention_folded_bwd,
            attn.attention_folded_reference, attn.attention_folded_bwd_reference)


def attn_excess(torch, got, want):
    """How far ``got`` is from ``want`` (one output of an attention kernel and
    of its plain version) as a share of its limit: (max abs error, the worst
    error over its limit, the share of elements that differ over its limit;
    the last is 0 for f32). Within tolerance when neither share exceeds 1."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if got.dtype == torch.float32:
        limit, differ = ATTN_F32_TOL * (1.0 + w.abs()), 0.0
    else:
        limit = ATTN_BF16_RTOL * w.abs() + ATTN_BF16_ATOL_OF_MAX * float(w.abs().max())
        differ = float((err > 0).sum()) / (ATTN_BF16_DIFFER_SHARE * err.numel() + 4)
    if not bool(torch.isfinite(g).all()):
        return float("inf"), float("inf"), differ
    return float(err.max()), float((err / limit).max()), differ


def phase_attention(torch, dev):
    """K3, K4, K8, K9 against their plain versions; returns the max abs
    error per (kernel, dtype, shape)."""
    errors = {}
    worst = {"float32": 0.0, "bfloat16": 0.0, "differ": 0.0}
    for pair, shapes in (("folded", ATTN_FOLDED_SHAPES), ("packed", ATTN_PACKED_SHAPES)):
        fwd, bwd, fwd_ref, bwd_ref = attn_functions(pair)
        for dtype in (torch.bfloat16, torch.float32):
            name = dtype_name(dtype)
            for b, l, h, dh in shapes:
                q, k, v, do = attn_inputs(torch, dev, dtype, b, l, h, dh, pair == "packed")
                extra = (h, dh) if pair == "packed" else ()
                got = {"o": fwd(q, k, v, *extra)}
                torch.cuda.synchronize()
                got.update(zip(("dq", "dk", "dv"), bwd(q, k, v, do, *extra)))
                torch.cuda.synchronize()
                want = {"o": fwd_ref(q, k, v, *extra)}
                want.update(zip(("dq", "dk", "dv"), bwd_ref(q, k, v, do, *extra)))
                errs, shares = {}, {}
                for key in got:
                    errs[key], of_limit, differ = attn_excess(torch, got[key], want[key])
                    shares[key] = max(of_limit, differ)
                    worst[name] = max(worst[name], of_limit)
                    worst["differ"] = max(worst["differ"], differ)
                    if not shares[key] <= 1.0:
                        raise AssertionError(
                            f"attention {pair} {name} (B, L, H, Dh)={(b, l, h, dh)}: {key} outside its "
                            f"tolerance: max abs err {errs[key]:.3e}, worst error {of_limit:.2f} of its "
                            f"limit, differing elements {differ:.2f} of theirs")
                print(f"attention {pair} {name} (B, L, H, Dh)={(b, l, h, dh)}: max_abs_err "
                      + ", ".join(f"{key} {e:.3e}" for key, e in errs.items())
                      + f"; worst share of the limit {max(shares.values()):.2f} ok")
                errors[(f"attn_{pair}_fwd", name, (b, l, h, dh))] = errs["o"]
                errors[(f"attn_{pair}_bwd", name, (b, l, h, dh))] = max(
                    errs["dq"], errs["dk"], errs["dv"])
    print(f"attention: worst error as a share of its limit: f32 {worst['float32']:.2f} "
          f"(limit {ATTN_F32_TOL:.0e} * (1 + |ref|)), bf16 {worst['bfloat16']:.2f} "
          f"(limit 2^-7 * |ref| + 2^-10 * max|ref|); bf16 elements that differ: "
          f"{worst['differ']:.2f} of the 2^-9 (+ 4 elements) allowed")
    return errors


def phase_train(torch, dev, label, config, iterations, launched, not_launched=()):
    """``iterations`` of ``train_mnk`` with ``config``: every kernel's launch
    count set to 0 just before and read just after. Kernels in ``launched``
    must have run, those in ``not_launched`` must not."""
    from rl_selfplay_mnk_tpu_torch.train import train_mnk
    from rl_selfplay_mnk_tpu_torch.utils.profiling import read_launches, reset_launches

    config["total_environment_steps"] = iterations * config["num_envs"] * config["n_steps"]
    config["run_name"] = f"chip_smoke_{label}"
    reset_launches()
    t0 = time.perf_counter()
    summary = train_mnk(config, device=str(dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()

    if summary["errors"]:
        raise AssertionError(f"{label}: training iterations failed: {summary['errors']}")
    its = summary["iterations"]
    if len(its) != iterations:
        raise AssertionError(f"{label}: expected {iterations} iterations, got {len(its)}")
    for i, m in enumerate(its):
        for key in ("actor_loss", "critic_loss", "entropy_loss", "explained_variance", "grad_norm"):
            if not math.isfinite(m[key]):
                raise AssertionError(f"{label} iteration {i}: {key} = {m[key]}")
        print(f"{label} iter {i}: fps {m['fps']:.1f} rollout_time {m['rollout_time']:.3f}s "
              f"learn_time {m['learn_time']:.3f}s explained_var {m['explained_variance']:.3f}")
    if len(summary["validations"]) != 1:
        raise AssertionError(f"{label}: expected one validation, got {len(summary['validations'])}")
    keys = {"win_rate", "loss_rate", "draw_rate", "score_rate", "games_played"}
    if set(summary["validations"][0]) != {f"validation/vs_benchmark/{k}" for k in keys}:
        raise AssertionError(f"{label}: validation keys: {sorted(summary['validations'][0])}")
    print(f"{label} validation: {json.dumps(summary['validations'][0])}")
    print(f"{label}: {iterations} iterations in {wall:.1f}s, launches {json.dumps(launches)}")
    for name in launched:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: kernel {name} was not launched on the train path")
    for name in not_launched:
        if launches[name] != 0:
            raise AssertionError(f"{label}: kernel {name} was launched {launches[name]} times")
    return launches, summary["model"]


def real_positions(torch, np, dev, mnk, envs, moves, seed):
    """Observations after ``moves`` random legal moves on ``envs`` boards."""
    from rl_selfplay_mnk_tpu_torch.env import EnvConfig, make_env_state, step

    rng = np.random.default_rng(seed)
    cfg = EnvConfig(*mnk)
    state = make_env_state(cfg, envs, dev)
    for _ in range(moves):
        mask = state.action_mask.cpu().numpy()
        state, _, _ = step(cfg, state, torch.as_tensor(random_legal_actions(rng, mask), device=dev))
    return state.boards


def eval_check(torch, label, kernel_forward, plain_forward):
    """The trained network's eval forward through the kernels (bf16) against
    its plain f32 forward. The plain forward in bf16, without the kernels, is
    the control: it shows what bf16 rounding alone moves."""
    ref_logits, ref_value = plain_forward(torch.float32)
    ref_p = torch.softmax(ref_logits.float(), -1)

    def errors(logits, value):
        dp = float((torch.softmax(logits.float(), -1) - ref_p).abs().max())
        return dp, float((value.float() - ref_value.float()).abs().max())

    p_err, v_err = errors(*kernel_forward())
    cp_err, cv_err = errors(*plain_forward(torch.bfloat16))
    p_tol, v_tol = max(EVAL_TOL["p"], 2 * cp_err), max(EVAL_TOL["v"], 2 * cv_err)
    print(f"{label} eval forward (kernels, bf16) vs plain f32 forward: max |dp| {p_err:.3e}, "
          f"max |dv| {v_err:.3e}; bf16 control without kernels: max |dp| {cp_err:.3e}, "
          f"max |dv| {cv_err:.3e}; tolerance |dp| {p_tol:.3e}, |dv| {v_tol:.3e}")
    if not (p_err <= p_tol and v_err <= v_tol):
        raise AssertionError(f"{label}: eval forward disagrees with the plain forward")


def phase_eval_check(torch, np, dev, model):
    """The trained ResNet's eval forward (folded BN, residual blocks through
    K2, bf16) against its unfolded eval forward with plain convolutions."""
    from rl_selfplay_mnk_tpu_torch.models.common import conv3x3
    from rl_selfplay_mnk_tpu_torch.models.registry import eval_apply

    obs = real_positions(torch, np, dev, (9, 9, 5), 256, 12, seed=1)

    def plain_forward(dtype):
        with torch.no_grad():
            x = torch.relu(model.bn_in(conv3x3(obs, model.conv_in, dtype), False))
            for blk in model.blocks:
                x = blk(x, False, dtype)
            return model.heads(x.permute(0, 2, 3, 1), dtype)

    eval_check(torch, "resnet_b_s", lambda: eval_apply(model, obs), plain_forward)


def plain_tiny_head_attention(query, key, value):
    """``tiny_head_attention`` through the plain version, on any device."""
    from rl_selfplay_mnk_tpu_torch.ops.attention import attention_packed_reference

    b, l, h, dh = query.shape
    packed = (t.reshape(b, l, h * dh) for t in (query, key, value))
    return attention_packed_reference(*packed, h, dh).reshape(b, l, h, dh)


def phase_transformer_eval_check(torch, np, dev, model, mnk):
    """The trained transformer's bf16 eval forward through the attention
    kernels against its f32 forward with the plain attention."""
    import copy

    from rl_selfplay_mnk_tpu_torch.models import snapshot, transformer
    from rl_selfplay_mnk_tpu_torch.models.registry import eval_apply
    from rl_selfplay_mnk_tpu_torch.utils.profiling import read_launches, reset_launches

    obs = real_positions(torch, np, dev, mnk, 256, 24, seed=3)

    def plain_forward(dtype):
        twin = copy.deepcopy(model)
        twin.dtype = dtype
        kernel_attention = transformer.tiny_head_attention
        transformer.tiny_head_attention = plain_tiny_head_attention
        try:
            return eval_apply(twin, obs)
        finally:
            transformer.tiny_head_attention = kernel_attention

    def kernel_forward():
        reset_launches()
        out = eval_apply(snapshot(model), obs)
        if read_launches()["attn_packed_fwd"] != len(model.layers):
            raise AssertionError("the eval forward did not go through the packed forward kernel")
        return out

    eval_check(torch, "transformer_b_s_w", kernel_forward, plain_forward)


def sdpa_layout(torch, t, b, l, h, dh, packed):
    """A kernel's input in ``scaled_dot_product_attention``'s (B, H, L, Dh)."""
    if packed:
        return t.reshape(b, l, h, dh).permute(0, 2, 1, 3).contiguous()
    return t.reshape(b, h, dh, l).permute(0, 1, 3, 2).contiguous()


def time_attention(torch, dev, pair, backward, b, l, h, dh):
    """One attention kernel at one shape, bf16: its device and per-call time,
    its plain version's, the library yardstick's, and the bound."""
    import torch.nn.functional as F

    packed = pair == "packed"
    fwd, bwd, fwd_ref, bwd_ref = attn_functions(pair)
    q, k, v, do = attn_inputs(torch, dev, torch.bfloat16, b, l, h, dh, packed, seed=5)
    extra = (h, dh) if packed else ()
    match = f"attn_{pair}_{'bwd' if backward else 'fwd'}"
    plain_iters = 10 if b > 1024 else 30
    if backward:
        ms, call = timed(lambda: bwd(q, k, v, do, *extra), match, 50)
        plain, plain_call = timed(lambda: bwd_ref(q, k, v, do, *extra), iters=plain_iters, warmup=3)
    else:
        ms, call = timed(lambda: fwd(q, k, v, *extra), match, 50)
        plain, plain_call = timed(lambda: fwd_ref(q, k, v, *extra), iters=plain_iters, warmup=3)

    lq, lk, lv, ldo = (sdpa_layout(torch, t, b, l, h, dh, packed) for t in (q, k, v, do))
    if backward:  # the library has no backward of its own to call: forward plus backward
        leaves = [t.requires_grad_(True) for t in (lq, lk, lv)]

        def library():
            out = F.scaled_dot_product_attention(*leaves)
            return torch.autograd.grad(out, leaves, ldo)
    else:
        def library():
            with torch.no_grad():
                return F.scaled_dot_product_attention(lq, lk, lv)

    lib, lib_call = timed(library, iters=50)
    elements = b * l * h * dh
    nbytes = (7 if backward else 4) * elements * 2
    ops = (10 if backward else 4) * b * h * l * l * dh
    bound_ms, bound_by = bound(nbytes, ops, "bfloat16")
    return {"shape": [b, l, h, dh], "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib, "call_ms": call,
            "plain_call_ms": plain_call, "library_call_ms": lib_call}


def attention_kernel_records(torch, dev, launches, attn_errors):
    """The four attention kernels' entries of the ``kernels`` line: timed at
    the update minibatch (the entry's own numbers) and at the rollout batch."""
    records = []
    for name, (pair, backward, replaces) in ATTN_KERNELS.items():
        (update_b, rollout_b), (l, h, dh) = ATTN_PATH_SHAPES[pair]
        at_update = time_attention(torch, dev, pair, backward, update_b, l, h, dh)
        at_rollout = time_attention(torch, dev, pair, backward, rollout_b, l, h, dh)
        record = {
            "name": name,
            "route": "cuda",
            "source": "rl_selfplay_mnk_tpu_torch/csrc/attention.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": attn_errors[(name, "bfloat16", (update_b, l, h, dh))],
        }
        record.update({key: value for key, value in at_update.items() if key != "shape"})
        record["library"] = ("scaled_dot_product_attention forward + backward" if backward
                             else "scaled_dot_product_attention")
        record["shape"] = at_update["shape"]
        record["at_rollout_batch"] = at_rollout
        records.append(record)
    return records


def phase_threshold(torch, dev):
    """Both attention pairs at one shape of either kind, from and to the
    models' (B, L, H, Dh) layout, transposes included: per-call time between
    CUDA events of the forward (no graph) and of forward plus backward."""
    from rl_selfplay_mnk_tpu_torch.ops import attention as attn

    def folded_route(q, k, v):
        b, l, h, dh = q.shape

        def fold(t):
            return t.permute(0, 2, 3, 1).reshape(b * h, dh, l).contiguous()

        out = attn.attention_folded(fold(q), fold(k), fold(v))
        return out.reshape(b, h, dh, l).permute(0, 3, 1, 2).contiguous()

    def packed_route(q, k, v):
        b, l, h, dh = q.shape
        d = h * dh
        out = attn.attention_packed(q.reshape(b, l, d), k.reshape(b, l, d), v.reshape(b, l, d), h, dh)
        return out.reshape(b, l, h, dh)

    results = []
    for kind in ("folded", "packed"):
        (b, _), (l, h, dh) = ATTN_PATH_SHAPES[kind]
        g = torch.Generator(device=dev).manual_seed(9)
        q, k, v, do = (torch.randn((b, l, h, dh), device=dev, generator=g).to(torch.bfloat16)
                       for _ in range(4))
        row = {"shape": [b, l, h, dh], "dispatch_takes": kind}
        for route_name, route in (("folded", folded_route), ("packed", packed_route)):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

            def forward():
                with torch.no_grad():
                    return route(q, k, v)

            def forward_backward():
                return torch.autograd.grad(route(*leaves), leaves, do)

            row[f"{route_name}_fwd_call_ms"] = time_ms(forward, iters=30, warmup=3)
            row[f"{route_name}_fwd_bwd_call_ms"] = time_ms(forward_backward, iters=30, warmup=3)
        results.append(row)
        print(f"threshold (B, L, H, Dh)={tuple(row['shape'])} (dispatch takes {kind}): "
              + ", ".join(f"{key} {value:.4f}" for key, value in row.items()
                          if key.endswith("_ms")))
    return results


def phase_timings(torch, np, dev, launches, k1_error, k2_errors, attn_launches, attn_errors):
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
    kernels += attention_kernel_records(torch, dev, attn_launches, attn_errors)
    for k in kernels:
        print(f"timing {k['name']}: device {k['ms']:.5f} ms, per call {k['call_ms']:.5f} ms; "
              f"plain device {k['plain_ms']:.5f} ms, per call {k['plain_call_ms']:.5f} ms; "
              f"library {k['library_ms']} / {k['library_call_ms']} ms; "
              f"bound {k['bound_ms']:.5f} ms by {k['bound_by']}")
        r = k.get("at_rollout_batch")
        if r:
            print(f"  at (B, L, H, Dh)={tuple(r['shape'])}: device {r['ms']:.5f} ms, per call "
                  f"{r['call_ms']:.5f} ms; plain device {r['plain_ms']:.5f} ms; library "
                  f"{r['library_ms']:.5f} ms; bound {r['bound_ms']:.5f} ms by {r['bound_by']}")
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

    from rl_selfplay_mnk_tpu_torch.train import build_config

    k1_error = phase_k1(torch, np, dev)
    k2_errors = phase_k2(torch, dev)
    attn_errors = phase_attention(torch, dev)

    folded = ("attn_folded_fwd", "attn_folded_bwd")
    packed = ("attn_packed_fwd", "attn_packed_bwd")
    config = build_config()
    config["validation_interval"] = 2
    resnet_launches, model = phase_train(
        torch, dev, "resnet_b_s 9x9x5", config, 3, ("env_step", "resblock"), folded + packed)
    phase_eval_check(torch, np, dev, model)
    launches_a, _ = phase_train(
        torch, dev, "transformer_b_s 9x9x5", build_config("transformer_b_s"), 6,
        ("env_step",) + folded, packed + ("resblock",))
    config = build_config("transformer_b_s_w", (13, 13, 5), 4096)
    config["validation_interval"] = 2
    launches_b, model = phase_train(
        torch, dev, "transformer_b_s_w 13x13x5", config, 3,
        ("env_step",) + packed, folded + ("resblock",))
    phase_transformer_eval_check(torch, np, dev, model, (13, 13, 5))

    attn_launches = {name: (launches_a if name in folded else launches_b)[name]
                     for name in folded + packed}
    threshold = phase_threshold(torch, dev)
    kernels = phase_timings(torch, np, dev, resnet_launches, k1_error, k2_errors,
                            attn_launches, attn_errors)

    print(json.dumps({"threshold": threshold}))
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
