#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check its kernels.

Usage (from the repository root, one card, no arguments)::

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. print the card's name and power limit (``nvidia-smi``); build the CUDA
   kernels from ``rl_selfplay_mnk_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together) and print the build time;
2. env-step kernel (K1) against its plain version over random playouts
   with random ``active`` masks: 3x3x3, 5x5x4, 9x9x5 and 13x13x5 at E =
   8192, 8191, 384 (rollout), 256 (validation), 16 (a tournament
   half-pairing) and 1 (a game of ``play``), 60 steps each, legal moves but
   for a quarter of the envs every third step playing an occupied cell and
   every third another playing an action out of range, half of the finished
   games played on past their end; all six outputs bitwise equal;
3. residual-block kernel (K2) against its plain version (f32 products, TF32
   off) at B in {256, 384, 8192, 8191, 16, 1}, 9x9, C in {32, 64}, bf16 (the
   tensor-core kernel, run twice: the same bits) and f32 (the FMA kernel),
   within the stated tolerances;
4. the seven attention kernels (K3 folded forward, K4 folded backward, K8
   packed forward, K9 packed backward; K5 lane-slice forward, K6 and K7
   in-kernel-fold forward and backward, a block per board) against their
   plain versions, bf16 and f32, at the shapes the paths give them (update
   minibatch, rollout and validation batch, a tournament half-pairing) and
   at odd, small and wide ones, within the stated tolerances; all seven in
   bf16 (the tensor-core kernels) run twice: the same bits; their first,
   FMA versions on the same bf16 inputs are held to the same limit; K9 also
   at (384, 81, 3, 32) on the inputs of seed 2; then the LayerNorm kernels
   (``ln_rows_fwd``, ``ln_rows_bwd``, ``ln_cols_sum``) forward and
   backward against their plain version at the registry's widths over the
   update minibatch's 8192 x 81 rows and 383, bf16 (twice: the same bits)
   and f32, within the stated tolerances;
5. the ResNet train path: ``train_mnk`` at the default config (9x9x5,
   ``resnet_b_s``, 384 envs, n_steps 256, batch 8192, 4 epochs) for 3
   iterations with a validation after the third, every kernel's launch
   counter set to 0 just before and read just after; losses and explained
   variance finite, one validation, K1's, K2's and LayerNorm's counters
   above 0 (every train and serving path below counts LayerNorm too); then
   the trained network's eval forward through the kernels against the
   unfolded plain-conv f32 forward on real positions, beside a bf16 control
   without the kernels;
6. train path A: the same trainer with ``transformer_b_s`` and the
   transformer family's hyper-parameters (9x9x5, batch 8192) for 4
   iterations with a validation and an export after each but the first; K1,
   the no-gradient forward kernel (K5) and the pair of the default
   with-gradient route above 0, the packed pair 0; its metrics stream holds
   the watch record at iteration 0 only, with every parameter's keys;
7. train path B: ``transformer_b_s_w`` on 13x13x5 (batch 4096) for 3
   iterations with one validation; K1's and the packed pair's counters
   above 0, the folded pair's 0; then the trained network's bf16 forward
   through the kernels against its f32 forward with the plain attention on
   real positions, beside a bf16 control with the plain attention;
8. train path C: ``transformer_c_s`` (the gated family) for 2 iterations
   with its ``attention_fn`` forced to the with-gradient route that the
   default does not take, so the folded pair and the in-kernel-fold pair are
   each launched on a train path;
8b. LFM2 (``lfm2_8b_a1b_l6_e8``, published widths) through ``train_mnk``: 2
   iterations at 32 envs x 8 steps, batch 128, one validation with its
   export; the RMS mode, the short convolution, the expert layer's kernels,
   LayerNorm (the heads), K1 and K8/K9 launched, no other attention kernel;
9. resume: the default config cut after 2 iterations (a checkpoint at
   iteration 1) and resumed for a third: it starts at iteration 2, with the
   opponent sources of path 5's uninterrupted run, each iteration logged
   once, finite losses;
10. the bench entry (``rl_selfplay_mnk_tpu_torch.bench.main``) at full
   width, 9x9x5 ``resnet_b_s``, 8192 envs, batch 8192, cut to 32 steps, one
   warm-up and one timed iteration: its JSON line, a finite positive
   throughput, K1 and K2 launched and no attention kernel;
11. the fused trainer (``train_fused.train_mnk_fused``): the default
   config and path A's ``transformer_b_s``, 4 iterations each with a
   validation after the third, by the ``step`` dispatch twice and by
   ``scan`` (CUDA graphs); step against step for the determinism rule, scan
   against step (the same bits where two step runs agree), K1 and K2 or
   K1, K5 and the gradient pair counted in the step runs' blocks (the
   validation between blocks and the graph capture counted apart), no
   host launch in the scan runs' blocks, the kernels found in the trace of
   a scan iteration, the graph replays counted;
12. the serving path, through ``compare_models.main`` and ``play.main``:
   (a) a 9x9x5 round robin, 32 games a pairing, over the six committed
   ``models/tpu_smoke30`` exports and path A's fresh exports: K1, K2 and K5
   above 0, every pairing's games add up, the last committed export takes
   at least 24 of 32 from the first and ELO rises with the iteration; (b) a
   13x13x5 round robin over four committed ``transformer_b_s_w`` exports: K1
   and K8 above 0, the last takes at least 28 of 32 from the first; then one
   game of the last ``tpu_smoke30`` export against the random policy, which
   the export wins;
13. timings at the paths' shapes, after warm-up: device time per call from
   ``torch.profiler`` (``ms``, ``plain_ms``, ``library_ms``) and the
   per-call time between CUDA events (``call_ms``...) for each kernel, its
   plain version and a library yardstick that the port never calls (two
   ``F.conv2d`` for K2, ``F.scaled_dot_product_attention`` for the attention
   kernels: its forward, and forward plus backward beside the backward
   kernels); K1 at ``utils/env_step_study.py``'s shapes (9x9x5 at 384 and
   8192 envs, 13x13x5 at 384, 9x9x5 at 16; 500 launches) with its
   registers, spill bytes and blocks an SM; K2 at B = 384, 8192, 16 and 1,
   each attention kernel at its update minibatch and at the rollout batch of
   384, K5-K7 also at a tournament half-pairing of 16, K9 also at (384, 81,
   3, 32); K2 and the seven attention kernels in bf16 also
   through their first version, the FMA kernel (``first_version_ms``); the
   tensor-core instantiations of K4-K9 on the paths with their registers,
   spill bytes and blocks an SM, and for K5, K6 and K7 the block's unit of
   work at each timed batch; the
   four ways through an attention kernel (fold, in-kernel fold, packed pair,
   lane slice) at the 9x9 and 13x13 batches of either kind, layout
   operations included, for the dispatch (the ``threshold`` line); one
   ``kernels`` JSON line with all nine kernels and LayerNorm (at d = 56 over
   the update minibatch's and the rollout's rows: the forward with and
   without the statistics, the backward, the plain version, ``F.layer_norm``
   on bf16 and its autograd backward as the library yardstick, the bound by
   bytes, and each instantiation's registers, spill bytes and blocks an SM),
   and LFM2's kernels at its benchmark cell's shapes
   (``utils/lfm2_study.py``: RMSNorm at 2048 and 64, the short convolution
   pair, the expert layer's dispatch and combine and its grouped products,
   K8/K9 at (512, 81, 32, 64)), each first held to its plain version on
   the timed inputs (forward and backward, the bf16 limit; the script fails
   past it).

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

K1_SHAPES = ((3, 3, 3), (5, 5, 4), (9, 9, 5), (13, 13, 5))
# large, odd, the rollout and validation batches, a tournament half-pairing
# and the single game of play.py
K1_ENVS = (8192, 8191, 384, 256, 16, 1)
K1_STEPS = 60
# K1's checks: every third step a quarter of the envs play a cell that holds
# a stone, and on every third other step a quarter play one of these actions,
# all off the board, in place of a legal move.
K1_WILD_ACTIONS = (-1, -7, 81, 169, 1000, 2**31 - 1, -(2**40))
# Validation and rollout batches, an odd one, a tournament half-pairing, one game.
K2_CASES = [(b, c) for b in (256, 384, 8192, 8191, 16, 1) for c in (32, 64)]
# K2 is timed at the rollout batch, the bench's 8192 envs, a tournament
# half-pairing and one game of play.
K2_TIMED_BATCHES = (384, 8192, 16, 1)
# |kernel - plain| <= atol + rtol * |plain|
K2_TOL = {
    "float32": (1e-4, 1e-4),  # f32 sums over 9C <= 576 products, in another order
    "bfloat16": (2.0**-6, 2.0**-6),  # output rounding to bf16 plus 1-ulp flips of bf16 h
}
# (B, L, H, Dh). First the shapes the train paths give each pair: the update
# minibatch, the rollout batch of 384 and the validation batch of 256. Then
# an odd batch, 13x13 tokens and a 3x3 board for the folded pair; for the
# packed pair also Dh = 32, four heads of 64 (the largest head of the
# registry), a head width that is not 16-byte aligned, a tournament
# half-pairing of 16 on 13x13, 13x13 with eight heads of 12, and the two
# update minibatches with heads below 16 channels (9x9 with four of 14,
# 13x13 with eight of 12).
ATTN_FOLDED_SHAPES = ((8192, 81, 4, 14), (384, 81, 4, 14), (256, 81, 4, 14),
                      (383, 81, 4, 14), (64, 169, 8, 12), (8, 9, 4, 14))
ATTN_PACKED_SHAPES = ((4096, 169, 2, 64), (384, 169, 2, 64), (256, 169, 2, 64),
                      (384, 81, 3, 32), (383, 169, 2, 64), (64, 169, 4, 64), (4, 81, 4, 14),
                      (16, 169, 2, 64), (384, 169, 8, 12), (16, 169, 8, 12),
                      (8192, 81, 4, 14), (2048, 169, 8, 12))
# The one-block-per-board kernels (K5-K7): the update minibatch, the rollout
# and validation batches, a tournament half-pairing of 16, an odd batch, four
# 13x13 batches of eight heads and a 3x3 board.
ATTN_BOARD_SHAPES = ((8192, 81, 4, 14), (384, 81, 4, 14), (256, 81, 4, 14), (16, 81, 4, 14),
                     (383, 81, 4, 14), (2048, 169, 8, 12), (64, 169, 8, 12), (8, 9, 4, 14),
                     (384, 169, 8, 12), (16, 169, 8, 12))
# K9 at inputs of other seeds (attn_inputs' ``seed``): (384, 81, 3, 32), the
# transformer_s and transformer_l updates' heads, at the seed where pass 1's
# S as one 16-deep product a step put dq at 1.54 of the bf16 limit.
K9_SEEDED_CASES = (((384, 81, 3, 32), 2),)
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
PALLAS = "rl_selfplay_mnk_tpu/ops/pallas_attention.py"
BOARD_SOURCE = "rl_selfplay_mnk_tpu_torch/csrc/attention_board.cu"
HEAD_SOURCE = "rl_selfplay_mnk_tpu_torch/csrc/attention.cu"
# name -> (layout of its tensors, backward?, TPU kernel, source, (L, H, Dh) and
# the batches it is timed at: update minibatch, rollout, and for K5-K7 a
# tournament half-pairing).
ATTN_KERNELS = {
    "attn_folded_fwd": ("folded", False, f"{PALLAS}:54", HEAD_SOURCE, (81, 4, 14), (8192, 384)),
    "attn_folded_bwd": ("folded", True, f"{PALLAS}:147", HEAD_SOURCE, (81, 4, 14), (8192, 384)),
    "attn_lane_slice_fwd": ("packed", False, f"{PALLAS}:334", BOARD_SOURCE, (81, 4, 14), (8192, 384, 16)),
    "attn_infold_fwd": ("packed", False, f"{PALLAS}:387", BOARD_SOURCE, (81, 4, 14), (8192, 384, 16)),
    "attn_infold_bwd": ("packed", True, f"{PALLAS}:427", BOARD_SOURCE, (81, 4, 14), (8192, 384, 16)),
    "attn_packed_fwd": ("packed", False, f"{PALLAS}:303", HEAD_SOURCE, (169, 2, 64), (4096, 384)),
    "attn_packed_bwd": ("packed", True, f"{PALLAS}:575", HEAD_SOURCE, (169, 2, 64), (4096, 384)),
}
# The attention kernels that run on the tensor cores in bf16: all seven.
TENSOR_CORE_KERNELS = ("attn_folded_fwd", "attn_folded_bwd", "attn_packed_fwd", "attn_packed_bwd",
                       "attn_lane_slice_fwd", "attn_infold_fwd", "attn_infold_bwd")
# (L, Dh) of K8's tensor-core instantiations on the paths: 13x13 with two
# heads of 64 (path B, the 13x13 tournament) and with eight of 12 (the
# no-gradient forwards of transformer_b_l and transformer_c_l), 9x9 with
# heads of 32 (transformer_s, transformer_l), and the largest the kernel takes.
K8_INSTANTIATIONS = ((169, 64), (169, 12), (81, 32), (192, 64))
# (L, Dh) of K9's tensor-core instantiations on the paths: path B's update
# (13x13, heads of 64) and the updates of transformer_s and transformer_l
# (9x9, heads of 32).
K9_INSTANTIATIONS = ((169, 64), (81, 32))
# (L, Dh) of K4's tensor-core instantiations on the paths: the 9x9 updates
# of path A and path C's family (four heads of 14), 13x13 with four heads of
# 14 and with eight of 12 (the with-gradient forwards of the 13x13 Dh < 32
# models), and the 3x3 board.
K4_INSTANTIATIONS = ((81, 14), (169, 14), (169, 12), (9, 14))
# (L, H, Dh) of K5's, K6's and K7's tensor-core instantiations on the paths:
# the 9x9 models (four heads of 14), 13x13 with four heads of 14 (K5 takes
# it: 676 head rows a board), 13x13 with eight heads of 12 (the board shapes
# and the forced in-kernel fold) and the 3x3 board.
BOARD_INSTANTIATIONS = ((81, 4, 14), (169, 4, 14), (169, 8, 12), (9, 4, 14))
INSTANTIATIONS = {"attn_folded_bwd": K4_INSTANTIATIONS, "attn_packed_fwd": K8_INSTANTIATIONS,
                  "attn_packed_bwd": K9_INSTANTIATIONS,
                  "attn_lane_slice_fwd": BOARD_INSTANTIATIONS,
                  "attn_infold_fwd": BOARD_INSTANTIATIONS, "attn_infold_bwd": BOARD_INSTANTIATIONS}
# (B, L, H, Dh) at which every route through an attention kernel is timed:
# the update minibatch, then the rollout batch of 384 at the registry's four
# Dh < 32 shapes (9x9 or 13x13, four heads of 14 or eight of 12), a
# tournament half-pairing of 16 at the smallest and the largest of them, and
# the 13x13 minibatch with two heads of 64.
THRESHOLD_SHAPES = ((8192, 81, 4, 14), (384, 81, 4, 14), (16, 81, 4, 14), (384, 81, 8, 12),
                    (384, 169, 4, 14), (2048, 169, 8, 12), (384, 169, 8, 12), (16, 169, 8, 12),
                    (4096, 169, 2, 64))
# Eval forward against plain f32: the larger of these and twice the bf16
# control's own error. A move probability is ~1/81 = 0.012, a value in [-1, 1].
EVAL_TOL = {"p": 1e-3, "v": 1.5e-2}
# LayerNorm (ops/layer_norm.py): the registry's widths (d = 56 of the
# 9x9 transformers, a head's cells x planes on 9x9 and 13x13, a head's
# hidden width, mlp_tiny's policy head) at the update minibatch's 8192 x 81
# rows, and an odd count. Timed at d = 56 over the update minibatch's and
# the rollout's rows.
LN_CASES = [(rows, width) for width in (56, 81, 162, 169, 338, 256, 2)
            for rows in (8192 * 81, 383)]
LN_TIMED_ROWS = (8192 * 81, 384 * 81)
LN_EPS = 1e-6
# y and dx: (rtol, share of the largest) of the dtype's limit, plus 2^-16 of
# the magnitudes of the terms the f32 arithmetic cancels; both sides round
# the same f32 function once (bf16: the attention kernels' limit).
LN_TOL = {"bfloat16": (2.0**-7, 2.0**-10), "float32": (2.0**-16, 2.0**-16)}
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
    """(device ms per call, or the event time when the profiler has none
    twice running; event ms per call)."""
    call = time_ms(fn, iters=iters, warmup=warmup)
    dev = device_ms(fn, iters=min(iters, 50), match=match)
    if dev is None:  # the profiler now and then reports no events at all
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
                actions = random_legal_actions(rng, mask)
                pick = rng.random(e) < 0.25
                if t % 3 == 1:  # a stone on a cell that holds one
                    occupied = np.where(~mask, rng.random(mask.shape), -1.0)
                    actions = np.where(pick & (~mask).any(1), occupied.argmax(1), actions)
                elif t % 3 == 2:
                    actions = np.where(pick, rng.choice(K1_WILD_ACTIONS, e), actions)
                actions = torch.as_tensor(actions, device=dev)
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
            print(f"K1 {m}x{n}x{k} E={e}: {K1_STEPS} steps (occupied cells, actions out of range, "
                  "play past the end), all six outputs bitwise equal")
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
            got = fused_residual_block(*args, 9, 9)
            if dtype == torch.bfloat16 and not torch.equal(got, fused_residual_block(*args, 9, 9)):
                raise AssertionError(f"K2 {name} B={b} C={c}: two runs differ")
            got = got.float()
            want = fused_residual_block_reference(*args, 9, 9).float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            max_err = float(err.max())
            worst = float((err - rtol * want.abs()).max())
            ok = bool(torch.isfinite(got).all()) and worst <= atol
            print(f"K2 {name} B={b} C={c}: max_abs_err {max_err:.3e} "
                  f"(tolerance {atol:.2e} + {rtol:.2e}*|ref|)"
                  f"{', same bits twice' if dtype == torch.bfloat16 else ''} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K2 {name} B={b} C={c} outside its tolerance")
            errors[(name, b, c)] = max_err
    return errors


def attn_inputs(torch, dev, dtype, b, l, h, dh, packed, n=4, seed=0):
    """q, k, v (and dO) for one attention call, in the layout of its pair."""
    g = torch.Generator(device=dev).manual_seed(seed + 7 * b + l)
    shape = (b, l, h * dh) if packed else (b * h, dh, l)
    return [torch.randn(shape, device=dev, generator=g).to(dtype) for _ in range(n)]


def attn_kernel(name):
    """(launch wrapper, plain version) of one attention kernel."""
    from rl_selfplay_mnk_tpu_torch.ops import attention as attn

    return {
        "attn_folded_fwd": (attn.attention_folded_fwd, attn.attention_folded_reference),
        "attn_folded_bwd": (attn.attention_folded_bwd, attn.attention_folded_bwd_reference),
        "attn_packed_fwd": (attn.attention_packed_fwd, attn.attention_packed_reference),
        "attn_packed_bwd": (attn.attention_packed_bwd, attn.attention_packed_bwd_reference),
        "attn_lane_slice_fwd": (attn.attention_lane_slice_fwd, attn.attention_lane_slice_reference),
        "attn_infold_fwd": (attn.attention_infold_fwd, attn.attention_infold_reference),
        "attn_infold_bwd": (attn.attention_infold_bwd, attn.attention_infold_bwd_reference),
    }[name]


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
    """K3-K9 against their plain versions; returns the max abs error per
    (kernel, dtype, shape)."""
    errors = {}
    worst = {"float32": 0.0, "bfloat16": 0.0, "differ": 0.0}
    groups = (
        ("folded", ("attn_folded_fwd",), "attn_folded_bwd", ATTN_FOLDED_SHAPES),
        ("packed", ("attn_packed_fwd",), "attn_packed_bwd", ATTN_PACKED_SHAPES),
        ("board", ("attn_lane_slice_fwd", "attn_infold_fwd"), "attn_infold_bwd", ATTN_BOARD_SHAPES),
    )
    for group, forwards, backward, shapes in groups:
        for dtype in (torch.bfloat16, torch.float32):
            name = dtype_name(dtype)
            for b, l, h, dh in shapes:
                q, k, v, do = attn_inputs(torch, dev, dtype, b, l, h, dh, group != "folded")
                extra = () if group == "folded" else (h, dh)
                got, want = {}, {}
                for kernel in forwards:
                    fwd, fwd_ref = attn_kernel(kernel)
                    got[kernel] = {"o": fwd(q, k, v, *extra)}
                    first = kernel in TENSOR_CORE_KERNELS and dtype == torch.bfloat16
                    if first:
                        if not torch.equal(got[kernel]["o"], fwd(q, k, v, *extra)):
                            raise AssertionError(f"{kernel} {name} (B, L, H, Dh)={(b, l, h, dh)}: "
                                                 "two runs differ")
                        # The first version, the FMA kernel, on the same bf16 inputs.
                        got[f"{kernel} first version"] = {"o": fwd(q, k, v, *extra, kernel="fma")}
                    torch.cuda.synchronize()
                    want[kernel] = {"o": fwd_ref(q, k, v, *extra)}
                    if first:
                        want[f"{kernel} first version"] = want[kernel]
                bwd, bwd_ref = attn_kernel(backward)
                got[backward] = dict(zip(("dq", "dk", "dv"), bwd(q, k, v, do, *extra)))
                tensor_cores = backward in TENSOR_CORE_KERNELS and dtype == torch.bfloat16
                if tensor_cores:
                    again = bwd(q, k, v, do, *extra)
                    if not all(torch.equal(a, g) for a, g in zip(again, got[backward].values())):
                        raise AssertionError(f"{backward} {name} (B, L, H, Dh)={(b, l, h, dh)}: "
                                             "two runs differ")
                    # The first version, the FMA kernel, on the same bf16 inputs.
                    got[f"{backward} first version"] = dict(
                        zip(("dq", "dk", "dv"), bwd(q, k, v, do, *extra, kernel="fma")))
                torch.cuda.synchronize()
                want[backward] = dict(zip(("dq", "dk", "dv"), bwd_ref(q, k, v, do, *extra)))
                if tensor_cores:
                    want[f"{backward} first version"] = want[backward]
                report = []
                for kernel in got:
                    errs, share = [], 0.0
                    for key in got[kernel]:
                        err, of_limit, differ = attn_excess(torch, got[kernel][key], want[kernel][key])
                        errs.append(err)
                        share = max(share, of_limit, differ)
                        worst[name] = max(worst[name], of_limit)
                        worst["differ"] = max(worst["differ"], differ)
                        if not max(of_limit, differ) <= 1.0:
                            raise AssertionError(
                                f"{kernel} {name} (B, L, H, Dh)={(b, l, h, dh)}: {key} outside its "
                                f"tolerance: max abs err {err:.3e}, worst error {of_limit:.2f} of its "
                                f"limit, differing elements {differ:.2f} of theirs")
                    errors[(kernel, name, (b, l, h, dh))] = max(errs)
                    report.append(f"{kernel} {max(errs):.3e} ({share:.2f} of the limit)")
                print(f"attention {name} (B, L, H, Dh)={(b, l, h, dh)}: max_abs_err "
                      + ", ".join(report) + " ok")
    # K9 on the inputs of other seeds, bf16, against its plain version, the
    # same bits twice.
    bwd, bwd_ref = attn_kernel("attn_packed_bwd")
    for (b, l, h, dh), seed in K9_SEEDED_CASES:
        q, k, v, do = attn_inputs(torch, dev, torch.bfloat16, b, l, h, dh, True, seed=seed)
        got = bwd(q, k, v, do, h, dh)
        again = bwd(q, k, v, do, h, dh)
        torch.cuda.synchronize()
        if not all(torch.equal(a, g) for a, g in zip(again, got)):
            raise AssertionError(f"attn_packed_bwd (B, L, H, Dh)={(b, l, h, dh)} seed {seed}: "
                                 "two runs differ")
        report = []
        for key, g, w in zip(("dq", "dk", "dv"), got, bwd_ref(q, k, v, do, h, dh)):
            err, of_limit, differ = attn_excess(torch, g, w)
            worst["bfloat16"] = max(worst["bfloat16"], of_limit)
            worst["differ"] = max(worst["differ"], differ)
            if not max(of_limit, differ) <= 1.0:
                raise AssertionError(
                    f"attn_packed_bwd bfloat16 (B, L, H, Dh)={(b, l, h, dh)} seed {seed}: {key} "
                    f"outside its tolerance: max abs err {err:.3e}, worst error {of_limit:.2f} of "
                    f"its limit, differing elements {differ:.2f} of theirs")
            report.append(f"{key} {err:.3e} ({max(of_limit, differ):.2f} of the limit)")
        print(f"attention bfloat16 attn_packed_bwd (B, L, H, Dh)={(b, l, h, dh)} seed {seed}: "
              "max_abs_err " + ", ".join(report) + ", same bits twice ok")
    print(f"attention: worst error as a share of its limit: f32 {worst['float32']:.2f} "
          f"(limit {ATTN_F32_TOL:.0e} * (1 + |ref|)), bf16 {worst['bfloat16']:.2f} "
          f"(limit 2^-7 * |ref| + 2^-10 * max|ref|); bf16 elements that differ: "
          f"{worst['differ']:.2f} of the 2^-9 (+ 4 elements) allowed")
    return errors


def ln_inputs(torch, dev, dtype, rows, width, seed=0):
    """x (a mean of 1.5 and a spread of 2), dy, and f32 weight and bias
    near 1 and 0, for one LayerNorm call."""
    g = torch.Generator(device=dev).manual_seed(seed + rows + 1000 * width)
    x = (torch.randn(rows, width, device=dev, generator=g) * 2.0 + 1.5).to(dtype)
    dy = torch.randn(rows, width, device=dev, generator=g).to(dtype)
    weight = 1.0 + 0.2 * torch.randn(width, device=dev, generator=g)
    bias = 0.2 * torch.randn(width, device=dev, generator=g)
    return x, dy, weight, bias


def ln_forward_backward(torch, fn, x, dy, weight, bias):
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, weight, bias)]
    y = fn(*leaves, LN_EPS)
    y.backward(dy)
    return (y.detach(), *(t.grad for t in leaves))


def phase_layer_norm(torch, dev):
    """The LayerNorm kernels (``ln_rows_fwd``, ``ln_rows_bwd``,
    ``ln_cols_sum``) against their plain version, forward and backward, at
    ``LN_CASES`` in bf16 and f32: y and dx as shares of ``LN_TOL``'s limit,
    dweight and dbias of 2^-16 of the sums of their terms' magnitudes; bf16
    twice, the same bits. Returns the max abs error of y per (dtype, rows,
    width)."""
    from rl_selfplay_mnk_tpu_torch.ops.layer_norm import layer_norm, layer_norm_reference

    errors = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = dtype_name(dtype)
        rtol, atol_of_max = LN_TOL[name]
        for rows, width in LN_CASES:
            x, dy, weight, bias = ln_inputs(torch, dev, dtype, rows, width)
            got = ln_forward_backward(torch, layer_norm, x, dy, weight, bias)
            if dtype == torch.bfloat16:
                again = ln_forward_backward(torch, layer_norm, x, dy, weight, bias)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"LayerNorm {name} {rows}x{width}: two runs differ")
            want = ln_forward_backward(torch, layer_norm_reference, x, dy, weight, bias)
            # the magnitudes of the terms each f32 result sums: xh = (x - mean)
            # * rstd as (|x| + |mean|) * rstd, which a rounding of the mean moves
            xf = x.double()
            mean = xf.mean(1, keepdim=True)
            rstd = torch.rsqrt(xf.var(1, unbiased=False, keepdim=True) + LN_EPS)
            xh = (xf.abs() + mean.abs()) * rstd
            gy = (dy.double() * weight.double()).abs()
            terms = [None, rstd * (gy + gy.mean(1, keepdim=True) + xh * (gy * xh).mean(1, keepdim=True)),
                     (dy.double().abs() * xh).sum(0), dy.double().abs().sum(0)]
            shares = []
            for i, (g, w, t) in enumerate(zip(got, want, terms)):
                g, w = g.double(), w.double()
                limit = (rtol * w.abs() + atol_of_max * w.abs().max()) if i < 2 else 0.0
                if t is not None:
                    limit = limit + 2.0**-16 * t
                shares.append(float(((g - w).abs() / limit).nan_to_num(nan=0.0).max()))
            errors[(name, rows, width)] = float((got[0].float() - want[0].float()).abs().max())
            ok = max(shares) <= 1 and all(bool(torch.isfinite(g).all()) for g in got)
            print(f"LayerNorm {name} {rows}x{width}: worst share of the limit y {shares[0]:.3f} "
                  f"dx {shares[1]:.3f} dweight {shares[2]:.3f} dbias {shares[3]:.3f}"
                  f"{', same bits twice' if dtype == torch.bfloat16 else ''} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"LayerNorm {name} {rows}x{width} outside its tolerance")
    return errors


def phase_train(torch, dev, label, config, iterations, launched, not_launched=(), validations=1):
    """``iterations`` of ``train_mnk`` with ``config``: every kernel's launch
    count set to 0 just before and read just after. Kernels in ``launched``
    must have run, those in ``not_launched`` must not. Returns (launches,
    ``train_mnk``'s summary: the trained model, the exports' directory, the
    metrics stream...)."""
    from rl_selfplay_mnk_tpu_torch.train import train_mnk
    from rl_selfplay_mnk_tpu_torch.utils.profiling import read_launches, reset_launches

    config["total_environment_steps"] = iterations * config["num_envs"] * config["n_steps"]
    config["run_name"] = "chip_smoke_" + label.replace(" ", "_")
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
    if len(summary["validations"]) != validations:
        raise AssertionError(
            f"{label}: expected {validations} validations, got {len(summary['validations'])}")
    keys = {"win_rate", "loss_rate", "draw_rate", "score_rate", "games_played"}
    for validation in summary["validations"]:
        if set(validation) != {f"validation/vs_benchmark/{k}" for k in keys}:
            raise AssertionError(f"{label}: validation keys: {sorted(validation)}")
        print(f"{label} validation: {json.dumps(validation)}")
    print(f"{label}: {iterations} iterations in {wall:.1f}s, launches {json.dumps(launches)}")
    for name in launched:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: kernel {name} was not launched on the train path")
    for name in not_launched:
        if launches[name] != 0:
            raise AssertionError(f"{label}: kernel {name} was launched {launches[name]} times")
    return launches, summary


def last_run_records(path):
    """The records of the last run in a metrics stream (after its last config
    line: a stream is appended to when a run's name comes back)."""
    records = [json.loads(line) for line in open(path)]
    start = max(i for i, r in enumerate(records) if r.get("_type") == "config")
    return records[start + 1:]


def phase_watch_record(summary, config):
    """The watch record of a train path run with the default
    ``watch_interval`` (20): logged at iteration 0 only, with a gradient
    norm, a gradient histogram and a parameter norm for every parameter, by
    its path in the JAX package's ``params`` tree; the norms finite, each
    histogram counting every element of every update."""
    from rl_selfplay_mnk_tpu_torch.models.convert import flax_param_paths

    named = dict(summary["model"].named_parameters())
    leaves = flax_param_paths(named)
    want = {f"{kind}/{leaf}/{what}" for leaf in leaves.values()
            for kind, what in (("gradients", "norm"), ("gradients", "hist"), ("parameters", "norm"))}
    watched = [r for r in last_run_records(summary["jsonl_path"])
               if any(k.startswith("gradients/") for k in r)]
    steps_per_iteration = config["num_envs"] * config["n_steps"]
    if [r["_step"] for r in watched] != [steps_per_iteration]:
        raise AssertionError(f"watch records at steps {[r['_step'] for r in watched]}, expected "
                             f"[{steps_per_iteration}] (iteration 0)")
    record = watched[0]
    keys = set(record) - {"_step", "_time"}
    if keys != want:
        raise AssertionError(f"watch record keys: {len(keys)}, expected {len(want)}; "
                             f"missing {sorted(want - keys)[:4]}, extra {sorted(keys - want)[:4]}")
    updates = 4 * steps_per_iteration // config["batch_size"]
    for name, leaf in leaves.items():
        norms = (record[f"gradients/{leaf}/norm"], record[f"parameters/{leaf}/norm"])
        if not all(isinstance(v, float) and math.isfinite(v) for v in norms):
            raise AssertionError(f"watch record: {leaf} norms {norms}")
        if sum(record[f"gradients/{leaf}/hist"]["counts"]) != updates * named[name].numel():
            raise AssertionError(f"watch record: {leaf}'s gradient histogram does not count "
                                 f"{updates} updates of {named[name].numel()} elements")
    print(f"watch record at iteration 0: {len(leaves)} parameters, each with a gradient norm and "
          f"histogram over {updates} updates and a parameter norm, keyed by the JAX package's "
          f"paths (e.g. {next(iter(leaves.values()))}); no other watch record")


def phase_resume(torch, dev, straight_sources, tmp):
    """The default config (9x9x5 ``resnet_b_s``, 384 envs) cut after two
    iterations, with a checkpoint at iteration 1, and resumed for a third
    under the same run name: it starts at iteration 2, draws the opponent
    sources of the first train path's uninterrupted run (the same config and
    seed), logs each iteration once, and its losses are finite. Bitwise
    equality is not asked on the card: cuDNN's backward sums in no fixed
    order (the CPU tests hold it)."""
    from rl_selfplay_mnk_tpu_torch.train import build_config, train_mnk
    from rl_selfplay_mnk_tpu_torch.utils.metrics import MetricsLogger

    config = build_config()
    config.update(validation_interval=2, export_dir=f"{tmp}/models", checkpoint_interval=1,
                  checkpoint_dir=f"{tmp}/checkpoints")
    steps = config["num_envs"] * config["n_steps"]
    t0 = time.perf_counter()
    runs = []
    for iterations, resume in ((2, False), (3, True)):
        config.update(total_environment_steps=iterations * steps, resume=resume)
        with MetricsLogger(run_name="resume", config=config, out_dir=f"{tmp}/runs") as logger:
            runs.append(train_mnk(dict(config), logger, device=str(dev)))
    torch.cuda.synchronize()
    cut, resumed = runs
    for run in runs:
        if run["errors"]:
            raise AssertionError(f"resume: training iterations failed: {run['errors']}")
        for m in run["iterations"]:
            if not all(math.isfinite(m[key]) for key in ("actor_loss", "critic_loss", "entropy_loss")):
                raise AssertionError(f"resume: losses not finite: {m}")
    if resumed["start_iteration"] != 2 or len(resumed["iterations"]) != 1:
        raise AssertionError(f"resume: started at iteration {resumed['start_iteration']} and ran "
                             f"{len(resumed['iterations'])}, expected 2 and 1")
    sources = cut["opponent_sources"] + resumed["opponent_sources"]
    if sources != straight_sources[:3]:
        raise AssertionError(f"resume: opponent sources {sources}, uninterrupted {straight_sources}")
    logged = [r["_step"] for r in map(json.loads, open(f"{tmp}/runs/resume.jsonl"))
              if "training/mean_reward" in r]
    if logged != [steps, 2 * steps, 3 * steps]:
        raise AssertionError(f"resume: the stream logs iterations at steps {logged}")
    print(f"resume: cut after 2 iterations, resumed at iteration {resumed['start_iteration']} for 1 "
          f"in {time.perf_counter() - t0:.1f}s; opponent sources {sources} as the uninterrupted "
          f"run's; each iteration logged once")


def phase_bench(torch, label):
    """The port's bench entry, ``rl_selfplay_mnk_tpu_torch.bench.main``, at
    full width (9x9x5 ``resnet_b_s``, 8192 envs, batch 8192), its depth cut
    to 32 steps (128 updates an iteration), one warm-up and one timed
    iteration; the counts set to 0 just before and read just after: K1 and
    K2 launched, no attention kernel; the throughput finite and positive."""
    from rl_selfplay_mnk_tpu_torch import bench
    from rl_selfplay_mnk_tpu_torch.utils.profiling import read_launches, reset_launches

    reset_launches()
    t0 = time.perf_counter()
    record = bench.main(["--n-steps", "32", "--warmup", "1", "--iters", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if not (math.isfinite(record["value"]) and record["value"] > 0):
        raise AssertionError(f"{label}: {record}")
    for name, count in launches.items():
        if (count > 0) != (name in ("env_step", "resblock", "layer_norm")):
            raise AssertionError(f"{label}: kernel {name} launched {count} times")
    print(f"{label}: {record['value']} env-steps/s in {wall:.1f}s with set-up; launches "
          f"{json.dumps(launches)}")
    return launches


def fused_run(torch, dev, label, arch, dispatch, tmp, iterations):
    """``train_mnk_fused`` with ``arch``'s default config at ``dispatch`` for
    ``iterations`` (blocks end after iteration 2: a validation there). The
    counts are set to 0 just before each block (``train_fused.run_block``)
    and read just after it, so the validation between blocks is not in
    them; the graph capture's (warm-up iteration and capture) are kept
    apart. Returns (summary, launches in the blocks, launches in the
    capture, wall, the final parameters as one f32 vector, the metrics)."""
    from rl_selfplay_mnk_tpu_torch import train_fused
    from rl_selfplay_mnk_tpu_torch.alg.fused import FusedTrainer
    from rl_selfplay_mnk_tpu_torch.train import build_config
    from rl_selfplay_mnk_tpu_torch.utils.profiling import read_launches, reset_launches

    counted = {"blocks": {}, "capture": {}}

    def counting(fn, key):
        def wrapped(*args, **kwargs):
            reset_launches()
            try:
                return fn(*args, **kwargs)
            finally:
                for name, n in read_launches().items():
                    counted[key][name] = counted[key].get(name, 0) + n
        return wrapped

    config = build_config(arch)
    config.update(validation_interval=2, export_dir=f"{tmp}/models", fused_dispatch=dispatch,
                  run_name=f"chip_smoke_fused_{arch}_{dispatch}",
                  total_environment_steps=iterations * config["num_envs"] * config["n_steps"])
    run_block, capture = train_fused.run_block, FusedTrainer.capture
    train_fused.run_block = counting(run_block, "blocks")
    FusedTrainer.capture = counting(capture, "capture")
    try:
        t0 = time.perf_counter()
        summary = train_fused.train_mnk_fused(config, device=str(dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        train_fused.run_block, FusedTrainer.capture = run_block, capture
    if summary["errors"] or summary["dispatch"] != dispatch:
        raise AssertionError(f"{label} {dispatch}: errors {summary['errors']}, dispatch "
                             f"{summary['dispatch']}")
    its = summary["iterations"]
    if len(its) != iterations or len(summary["validations"]) != 1:
        raise AssertionError(f"{label} {dispatch}: {len(its)} iterations and "
                             f"{len(summary['validations'])} validations, expected {iterations} "
                             f"and 1")
    for m in its:
        if not all(math.isfinite(m[key]) for key in ("actor_loss", "critic_loss", "entropy_loss",
                                                      "explained_variance", "grad_norm")):
            raise AssertionError(f"{label} {dispatch}: metrics not finite: {m}")
    params = torch.cat([p.detach().float().reshape(-1) for p in summary["model"].state_dict().values()])
    untimed = [[m[k] for k in sorted(m) if k not in ("fps", "rollout_time", "learn_time")]
               for m in its]
    return summary, counted["blocks"], counted["capture"], wall, params, untimed


def phase_fused(torch, dev, tmp, default_pair):
    """The fused trainer (``train_fused.train_mnk_fused``) at the default
    config (9x9x5 ``resnet_b_s``, 384 envs, n_steps 256, batch 8192) and at
    path A's ``transformer_b_s``, 4 iterations each across the validation
    after iteration 2: twice by the ``step`` dispatch (eager pieces), then by
    ``scan`` (CUDA graphs), from one seed. The two step runs show whether
    eager runs give the same bits; if they do, scan must give them too, if
    not, scan must stay within their spread. The step runs' counts, taken
    over the blocks alone, show K1 and K2 (ResNet) or K1, K5 and the
    gradient pair (transformer) on the path; the scan run's blocks launch
    no kernel from the host (graph replays only), and a traced scan
    iteration (``utils/profiling.profile_fused_iteration``) shows the same
    kernels inside the replays, with its launches an iteration. Prints each
    run's wall time an iteration, its launches an iteration in the blocks,
    the capture's launches and the graph replays an iteration, and the
    largest step-vs-scan difference."""
    from rl_selfplay_mnk_tpu_torch.utils.profiling import profile_fused_iteration

    paths = {}
    for arch, launched in (("resnet_b_s", ("env_step", "resblock", "layer_norm")),
                           ("transformer_b_s",
                            ("env_step", "attn_lane_slice_fwd", "layer_norm") + default_pair)):
        label = f"fused {arch} 9x9x5"
        iterations = 4
        runs = [fused_run(torch, dev, label, arch, d, tmp, iterations)
                for d in ("step", "step", "scan")]
        for (summary, blocks, capture, wall, _, _), name in zip(runs, ("step", "step again",
                                                                       "scan")):
            walls = summary["block_walls"]
            per_iter = sum(w for _, w in walls) / sum(n for n, _ in walls)
            print(f"{label} {name}: {wall:.1f}s in all ({summary.get('capture_s', 0.0):.1f}s "
                  f"capture), {per_iter:.3f}s an iteration in its blocks, launches from the host "
                  f"an iteration in the blocks {json.dumps({k: v / iterations for k, v in blocks.items() if v})}, "
                  f"in the capture {json.dumps({k: v for k, v in capture.items() if v})}, graph "
                  f"replays an iteration {summary['graph_replays'] / iterations:.0f}")
        step_launches = runs[0][1]
        for name in launched:
            if step_launches.get(name, 0) <= 0:
                raise AssertionError(f"{label}: kernel {name} was not launched in the step "
                                     f"dispatch's blocks")
        if any(runs[2][1].values()):
            raise AssertionError(f"{label}: the scan blocks launched kernels from the host: "
                                 f"{runs[2][1]}")
        paths[label] = step_launches
        replays = runs[2][0]["graph_replays"]
        cfg_updates = 4 * 384 * 256 // 8192
        if replays != iterations * (3 + 256 + cfg_updates):
            raise AssertionError(f"{label}: {replays} graph replays for {iterations} iterations")

        def spread(a, b):
            return max((a[4] - b[4]).abs().max().item(),
                       max(abs(x - y) for ra, rb in zip(a[5], b[5]) for x, y in zip(ra, rb)))

        eager, scan = spread(runs[0], runs[1]), spread(runs[0], runs[2])
        if (eager == 0.0 and scan != 0.0) or scan > eager:
            raise AssertionError(f"{label}: scan differs from step by {scan:.3e}, two step runs "
                                 f"by {eager:.3e}")
        print(f"{label}: largest step-vs-scan difference {scan:.3e} (parameters, BatchNorm "
              f"statistics and metrics; two step runs: {eager:.3e})")
        rec = profile_fused_iteration("scan", warmup=1, iters=1, arch=arch)
        found = rec["port_kernels_in_trace"]
        for name in launched:
            if found[name] <= 0:
                raise AssertionError(f"{label}: kernel {name} not in the trace of a scan iteration")
        print(f"{label}: a traced scan iteration: {rec['graph_replays']} graph replays, "
              f"{rec['kernel_launches']} kernels, idle share {rec['idle_share']:.3f}, port kernels "
              f"launched an iteration (from the trace) "
              f"{json.dumps({k: v for k, v in found.items() if v})}")
    return paths


# The distributed phase's check of the first minibatch's all-reduced gradient
# (two ranks sharing the card, gloo) against one rank's, on the same
# trajectory, weights and indices in the same layout: ||g2 - g1|| <=
# DIST_GRAD_RTOL * ||g1||, the limit set before the first run on the card.
# Two ranks average two halves' gradients, and their BatchNorm statistics
# are means of two ranks' means. The reason given then (a few bf16
# activations moved by one rounding step) missed the larger part: each
# weight's gradient comes out of a bf16 product rounded to bf16 (up to 2^-9
# of each element), once for the whole batch on one rank and once for each
# half on two. The first run read 7.425e-3 (NVIDIA H100 80GB HBM3, 700.00
# W), 0.95 of the limit; the inputs are fixed by the seed, so a run reads
# the same.
DIST_GRAD_RTOL = 2.0**-7
DIST_STEPS = 2 * 384 * 256  # two iterations of the default config


class RunProbe:
    """Instruments ``train.main``/``train_mnk`` for the distributed phase:
    the update's collectives timed (``Collectives.timed``: a device sync
    around each, on during the update only), their seconds and calls, each
    iteration's wall and metrics."""

    def __init__(self):
        self.dp = None
        self.update_s, self.update_calls, self.minibatches = 0.0, 0, 0
        self.walls, self.metrics = [], []

    def __enter__(self):
        import torch

        from rl_selfplay_mnk_tpu_torch import train
        from rl_selfplay_mnk_tpu_torch.alg import ppo
        from rl_selfplay_mnk_tpu_torch.parallel import mesh

        self.saved = (train.data_parallel, ppo.PPOLearner.update, ppo.PPOLearner.learn)
        data_parallel, update, learn = self.saved
        probe = self

        def keeping_dp(num_envs, device):
            probe.dp = mesh.data_parallel(num_envs, device)
            return probe.dp

        def totals():
            stats = probe.dp.coll.stats.values() if probe.dp is not None else []
            return sum(c for c, _ in stats), sum(t for _, t in stats)

        def timed_update(learner, *args, **kwargs):
            calls0, s0 = totals()
            if probe.dp is not None:
                probe.dp.coll.timed = True
            try:
                out = update(learner, *args, **kwargs)
            finally:
                if probe.dp is not None:
                    probe.dp.coll.timed = False
            calls1, s1 = totals()
            probe.update_calls += calls1 - calls0
            probe.update_s += s1 - s0
            probe.minibatches += learner.config.updates_per_iteration
            return out

        def timed_learn(learner, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = learn(learner, *args, **kwargs)
            torch.cuda.synchronize()
            probe.walls.append(time.perf_counter() - t0)
            probe.metrics.append(metrics.scalars())
            return metrics

        train.data_parallel = keeping_dp
        ppo.PPOLearner.update = timed_update
        ppo.PPOLearner.learn = timed_learn
        return self

    def __exit__(self, *exc):
        from rl_selfplay_mnk_tpu_torch import train
        from rl_selfplay_mnk_tpu_torch.alg import ppo

        train.data_parallel, ppo.PPOLearner.update, ppo.PPOLearner.learn = self.saved

    def record(self) -> dict:
        return {"walls": self.walls, "metrics": self.metrics,
                "update_s": self.update_s, "update_calls": self.update_calls,
                "minibatches": self.minibatches,
                "stats": dict(self.dp.coll.stats) if self.dp is not None else {}}


def check_collectives_identity(torch, dev):
    """At world 1 every collective of ``parallel.mesh.Collectives`` gives
    back its input's bits (on NCCL here)."""
    from rl_selfplay_mnk_tpu_torch.parallel.mesh import Collectives

    coll = Collectives(dev)
    x = torch.randn(4099, device=dev)
    for name, got in (("all_reduce", coll.all_reduce(x.clone())),
                      ("reduce_scatter", coll.reduce_scatter(x.clone())),
                      ("all_gather", coll.all_gather(x.clone())),
                      ("broadcast", coll.broadcast(x.clone()))):
        if not torch.equal(got, x):
            raise AssertionError(f"{name} at world 1 on {coll.backend} changed its input")
    return coll.backend


def first_gradient(torch, path, dp=None):
    """The first minibatch's gradient of the default config's learner (in
    the layout of two shards) on the trajectory, weights and indices saved
    at ``path``: over ``dp``'s ranks (this rank's rows; the gradient after
    the ranks' mean) or on one rank; before the clip, as one f32 vector."""
    from rl_selfplay_mnk_tpu_torch.alg import ppo
    from rl_selfplay_mnk_tpu_torch.train import build_config, create_learner
    from rl_selfplay_mnk_tpu_torch.utils.hardware import detect_hardware_config

    saved = torch.load(path, weights_only=False)
    config = build_config()
    config["shard_groups"] = 2
    learner = create_learner(config, detect_hardware_config("cuda:0"), dp)[0]
    learner.model.load_state_dict(saved["state"])
    rows = (lambda x: x) if dp is None else dp.shard.take
    dev = learner.device
    traj = {k: (v if dp is None else v[:, dp.shard.start:dp.shard.stop]).to(dev)
            for k, v in saved["traj"].items()}
    final = {k: rows(v).to(dev) for k, v in saved["final"].items()}
    flats = ppo._update_prepare_impl(learner.model, learner.config, traj, final, dp)
    world, rank = (1, 0) if dp is None else (dp.world, dp.rank)
    idx = ppo.rank_indices(learner.config, saved["idx"].to(dev), world, rank)
    grads = {}
    clip = ppo.PPOOptimizer.clip

    def recording(opt, watch=None):
        if opt.dp is not None:
            opt.reduce_grads()
        grads["g"] = torch.cat([p.grad.detach().reshape(-1).float() for p in opt.params]).cpu()
        opt.dp, dp_saved = None, opt.dp
        try:
            return clip(opt, watch)
        finally:
            opt.dp = dp_saved

    ppo.PPOOptimizer.clip = recording
    try:
        ppo.minibatch_update(learner.model, learner.config, learner.optimizer, flats, idx[0],
                             0.05, dp=dp)
    finally:
        ppo.PPOOptimizer.clip = clip
    return grads["g"]


def save_gradient_inputs(torch, path):
    """One rollout of the default config's learner (in the layout of two
    shards) against the random policy, its weights and one epoch's indices
    over the whole batch, saved for ``first_gradient``."""
    from rl_selfplay_mnk_tpu_torch.alg import ppo
    from rl_selfplay_mnk_tpu_torch.selfplay.policies import RandomPolicy
    from rl_selfplay_mnk_tpu_torch.train import build_config, create_learner
    from rl_selfplay_mnk_tpu_torch.utils.hardware import detect_hardware_config

    config = build_config()
    config["shard_groups"] = 2
    learner = create_learner(config, detect_hardware_config("cuda:0"))[0]
    state = {k: v.detach().cpu().clone() for k, v in learner.model.state_dict().items()}
    traj, _ = learner.rollout(RandomPolicy(torch.Generator(device="cuda:0").manual_seed(7)))
    idx = ppo._minibatch_indices(learner.config, learner.generator, learner.device)
    torch.save({"state": state, "traj": {k: v.cpu() for k, v in traj.items()},
                "final": {k: v.cpu() for k, v in learner._obs.items()}, "idx": idx.cpu()}, path)


def rank_entry(runs, workdir, check_identity=False, grad_inputs=None, start_file=None):
    """A rank of the distributed phase: from a directory of its own, each
    argv of ``runs`` through ``train.main`` (the user's command line), with
    the launch counters set to 0 just before and read just after; returns
    each run's counts, probe record and wall, the backend and, with
    ``grad_inputs``, the first minibatch's all-reduced gradient on them.
    With ``start_file`` it waits (started, joined and imported) until that
    file exists."""
    import os

    import torch

    from rl_selfplay_mnk_tpu_torch import train
    from rl_selfplay_mnk_tpu_torch.parallel import mesh
    from rl_selfplay_mnk_tpu_torch.utils.profiling import read_launches, reset_launches

    own = os.path.join(workdir, f"rank{mesh.process_index()}")
    os.makedirs(own, exist_ok=True)
    os.chdir(own)
    import torch.distributed as dist

    out = {"backend": dist.get_backend(), "runs": []}
    while start_file is not None and not os.path.exists(start_file):
        time.sleep(0.05)
    if check_identity:
        check_collectives_identity(torch, torch.device("cuda:0"))
    for argv in runs:
        with RunProbe() as probe:
            reset_launches()
            t0 = time.perf_counter()
            train.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
        out["runs"].append({"launches": launches, "wall": wall, **probe.record()})
    if grad_inputs is not None:
        dp = mesh.data_parallel(384, torch.device("cuda:0"))
        out["grad"] = first_gradient(torch, grad_inputs, dp)
    return out


def same_export(a, b) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def phase_distributed(torch, dev, tmp):
    """The data-parallel entry on the card (``parallel/``, ``train.main
    --multihost``), each rank started by ``parallel.launch``:

    (a) world 1 on NCCL (a process group of one), the default config for 2
        iterations, against the same command without a process group run
        meanwhile in this process: the same bits (the final exports'
        bytes), and every collective at world 1 gives back its input;
    (b) world 2, two ranks sharing the card over gloo (collectives staged
        through host memory), 2 iterations each at 384 envs: ``resnet_b_s``
        (the replicated learner) and ``transformer_b_s --zero-opt`` (the
        grouped shuffle; ``learner/zero_sharded`` = 1); finite losses on
        both ranks, exports and metric streams written by rank 0 alone, K1
        and K2 (K1, K5, K3, K4) launched on every rank; then the first
        minibatch's all-reduced gradient of the default config's learner
        against one rank's on the same trajectory, weights and indices in
        the same layout (``shard_groups`` 2), within ``DIST_GRAD_RTOL``;
    and prints the iterations' walls and the collectives' time a minibatch
    (device-synchronised timing, ``Collectives(timed=True)``) beside the
    card."""
    import os

    from rl_selfplay_mnk_tpu_torch import train
    from rl_selfplay_mnk_tpu_torch.parallel.launch import RankGroup

    t_phase = time.perf_counter()
    card = card_line()
    base = ["--total-steps", str(DIST_STEPS), "--device", "cuda:0"]

    w1_argv = base + ["--run-name", "dist_w1", "--multihost", "--num-processes", "1",
                      "--process-id", "0"]
    w1 = RankGroup("chip_smoke:rank_entry", 1, dict(runs=[w1_argv], workdir=f"{tmp}/dist_w1",
                                                    check_identity=True),
                   timeout=300, device="cuda:0")
    world2 = [
        base + ["--run-name", "dist_resnet"],
        base + ["--run-name", "dist_zero", "--arch", "transformer_b_s", "--zero-opt"],
    ]
    launched = {"dist_resnet": ("env_step", "resblock", "layer_norm"),
                "dist_zero": ("env_step", "attn_lane_slice_fwd", "attn_folded_fwd",
                              "attn_folded_bwd", "layer_norm")}
    # Each rank its own argvs (the launcher passes one kwargs; a rank picks
    # its list by its index). The two ranks start, join and import now, and
    # train once world 1 is done (``start_file``), so that no two runs share
    # the card.
    ranks = [[argv + ["--multihost", "--num-processes", "2", "--process-id", str(r)]
              for argv in world2] for r in range(2)]
    grad_inputs = f"{tmp}/dist_grad_inputs.pt"
    start_file = f"{tmp}/dist_world2_go"
    group = RankGroup("chip_smoke:rank_entry_of", 2, dict(per_rank=ranks,
                                                          workdir=f"{tmp}/dist_w2",
                                                          grad_inputs=grad_inputs,
                                                          start_file=start_file),
                      timeout=400, device="cuda:0")
    cwd = os.getcwd()
    os.makedirs(f"{tmp}/dist_nopg", exist_ok=True)
    os.chdir(f"{tmp}/dist_nopg")
    try:
        train.main(base + ["--run-name", "dist_nopg"])
        os.chdir(cwd)
        save_gradient_inputs(torch, grad_inputs)
        g1 = first_gradient(torch, grad_inputs)
        (w1_out,), _ = w1.wait()
        open(start_file, "w").close()
        outs, _ = group.wait()
    finally:
        os.chdir(cwd)
        w1.close()
        group.close()
    if w1_out["backend"] != "nccl":
        raise AssertionError(f"world 1 on the card took {w1_out['backend']}, not nccl")
    export = "models/{}/model_00002.msgpack"
    w1_export = f"{tmp}/dist_w1/rank0/" + export.format("dist_w1")
    nopg_export = f"{tmp}/dist_nopg/" + export.format("dist_nopg")
    if not same_export(w1_export, nopg_export):
        raise AssertionError("world 1 on NCCL and the run without a process group differ")
    print(f"distributed world 1 (nccl, a group of one): the same bits as without a process "
          f"group; iteration walls {[round(w, 3) for w in w1_out['runs'][0]['walls']]} s; "
          f"collectives at world 1 give back their inputs")
    if any(o["backend"] != "gloo" for o in outs):
        raise AssertionError(f"two ranks on one card took {[o['backend'] for o in outs]}")
    if os.listdir(f"{tmp}/dist_w2/rank1"):
        raise AssertionError(f"rank 1 wrote {os.listdir(f'{tmp}/dist_w2/rank1')}")
    for i, argv in enumerate(world2):
        name = argv[argv.index("--run-name") + 1]
        rank0 = f"{tmp}/dist_w2/rank0"
        if not os.path.exists(f"{rank0}/" + export.format(name)):
            raise AssertionError(f"{name}: rank 0 wrote no final export")
        records = [json.loads(line) for line in open(f"{rank0}/runs/{name}.jsonl")]
        flag = [r["learner/zero_sharded"] for r in records if "learner/zero_sharded" in r]
        if flag != [1 if name == "dist_zero" else 0]:
            raise AssertionError(f"{name}: learner/zero_sharded {flag}")
        for r, out in enumerate(outs):
            run = out["runs"][i]
            for m in run["metrics"]:
                if not all(math.isfinite(m[k]) for k in ("actor_loss", "critic_loss",
                                                          "entropy_loss", "grad_norm")):
                    raise AssertionError(f"{name} rank {r}: metrics not finite: {m}")
            if len(run["metrics"]) != 2:
                raise AssertionError(f"{name} rank {r}: {len(run['metrics'])} iterations")
            for kernel in launched[name]:
                if run["launches"][kernel] <= 0:
                    raise AssertionError(f"{name} rank {r}: kernel {kernel} not launched")
            per_mb = run["update_s"] / max(run["minibatches"], 1)
            calls = run["update_calls"] / max(run["minibatches"], 1)
            print(f"distributed world 2 {name} rank {r}: iteration walls "
                  f"{[round(w, 3) for w in run['walls']]} s, collectives in the update "
                  f"{per_mb * 1e3:.3f} ms a minibatch ({calls:.1f} calls), by op "
                  f"{json.dumps({k: [c, round(t, 4)] for k, (c, t) in run['stats'].items()})}, "
                  f"launches {json.dumps({k: v for k, v in run['launches'].items() if v})}")
    g2 = [o["grad"] for o in outs]
    if not torch.equal(g2[0], g2[1]):
        raise AssertionError("the ranks' all-reduced gradients differ")
    rel = ((g2[0] - g1).norm() / g1.norm()).item()
    if not rel <= DIST_GRAD_RTOL:
        raise AssertionError(f"the first minibatch's all-reduced gradient is {rel:.3e} of its "
                             f"norm from one rank's (limit {DIST_GRAD_RTOL:.3e})")
    print(f"distributed: first minibatch gradient, two ranks against one on the same "
          f"trajectory in the same layout: ||g2 - g1|| / ||g1|| = {rel:.3e} (limit 2^-7)")
    print(f"distributed phase: {time.perf_counter() - t_phase:.1f}s on {card}")


def rank_entry_of(per_rank, workdir, grad_inputs=None, start_file=None):
    """``rank_entry`` with this rank's own list of argvs."""
    from rl_selfplay_mnk_tpu_torch.parallel.mesh import process_index

    return rank_entry(per_rank[process_index()], workdir, grad_inputs=grad_inputs,
                      start_file=start_file)


def read_csv(path):
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def phase_tournament(torch, label, paths, board, out_dir, launched, first, last, least_wins,
                     rising=()):
    """A round robin through ``compare_models.main`` on the card, 32 games a
    pairing, the launch counts set to 0 just before and read just after.
    Every pairing's games add up; the export ``last`` takes at least
    ``least_wins`` games from ``first``; ELO rises along ``rising``."""
    from rl_selfplay_mnk_tpu_torch import compare_models
    from rl_selfplay_mnk_tpu_torch.utils.profiling import read_launches, reset_launches

    games = 32
    reset_launches()
    t0 = time.perf_counter()
    saved = compare_models.main([*paths, "--games", str(games), "--board", *map(str, board),
                                 "--output", out_dir, "--seed", "0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    matches = read_csv(f"{saved}/match_results.csv")
    ratings = {row["unique_id"]: float(row["rating"]) for row in read_csv(f"{saved}/elo_ratings.csv")}
    players = len(ratings)
    if len(matches) != players * (players - 1) // 2:
        raise AssertionError(f"{label}: {len(matches)} pairings for {players} models")
    for row in matches:
        total = int(row["player1_wins"]) + int(row["player2_wins"]) + int(row["draws"])
        if total != games or int(row["total_games"]) != games:
            raise AssertionError(f"{label}: {row['player1_unique_id']} vs "
                                 f"{row['player2_unique_id']} played {total} of {games} games")
    for name in launched:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: kernel {name} was not launched by the tournament")
    wins = None
    for row in matches:
        if (row["player1_unique_id"], row["player2_unique_id"]) == (first, last):
            wins = int(row["player2_wins"])
        elif (row["player1_unique_id"], row["player2_unique_id"]) == (last, first):
            wins = int(row["player1_wins"])
    if wins is None or wins < least_wins:
        raise AssertionError(f"{label}: {last} took {wins} of {games} from {first}, "
                             f"expected at least {least_wins}")
    for lower, higher in zip(rising, rising[1:]):
        if not ratings[lower] < ratings[higher]:
            raise AssertionError(f"{label}: ELO {lower} {ratings[lower]} is not below "
                                 f"{higher} {ratings[higher]}")
    print(f"{label}: {players} models, {len(matches)} pairings of {games} games in {wall:.1f}s; "
          f"{last} took {wins} of {games} from {first}; ELO "
          + ", ".join(f"{key} {ratings[key]:.2f}" for key in (rising or (first, last)))
          + f"; launches {json.dumps(launches)}")
    return launches


def phase_play(torch, model_dir):
    """One game through ``play.main`` on the card: the directory's latest
    export (Black) against the random policy; the export wins."""
    import contextlib
    import io

    from rl_selfplay_mnk_tpu_torch import play

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        history, winner = play.main(["--p1", model_dir, "--p2", "random", "--seed", "3"])
    torch.cuda.synchronize()
    last = [line for line in out.getvalue().splitlines() if line.strip()][-1]
    print(f"play: {len(history)} moves; {last}")
    if winner != 0:
        raise AssertionError(f"play: the trained model did not win (winner {winner})")


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

    from rl_selfplay_mnk_tpu_torch.models import snapshot
    from rl_selfplay_mnk_tpu_torch.models.registry import eval_apply
    from rl_selfplay_mnk_tpu_torch.utils.profiling import read_launches, reset_launches

    obs = real_positions(torch, np, dev, mnk, 256, 24, seed=3)

    def plain_forward(dtype):
        twin = copy.deepcopy(model)
        twin.dtype = dtype
        for layer in twin.layers:
            layer.attn.attention_fn = plain_tiny_head_attention
        return eval_apply(twin, obs)

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


def time_attention(torch, dev, name, b, l, h, dh):
    """One attention kernel at one shape, bf16: its device and per-call time,
    its plain version's, the library yardstick's, and the bound."""
    import torch.nn.functional as F

    layout, backward = ATTN_KERNELS[name][:2]
    packed = layout == "packed"
    kernel, plain_version = attn_kernel(name)
    q, k, v, do = attn_inputs(torch, dev, torch.bfloat16, b, l, h, dh, packed, seed=5)
    args = (q, k, v, do) if backward else (q, k, v)
    extra = (h, dh) if packed else ()
    plain_iters = 10 if b > 1024 else 30
    ms, call = timed(lambda: kernel(*args, *extra), name, 50)
    first = {}
    if name in TENSOR_CORE_KERNELS:  # the FMA kernel, the first version, on the same inputs
        first["first_version_ms"], first["first_version_call_ms"] = timed(
            lambda: kernel(*args, *extra, kernel="fma"), name, 50)
    plain, plain_call = timed(lambda: plain_version(*args, *extra), iters=plain_iters, warmup=3)

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
    return {"shape": [b, l, h, dh], "ms": ms, **first, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib, "call_ms": call,
            "plain_call_ms": plain_call, "library_call_ms": lib_call}


def attention_kernel_records(torch, dev, launches, attn_errors):
    """The seven attention kernels' entries of the ``kernels`` line: timed at
    the update minibatch (the entry's own numbers), at the rollout batch and,
    for the one-block-per-board kernels, at a tournament half-pairing.
    ``launches`` maps a kernel to (count, the path that counted it)."""
    records = []
    for name, (_, backward, replaces, source, (l, h, dh), batches) in ATTN_KERNELS.items():
        at = [time_attention(torch, dev, name, b, l, h, dh) for b in batches]
        record = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name][0],
            "launches_on": launches[name][1],
            "max_abs_err": attn_errors[(name, "bfloat16", (batches[0], l, h, dh))],
        }
        record.update({key: value for key, value in at[0].items() if key != "shape"})
        record["library"] = ("scaled_dot_product_attention forward + backward" if backward
                             else "scaled_dot_product_attention")
        record["shape"] = at[0]["shape"]
        record["at_rollout_batch"] = at[1]
        if len(at) > 2:
            record["at_tournament_batch"] = at[2]
        if name == "attn_packed_bwd":  # the transformer_s and transformer_l updates' heads
            record["at_dh32_minibatch"] = time_attention(torch, dev, name, 384, 81, 3, 32)
        if name in INSTANTIATIONS:
            record["instantiations"] = instantiations(torch, dev, name)
        records.append(record)
    return records


def instantiations(torch, dev, name):
    """What each tensor-core instantiation on the paths of K4-K9 takes on the
    card (registers, spill bytes, shared memory, blocks an SM); for K5, K6
    and K7 also the block's unit of work at each batch the kernel is timed
    at."""
    from rl_selfplay_mnk_tpu_torch.ops.attention import board_mma_plan, mma_resources

    kernel = name.removeprefix("attn_")
    out = []
    for shape in INSTANTIATIONS[name]:
        if len(shape) == 2:
            l, dh = shape
            rec = {"L": l, "dh": dh, **mma_resources(kernel, l, dh, dev)}
            print(f"{name} tensor cores (L, Dh)={shape}: {rec['registers']} registers, "
                  f"{rec['local_bytes']} local (spill) bytes a thread; {rec['heads_per_block']} "
                  f"heads, {rec['smem_bytes']} bytes of shared memory a block; "
                  f"{rec['blocks_per_sm']} blocks an SM")
        else:
            l, h, dh = shape
            plans = {b: board_mma_plan(kernel, b, l, h, dh, dev)._asdict()
                     for b in ATTN_KERNELS[name][5]}
            first = next(iter(plans.values()))
            rec = {"L": l, "H": h, "dh": dh, "registers": first["registers"],
                   "local_bytes": first["local_bytes"], "plans": plans}
            print(f"{name} tensor cores (L, H, Dh)={shape}: {rec['registers']} registers, "
                  f"{rec['local_bytes']} local (spill) bytes a thread")
            for b, plan in plans.items():
                print(f"  at B={b}: {plan['per_block']} {plan['unit']} a block, "
                      f"{plan['blocks_per_board']} blocks a board, {plan['blocks']} blocks; "
                      f"{plan['smem_bytes']} bytes of shared memory a block, "
                      f"{plan['blocks_per_sm']} blocks an SM")
        out.append(rec)
    return out


def phase_threshold(torch, dev):
    """The four ways from the models' (B, L, H, Dh) layout through an
    attention kernel and back, the result made contiguous as the output
    projection needs it, layout operations included: the two routes that
    ``tiny_head_attention`` lets a caller force, and the packed pair and the
    lane-slice kernel called as its dispatch calls them. Per-call time between
    CUDA events of the forward under ``no_grad`` and of forward plus backward
    (none for the lane-slice kernel, which has no backward)."""
    from rl_selfplay_mnk_tpu_torch.ops import attention as attn

    def on_packed(kernel):
        def route(q, k, v):
            b, l, h, dh = q.shape
            out = kernel(*(t.reshape(b, l, h * dh) for t in (q, k, v)), h, dh)
            return out.reshape(b, l, h, dh)
        return route

    routes = {
        "folded": lambda q, k, v: attn.tiny_head_attention(q, k, v, route="folded"),
        "infold": lambda q, k, v: attn.tiny_head_attention(q, k, v, route="infold"),
        "packed": on_packed(attn.attention_packed),
        "lane_slice": on_packed(attn.attention_lane_slice_fwd),
    }
    results = []
    for b, l, h, dh in THRESHOLD_SHAPES:
        g = torch.Generator(device=dev).manual_seed(9)
        q, k, v, do = (torch.randn((b, l, h, dh), device=dev, generator=g).to(torch.bfloat16)
                       for _ in range(4))
        with torch.no_grad():
            taken_without = tiny_head_attention_route(torch, q, k, v)
        row = {"shape": [b, l, h, dh], "dispatch_takes_without_gradient": taken_without}
        for name, route in routes.items():
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

            def forward():
                with torch.no_grad():
                    return route(q, k, v).contiguous()

            def forward_backward():
                out = route(*leaves).contiguous()
                return torch.autograd.grad(out, leaves, do)

            iters = 30 if b > 1024 else 100
            row[f"{name}_fwd_call_ms"] = time_ms(forward, iters=iters, warmup=3)
            row[f"{name}_fwd_bwd_call_ms"] = (
                None if name == "lane_slice" else time_ms(forward_backward, iters=iters, warmup=3))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        row["dispatch_takes_with_gradient"] = tiny_head_attention_route(torch, *leaves)
        results.append(row)
        print(f"threshold (B, L, H, Dh)={tuple(row['shape'])} (dispatch takes "
              f"{row['dispatch_takes_without_gradient']} without a gradient, "
              f"{row['dispatch_takes_with_gradient']} with one): "
              + ", ".join(f"{key} {value:.4f}" for key, value in row.items()
                          if key.endswith("_ms") and value is not None))
    return results


def tiny_head_attention_route(torch, q, k, v):
    """The route ``tiny_head_attention`` takes for these tensors by itself:
    the one whose forward wrapper counts a launch."""
    from rl_selfplay_mnk_tpu_torch.ops import attention as attn

    forwards = {"folded": attn.attention_folded_fwd, "packed": attn.attention_packed_fwd,
                "infold": attn.attention_infold_fwd, "lane_slice": attn.attention_lane_slice_fwd}
    before = {route: fn.launches for route, fn in forwards.items()}
    attn.tiny_head_attention(q, k, v)
    taken = [route for route, fn in forwards.items() if fn.launches != before[route]]
    if len(taken) != 1:
        raise AssertionError(f"tiny_head_attention launched {taken}")
    return taken[0]


def time_resblock(torch, F, dev, b, c=32):
    """K2 at B boards of 9x9, C channels, bf16: the tensor-core kernel, its
    first version (the FMA kernel) on the same inputs, the plain version,
    cuDNN's two convolutions with the bias, ReLU and residual, and the bound."""
    from rl_selfplay_mnk_tpu_torch.ops.resblock import (
        fused_residual_block,
        fused_residual_block_reference,
    )

    x, w1, b1, w2, b2 = k2_inputs(torch, b, c, torch.bfloat16, dev, seed=3)
    ms, call = timed(lambda: fused_residual_block(x, w1, b1, w2, b2, 9, 9), "resblock")
    first, first_call = timed(lambda: fused_residual_block(x, w1, b1, w2, b2, 9, 9, kernel="fma"),
                              "resblock")
    plain, plain_call = timed(lambda: fused_residual_block_reference(x, w1, b1, w2, b2, 9, 9), iters=50)
    cw1 = w1.reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous()
    cw2 = w2.reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous()
    cb1, cb2 = b1.to(torch.bfloat16), b2.to(torch.bfloat16)
    x_nchw = x.view(b, 9, 9, c).permute(0, 3, 1, 2)

    def library_block():
        h = torch.relu(F.conv2d(x_nchw, cw1, cb1, padding=1))
        return torch.relu(F.conv2d(h, cw2, cb2, padding=1) + x_nchw)

    lib, lib_call = timed(library_block)
    nbytes = 2 * x.numel() * 2 + 2 * w1.numel() * 2 + 2 * c * 4
    bound_ms, bound_by = bound(nbytes, 2 * (2 * b * 81 * 9 * c * c), "bfloat16")
    return {"shape": [b, 81, c], "ms": ms, "first_version_ms": first, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib, "call_ms": call,
            "first_version_call_ms": first_call, "plain_call_ms": plain_call,
            "library_call_ms": lib_call}


def time_layer_norm(torch, dev, rows, width=56):
    """LayerNorm over ``rows`` rows of ``width`` in bf16, as the update
    (forward with the statistics, backward) and the rollout (forward alone)
    run it: the kernels, the plain version (cast, f32 ``F.layer_norm``,
    cast, and autograd's backward of the three), ``F.layer_norm`` on bf16
    (the library yardstick, which the port never calls), and the bound by
    bytes."""
    import torch.nn.functional as F

    from rl_selfplay_mnk_tpu_torch.ops.layer_norm import (
        layer_norm_bwd,
        layer_norm_fwd,
        layer_norm_reference,
    )

    x, dy, weight, bias = ln_inputs(torch, dev, torch.bfloat16, rows, width, seed=4)
    _, mean, rstd = layer_norm_fwd(x, weight, bias, LN_EPS, stats=True)
    ms, call = timed(lambda: layer_norm_fwd(x, weight, bias, LN_EPS, stats=True), "ln_rows_fwd")
    rollout_ms, rollout_call = timed(lambda: layer_norm_fwd(x, weight, bias, LN_EPS, stats=False),
                                     "ln_rows_fwd")
    bwd_ms, bwd_call = timed(lambda: layer_norm_bwd(x, dy, weight, mean, rstd))
    with torch.no_grad():
        plain, plain_call = timed(lambda: layer_norm_reference(x, weight, bias, LN_EPS))
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, weight, bias)]
    y_plain = layer_norm_reference(*leaves, LN_EPS)
    plain_bwd, plain_bwd_call = timed(
        lambda: torch.autograd.grad(y_plain, leaves, dy, retain_graph=True))
    wb, bb = weight.to(torch.bfloat16), bias.to(torch.bfloat16)
    with torch.no_grad():
        lib, lib_call = timed(lambda: F.layer_norm(x, (width,), wb, bb, LN_EPS))
    lib_leaves = [t.detach().clone().requires_grad_(True) for t in (x, wb, bb)]
    y_lib = F.layer_norm(lib_leaves[0], (width,), lib_leaves[1], lib_leaves[2], LN_EPS)
    lib_bwd, lib_bwd_call = timed(
        lambda: torch.autograd.grad(y_lib, lib_leaves, dy, retain_graph=True))
    elems = rows * width
    # forward: x in, y out, each row's mean and rstd out; backward: x, dy,
    # mean and rstd in, dx out; weight, bias and their gradients once
    fwd_bound, fwd_by = bound(2 * elems * 2 + rows * 8 + 2 * width * 4, 8 * elems, "float32")
    rollout_bound, _ = bound(2 * elems * 2 + 2 * width * 4, 8 * elems, "float32")
    bwd_bound, bwd_by = bound(3 * elems * 2 + rows * 8 + 3 * width * 4, 12 * elems, "float32")
    return {"shape": [rows, width], "ms": ms, "plain_ms": plain, "bound_ms": fwd_bound,
            "bound_by": fwd_by, "library_ms": lib, "call_ms": call, "plain_call_ms": plain_call,
            "library_call_ms": lib_call,
            "no_statistics": {"ms": rollout_ms, "call_ms": rollout_call, "bound_ms": rollout_bound},
            "backward": {"ms": bwd_ms, "plain_ms": plain_bwd, "bound_ms": bwd_bound,
                         "bound_by": bwd_by, "library_ms": lib_bwd, "call_ms": bwd_call,
                         "plain_call_ms": plain_bwd_call, "library_call_ms": lib_bwd_call}}


def layer_norm_record(torch, dev, launches, ln_errors):
    """The LayerNorm kernels' entry of the ``kernels`` line: at the update
    minibatch's 8192 x 81 rows of d = 56 (the entry's own numbers) and the
    rollout's 384 x 81, with each instantiation's registers, spill bytes
    and blocks an SM at the registry's widths."""
    from rl_selfplay_mnk_tpu_torch.ops.layer_norm import kernel_resources, row_plan

    main, rollout = (time_layer_norm(torch, dev, rows) for rows in LN_TIMED_ROWS)
    resources = {}
    for width in (56, 81, 162, 128, 256, 338):
        plan = row_plan(width, 2)
        resources[width] = {"plan": plan._asdict(),
                            **{kind: kernel_resources(True, plan, kind == "backward", width)
                               for kind in ("forward", "backward")}}
    record = {
        "name": "layer_norm",
        "route": "cuda",
        "source": "rl_selfplay_mnk_tpu_torch/csrc/layer_norm.cu",
        "replaces": None,
        "launches": launches["layer_norm"][0],
        "launches_on": launches["layer_norm"][1],
        "max_abs_err": ln_errors[("bfloat16", LN_TIMED_ROWS[0], 56)],
        **{key: value for key, value in main.items() if key != "shape"},
        "library": "F.layer_norm on bf16 (forward; backward: autograd's)",
        "shape": main["shape"],
        "at_rollout_batch": rollout,
        "instantiations": resources,
    }
    for r in (main, rollout):
        b = r["backward"]
        print(f"  LayerNorm at {tuple(r['shape'])}: forward without statistics "
              f"{r['no_statistics']['ms']:.5f} ms (bound {r['no_statistics']['bound_ms']:.5f}); "
              f"backward device {b['ms']:.5f} ms, per call {b['call_ms']:.5f} ms; plain "
              f"{b['plain_ms']:.5f} ms; library {b['library_ms']:.5f} ms; bound "
              f"{b['bound_ms']:.5f} ms by {b['bound_by']}")
    print(f"  LayerNorm instantiations (bf16): {json.dumps(resources)}")
    return record


def phase_timings(torch, dev, launches, k1_error, k2_errors, attn_errors, ln_errors):
    import torch.nn.functional as F

    from rl_selfplay_mnk_tpu_torch.env.lines import num_lines
    from rl_selfplay_mnk_tpu_torch.ops.env_step import kernel_resources
    from rl_selfplay_mnk_tpu_torch.utils.env_step_study import TIMED, time_k1

    # K1 on mid-game boards at the main path's 384 envs, bench.py's 8192,
    # 13x13 and a tournament half-pairing; bound by the bytes it must move.
    k1 = {}
    for mnk, e in TIMED:
        r = time_k1(mnk, e, dev)
        ops = e * (2 * mnk[0] * mnk[1] + num_lines(*mnk) * mnk[2] + 8)  # placement, line sums, flags
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), ops, "float32")
        r["library_ms"] = None
        k1[mnk, e] = r
    k1_main = k1[(9, 9, 5), 384]

    k2 = {b: time_resblock(torch, F, dev, b) for b in K2_TIMED_BATCHES}
    kernels = [
        {
            "name": "env_step",
            "route": "cuda",
            "source": "rl_selfplay_mnk_tpu_torch/csrc/env_step.cu",
            "replaces": "rl_selfplay_mnk_tpu/ops/pallas_env.py:28",
            "launches": launches["env_step"][0],
            "launches_on": launches["env_step"][1],
            "max_abs_err": k1_error,
            **{key: k1_main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                             "call_ms", "plain_call_ms")},
            "library_call_ms": None,
            "shape": k1_main["shape"],
            "at_bench_batch": k1[(9, 9, 5), 8192],
            "at_13x13": k1[(13, 13, 5), 384],
            "at_tournament_batch": k1[(9, 9, 5), 16],
            "resources": kernel_resources(),
        },
        {
            "name": "resblock",
            "route": "cuda",
            "source": "rl_selfplay_mnk_tpu_torch/csrc/resblock.cu",
            "replaces": "rl_selfplay_mnk_tpu/ops/pallas_resnet.py:67",
            "launches": launches["resblock"][0],
            "launches_on": launches["resblock"][1],
            "max_abs_err": k2_errors[("bfloat16", 384, 32)],
            **{key: value for key, value in k2[384].items() if key != "shape"},
            "library": "two F.conv2d (cuDNN), with the bias, ReLU and residual",
            "shape": k2[384]["shape"],
            "at_bench_batch": k2[8192],
            "at_tournament_batch": k2[16],
            "at_play_batch": k2[1],
        },
    ]
    kernels += attention_kernel_records(torch, dev, launches, attn_errors)
    kernels.append(layer_norm_record(torch, dev, launches, ln_errors))
    for k in kernels:
        first = f" (first version {k['first_version_ms']:.5f})" if "first_version_ms" in k else ""
        print(f"timing {k['name']}: device {k['ms']:.5f} ms{first}, per call {k['call_ms']:.5f} ms; "
              f"plain device {k['plain_ms']:.5f} ms, per call {k['plain_call_ms']:.5f} ms; "
              f"library {k['library_ms']} / {k['library_call_ms']} ms; "
              f"bound {k['bound_ms']:.5f} ms by {k['bound_by']}")
        if "resources" in k:
            print(f"  registers, spill bytes, blocks an SM: {k['resources']}")
        for key in ("at_bench_batch", "at_13x13", "at_rollout_batch", "at_dh32_minibatch",
                    "at_tournament_batch", "at_play_batch"):
            r = k.get(key)
            if r:
                first = f" (first version {r['first_version_ms']:.5f})" if "first_version_ms" in r else ""
                lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.5f} ms"
                print(f"  at {tuple(r['shape'])}: device {r['ms']:.5f} ms{first}, per call "
                      f"{r['call_ms']:.5f} ms; plain device {r['plain_ms']:.5f} ms; library "
                      f"{lib}; bound {r['bound_ms']:.5f} ms by {r['bound_by']}")
    return kernels


def lfm2_kernel_records(launches) -> list:
    """LFM2's kernels at the benchmark cell's shapes (``utils/lfm2_study.py``):
    RMSNorm at 2048 and 64, the short convolution pair, the expert layer's
    dispatch and combine and its grouped products, K8/K9 at (512, 81, 32,
    64); each with its launches on the LFM2 train path. ``lfm2_study.rows``
    holds each kernel's outputs to its plain version's first and raises
    past the bf16 limit (``error``: the worst share of it)."""
    import torch

    from rl_selfplay_mnk_tpu_torch.utils import lfm2_study

    wrapper = {"rms_norm_2048": "rms_norm", "rms_norm_64": "rms_norm",
               "short_conv": "short_conv", "moe_dispatch": "moe", "expert_gemm": "moe",
               "K8": "attn_packed_fwd", "K9": "attn_packed_bwd"}
    records = []
    for row in lfm2_study.rows(torch.device("cuda:0")):
        name = wrapper[row["name"]]
        row.update(launches=launches[name][0], launches_on=launches[name][1])
        records.append(row)
        back = row.get("backward")
        extra = (f"; backward {back['ms']:.5f} ms (plain {back['plain_ms']}, library "
                 f"{back['library_ms']}, bound {back['bound_ms']:.5f})" if back else "")
        print(f"timing {row['name']} at {tuple(row['shape'])}: device {row['ms']:.5f} ms, per call "
              f"{row['call_ms']:.5f} ms; plain {row['plain_ms']} ms; library {row['library_ms']} "
              f"ms; bound {row['bound_ms']:.5f} ms by {row['bound_by']}{extra}; "
              f"{row['error']:.3f} of the bf16 limit")
    return records


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
    ln_errors = phase_layer_norm(torch, dev)

    import functools
    import tempfile

    from rl_selfplay_mnk_tpu_torch.models import registry
    from rl_selfplay_mnk_tpu_torch.ops.attention import GRADIENT_ROUTE, tiny_head_attention

    folded = ("attn_folded_fwd", "attn_folded_bwd")
    infold = ("attn_infold_fwd", "attn_infold_bwd")
    packed = ("attn_packed_fwd", "attn_packed_bwd")
    gradient_pairs = {"folded": folded, "infold": infold}
    default_pair = gradient_pairs[GRADIENT_ROUTE]
    other_route = "infold" if GRADIENT_ROUTE == "folded" else "folded"
    other_pair = gradient_pairs[other_route]
    paths = {}  # label -> launch counts of that path

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        config = build_config()
        config.update(validation_interval=2, export_dir=f"{tmp}/models")
        label = "resnet_b_s 9x9x5"
        paths[label], summary = phase_train(
            torch, dev, label, config, 3, ("env_step", "resblock", "layer_norm"),
            folded + infold + packed + ("attn_lane_slice_fwd",))
        phase_eval_check(torch, np, dev, summary["model"])
        sources = summary["opponent_sources"]

        # Path A: rollouts, opponents and validations record no gradient (K5),
        # the update does (the default pair).
        config = build_config("transformer_b_s")
        config.update(validation_interval=1, export_dir=f"{tmp}/models")
        label_a = "transformer_b_s 9x9x5"
        paths[label_a], summary = phase_train(
            torch, dev, label_a, config, 4,
            ("env_step", "attn_lane_slice_fwd", "layer_norm") + default_pair,
            packed + other_pair + ("resblock",), validations=3)
        exports_a = summary["export_dir"]
        phase_watch_record(summary, config)

        config = build_config("transformer_b_s_w", (13, 13, 5), 4096)
        config.update(validation_interval=2, export_dir=f"{tmp}/models")
        label_b = "transformer_b_s_w 13x13x5"
        paths[label_b], summary = phase_train(
            torch, dev, label_b, config, 3, ("env_step", "layer_norm") + packed,
            folded + infold + ("resblock", "attn_lane_slice_fwd"))
        phase_transformer_eval_check(torch, np, dev, summary["model"], (13, 13, 5))

        # Path C: the gated family with every attention forced to the other
        # with-gradient route, forwards without a gradient included.
        config = build_config("transformer_c_s")
        config.update(validation_interval=1, export_dir=f"{tmp}/models")
        label_c = f"transformer_c_s 9x9x5 route={other_route}"
        factory = registry.ARCHITECTURE_REGISTRY["transformer_c_s"]
        registry.ARCHITECTURE_REGISTRY["transformer_c_s"] = functools.partial(
            factory, attention_fn=functools.partial(tiny_head_attention, route=other_route))
        try:
            paths[label_c], _ = phase_train(
                torch, dev, label_c, config, 2, ("env_step", "layer_norm") + other_pair,
                packed + default_pair + ("resblock", "attn_lane_slice_fwd"))
        finally:
            registry.ARCHITECTURE_REGISTRY["transformer_c_s"] = factory

        # LFM2 at its published widths through train_mnk's own loop: the RMS
        # mode, the short convolution, the expert layer's kernels and K8/K9.
        config = build_config("lfm2_8b_a1b_l6_e8")
        config.update(num_envs=32, n_steps=8, batch_size=128, validation_interval=1,
                      validation_episodes=16, export_dir=f"{tmp}/models")
        label_lfm2 = "lfm2_8b_a1b_l6_e8 9x9x5"
        paths[label_lfm2], _ = phase_train(
            torch, dev, label_lfm2, config, 2,
            ("env_step", "layer_norm", "rms_norm", "short_conv", "moe") + packed,
            folded + infold + ("resblock", "attn_lane_slice_fwd"))

        phase_resume(torch, dev, sources, tmp)
        label_bench = "bench 9x9x5 8192 envs"
        paths[label_bench] = phase_bench(torch, label_bench)
        phase_fused(torch, dev, tmp, default_pair)
        phase_distributed(torch, dev, tmp)

        # The serving path.
        label_9 = "tournament 9x9x5"
        paths[label_9] = phase_tournament(
            torch, label_9, ["models/tpu_smoke30", exports_a], (9, 9, 5), f"{tmp}/results",
            ("env_step", "resblock", "attn_lane_slice_fwd", "layer_norm"),
            "tpu_smoke30/model_00005", "tpu_smoke30/model_00030", 24,
            rising=("tpu_smoke30/model_00005", "tpu_smoke30/model_00015", "tpu_smoke30/model_00030"))
        full13 = "evidence/exports_full13_transformer_b_s_w"
        label_13 = "tournament 13x13x5"
        paths[label_13] = phase_tournament(
            torch, label_13, [f"{full13}/model_{i:05d}.msgpack" for i in (5, 1345, 2690, 4365)],
            (13, 13, 5), f"{tmp}/results", ("env_step", "attn_packed_fwd", "layer_norm"),
            "full13_transformer_b_s_w/model_00005", "full13_transformer_b_s_w/model_04365", 28)
        phase_play(torch, "models/tpu_smoke30")

    # Each kernel's launches: the count of the first of these paths that ran it.
    launches = {}
    for name in paths[label]:
        for path in (label_9, label_13, label_a, label_b, label_c, label, label_bench, label_lfm2):
            if paths[path][name] > 0:
                launches[name] = (paths[path][name], path)
                break
        else:
            raise AssertionError(f"kernel {name} was launched on none of the paths")
    threshold = phase_threshold(torch, dev)
    kernels = phase_timings(torch, dev, launches, k1_error, k2_errors, attn_errors, ln_errors)
    kernels += lfm2_kernel_records(launches)

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
