"""The fused env step (kernel K1) and its plain PyTorch version.

Replaces the TPU kernel ``rl_selfplay_mnk_tpu/ops/pallas_env.py``
(``_step_kernel``, entry ``fused_step``): stone placement gated by
``active``, move count, the K-in-a-row win check, draw/done/reward, the
player toggle and the next action mask.

On the H100 the call is bound by bytes (11.5 MB at bench.py's 8192 envs on
9x9), and at the main path's 384 envs by one memory round trip and the
launch. The kernel (``csrc/env_step.cu``) is one launch, a warp per env, any
env count: the mover's stones become ballot words and every run of k is a
shift-and-AND in registers, with an exact float count in the kernel for an
env whose planes hold values other than 0 and 1. It reads no line table.

``fused_step`` launches the kernel for CUDA tensors and runs
``fused_step_reference`` for CPU tensors; there is no other route. Both
give the same six outputs bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..env.lines import line_matrix
from ..env.mnk_env import EnvConfig, EnvState
from .cuda_build import check_launch, load_library


def fused_step_reference(
    cfg: EnvConfig,
    state: EnvState,
    actions: torch.Tensor,
    active: Optional[torch.Tensor] = None,
):
    """Plain PyTorch version of the kernel, with the TPU kernel's arithmetic.

    Returns (new_state, rewards, dones, action_mask).
    """
    e = state.boards.shape[0]
    mn = cfg.num_actions
    device = state.boards.device
    if active is None:
        active = torch.ones((e,), dtype=torch.bool, device=device)
    boards = state.boards.reshape(e, 2 * mn)
    black, white = boards[:, :mn], boards[:, mn:]
    active_f = active.to(torch.float32)[:, None]
    cols = torch.arange(mn, device=device)
    onehot = (cols[None, :] == actions.to(torch.int64)[:, None]).to(torch.float32) * active_f
    is_black = (state.current_player == 0).to(torch.float32)[:, None]
    black = black + onehot * is_black
    white = white + onehot * (1.0 - is_black)
    move_count = state.move_count + active.to(torch.int32)

    mover = black * is_black + white * (1.0 - is_black)
    lines = torch.from_numpy(line_matrix(cfg.m, cfg.n, cfg.k)).to(device)
    winners = (mover @ lines > cfg.k - 0.5).any(dim=1) & active
    draws = (move_count >= mn) & ~winners & active
    mask = (black + white) < 0.5
    new_state = EnvState(
        boards=torch.cat([black, white], dim=1).reshape(e, 2, cfg.m, cfg.n),
        current_player=state.current_player ^ active.to(torch.int32),
        move_count=move_count,
        action_mask=mask,
    )
    return new_state, winners.to(torch.float32), winners | draws, mask


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("env_step")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.env_step_launch.argtypes = [p] * 5 + [i] * 4 + [p] * 7
    lib.env_step_launch.restype = ctypes.c_int
    lib.env_step_resources.argtypes = [ctypes.POINTER(i)] * 3
    lib.env_step_resources.restype = ctypes.c_int
    return lib


def kernel_resources() -> dict:
    """The kernel's registers and spilled bytes a thread, and the blocks of
    four envs an SM holds at once (``cudaFuncGetAttributes``)."""
    regs, local, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    check_launch("env_step_resources",
                 _lib().env_step_resources(ctypes.byref(regs), ctypes.byref(local),
                                           ctypes.byref(blocks)))
    return {"registers": regs.value, "local_bytes": local.value, "blocks_per_sm": blocks.value}


def _require(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"fused_step: {name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}"
        )


def fused_step(
    cfg: EnvConfig,
    state: EnvState,
    actions: torch.Tensor,
    active: Optional[torch.Tensor] = None,
):
    """One env step plus the next action mask.

    Returns (new_state, rewards, dones, action_mask), identical to the JAX
    package's ``fused_step``; ``new_state`` carries the same mask, so the
    next ``observe`` reads it instead of recomputing it. CUDA tensors launch the kernel (and add one to
    ``fused_step.launches``); CPU tensors take ``fused_step_reference``.
    """
    device = state.boards.device
    if device.type == "cpu":
        return fused_step_reference(cfg, state, actions, active)
    if device.type != "cuda":
        raise ValueError(f"fused_step: unsupported device {device}")
    e = state.boards.shape[0]
    mn = cfg.num_actions
    if active is None:
        active = torch.ones((e,), dtype=torch.bool, device=device)
    actions = actions.to(torch.int64)
    _require(state.boards, "boards", torch.float32, (e, 2, cfg.m, cfg.n))
    _require(state.current_player, "current_player", torch.int32, (e,))
    _require(state.move_count, "move_count", torch.int32, (e,))
    _require(actions, "actions", torch.int64, (e,))
    _require(active, "active", torch.bool, (e,))
    for t in (state.current_player, state.move_count, actions, active):
        if t.device != device:
            raise ValueError("fused_step: all inputs must be on one device")

    boards = torch.empty_like(state.boards)
    player = torch.empty_like(state.current_player)
    move_count = torch.empty_like(state.move_count)
    rewards = torch.empty((e,), dtype=torch.float32, device=device)
    dones = torch.empty((e,), dtype=torch.bool, device=device)
    mask = torch.empty((e, mn), dtype=torch.bool, device=device)
    code = _lib().env_step_launch(
        state.boards.data_ptr(), state.current_player.data_ptr(),
        state.move_count.data_ptr(), actions.data_ptr(), active.data_ptr(),
        e, cfg.m, cfg.n, cfg.k,
        boards.data_ptr(), player.data_ptr(), move_count.data_ptr(),
        rewards.data_ptr(), dones.data_ptr(), mask.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    check_launch("env_step", code)
    fused_step.launches += 1
    return EnvState(boards, player, move_count, mask), rewards, dones, mask


fused_step.launches = 0
