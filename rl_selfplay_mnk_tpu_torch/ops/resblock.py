"""The eval-mode residual block (kernel K2) and its plain PyTorch version.

Replaces the TPU kernel ``rl_selfplay_mnk_tpu/ops/pallas_resnet.py``
(``_resblock_kernel``, entry ``fused_residual_block``)::

    h = relu(conv1(x) + b1)            rounded to x's dtype
    y = relu(conv2(h) + b2 + x)

for 3x3 SAME convolutions with BatchNorm folded into the weights
(``models/fold_bn.py``), activations channels-last (B, M*N, C), weights in
im2col layout (9C, C) ordered (dy, dx, cin), f32 accumulation.

On the H100 the main path's call (384 boards, 9x9, C=32, bf16) has an ideal
time bound by bytes, about equal to its tensor-core time; at a tournament's
16 boards it is a few microseconds of one block's latency. The kernels are
in ``csrc/resblock.cu``, chosen by dtype (``kernel_for``): bf16 runs each
conv as an implicit GEMM on the tensor cores, one board per block by
default (``mma_block_plan``); f32 runs the first version, FMA on the CUDA
cores (a tensor-core product of f32 data would round to TF32).

``fused_residual_block`` launches a kernel for CUDA tensors and runs
``fused_residual_block_reference`` for CPU tensors; there is no other route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .cuda_build import KernelError, check_launch, load_library

_CHANNEL_STEP = 16  # both kernels' output-channel slices are multiples of it
_MMA_MAX_WARPS = 16  # csrc/resblock.cu kMmaMaxWarps
_MMA_MAX_SLICE = 96  # csrc/resblock.cu kMmaMaxGroups * 16: output channels a warp holds at most
_MMA_MAX_BOARDS = 8  # the most boards a block of it packs


def conv_kernel_to_im2col(weight: torch.Tensor) -> torch.Tensor:
    """torch conv weight (Cout, Cin, 3, 3) -> (9*Cin, Cout), rows ordered
    (dy, dx, cin) like the JAX package's HWIO reshape."""
    cout, cin, kh, kw = weight.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"expected a 3x3 kernel, got {kh}x{kw}")
    return weight.permute(2, 3, 1, 0).reshape(9 * cin, cout)


def _patches(a: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """(B, MN, C) -> (B, MN, 9C) zero-padded 3x3 patches, (dy, dx, cin) order."""
    b, _, c = a.shape
    padded = F.pad(a.reshape(b, m, n, c), (0, 0, 1, 1, 1, 1))
    taps = [padded[:, dy : dy + m, dx : dx + n, :] for dy in range(3) for dx in range(3)]
    return torch.cat(taps, dim=-1).reshape(b, m * n, 9 * c)


def fused_residual_block_reference(x, w1, b1, w2, b2, m: int, n: int) -> torch.Tensor:
    """Plain PyTorch version: f32 products of the x-typed operands, h
    rounded to x's dtype between the convs, as the kernel does."""
    xf = x.to(torch.float32)
    h = torch.relu(_patches(xf, m, n) @ w1.to(torch.float32) + b1.to(torch.float32))
    h = h.to(x.dtype).to(torch.float32)
    y = _patches(h, m, n) @ w2.to(torch.float32) + b2.to(torch.float32) + xf
    return torch.relu(y).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("resblock")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.resblock_launch.argtypes = [i] + [p] * 6 + [i] * 5 + [p]
    lib.resblock_launch.restype = ctypes.c_int
    lib.resblock_smem_bytes.argtypes = [i] * 5
    lib.resblock_smem_bytes.restype = ctypes.c_size_t
    lib.resblock_mma_launch.argtypes = [p] * 6 + [i] * 8 + [p]
    lib.resblock_mma_launch.restype = ctypes.c_int
    lib.resblock_mma_smem_bytes.argtypes = [i] * 6
    lib.resblock_mma_smem_bytes.restype = ctypes.c_size_t
    return lib


def kernel_for(dtype: torch.dtype) -> str:
    """The kernel a dtype takes: ``"mma"`` (tensor cores) for bf16, ``"fma"``
    (the CUDA cores) for f32."""
    if dtype == torch.bfloat16:
        return "mma"
    if dtype == torch.float32:
        return "fma"
    raise ValueError(f"fused_residual_block: unsupported dtype {dtype}")


@functools.lru_cache(maxsize=None)
def boards_per_block(is_bf16: bool, c: int, m: int, n: int, device: torch.device) -> int:
    """Boards one block of the FMA kernel holds: enough to fill its
    256-position pass, as many as the card's shared memory per block allows."""
    lib = _lib()
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    tb = max(1, 256 // (m * n))
    while tb > 1 and lib.resblock_smem_bytes(int(is_bf16), c, tb, m, n) > limit:
        tb -= 1
    need = lib.resblock_smem_bytes(int(is_bf16), c, tb, m, n)
    if need > limit:
        raise KernelError(
            f"fused_residual_block: C={c} on {m}x{n} needs {need} bytes of shared "
            f"memory per block, the card allows {limit}"
        )
    return tb


class MmaPlan(NamedTuple):
    """How the tensor-core kernel covers one call."""

    boards: int  # boards a block holds
    slice_channels: int  # output channels a conv computes at a time
    whole_weights: bool  # both convs' weights staged at once (slice_channels == C)
    threads: int  # 32 per warp; a warp owns 16 output positions at a time
    smem_bytes: int  # shared memory per block


def mma_smem_bytes(c: int, boards: int, m: int, n: int, slice_channels: int, whole: bool) -> int:
    """Shared memory per block of the tensor-core kernel, as
    ``csrc/resblock.cu::mma_smem_bytes`` computes it: weight rows of
    slice + 8 bf16, x and h rows of C + 8 with a one-cell halo, both biases
    in f32."""
    weights = (2 if whole else 1) * 9 * c * (slice_channels + 8)
    acts = 2 * boards * (m + 2) * (n + 2) * (c + 8)
    return 2 * (weights + acts) + 2 * c * 4


def mma_block_plan(batch: int, c: int, m: int, n: int, *, sms: int, smem_per_block: int) -> MmaPlan:
    """The tensor-core kernel's plan for ``batch`` boards of C channels on an
    M x N board, from the card's limits (SM count, shared memory per block in
    bytes).

    One board per block while the batch has no more boards than the card has
    SMs, so a tournament's 16 boards run on 16 SMs. Past that, ceil(B / SMs)
    boards a block, at most eight: every SM still gets a block, and each
    block loads the weights, which every block reads, for several boards.
    Both convs' weights sit in shared memory where they fit next to the
    boards, else the widest output-channel slice (a multiple of 16 dividing
    C, at most 96) that does. The warps cover the block's 16-position
    tiles, at most 16 of them at a time."""
    if c % _CHANNEL_STEP:
        raise ValueError(f"fused_residual_block: C={c} is not a multiple of {_CHANNEL_STEP}")
    slices = [s for s in range(min(c, _MMA_MAX_SLICE), 0, -_CHANNEL_STEP) if c % s == 0]
    options = ([(c, True)] if c <= _MMA_MAX_SLICE else []) + [(s, False) for s in slices]
    for slice_channels, whole in options:
        if mma_smem_bytes(c, 1, m, n, slice_channels, whole) <= smem_per_block:
            break
    else:
        need = mma_smem_bytes(c, 1, m, n, _CHANNEL_STEP, False)
        raise KernelError(
            f"fused_residual_block: C={c} on {m}x{n} needs {need} bytes of shared memory "
            f"per block, the card allows {smem_per_block}"
        )
    boards = min(max(1, -(-batch // sms)), _MMA_MAX_BOARDS)
    while boards > 1 and mma_smem_bytes(c, boards, m, n, slice_channels, whole) > smem_per_block:
        boards -= 1
    tiles = -(-boards * m * n // 16)
    return MmaPlan(boards, slice_channels, whole, 32 * min(tiles, _MMA_MAX_WARPS),
                   mma_smem_bytes(c, boards, m, n, slice_channels, whole))


@functools.lru_cache(maxsize=None)
def _card_mma_plan(batch: int, c: int, m: int, n: int, device: torch.device) -> MmaPlan:
    props = torch.cuda.get_device_properties(device)
    plan = mma_block_plan(batch, c, m, n, sms=props.multi_processor_count,
                          smem_per_block=props.shared_memory_per_block_optin)
    built = _lib().resblock_mma_smem_bytes(c, plan.boards, m, n, plan.slice_channels,
                                           int(plan.whole_weights))
    if built != plan.smem_bytes:
        raise KernelError(f"fused_residual_block: the kernel needs {built} bytes of shared "
                          f"memory, the plan counted {plan.smem_bytes}")
    return plan


def fused_residual_block(x, w1, b1, w2, b2, m: int, n: int, kernel: str | None = None) -> torch.Tensor:
    """Residual block on channels-last x (B, M*N, C), bf16 or f32.

    w1/w2: (9C, C) im2col weights in x's dtype; b1/b2: (C,) float32.
    CUDA tensors launch a kernel (and add one to
    ``fused_residual_block.launches``): ``kernel_for(x.dtype)``, unless
    ``kernel="fma"`` asks for the FMA kernel on bf16 too (the first version,
    which chip_smoke.py times beside the tensor-core kernel). CPU tensors
    take the plain version.
    """
    device = x.device
    if device.type == "cpu":
        return fused_residual_block_reference(x, w1, b1, w2, b2, m, n)
    if device.type != "cuda":
        raise ValueError(f"fused_residual_block: unsupported device {device}")
    if x.dim() != 3 or x.shape[1] != m * n:
        raise ValueError(f"fused_residual_block: x must be (B, {m * n}, C), got {tuple(x.shape)}")
    b, _, c = x.shape
    default = kernel_for(x.dtype)
    if kernel not in (None, default, "fma"):
        raise ValueError(f"fused_residual_block: no {kernel!r} kernel for {x.dtype}")
    kernel = kernel or default
    if c % _CHANNEL_STEP:
        raise ValueError(f"fused_residual_block: C={c} is not a multiple of {_CHANNEL_STEP}")
    for name, t, dtype, shape in (
        ("x", x, x.dtype, (b, m * n, c)),
        ("w1", w1, x.dtype, (9 * c, c)),
        ("w2", w2, x.dtype, (9 * c, c)),
        ("b1", b1, torch.float32, (c,)),
        ("b2", b2, torch.float32, (c,)),
    ):
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"fused_residual_block: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    stream = torch.cuda.current_stream(device).cuda_stream
    y = torch.empty_like(x)
    pointers = (x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                y.data_ptr())
    if kernel == "mma":
        if any(t.data_ptr() % 16 for t in (x, w1, w2, y)):
            raise ValueError("fused_residual_block: the tensor-core kernel moves 16-byte pieces, "
                             "so x, w1 and w2 must start 16-byte aligned")
        plan = _card_mma_plan(b, c, m, n, device)
        code = _lib().resblock_mma_launch(
            *pointers, b, m, n, c, plan.boards, plan.slice_channels, int(plan.whole_weights),
            plan.threads, stream)
    else:
        is_bf16 = x.dtype == torch.bfloat16
        tb = boards_per_block(is_bf16, c, m, n, device)
        code = _lib().resblock_launch(int(is_bf16), *pointers, b, m, n, c, tb, stream)
    check_launch(f"resblock ({kernel})", code)
    fused_residual_block.launches += 1
    return y


fused_residual_block.launches = 0
