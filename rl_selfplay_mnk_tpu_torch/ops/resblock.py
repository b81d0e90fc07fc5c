"""The eval-mode residual block (kernel K2) and its plain PyTorch version.

Replaces the TPU kernel ``rl_selfplay_mnk_tpu/ops/pallas_resnet.py``
(``_resblock_kernel``, entry ``fused_residual_block``)::

    h = relu(conv1(x) + b1)            rounded to x's dtype
    y = relu(conv2(h) + b2 + x)

for 3x3 SAME convolutions with BatchNorm folded into the weights
(``models/fold_bn.py``), activations channels-last (B, M*N, C), weights in
im2col layout (9C, C) ordered (dy, dx, cin), f32 accumulation.

On the H100 the main path's call (384 boards, 9x9, C=32, bf16) has an ideal
time bound by bytes, about equal to its tensor-core time; the kernel
(``csrc/resblock.cu``) keeps x, h and the weights in shared memory and does
its products with FMA on the CUDA cores, which bound it for now.

``fused_residual_block`` launches the kernel for CUDA tensors and runs
``fused_residual_block_reference`` for CPU tensors; there is no other route.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .cuda_build import KernelError, check_launch, load_library

_CHANNEL_STEP = 16  # the kernel's output-channel slice


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
    return lib


@functools.lru_cache(maxsize=None)
def boards_per_block(is_bf16: bool, c: int, m: int, n: int, device: torch.device) -> int:
    """Boards one block of the kernel holds: enough to fill its 256-position
    pass, as many as the card's shared memory per block allows."""
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


def fused_residual_block(x, w1, b1, w2, b2, m: int, n: int) -> torch.Tensor:
    """Residual block on channels-last x (B, M*N, C), bf16 or f32.

    w1/w2: (9C, C) im2col weights in x's dtype; b1/b2: (C,) float32.
    CUDA tensors launch the kernel (and add one to
    ``fused_residual_block.launches``); CPU tensors take the plain version.
    """
    device = x.device
    if device.type == "cpu":
        return fused_residual_block_reference(x, w1, b1, w2, b2, m, n)
    if device.type != "cuda":
        raise ValueError(f"fused_residual_block: unsupported device {device}")
    if x.dim() != 3 or x.shape[1] != m * n:
        raise ValueError(f"fused_residual_block: x must be (B, {m * n}, C), got {tuple(x.shape)}")
    b, _, c = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_residual_block: unsupported dtype {x.dtype}")
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
    is_bf16 = x.dtype == torch.bfloat16
    tb = boards_per_block(is_bf16, c, m, n, device)
    y = torch.empty_like(x)
    code = _lib().resblock_launch(
        int(is_bf16), x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), y.data_ptr(), b, m, n, c, tb,
        torch.cuda.current_stream(device).cuda_stream,
    )
    check_launch("resblock", code)
    fused_residual_block.launches += 1
    return y


fused_residual_block.launches = 0
