"""LayerNorm over the last axis: a CUDA kernel pair and its plain PyTorch version.

Replaces no TPU kernel: the JAX package leaves flax's ``nn.LayerNorm`` to
XLA. The function is flax's with f32 statistics::

    y = (x - mean) * rsqrt(var + eps) * weight + bias

over the last axis of x (bf16 or f32), the mean and the two-pass variance
in f32, weight and bias f32, y in x's dtype rounded once from f32: the
plain version's (x cast to f32, ``F.layer_norm``, cast back) at the same
rounding points.

On the card ``layer_norm`` launches the kernels in ``csrc/layer_norm.cu``:
``ln_rows_fwd`` (writing each row's f32 mean and rstd only when autograd
needs them), and for the gradient ``ln_rows_bwd`` (dx, and each block's
partial sums of dweight and dbias) then ``ln_cols_sum`` (those partials
summed over the blocks in a fixed order: no atomics, the same bits every
run). A group of lanes owns a row in registers (``row_plan``). They launch
on the current stream, never synchronise and allocate through
``torch.empty`` alone, so a CUDA graph can capture them. A CPU tensor takes
``layer_norm_reference``; there is no other route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .cuda_build import KernelError, check_launch, load_library

MAX_WIDTH = 512  # csrc/layer_norm.cu kMaxWidth: 16 f32 a lane of 32
THREADS = 256  # csrc/layer_norm.cu kThreads: eight warps a block
_VECTOR_BYTES = (16, 8, 4, 2)


class RowPlan(NamedTuple):
    """How the kernels cover a row."""

    vector_bytes: int  # bytes a load moves
    vector_elems: int  # elements a load moves
    lanes: int  # lanes a row takes, a power of two
    rows_per_warp: int
    vectors_per_lane: int  # loads a lane makes of a row, rounded up to a power of two


def row_plan(width: int, itemsize: int, address: int = 0) -> RowPlan:
    """The kernels' plan for rows of ``width`` elements of ``itemsize``
    bytes, every tensor they touch at addresses whose bitwise or is
    ``address``: the widest load of 16, 8, 4 or 2 bytes that holds whole
    elements and divides both the row's bytes and ``address``, the smallest
    power of two of lanes that covers the row with one load each (at most
    32), and the loads a lane then makes."""
    if not 1 <= width <= MAX_WIDTH:
        raise KernelError(f"layer_norm: width {width} is outside the kernels' 1 to {MAX_WIDTH}")
    row_bytes = width * itemsize
    for vector_bytes in _VECTOR_BYTES:
        if vector_bytes >= itemsize and row_bytes % vector_bytes == 0 and address % vector_bytes == 0:
            break
    else:
        raise KernelError(f"layer_norm: no load of whole {itemsize}-byte elements fits rows of "
                          f"{row_bytes} bytes at address {address:#x}")
    elems = vector_bytes // itemsize
    vectors = width // elems
    lanes = min(32, 1 << (vectors - 1).bit_length())
    per_lane = -(-vectors // lanes)
    return RowPlan(vector_bytes, elems, lanes, 32 // lanes, 1 << (per_lane - 1).bit_length())


def layer_norm_reference(x, weight, bias, eps: float) -> torch.Tensor:
    """Plain version: x cast to f32, ``F.layer_norm``, cast back to x's dtype."""
    return F.layer_norm(x.to(torch.float32), (x.shape[-1],), weight, bias, eps).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("layer_norm")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ln_rows_fwd_launch.argtypes = [i, p, p, p, ll] + [i] * 4 + [ctypes.c_float, i] + [p] * 4
    lib.ln_rows_bwd_launch.argtypes = [i] + [p] * 5 + [ll] + [i] * 5 + [p] * 3
    lib.ln_cols_sum_launch.argtypes = [p, i, i, p, p, p]
    lib.ln_rows_resources.argtypes = [i] * 5 + [ctypes.POINTER(i)] * 3
    for entry in (lib.ln_rows_fwd_launch, lib.ln_rows_bwd_launch, lib.ln_cols_sum_launch,
                  lib.ln_rows_resources):
        entry.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def kernel_resources(is_bf16: bool, plan: RowPlan, backward: bool, width: int) -> dict:
    """One instantiation's registers and spilled bytes a thread and the
    blocks of ``THREADS`` an SM holds at once (``cudaFuncGetAttributes``)."""
    regs, local, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    check_launch("ln_rows_resources", _lib().ln_rows_resources(
        int(is_bf16), plan.vector_elems, plan.vectors_per_lane, int(backward), width,
        ctypes.byref(regs), ctypes.byref(local), ctypes.byref(blocks)))
    return {"registers": regs.value, "local_bytes": local.value, "blocks_per_sm": blocks.value}


@functools.lru_cache(maxsize=None)
def _card_plan(width: int, dtype: torch.dtype, low_bits: int, backward: bool, device) -> tuple:
    """(the row plan, the blocks the card holds at once) for one kernel on
    tensors whose addresses' bitwise or ends in ``low_bits`` (mod 16)."""
    plan = row_plan(width, dtype.itemsize, low_bits)
    per_sm = kernel_resources(dtype == torch.bfloat16, plan, backward, width)["blocks_per_sm"]
    return plan, per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def _blocks(plan: RowPlan, resident: int, rows: int) -> int:
    """Enough blocks for a row a group, at most as many as the card holds
    at once (their warps then walk the rows)."""
    return max(1, min(-(-rows // (THREADS // 32 * plan.rows_per_warp)), resident))


def _check(x, weight, bias) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"layer_norm: unsupported dtype {x.dtype}")
    width = x.shape[-1]
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != (width,)
                or not t.is_contiguous()):
            raise ValueError(f"layer_norm: {name} must be a contiguous float32 tensor of shape "
                             f"({width},) on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def layer_norm_fwd(x, weight, bias, eps: float, stats: bool):
    """The forward kernel on a CUDA tensor: (y, mean, rstd), the per-row f32
    statistics only where ``stats`` (else None)."""
    _check(x, weight, bias)
    x = x.contiguous()
    width = x.shape[-1]
    rows = x.numel() // width
    y = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    plan, resident = _card_plan(width, x.dtype, (x.data_ptr() | y.data_ptr()) % 16, False,
                                x.device)
    code = _lib().ln_rows_fwd_launch(
        int(x.dtype == torch.bfloat16), x.data_ptr(), weight.data_ptr(), bias.data_ptr(), rows,
        width, plan.vector_elems, plan.lanes, plan.vectors_per_lane, eps,
        _blocks(plan, resident, rows), y.data_ptr(),
        mean.data_ptr() if stats else None, rstd.data_ptr() if stats else None, _stream(x.device))
    check_launch("ln_rows_fwd", code)
    layer_norm.launches += 1
    return y, mean, rstd


def layer_norm_bwd(x, dy, weight, mean, rstd):
    """The backward kernels on CUDA tensors: (dx in x's dtype, dweight,
    dbias in f32)."""
    x, dy = x.contiguous(), dy.to(x.dtype).contiguous()
    width = x.shape[-1]
    rows = x.numel() // width
    dx = torch.empty_like(x)
    dweight = torch.empty(width, dtype=torch.float32, device=x.device)
    dbias = torch.empty_like(dweight)
    plan, resident = _card_plan(width, x.dtype, (x.data_ptr() | dy.data_ptr() | dx.data_ptr()) % 16,
                                True, x.device)
    blocks = _blocks(plan, resident, rows)
    part = torch.empty((blocks, 2, width), dtype=torch.float32, device=x.device)
    stream = _stream(x.device)
    lib = _lib()
    check_launch("ln_rows_bwd", lib.ln_rows_bwd_launch(
        int(x.dtype == torch.bfloat16), x.data_ptr(), dy.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), weight.data_ptr(), rows, width, plan.vector_elems, plan.lanes,
        plan.vectors_per_lane, blocks, dx.data_ptr(), part.data_ptr(), stream))
    check_launch("ln_cols_sum", lib.ln_cols_sum_launch(
        part.data_ptr(), blocks, width, dweight.data_ptr(), dbias.data_ptr(), stream))
    layer_norm.launches += 2
    return dx, dweight, dbias


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, rstd = layer_norm_fwd(x, weight, bias, eps, stats=True)
        ctx.save_for_backward(x, weight, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        return (*layer_norm_bwd(x, dy, weight, mean, rstd), None)


def layer_norm(x, weight, bias, eps: float) -> torch.Tensor:
    """LayerNorm over x's last axis with f32 statistics, y in x's dtype.

    ``weight`` and ``bias``: f32 of shape (x.shape[-1],). A CUDA tensor
    launches the kernels (one launch a forward, added to
    ``layer_norm.launches``, two a backward); the forward saves x itself and
    each row's mean and rstd, and writes the statistics only where a
    gradient is being recorded. A CPU tensor takes ``layer_norm_reference``.
    """
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        return _LayerNorm.apply(x, weight, bias, eps)
    return layer_norm_fwd(x, weight, bias, eps, stats=False)[0]


layer_norm.launches = 0
