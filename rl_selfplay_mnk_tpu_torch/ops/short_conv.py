"""LFM2's gated short convolution between its two projections, and its
plain PyTorch version.

Replaces no TPU kernel: the JAX package has no such layer. The function
(``Lfm2ShortConv`` between ``in_proj`` and ``out_proj``), over each
board's cells in row-major order, causal::

    B, C, x = split3(bcx)                        bcx (boards, L, 3D)
    z[t] = sum_j w[:, j] * (B * x)[t - K + 1 + j]   depthwise, K taps, 0 before t = 0
    y = C * z

in f32 from bcx in its own dtype and f32 taps ``w`` (D, K), y rounded to
bcx's dtype once. Backward, with dz = dy * C:  dC = dy * z,
d(Bx)[t] = sum_j w[:, j] * dz[t + K - 1 - j],  dB = d(Bx) * x,  dx = d(Bx) * B
(rounded once into one (boards, L, 3D) gradient) and dw[:, j] = the sum over
boards and cells of dz[t] * (B x)[t - K + 1 + j] in f32.

On the card ``short_conv`` launches the kernels in ``csrc/short_conv.cu``:
``short_conv_fwd``, and for the gradient ``short_conv_bwd`` (the (B, C, x)
gradient and each board group's partial tap sums) then ``short_conv_wsum``
(their sum over the groups in a fixed order). A thread walks one board's
cells for a vector of channels, so every element is read and written once.
They launch on the current stream, never synchronise and allocate through
``torch.empty`` alone; ``short_conv.launches`` counts them. A CPU tensor
takes ``short_conv_reference``, differentiated by autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .cuda_build import KernelError, check_launch, load_library

TAPS = 3  # csrc/short_conv.cu kTaps: LFM2's conv_L_cache
BWD_GROUPS = 512  # board groups of the backward: its threads are groups x D / 8


def _taps(bx, w):
    """z (boards, L, D) f32 of Bx (boards, L, D) f32 and taps w (D, K)."""
    k = w.shape[1]
    length = bx.shape[1]
    padded = F.pad(bx, (0, 0, k - 1, 0))
    z = padded[:, 0:length] * w[:, 0]
    for j in range(1, k):
        z = z + padded[:, j:j + length] * w[:, j]
    return z


def short_conv_reference(bcx, weight):
    """Plain version: (boards, L, 3D) -> (boards, L, D) in bcx's dtype,
    computed in f32 (f64 for f64 inputs)."""
    ct = torch.promote_types(bcx.dtype, torch.float32)
    b, c, x = bcx.to(ct).chunk(3, dim=-1)
    return (c * _taps(b * x, weight.to(ct))).to(bcx.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("short_conv")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.short_conv_fwd_launch.argtypes = [i, i, p, p, ll, i, i, i, p, p]
    lib.short_conv_bwd_launch.argtypes = [i, i, p, p, p, ll, i, i, i, i, p, p, p, p]
    lib.short_conv_fwd_launch.restype = lib.short_conv_bwd_launch.restype = i
    return lib


def _vector(t: torch.Tensor, d: int, *more) -> int:
    """Elements a thread loads at once: 16 bytes where the width and every
    address allow it, else one."""
    ve = 16 // t.element_size()
    aligned = all(x.data_ptr() % 16 == 0 for x in (t, *more))
    return ve if d % ve == 0 and aligned else 1


def _check(bcx, weight) -> None:
    if bcx.device.type != "cuda" or bcx.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"short_conv: unsupported {bcx.dtype} tensor on {bcx.device}")
    d = bcx.shape[-1] // 3
    if (bcx.dim() != 3 or bcx.shape[-1] != 3 * d or weight.dtype != torch.float32
            or tuple(weight.shape) != (d, TAPS) or weight.device != bcx.device):
        raise KernelError(f"short_conv: the kernels take (boards, L, 3D) with f32 taps (D, {TAPS}); "
                          f"got {tuple(bcx.shape)} and {weight.dtype} {tuple(weight.shape)}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def short_conv_fwd(bcx, weight):
    """The forward kernel on a CUDA tensor: y (boards, L, D)."""
    _check(bcx, weight)
    bcx, weight = bcx.contiguous(), weight.contiguous()
    boards, length, d3 = bcx.shape
    d = d3 // 3
    y = torch.empty((boards, length, d), dtype=bcx.dtype, device=bcx.device)
    check_launch("short_conv_fwd", _lib().short_conv_fwd_launch(
        int(bcx.dtype == torch.bfloat16), _vector(bcx, d, y), bcx.data_ptr(), weight.data_ptr(),
        boards, length, d, TAPS, y.data_ptr(), _stream(bcx.device)))
    short_conv.launches += 1
    return y


def short_conv_bwd(bcx, weight, dy):
    """The backward kernels on CUDA tensors: (dbcx in bcx's dtype, dweight f32)."""
    bcx, weight = bcx.contiguous(), weight.contiguous()
    dy = dy.to(bcx.dtype).contiguous()
    boards, length, d3 = bcx.shape
    d = d3 // 3
    groups = max(1, min(boards, BWD_GROUPS))
    dbcx = torch.empty_like(bcx)
    part = torch.empty((groups, d, TAPS), dtype=torch.float32, device=bcx.device)
    dweight = torch.empty((d, TAPS), dtype=torch.float32, device=bcx.device)
    check_launch("short_conv_bwd", _lib().short_conv_bwd_launch(
        int(bcx.dtype == torch.bfloat16), _vector(bcx, d, dy, dbcx), bcx.data_ptr(),
        weight.data_ptr(), dy.data_ptr(), boards, length, d, TAPS, groups, dbcx.data_ptr(),
        part.data_ptr(), dweight.data_ptr(), _stream(bcx.device)))
    short_conv.launches += 2
    return dbcx, dweight


class _ShortConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bcx, weight):
        ctx.save_for_backward(bcx, weight)
        return short_conv_fwd(bcx, weight)

    @staticmethod
    def backward(ctx, dy):
        bcx, weight = ctx.saved_tensors
        return short_conv_bwd(bcx, weight, dy)


def short_conv(bcx, weight):
    """The gated short convolution of ``bcx`` (boards, L, 3D) with taps
    ``weight`` (D, K) f32 -> (boards, L, D) in bcx's dtype: the kernels for
    a CUDA tensor (one launch a forward, two a backward, added to
    ``short_conv.launches``), ``short_conv_reference`` for a CPU tensor."""
    if bcx.device.type == "cpu":
        return short_conv_reference(bcx, weight)
    _check(bcx, weight)
    if torch.is_grad_enabled() and (bcx.requires_grad or weight.requires_grad):
        return _ShortConv.apply(bcx, weight)
    return short_conv_fwd(bcx, weight)


short_conv.launches = 0
