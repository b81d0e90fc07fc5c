"""Fused attention for tiny heads on board-length tokens (kernels K3-K9) and
their plain PyTorch versions.

Replaces the TPU kernels of ``rl_selfplay_mnk_tpu/ops/pallas_attention.py``:

  * ``attention_folded`` on (BH, Dh, L): ``_attn_kernel`` forward (K3) and
    ``_attn_bwd_kernel`` backward (K4);
  * ``attention_packed`` on (B, L, D = H * Dh): ``_packed_fwd_kernel``
    forward (K8) and ``_packed_bwd_kernel`` backward (K9);
  * ``attention_lane_slice_fwd`` on (B, L, D): ``_lane_slice_fwd_kernel``
    (K5), forward only, a board's rows in a block, heads as column slices on
    chip;
  * ``attention_infold`` on (B, L, D): ``_infold_fwd_kernel`` forward (K6) and
    ``_infold_bwd_kernel`` backward (K7), a board (or a group of its heads) a
    block, transposed on chip, heads as row slices;
  * ``tiny_head_attention`` on (B, L, H, Dh), the models' entry, which picks
    among them (see there).

All compute dense softmax attention per head with the scores kept on chip::

    s = (q . k) / sqrt(Dh)      f32        o  = p~ . v        p~ = p in v's dtype
    p = softmax(s)              f32        dp = dO . v
    ds~ = p * (dp - rowsum(dp * p)) / sqrt(Dh), in q's dtype
    dq = ds~ . k    dk = ds~^T . q    dv = p~^T . dO          f32 sums

Each pair is a ``torch.autograd.Function`` that saves q, k, v only and
recomputes the probabilities in its backward; the incoming gradient is cast
to q's dtype first.

On the H100 both directions are bound by bytes at the models' shapes. In
bf16 every kernel does its products on the tensor cores (``mma.sync``): the
forwards (K3, ``folded_fwd_kernel_for``; K8, ``packed_fwd_kernel_for``; K5,
``lane_slice_fwd_kernel_for``; K6, ``infold_fwd_kernel_for``) a warp per 16
query rows with the scores and probabilities in registers; the backwards
(K9, ``packed_bwd_kernel_for``, ``csrc/attention_bwd.cu``; K4,
``folded_bwd_kernel_for``, ``csrc/attention_folded_bwd.cu``; K7,
``infold_bwd_kernel_for``, ``csrc/attention_board.cu``) a warp per 16 query
rows and then per 16 key rows. In f32 they are the first versions, which
hold a head or a board in shared memory (``csrc/attention.cu``,
``csrc/attention_board.cu``) and do their products with FMA on the CUDA
cores. ``kernel="fma"`` runs that first version on bf16 too.

The seven launch wrappers (``attention_folded_fwd``, ``attention_folded_bwd``,
``attention_packed_fwd``, ``attention_packed_bwd``,
``attention_lane_slice_fwd``, ``attention_infold_fwd``,
``attention_infold_bwd``) launch their kernel for CUDA tensors, adding one to
their ``.launches``, and run their ``*_reference`` for CPU tensors; there is
no other route.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from .cuda_build import KernelError, check_launch, load_library

PACKED_MIN_HEAD_DIM = 32  # tiny_head_attention: from it on, the packed pair
# tiny_head_attention below that width, where a gradient is recorded: "folded"
# (fold, K3/K4, unfold) or "infold" (K6/K7 on the packed interface).
GRADIENT_ROUTE = "folded"
# tiny_head_attention below that width, where no gradient is recorded: the
# lane-slice kernel (K5) up to this many (head, query row) pairs a board, the
# packed forward (K8) above. A K5 block walks all of a board's pairs; at 13x13
# with eight heads (1352) it loses to a block per (board, head) at every batch
# read, at 676 pairs and fewer it beats the fold route (PERF.md, "Threshold").
LANE_SLICE_MAX_HEAD_ROWS = 1024


# ---------------------------------------------------------------------------
# plain PyTorch versions: the kernels' arithmetic and rounding
# ---------------------------------------------------------------------------


def _probabilities_reference(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 softmax((q . k) / sqrt(dh)) for q, k (N, L, dh): (N, L, L)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(1, 2)) * scale
    return torch.softmax(s, dim=-1)


def _heads_fwd_reference(q, k, v):
    """q, k, v (N, L, dh) -> o (N, L, dh) in q's dtype."""
    p = _probabilities_reference(q, k)
    o = torch.matmul(p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return o.to(q.dtype)


def _heads_bwd_reference(q, k, v, do):
    """q, k, v, do (N, L, dh) -> dq, dk, dv (N, L, dh) in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = (t.to(torch.float32) for t in (q, k, v, do))
    p = _probabilities_reference(q, k)
    dp = torch.matmul(gf, vf.transpose(1, 2))
    row = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - row) * scale).to(q.dtype).to(torch.float32)
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(1, 2), qf)
    dv = torch.matmul(p.to(q.dtype).to(torch.float32).transpose(1, 2), gf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _folded_to_heads(t):  # (BH, Dh, L) -> (BH, L, Dh)
    return t.transpose(1, 2)


def _packed_to_heads(t, h, dh):  # (B, L, H*Dh) -> (B*H, L, Dh)
    b, l, _ = t.shape
    return t.reshape(b, l, h, dh).permute(0, 2, 1, 3).reshape(b * h, l, dh)


def _heads_to_packed(t, b, h):  # (B*H, L, Dh) -> (B, L, H*Dh)
    _, l, dh = t.shape
    return t.reshape(b, h, l, dh).permute(0, 2, 1, 3).reshape(b, l, h * dh)


def attention_folded_reference(q, k, v):
    """Plain version of the folded forward: q, k, v (BH, Dh, L) -> (BH, Dh, L)."""
    o = _heads_fwd_reference(*(_folded_to_heads(t) for t in (q, k, v)))
    return o.transpose(1, 2).contiguous()


def attention_folded_bwd_reference(q, k, v, do):
    """Plain version of the folded backward: (BH, Dh, L) x4 -> dq, dk, dv."""
    grads = _heads_bwd_reference(*(_folded_to_heads(t) for t in (q, k, v, do)))
    return tuple(g.transpose(1, 2).contiguous() for g in grads)


def attention_packed_reference(q, k, v, h: int, dh: int):
    """Plain version of the packed forward: q, k, v (B, L, H*Dh) -> (B, L, H*Dh)."""
    o = _heads_fwd_reference(*(_packed_to_heads(t, h, dh) for t in (q, k, v)))
    return _heads_to_packed(o, q.shape[0], h)


def attention_packed_bwd_reference(q, k, v, do, h: int, dh: int):
    """Plain version of the packed backward: (B, L, H*Dh) x4 -> dq, dk, dv."""
    grads = _heads_bwd_reference(*(_packed_to_heads(t, h, dh) for t in (q, k, v, do)))
    return tuple(_heads_to_packed(g, q.shape[0], h) for g in grads)


def attention_lane_slice_reference(q, k, v, h: int, dh: int):
    """Plain version of the lane-slice forward: every head is a column slice
    of the rows, q, k, v (B, L, H*Dh) -> (B, L, H*Dh)."""
    heads = [slice(i * dh, (i + 1) * dh) for i in range(h)]
    return torch.cat([_heads_fwd_reference(q[:, :, sl], k[:, :, sl], v[:, :, sl])
                      for sl in heads], dim=2)


def attention_infold_reference(q, k, v, h: int, dh: int):
    """Plain version of the in-kernel-fold forward: the boards transposed to
    (B, H*Dh, L), every head a row slice, the result transposed back."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    heads = [slice(i * dh, (i + 1) * dh) for i in range(h)]
    out = [_heads_fwd_reference(*(t[:, sl].transpose(1, 2) for t in (qt, kt, vt))).transpose(1, 2)
           for sl in heads]
    return torch.cat(out, dim=1).transpose(1, 2).contiguous()


def attention_infold_bwd_reference(q, k, v, do, h: int, dh: int):
    """Plain version of the in-kernel-fold backward: (B, L, H*Dh) x4 -> dq, dk, dv."""
    ts = [t.transpose(1, 2) for t in (q, k, v, do)]
    heads = [slice(i * dh, (i + 1) * dh) for i in range(h)]
    grads = [_heads_bwd_reference(*(t[:, sl].transpose(1, 2) for t in ts)) for sl in heads]
    return tuple(torch.cat([g[i].transpose(1, 2) for g in grads], dim=1).transpose(1, 2).contiguous()
                 for i in range(3))


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.attn_smem_bytes.argtypes = [i] * 4
    lib.attn_smem_bytes.restype = ctypes.c_size_t
    for fn in (lib.attn_max_tokens, lib.attn_max_head_dim):
        fn.argtypes = []
        fn.restype = i
    lib.attn_max_threads.argtypes = [i]
    lib.attn_max_threads.restype = i
    lib.attn_folded_fwd_launch.argtypes = [i] + [p] * 4 + [i] * 4 + [p]
    lib.attn_folded_fwd_mma_launch.argtypes = [i] + [p] * 4 + [i] * 4 + [p]
    lib.attn_folded_fwd_mma_smem_bytes.argtypes = [i] * 3
    lib.attn_folded_fwd_mma_smem_bytes.restype = ctypes.c_size_t
    lib.attn_folded_bwd_launch.argtypes = [i] + [p] * 7 + [i] * 4 + [p]
    lib.attn_packed_fwd_launch.argtypes = [i] + [p] * 4 + [i] * 5 + [p]
    lib.attn_packed_fwd_mma_launch.argtypes = [i] + [p] * 4 + [i] * 5 + [p]
    lib.attn_packed_fwd_mma_smem_bytes.argtypes = [i] * 3
    lib.attn_packed_fwd_mma_smem_bytes.restype = ctypes.c_size_t
    lib.attn_packed_fwd_mma_resources.argtypes = [i] * 3 + [ctypes.POINTER(i)] * 3
    lib.attn_packed_bwd_launch.argtypes = [i] + [p] * 7 + [i] * 5 + [p]
    for fn in (lib.attn_folded_fwd_launch, lib.attn_folded_bwd_launch, lib.attn_folded_fwd_mma_launch,
               lib.attn_packed_fwd_launch, lib.attn_packed_fwd_mma_launch,
               lib.attn_packed_fwd_mma_resources, lib.attn_packed_bwd_launch):
        fn.restype = i
    return lib


def _bind_bwd_mma(lib, kernel: str, dims: int):
    """argtypes of a tensor-core backward's three entries: its launch (with
    ``dims`` ints after the seven pointers), shared bytes and resources."""
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = getattr(lib, f"attn_{kernel}_mma_launch")
    launch.argtypes = [i] + [p] * 7 + [i] * dims + [p]
    getattr(lib, f"attn_{kernel}_mma_smem_bytes").argtypes = [i] * 3
    getattr(lib, f"attn_{kernel}_mma_smem_bytes").restype = ctypes.c_size_t
    resources = getattr(lib, f"attn_{kernel}_mma_resources")
    resources.argtypes = [i] * 3 + [ctypes.POINTER(i)] * 3
    launch.restype = resources.restype = i


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    """``csrc/attention_bwd.cu``: the tensor-core K9, built beside
    ``attention.cu`` by its own nvcc."""
    lib = load_library("attention_bwd")
    _bind_bwd_mma(lib, "packed_bwd", 5)
    return lib


@functools.lru_cache(maxsize=None)
def _folded_bwd_lib():
    """``csrc/attention_folded_bwd.cu``: the tensor-core K4, built by its own
    nvcc."""
    lib = load_library("attention_folded_bwd")
    _bind_bwd_mma(lib, "folded_bwd", 4)
    return lib


def _kernel_for(name: str, dtype: torch.dtype) -> str:
    if dtype == torch.bfloat16:
        return "mma"
    if dtype == torch.float32:
        return "fma"
    raise ValueError(f"{name}: unsupported dtype {dtype}")


def folded_fwd_kernel_for(dtype: torch.dtype) -> str:
    """The kernel K3 takes for a dtype: ``"mma"`` (tensor cores) for bf16,
    ``"fma"`` (the CUDA cores) for f32."""
    return _kernel_for("attention_folded_fwd", dtype)


def packed_fwd_kernel_for(dtype: torch.dtype) -> str:
    """The kernel K8 takes for a dtype: ``"mma"`` (tensor cores) for bf16,
    ``"fma"`` (the CUDA cores) for f32, whose products on the tensor cores
    would round to TF32."""
    return _kernel_for("attention_packed_fwd", dtype)


def packed_bwd_kernel_for(dtype: torch.dtype) -> str:
    """The kernel K9 takes for a dtype: ``"mma"`` (tensor cores) for bf16,
    ``"fma"`` (the CUDA cores) for f32, as K8."""
    return _kernel_for("attention_packed_bwd", dtype)


def folded_bwd_kernel_for(dtype: torch.dtype) -> str:
    """The kernel K4 takes for a dtype: ``"mma"`` (tensor cores) for bf16,
    ``"fma"`` (the CUDA cores) for f32, as K8."""
    return _kernel_for("attention_folded_bwd", dtype)


def lane_slice_fwd_kernel_for(dtype: torch.dtype) -> str:
    """The kernel K5 takes for a dtype: ``"mma"`` (tensor cores) for bf16,
    ``"fma"`` (the CUDA cores) for f32, as K8."""
    return _kernel_for("attention_lane_slice_fwd", dtype)


def infold_fwd_kernel_for(dtype: torch.dtype) -> str:
    """The kernel K6 takes for a dtype: ``"mma"`` (tensor cores) for bf16,
    ``"fma"`` (the CUDA cores) for f32, as K8."""
    return _kernel_for("attention_infold_fwd", dtype)


def infold_bwd_kernel_for(dtype: torch.dtype) -> str:
    """The kernel K7 takes for a dtype: ``"mma"`` (tensor cores) for bf16,
    ``"fma"`` (the CUDA cores) for f32, as K8."""
    return _kernel_for("attention_infold_bwd", dtype)


KERNELS = ("mma", "fma")  # what a wrapper's ``kernel`` may name


def _known_kernel(name: str, kernel) -> None:
    if kernel is not None and kernel not in KERNELS:
        raise ValueError(f"{name}: unknown kernel {kernel!r}, expected one of {KERNELS}")


def _kernel_on_card(name: str, dtype: torch.dtype, kernel) -> str:
    """The kernel a wrapper launches for a CUDA tensor of ``dtype``: the one
    the dtype takes, or ``"fma"`` (the first version) where the caller asks
    for it; the tensor cores never take f32."""
    default = _kernel_for(name, dtype)
    if kernel not in (None, default, "fma"):
        raise ValueError(f"{name}: no {kernel!r} kernel for {dtype}")
    return kernel or default


_MMA_MAX_HEADS = 4  # csrc/attn_mma.cuh kMmaMaxHeads
# A block of a tensor-core kernel takes heads while they fit this much shared
# memory: three or more blocks an SM for the forwards; three for the
# backwards where a head is small (two heads of (81, 32) for K9, four of
# (81, 14) for K4), while K9's (169, 64) head alone takes 101 KiB (two
# blocks an SM).
_MMA_HEADS_SMEM = {"folded_fwd": 64 * 1024, "packed_fwd": 64 * 1024, "packed_bwd": 74 * 1024,
                   "folded_bwd": 74 * 1024}


def _mma_entry(kernel: str, what: str):
    """``attn_<kernel>_mma_<what>`` of a tensor-core kernel's library: K9's
    or K4's own, or that of ``attention.cu``."""
    lib = {"packed_bwd": _bwd_lib, "folded_bwd": _folded_bwd_lib}.get(kernel, _lib)()
    return getattr(lib, f"attn_{kernel}_mma_{what}")


@functools.lru_cache(maxsize=None)
def _mma_heads(kernel: str, l: int, dh: int, device: torch.device) -> int:
    """Heads a block of the tensor-core K3 (``kernel`` "folded_fwd"), K4
    ("folded_bwd"), K8 ("packed_fwd") or K9 ("packed_bwd") takes: up to four,
    while their slabs fit ``_MMA_HEADS_SMEM[kernel]``, and one where a single
    head needs more."""
    lib = _lib()
    if l > lib.attn_max_tokens() or dh > lib.attn_max_head_dim():
        raise KernelError(
            f"attention: L={l}, Dh={dh} is beyond the kernel's "
            f"L <= {lib.attn_max_tokens()}, Dh <= {lib.attn_max_head_dim()}"
        )
    one = _mma_entry(kernel, "smem_bytes")(l, dh, 1)
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    if one > limit:
        raise KernelError(f"attention {kernel}: L={l}, Dh={dh} needs {one} bytes of shared "
                          f"memory per block, the card allows {limit}")
    return max(1, min(_MMA_MAX_HEADS, _MMA_HEADS_SMEM[kernel] // one))


def mma_resources(kernel: str, l: int, dh: int, device: torch.device) -> dict:
    """What the tensor-core K4 (``kernel`` "folded_bwd"), K8 ("packed_fwd")
    or K9 ("packed_bwd") for heads of (L, Dh) takes on the card: the
    registers and local (spill) bytes of a thread, the heads and shared bytes
    of a block, and the blocks that fit an SM."""
    entry = _mma_entry(kernel, "resources")
    heads = _mma_heads(kernel, l, dh, device)
    regs, local, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        check_launch(entry.__name__, entry(
            l, dh, heads, ctypes.byref(regs), ctypes.byref(local), ctypes.byref(blocks)))
    return {"registers": regs.value, "local_bytes": local.value, "heads_per_block": heads,
            "smem_bytes": _mma_entry(kernel, "smem_bytes")(l, dh, heads),
            "blocks_per_sm": blocks.value}


@functools.lru_cache(maxsize=None)
def _threads(backward: bool, l: int, dh: int, device: torch.device) -> int:
    """Threads per block: 16 warps for long boards, 8 otherwise, within the
    kernel's own limit, and fewer where the card's shared memory per block
    asks for it."""
    lib = _lib()
    if l > lib.attn_max_tokens() or dh > lib.attn_max_head_dim():
        raise KernelError(
            f"attention: L={l}, Dh={dh} is beyond the kernel's "
            f"L <= {lib.attn_max_tokens()}, Dh <= {lib.attn_max_head_dim()}"
        )
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    threads = min(512 if l > 96 else 256, lib.attn_max_threads(int(backward)))
    while threads > 32 and lib.attn_smem_bytes(int(backward), l, dh, threads) > limit:
        threads //= 2
    need = lib.attn_smem_bytes(int(backward), l, dh, threads)
    if need > limit:
        raise KernelError(
            f"attention {'backward' if backward else 'forward'}: L={l}, Dh={dh} needs "
            f"{need} bytes of shared memory per block, the card allows {limit}"
        )
    return threads


@functools.lru_cache(maxsize=None)
def _board_lib():
    lib = load_library("attention_board")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.board_attn_smem_bytes.argtypes = [i] * 7
    lib.board_attn_smem_bytes.restype = ctypes.c_size_t
    for fn in (lib.board_attn_max_tokens, lib.board_attn_max_head_dim, lib.board_attn_max_threads):
        fn.argtypes = []
        fn.restype = i
    lib.attn_lane_slice_fwd_launch.argtypes = [i] + [p] * 4 + [i] * 5 + [p]
    lib.attn_infold_fwd_launch.argtypes = [i] + [p] * 4 + [i] * 6 + [p]
    lib.attn_infold_bwd_launch.argtypes = [i] + [p] * 7 + [i] * 6 + [p]
    for kernel in ("lane_slice_fwd", "infold_fwd"):
        getattr(lib, f"attn_{kernel}_mma_launch").argtypes = [i] + [p] * 4 + [i] * 5 + [p]
        getattr(lib, f"attn_{kernel}_mma_smem_bytes").argtypes = [i] * 3
        getattr(lib, f"attn_{kernel}_mma_smem_bytes").restype = ctypes.c_size_t
        getattr(lib, f"attn_{kernel}_mma_resources").argtypes = [i] * 3 + [ctypes.POINTER(i)] * 3
    _bind_bwd_mma(lib, "infold_bwd", 5)
    for fn in (lib.attn_lane_slice_fwd_launch, lib.attn_infold_fwd_launch,
               lib.attn_infold_bwd_launch, lib.attn_lane_slice_fwd_mma_launch,
               lib.attn_infold_fwd_mma_launch, lib.attn_lane_slice_fwd_mma_resources,
               lib.attn_infold_fwd_mma_resources):
        fn.restype = i
    return lib


_BOARD_KINDS = {"lane slice forward": 0, "in-kernel-fold forward": 1, "in-kernel-fold backward": 2}


@functools.lru_cache(maxsize=None)
def _board_plan(kind: str, l: int, h: int, dh: int, itemsize: int, device: torch.device):
    """(threads per block, heads per pass) of a one-block-per-board kernel:
    the most threads, then the most heads at a time, that fit the card's
    shared memory per block. The lane-slice kernel holds all heads at once."""
    _board_limits(kind, l, dh)
    lib = _board_lib()
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    code = _BOARD_KINDS[kind]
    threads = lib.board_attn_max_threads()
    while threads >= 32:
        for heads in (range(h, 0, -1) if code else (h,)):
            if lib.board_attn_smem_bytes(code, l, h, dh, heads, threads, itemsize) <= limit:
                return threads, heads
        threads //= 2
    need = lib.board_attn_smem_bytes(code, l, h, dh, 1 if code else h, 32, itemsize)
    raise KernelError(
        f"attention {kind}: L={l}, H={h}, Dh={dh} needs {need} bytes of shared memory "
        f"per block, the card allows {limit}"
    )


# K6 and K7 on the tensor cores take no more heads a block than fit this much
# shared memory, so that three blocks share an SM.
_INFOLD_MMA_SMEM = 75 * 1024


def _board_limits(name: str, l: int, dh: int) -> None:
    lib = _board_lib()
    if l > lib.board_attn_max_tokens() or dh > lib.board_attn_max_head_dim():
        raise KernelError(
            f"attention {name}: L={l}, Dh={dh} is beyond the kernel's "
            f"L <= {lib.board_attn_max_tokens()}, Dh <= {lib.board_attn_max_head_dim()}"
        )


@functools.lru_cache(maxsize=None)
def _board_mma_resources(kernel: str, l: int, h: int, dh: int, per_block: int,
                         device: torch.device) -> tuple:
    """(registers, local (spill) bytes) a thread of the tensor-core K5, K6 or
    K7 instantiation for (L, Dh) takes, a block's shared bytes with
    ``per_block`` units, and the blocks that fit an SM with them."""
    lib = _board_lib()
    shape = (l, h, dh) if kernel == "lane_slice_fwd" else (l, dh, per_block)
    entry = getattr(lib, f"attn_{kernel}_mma_resources")
    regs, local, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        check_launch(entry.__name__, entry(
            *shape, ctypes.byref(regs), ctypes.byref(local), ctypes.byref(blocks)))
    return (regs.value, local.value, getattr(lib, f"attn_{kernel}_mma_smem_bytes")(*shape),
            blocks.value)


class BoardPlan(NamedTuple):
    """A block's unit of work for the tensor-core K5, K6 or K7 at one batch,
    and what the instantiation takes on the card."""

    unit: str               # "query tiles" (K5) or "heads" (K6, K7)
    per_block: int          # units a block
    blocks_per_board: int
    blocks: int
    registers: int          # a thread's
    local_bytes: int        # a thread's spills
    smem_bytes: int         # a block's
    blocks_per_sm: int


@functools.lru_cache(maxsize=None)
def board_mma_plan(kernel: str, b: int, l: int, h: int, dh: int,
                   device: torch.device) -> BoardPlan:
    """A block's unit of work for the tensor-core K5 (``kernel``
    "lane_slice_fwd": 16-row query tiles of one board; a block stages all of
    the board's k and v rows and its own q rows, whole rows either way), K6
    ("infold_fwd") or K7 ("infold_bwd": heads of one board, whose columns the
    block transposes; a backward needs all of a head's queries, so it splits
    by heads only), at B boards of (L, H, Dh).

    The rule: the fewest units a block, so the most blocks a board, with
    which all B x (blocks a board) blocks are resident on the card at once
    (the SMs times the blocks an SM holds); where even a board a block is
    more than that, the most units a block. K6 and K7 take no more heads a
    block than fit ``_INFOLD_MMA_SMEM`` (one at least)."""
    _board_limits(kernel, l, dh)
    lib = _board_lib()
    props = torch.cuda.get_device_properties(device)
    if kernel == "lane_slice_fwd":
        unit, units = "query tiles", -(-l // 16)
        counts = list(range(1, units + 1))
    else:
        unit, units = "heads", h
        smem_bytes = getattr(lib, f"attn_{kernel}_mma_smem_bytes")
        counts = [n for n in range(1, h + 1) if smem_bytes(l, dh, n) <= _INFOLD_MMA_SMEM] or [1]
    smem = _board_mma_resources(kernel, l, h, dh, counts[0], device)[2]
    if smem > props.shared_memory_per_block_optin:
        raise KernelError(f"attention {kernel}: L={l}, H={h}, Dh={dh} needs {smem} bytes of "
                          f"shared memory per block, the card allows "
                          f"{props.shared_memory_per_block_optin}")
    for per_block in counts:
        resources = _board_mma_resources(kernel, l, h, dh, per_block, device)
        if b * -(-units // per_block) <= props.multi_processor_count * resources[3]:
            break
    parts = -(-units // per_block)
    return BoardPlan(unit, per_block, parts, b * parts, *resources)


def _on_card(name: str, q: torch.Tensor) -> bool:
    """True for the kernel (a CUDA tensor), False for the plain version (CPU)."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    return True


def _checked(name: str, tensors: dict) -> torch.Tensor:
    """The tensors of one launch are alike: contiguous, of one supported
    dtype, one shape and one device. Returns q."""
    q = tensors["q"]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: unsupported dtype {q.dtype}")
    for key, t in tensors.items():
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: {key} must be a contiguous {q.dtype} tensor of shape {tuple(q.shape)} "
                f"on {q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    return q


def _run(wrapper, entry, tensors: dict, n_out: int, args: tuple):
    """Launch ``entry`` on the current stream with ``args`` after the
    pointers and count it on ``wrapper``. Returns the n_out outputs."""
    q = tensors["q"]
    outs = [torch.empty_like(q) for _ in range(n_out)]
    code = entry(
        int(q.dtype == torch.bfloat16), *(t.data_ptr() for t in (*tensors.values(), *outs)),
        *args, torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(entry.__name__, code)
    wrapper.launches += 1
    return outs


def _launch(wrapper, entry_name: str, backward: bool, tensors: dict, l: int, dh: int, dims: tuple):
    """One kernel of ``csrc/attention.cu`` (a block per head): [o] or [dq, dk, dv]."""
    q = _checked(wrapper.__name__, tensors)
    threads = _threads(backward, l, dh, q.device)
    return _run(wrapper, getattr(_lib(), entry_name), tensors, 3 if backward else 1,
                (*dims, threads))


def _launch_board(wrapper, entry_name: str, kind: str, tensors: dict, dims: tuple):
    """One kernel of ``csrc/attention_board.cu`` (a block per board)."""
    q = _checked(wrapper.__name__, tensors)
    _, l, h, dh = dims
    threads, heads = _board_plan(kind, l, h, dh, q.element_size(), q.device)
    args = (*dims, threads) if kind == "lane slice forward" else (*dims, heads, threads)
    return _run(wrapper, getattr(_board_lib(), entry_name), tensors,
                3 if kind.endswith("backward") else 1, args)


def _folded_dims(name: str, q: torch.Tensor) -> tuple:
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be (BH, Dh, L), got {tuple(q.shape)}")
    return tuple(q.shape)


def _packed_dims(name: str, q: torch.Tensor, h: int, dh: int) -> tuple:
    if q.dim() != 3 or q.shape[2] != h * dh:
        raise ValueError(f"{name}: q must be (B, L, {h * dh}), got {tuple(q.shape)}")
    return q.shape[0], q.shape[1], h, dh


def attention_folded_fwd(q, k, v, kernel: str | None = None):
    """K3: q, k, v (BH, Dh, L), bf16 or f32 -> o (BH, Dh, L).

    On the card it launches ``folded_fwd_kernel_for(q.dtype)``, unless
    ``kernel="fma"`` asks for the FMA kernel on bf16 too (the first version,
    which chip_smoke.py times beside the tensor-core kernel)."""
    _known_kernel("attention_folded_fwd", kernel)
    if not _on_card("attention_folded_fwd", q):
        return attention_folded_reference(q, k, v)
    bh, dh, l = _folded_dims("attention_folded_fwd", q)
    tensors = {"q": q, "k": k, "v": v}
    if _kernel_on_card("attention_folded_fwd", q.dtype, kernel) == "fma":
        return _launch(attention_folded_fwd, "attn_folded_fwd_launch", False, tensors, l, dh,
                       (bh, dh, l))[0]
    _checked("attention_folded_fwd", tensors)
    return _run(attention_folded_fwd, _lib().attn_folded_fwd_mma_launch, tensors, 1,
                (bh, dh, l, _mma_heads("folded_fwd", l, dh, q.device)))[0]


def attention_folded_bwd(q, k, v, do, kernel: str | None = None):
    """K4: q, k, v, do (BH, Dh, L), bf16 or f32 -> dq, dk, dv (BH, Dh, L).

    On the card it launches ``folded_bwd_kernel_for(q.dtype)``, unless
    ``kernel="fma"`` asks for the FMA kernel on bf16 too (the first version,
    which chip_smoke.py times beside the tensor-core kernel)."""
    _known_kernel("attention_folded_bwd", kernel)
    if not _on_card("attention_folded_bwd", q):
        return attention_folded_bwd_reference(q, k, v, do)
    bh, dh, l = _folded_dims("attention_folded_bwd", q)
    tensors = {"q": q, "k": k, "v": v, "do": do}
    if _kernel_on_card("attention_folded_bwd", q.dtype, kernel) == "fma":
        return tuple(_launch(attention_folded_bwd, "attn_folded_bwd_launch", True, tensors, l, dh,
                             (bh, dh, l)))
    _checked("attention_folded_bwd", tensors)
    return tuple(_run(attention_folded_bwd, _folded_bwd_lib().attn_folded_bwd_mma_launch, tensors,
                      3, (bh, dh, l, _mma_heads("folded_bwd", l, dh, q.device))))


def attention_packed_fwd(q, k, v, h: int, dh: int, kernel: str | None = None):
    """K8: q, k, v (B, L, H*Dh), bf16 or f32 -> o (B, L, H*Dh).

    On the card it launches ``packed_fwd_kernel_for(q.dtype)``, unless
    ``kernel="fma"`` asks for the FMA kernel on bf16 too (the first version,
    which chip_smoke.py times beside the tensor-core kernel)."""
    _known_kernel("attention_packed_fwd", kernel)
    if not _on_card("attention_packed_fwd", q):
        return attention_packed_reference(q, k, v, h, dh)
    dims = _packed_dims("attention_packed_fwd", q, h, dh)
    tensors = {"q": q, "k": k, "v": v}
    if _kernel_on_card("attention_packed_fwd", q.dtype, kernel) == "fma":
        return _launch(attention_packed_fwd, "attn_packed_fwd_launch", False, tensors, dims[1], dh,
                       dims)[0]
    _checked("attention_packed_fwd", tensors)
    return _run(attention_packed_fwd, _lib().attn_packed_fwd_mma_launch, tensors, 1,
                (*dims, _mma_heads("packed_fwd", dims[1], dh, q.device)))[0]


def attention_packed_bwd(q, k, v, do, h: int, dh: int, kernel: str | None = None):
    """K9: q, k, v, do (B, L, H*Dh), bf16 or f32 -> dq, dk, dv (B, L, H*Dh).

    On the card it launches ``packed_bwd_kernel_for(q.dtype)``, unless
    ``kernel="fma"`` asks for the FMA kernel on bf16 too (the first version,
    which chip_smoke.py times beside the tensor-core kernel)."""
    _known_kernel("attention_packed_bwd", kernel)
    if not _on_card("attention_packed_bwd", q):
        return attention_packed_bwd_reference(q, k, v, do, h, dh)
    dims = _packed_dims("attention_packed_bwd", q, h, dh)
    tensors = {"q": q, "k": k, "v": v, "do": do}
    if _kernel_on_card("attention_packed_bwd", q.dtype, kernel) == "fma":
        return tuple(_launch(attention_packed_bwd, "attn_packed_bwd_launch", True, tensors, dims[1],
                             dh, dims))
    _checked("attention_packed_bwd", tensors)
    return tuple(_run(attention_packed_bwd, _bwd_lib().attn_packed_bwd_mma_launch, tensors, 3,
                      (*dims, _mma_heads("packed_bwd", dims[1], dh, q.device))))


def _board_fwd(wrapper, kernel_name: str, fma_kind: str, q, k, v, h: int, dh: int, kernel):
    """K5 or K6 on the card: the tensor-core kernel (bf16) at the block plan
    of ``board_mma_plan``, or the FMA kernel a block per board."""
    dims = _packed_dims(wrapper.__name__, q, h, dh)
    tensors = {"q": q, "k": k, "v": v}
    if _kernel_on_card(wrapper.__name__, q.dtype, kernel) == "fma":
        return _launch_board(wrapper, f"attn_{kernel_name}_launch", fma_kind, tensors, dims)[0]
    _checked(wrapper.__name__, tensors)
    per_block = board_mma_plan(kernel_name, *dims, q.device).per_block
    return _run(wrapper, getattr(_board_lib(), f"attn_{kernel_name}_mma_launch"), tensors, 1,
                (*dims, per_block))[0]


def attention_lane_slice_fwd(q, k, v, h: int, dh: int, kernel: str | None = None):
    """K5: q, k, v (B, L, H*Dh), bf16 or f32 -> o (B, L, H*Dh). Forward only.

    On the card it launches ``lane_slice_fwd_kernel_for(q.dtype)``, unless
    ``kernel="fma"`` asks for the FMA kernel on bf16 too (the first version,
    which chip_smoke.py times beside the tensor-core kernel)."""
    _known_kernel("attention_lane_slice_fwd", kernel)
    if not _on_card("attention_lane_slice_fwd", q):
        return attention_lane_slice_reference(q, k, v, h, dh)
    return _board_fwd(attention_lane_slice_fwd, "lane_slice_fwd", "lane slice forward",
                      q, k, v, h, dh, kernel)


def attention_infold_fwd(q, k, v, h: int, dh: int, kernel: str | None = None):
    """K6: q, k, v (B, L, H*Dh), bf16 or f32 -> o (B, L, H*Dh).

    On the card it launches ``infold_fwd_kernel_for(q.dtype)``, unless
    ``kernel="fma"`` asks for the FMA kernel on bf16 too (the first
    version)."""
    _known_kernel("attention_infold_fwd", kernel)
    if not _on_card("attention_infold_fwd", q):
        return attention_infold_reference(q, k, v, h, dh)
    return _board_fwd(attention_infold_fwd, "infold_fwd", "in-kernel-fold forward",
                      q, k, v, h, dh, kernel)


def attention_infold_bwd(q, k, v, do, h: int, dh: int, kernel: str | None = None):
    """K7: q, k, v, do (B, L, H*Dh), bf16 or f32 -> dq, dk, dv (B, L, H*Dh).

    On the card it launches ``infold_bwd_kernel_for(q.dtype)`` (in bf16 at
    the block plan of ``board_mma_plan``), unless ``kernel="fma"`` asks for
    the FMA kernel on bf16 too (the first version, a block per board)."""
    _known_kernel("attention_infold_bwd", kernel)
    if not _on_card("attention_infold_bwd", q):
        return attention_infold_bwd_reference(q, k, v, do, h, dh)
    dims = _packed_dims("attention_infold_bwd", q, h, dh)
    tensors = {"q": q, "k": k, "v": v, "do": do}
    if _kernel_on_card("attention_infold_bwd", q.dtype, kernel) == "fma":
        return tuple(_launch_board(attention_infold_bwd, "attn_infold_bwd_launch",
                                   "in-kernel-fold backward", tensors, dims))
    _checked("attention_infold_bwd", tensors)
    per_block = board_mma_plan("infold_bwd", *dims, q.device).per_block
    return tuple(_run(attention_infold_bwd, _board_lib().attn_infold_bwd_mma_launch, tensors, 3,
                      (*dims, per_block)))


for _wrapper in (attention_folded_fwd, attention_folded_bwd, attention_packed_fwd,
                 attention_packed_bwd, attention_lane_slice_fwd, attention_infold_fwd,
                 attention_infold_bwd):
    _wrapper.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _AttentionFolded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return attention_folded_fwd(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return attention_folded_bwd(q, k, v, g.to(q.dtype).contiguous())


class _AttentionPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, h, dh):
        ctx.save_for_backward(q, k, v)
        ctx.heads = (h, dh)
        return attention_packed_fwd(q, k, v, h, dh)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*attention_packed_bwd(q, k, v, g.to(q.dtype).contiguous(), *ctx.heads), None, None)


class _AttentionInfold(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, h, dh):
        ctx.save_for_backward(q, k, v)
        ctx.heads = (h, dh)
        return attention_infold_fwd(q, k, v, h, dh)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*attention_infold_bwd(q, k, v, g.to(q.dtype).contiguous(), *ctx.heads), None, None)


def attention_folded(q, k, v):
    """Attention on folded heads (BH, Dh, L), differentiable: K3 forward, K4
    backward. Saves q, k, v and recomputes the probabilities in the backward."""
    return _AttentionFolded.apply(q, k, v)


def attention_packed(q, k, v, h: int, dh: int):
    """Attention on packed heads (B, L, H*Dh), differentiable: K8 forward, K9
    backward. Saves q, k, v and recomputes the probabilities in the backward."""
    return _AttentionPacked.apply(q, k, v, h, dh)


def attention_infold(q, k, v, h: int, dh: int):
    """Attention on packed heads (B, L, H*Dh) by the one-block-per-board
    kernels, differentiable: K6 forward, K7 backward. Saves q, k, v and
    recomputes the probabilities in the backward."""
    return _AttentionInfold.apply(q, k, v, h, dh)


ROUTES = ("folded", "infold")  # what a caller of tiny_head_attention can force


def tiny_head_attention(query, key, value, route=None):
    """Attention for (B, L, H, Dh) query, key, value -> (B, L, H, Dh).

    With ``route`` None: Dh >= 32 takes the packed pair (K8/K9); below that,
    a forward that records no gradient (rollout, opponent, validation,
    tournament, play) takes the forward-only lane-slice kernel (K5), or the
    packed forward (K8) past ``LANE_SLICE_MAX_HEAD_ROWS``, and one that does
    takes ``GRADIENT_ROUTE``. All but ``"folded"`` work on
    (B, L, H*Dh), a free reshape of a contiguous tensor; ``"folded"`` moves
    the heads to (BH, Dh, L) with a transpose, runs K3/K4 and moves them back.
    A caller can force either of ``ROUTES``, with or without a gradient.
    """
    b, l, h, dh = query.shape
    if route is not None and route not in ROUTES:
        raise ValueError(f"tiny_head_attention: route must be one of {ROUTES}, got {route!r}")
    recording = torch.is_grad_enabled() and any(t.requires_grad for t in (query, key, value))
    if route is None and dh < PACKED_MIN_HEAD_DIM and recording:
        route = GRADIENT_ROUTE
    if route == "folded":
        def fold(t):  # (B, L, H, Dh) -> (BH, Dh, L)
            return t.permute(0, 2, 3, 1).reshape(b * h, dh, l).contiguous()

        out = attention_folded(fold(query), fold(key), fold(value))
        return out.reshape(b, h, dh, l).permute(0, 3, 1, 2)
    d = h * dh
    q, k, v = (t.reshape(b, l, d).contiguous() for t in (query, key, value))
    if route == "infold":
        out = attention_infold(q, k, v, h, dh)
    elif dh >= PACKED_MIN_HEAD_DIM or h * l > LANE_SLICE_MAX_HEAD_ROWS:
        out = attention_packed(q, k, v, h, dh)
    else:
        out = attention_lane_slice_fwd(q, k, v, h, dh)
    return out.reshape(b, l, h, dh)
