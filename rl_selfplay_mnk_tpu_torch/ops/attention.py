"""Fused attention for tiny heads on board-length tokens (kernels K3, K4, K8,
K9) and their plain PyTorch versions.

Replaces the TPU kernels of ``rl_selfplay_mnk_tpu/ops/pallas_attention.py``:

  * ``attention_folded`` on (BH, Dh, L): ``_attn_kernel`` forward (K3) and
    ``_attn_bwd_kernel`` backward (K4);
  * ``attention_packed`` on (B, L, D = H * Dh): ``_packed_fwd_kernel``
    forward (K8) and ``_packed_bwd_kernel`` backward (K9);
  * ``tiny_head_attention`` on (B, L, H, Dh), the models' entry, with the
    same dispatch: Dh < 32 folds with a transpose and takes the folded pair,
    Dh >= 32 reshapes (free) and takes the packed pair.

All compute dense softmax attention per head with the scores kept on chip::

    s = (q . k) / sqrt(Dh)      f32        o  = p~ . v        p~ = p in v's dtype
    p = softmax(s)              f32        dp = dO . v
    ds~ = p * (dp - rowsum(dp * p)) / sqrt(Dh), in q's dtype
    dq = ds~ . k    dk = ds~^T . q    dv = p~^T . dO          f32 sums

Each pair is a ``torch.autograd.Function`` that saves q, k, v only and
recomputes the probabilities in its backward; the incoming gradient is cast
to q's dtype first.

On the H100 both directions are bound by bytes at the trainer's shapes; the
kernels (``csrc/attention.cu``) hold one head per block in shared memory and
do their products with FMA on the CUDA cores, which bound them for now.

The four launch wrappers (``attention_folded_fwd``, ``attention_folded_bwd``,
``attention_packed_fwd``, ``attention_packed_bwd``) launch their kernel for
CUDA tensors, adding one to their ``.launches``, and run their
``*_reference`` for CPU tensors; there is no other route.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .cuda_build import KernelError, check_launch, load_library

PACKED_MIN_HEAD_DIM = 32  # tiny_head_attention: below it fold, from it on pack


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
    lib.attn_folded_bwd_launch.argtypes = [i] + [p] * 7 + [i] * 4 + [p]
    lib.attn_packed_fwd_launch.argtypes = [i] + [p] * 4 + [i] * 5 + [p]
    lib.attn_packed_bwd_launch.argtypes = [i] + [p] * 7 + [i] * 5 + [p]
    for fn in (lib.attn_folded_fwd_launch, lib.attn_folded_bwd_launch,
               lib.attn_packed_fwd_launch, lib.attn_packed_bwd_launch):
        fn.restype = i
    return lib


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


def _on_card(name: str, q: torch.Tensor) -> bool:
    """True for the kernel (a CUDA tensor), False for the plain version (CPU)."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    return True


def _launch(wrapper, entry_name: str, backward: bool, tensors: dict, l: int, dh: int, dims: tuple):
    """Check the inputs, launch one kernel on the current stream and count
    it on ``wrapper``. Returns the outputs: [o] or [dq, dk, dv]."""
    name = wrapper.__name__
    q = tensors["q"]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: unsupported dtype {q.dtype}")
    for key, t in tensors.items():
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: {key} must be a contiguous {q.dtype} tensor of shape {tuple(q.shape)} "
                f"on {q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    threads = _threads(backward, l, dh, q.device)
    outs = [torch.empty_like(q) for _ in range(3 if backward else 1)]
    code = getattr(_lib(), entry_name)(
        int(q.dtype == torch.bfloat16), *(t.data_ptr() for t in (*tensors.values(), *outs)),
        *dims, threads, torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(entry_name, code)
    wrapper.launches += 1
    return outs


def _folded_dims(name: str, q: torch.Tensor) -> tuple:
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be (BH, Dh, L), got {tuple(q.shape)}")
    return tuple(q.shape)


def _packed_dims(name: str, q: torch.Tensor, h: int, dh: int) -> tuple:
    if q.dim() != 3 or q.shape[2] != h * dh:
        raise ValueError(f"{name}: q must be (B, L, {h * dh}), got {tuple(q.shape)}")
    return q.shape[0], q.shape[1], h, dh


def attention_folded_fwd(q, k, v):
    """K3: q, k, v (BH, Dh, L), bf16 or f32 -> o (BH, Dh, L)."""
    if not _on_card("attention_folded_fwd", q):
        return attention_folded_reference(q, k, v)
    bh, dh, l = _folded_dims("attention_folded_fwd", q)
    return _launch(attention_folded_fwd, "attn_folded_fwd_launch", False,
                   {"q": q, "k": k, "v": v}, l, dh, (bh, dh, l))[0]


def attention_folded_bwd(q, k, v, do):
    """K4: q, k, v, do (BH, Dh, L) -> dq, dk, dv (BH, Dh, L)."""
    if not _on_card("attention_folded_bwd", q):
        return attention_folded_bwd_reference(q, k, v, do)
    bh, dh, l = _folded_dims("attention_folded_bwd", q)
    return tuple(_launch(attention_folded_bwd, "attn_folded_bwd_launch", True,
                         {"q": q, "k": k, "v": v, "do": do}, l, dh, (bh, dh, l)))


def attention_packed_fwd(q, k, v, h: int, dh: int):
    """K8: q, k, v (B, L, H*Dh), bf16 or f32 -> o (B, L, H*Dh)."""
    if not _on_card("attention_packed_fwd", q):
        return attention_packed_reference(q, k, v, h, dh)
    dims = _packed_dims("attention_packed_fwd", q, h, dh)
    return _launch(attention_packed_fwd, "attn_packed_fwd_launch", False,
                   {"q": q, "k": k, "v": v}, dims[1], dh, dims)[0]


def attention_packed_bwd(q, k, v, do, h: int, dh: int):
    """K9: q, k, v, do (B, L, H*Dh) -> dq, dk, dv (B, L, H*Dh)."""
    if not _on_card("attention_packed_bwd", q):
        return attention_packed_bwd_reference(q, k, v, do, h, dh)
    dims = _packed_dims("attention_packed_bwd", q, h, dh)
    return tuple(_launch(attention_packed_bwd, "attn_packed_bwd_launch", True,
                         {"q": q, "k": k, "v": v, "do": do}, dims[1], dh, dims))


attention_folded_fwd.launches = 0
attention_folded_bwd.launches = 0
attention_packed_fwd.launches = 0
attention_packed_bwd.launches = 0


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


def attention_folded(q, k, v):
    """Attention on folded heads (BH, Dh, L), differentiable: K3 forward, K4
    backward. Saves q, k, v and recomputes the probabilities in the backward."""
    return _AttentionFolded.apply(q, k, v)


def attention_packed(q, k, v, h: int, dh: int):
    """Attention on packed heads (B, L, H*Dh), differentiable: K8 forward, K9
    backward. Saves q, k, v and recomputes the probabilities in the backward."""
    return _AttentionPacked.apply(q, k, v, h, dh)


def tiny_head_attention(query, key, value):
    """Attention for (B, L, H, Dh) query, key, value -> (B, L, H, Dh).

    Dh < 32 (many tiny heads) folds to (BH, Dh, L) with a transpose and
    takes the folded pair; Dh >= 32 reshapes to (B, L, H*Dh), which is free
    on a contiguous tensor, and takes the packed pair.
    """
    b, l, h, dh = query.shape
    if dh < PACKED_MIN_HEAD_DIM:
        def fold(t):  # (B, L, H, Dh) -> (BH, Dh, L)
            return t.permute(0, 2, 3, 1).reshape(b * h, dh, l).contiguous()

        out = attention_folded(fold(query), fold(key), fold(value))
        return out.reshape(b, h, dh, l).permute(0, 3, 1, 2)
    d = h * dh
    out = attention_packed(
        query.reshape(b, l, d).contiguous(), key.reshape(b, l, d).contiguous(),
        value.reshape(b, l, d).contiguous(), h, dh,
    )
    return out.reshape(b, l, h, dh)
