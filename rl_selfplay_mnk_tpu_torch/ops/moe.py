"""The expert layer of one chip's share: routed over every expert of the
layer, computed for the experts this chip holds.

Replaces no TPU kernel: the JAX package has no expert layer. The function
is LFM2's sparse block (``Lfm2MoeSparseMoeBlock``) cut to the experts
``[first, first + held)`` of ``num_experts``, as expert parallelism cuts
it::

    s = sigmoid(x W_r^T)                        f32, all num_experts
    picks = top_k(s + expert_bias)              the bias moves selection only
    w = s[picks] / (sum s[picks] + 1e-6) * routed_scaling_factor
    y = sum over the picks p held here of w_p * W2_p (silu(W1_p x) * (W3_p x))

A pick of an expert not held here adds nothing: that part of the result is
the other chips'. The four shares of a 32-expert layer, summed, are the
whole layer (tests/test_torch_lfm2.py).

The dispatch sorts the (token, pick) pairs by held expert (the pairs of
experts not held last), so each expert's rows are contiguous, with the
experts' ends (``ends``, int32) computed on the device: nothing is read on
the host. The grouped SwiGLU products run over those rows
(``grouped_mm``: ``torch._grouped_mm``, a library grouped GEMM that reads
the ends on the device, for bf16 CUDA tensors; a loop over the experts
otherwise). Rows past the last held expert's end are never read. The
combine gathers each token's k rows back by the inverse permutation and
sums them weighted in f32, and the gather of the tokens into sorted rows
sums its gradient the same way: no atomics, the same bits every run.

On the card the router's top k and weights, the sort, the gather, the
SwiGLU between the grouped products and the combine are the kernels of
``csrc/moe.cu`` (``moe_*``), forward and backward, each reading the held
rows' count from ``ends`` on the device; ``held_experts.launches`` counts
them. Only the router's logits (a (N, D) x (D, E) product in f32) and the
grouped products are library calls. A CPU tensor takes the plain version
(``held_experts_reference``): each held expert over the tokens that picked
it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..utils import tracing
from .cuda_build import KernelError, check_launch, load_library

NORM_EPS = 1e-6  # Lfm2MoeSparseMoeBlock: the picks' weights over their sum + 1e-6


def route(x, gate_weight, expert_bias, top_k: int, scale: float):
    """(weights (N, k) f32, picks (N, k) int64) of x (N, D): sigmoid scores
    in f32, the top k by score + bias, the weights normalised over the
    picks."""
    scores = torch.sigmoid(F.linear(x.to(torch.float32), gate_weight.to(torch.float32)))
    picks = torch.topk(scores + expert_bias, top_k, dim=-1).indices
    w = scores.gather(1, picks)
    return w / (w.sum(-1, keepdim=True) + NORM_EPS) * scale, picks


def grouped_mm(a, b, ends):
    """Rows of a (R, K) times b[g] (K, N) for the rows of group g, the
    groups ending at ``ends`` (int32, on the device): (R, N), rows past the
    last end undefined. With a 2-D ``b`` (R, N) the product over each
    group's rows instead: a (K, R) -> (G, K, N). The library's grouped GEMM
    (bf16 CUDA tensors)."""
    return torch._grouped_mm(a, b, offs=ends)


# ---------------------------------------------------------------------------
# the kernels (csrc/moe.cu)
# ---------------------------------------------------------------------------

SORT_BLOCK = 4096  # csrc/moe.cu kPairsPerBlock
MAX_EXPERTS, MAX_TOP_K, MAX_HELD = 64, 8, 64
ROW_BLOCKS = 132 * 8  # the SwiGLU kernels' blocks, walking the held rows


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("moe")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.moe_route_launch.argtypes = [p, p, i, i, i, i, i, f, p, p, p, p, p]
    lib.moe_route_bwd_launch.argtypes = [p, p, p, i, i, i, f, p, p]
    lib.moe_sort_launch.argtypes = [p, ll, i, p, p, p, p, p]
    lib.moe_gather_launch.argtypes = [i, i, p, p, p, i, i, ll, i, p, p]
    lib.moe_gather_bwd_launch.argtypes = [i, i, p, p, p, i, i, ll, i, p, p]
    lib.moe_swiglu_launch.argtypes = [i, i, p, p, p, i, i, i, p, p]
    lib.moe_swiglu_bwd_launch.argtypes = [i, i, p, p, p, p, i, i, i, p, p, p]
    lib.moe_combine_launch.argtypes = [i, i, p, p, p, p, i, i, ll, i, p, p]
    lib.moe_combine_bwd_launch.argtypes = [i, i, p, p, p, p, p, i, i, ll, i, p, p, p]
    for name in ("route", "route_bwd", "sort", "gather", "gather_bwd", "swiglu", "swiglu_bwd",
                 "combine", "combine_bwd"):
        getattr(lib, f"moe_{name}_launch").restype = i
    return lib


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _rows(dtype, width: int, *tensors) -> tuple:
    """(is_bf16, elements a load) of the row kernels: 16 bytes where the
    width and every address allow it, else one."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise KernelError(f"moe: unsupported dtype {dtype}")
    ve = 16 // (2 if dtype == torch.bfloat16 else 4)
    if width % ve or any(t.data_ptr() % 16 for t in tensors):
        ve = 1
    return int(dtype == torch.bfloat16), ve


def _count(n: int = 1) -> None:
    held_experts.launches += n


class _Route(torch.autograd.Function):
    """logits (N, E) f32 -> weights (N, k) f32, and (not differentiable)
    picks, the picks' scores and each pair's held expert (int32)."""

    @staticmethod
    def forward(ctx, logits, bias, top_k, first, held, scale):
        n, e = logits.shape
        if e > MAX_EXPERTS or top_k > MAX_TOP_K or held > MAX_HELD:
            raise KernelError(f"moe: {e} experts, top {top_k}, {held} held is past the kernels")
        logits = logits.contiguous()
        picks = torch.empty((n, top_k), dtype=torch.int32, device=logits.device)
        scores = torch.empty((n, top_k), dtype=torch.float32, device=logits.device)
        weights = torch.empty_like(scores)
        keys = torch.empty_like(picks)
        check_launch("moe_route_fwd", _lib().moe_route_launch(
            logits.data_ptr(), bias.contiguous().data_ptr(), n, e, top_k, first, held, scale,
            picks.data_ptr(), weights.data_ptr(), scores.data_ptr(), keys.data_ptr(),
            _stream(logits)))
        _count()
        ctx.save_for_backward(picks, scores)
        ctx.shape, ctx.scale = (n, e, top_k), scale
        ctx.mark_non_differentiable(picks, keys)
        return weights, picks, keys

    @staticmethod
    def backward(ctx, dweights, _picks, _keys):
        picks, scores = ctx.saved_tensors
        n, e, top_k = ctx.shape
        dlogits = torch.empty((n, e), dtype=torch.float32, device=picks.device)
        check_launch("moe_route_bwd", _lib().moe_route_bwd_launch(
            dweights.contiguous().data_ptr(), picks.data_ptr(), scores.data_ptr(), n, e, top_k,
            ctx.scale, dlogits.data_ptr(), _stream(picks)))
        _count()
        return dlogits, None, None, None, None, None


def _sort(keys, held: int):
    """(order, inverse, ends) int32 of the pairs' keys, on the device."""
    pairs = keys.numel()
    bins = held + 1
    blocks = -(-pairs // SORT_BLOCK)
    counts = torch.empty((blocks, bins), dtype=torch.int32, device=keys.device)
    order = torch.empty(pairs, dtype=torch.int32, device=keys.device)
    inverse = torch.empty_like(order)
    ends = torch.empty(held, dtype=torch.int32, device=keys.device)
    check_launch("moe_sort", _lib().moe_sort_launch(
        keys.data_ptr(), pairs, bins, counts.data_ptr(), order.data_ptr(), inverse.data_ptr(),
        ends.data_ptr(), _stream(keys)))
    _count(2)
    return order, inverse, ends


class _GatherK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, order, inverse, ends, top_k):
        x = x.contiguous()
        n, d = x.shape
        xs = torch.empty((order.numel(), d), dtype=x.dtype, device=x.device)
        held = ends.numel()
        bf, ve = _rows(x.dtype, d, x, xs)
        check_launch("moe_gather_fwd", _lib().moe_gather_launch(
            bf, ve, x.data_ptr(), order.data_ptr(), ends.data_ptr(), held, top_k, order.numel(),
            d, xs.data_ptr(), _stream(x)))
        _count()
        ctx.save_for_backward(inverse, ends)
        ctx.top_k, ctx.n = top_k, n
        return xs

    @staticmethod
    def backward(ctx, dxs):
        inverse, ends = ctx.saved_tensors
        dxs = dxs.contiguous()
        d = dxs.shape[1]
        dx = torch.empty((ctx.n, d), dtype=dxs.dtype, device=dxs.device)
        bf, ve = _rows(dxs.dtype, d, dxs, dx)
        check_launch("moe_gather_bwd", _lib().moe_gather_bwd_launch(
            bf, ve, dxs.data_ptr(), inverse.data_ptr(), ends.data_ptr(), ends.numel(), ctx.top_k,
            ctx.n, d, dx.data_ptr(), _stream(dxs)))
        _count()
        return dx, None, None, None, None


def _swiglu_fwd(h1, h3, ends):
    h = torch.empty_like(h1)
    bf, ve = _rows(h1.dtype, h1.shape[1], h1, h3, h)
    check_launch("moe_swiglu_fwd", _lib().moe_swiglu_launch(
        bf, ve, h1.data_ptr(), h3.data_ptr(), ends.data_ptr(), ends.numel(), h1.shape[1],
        ROW_BLOCKS, h.data_ptr(), _stream(h1)))
    _count()
    return h


def _swiglu_bwd(dh, h1, h3, ends):
    dh1, dh3 = torch.empty_like(h1), torch.empty_like(h3)
    bf, ve = _rows(h1.dtype, h1.shape[1], dh, h1, h3, dh1, dh3)
    check_launch("moe_swiglu_bwd", _lib().moe_swiglu_bwd_launch(
        bf, ve, dh.data_ptr(), h1.data_ptr(), h3.data_ptr(), ends.data_ptr(), ends.numel(),
        h1.shape[1], ROW_BLOCKS, dh1.data_ptr(), dh3.data_ptr(), _stream(h1)))
    _count()
    return dh1, dh3


class _GroupedSwiGLUK(torch.autograd.Function):
    """W2_g (silu(W1_g x) * (W3_g x)) for the rows of each held expert g:
    the grouped products, the SwiGLU between them by ``moe_swiglu_*`` over
    the held rows alone, no masks (no consumer reads a row past the last
    end)."""

    @staticmethod
    def forward(ctx, xs, w1, w3, w2, ends):
        dt = xs.dtype
        w1c, w3c, w2c = (w.to(dt) for w in (w1, w3, w2))
        h1 = grouped_mm(xs, w1c.transpose(-2, -1), ends)
        h3 = grouped_mm(xs, w3c.transpose(-2, -1), ends)
        y = grouped_mm(_swiglu_fwd(h1, h3, ends), w2c.transpose(-2, -1), ends)
        ctx.save_for_backward(xs, h1, h3, w1c, w3c, w2c, ends)
        ctx.param_dtype = (w1.dtype, w3.dtype, w2.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        xs, h1, h3, w1c, w3c, w2c, ends = ctx.saved_tensors
        dy = dy.to(xs.dtype).contiguous()
        dh = grouped_mm(dy, w2c, ends)
        dw2 = grouped_mm(dy.t(), _swiglu_fwd(h1, h3, ends), ends)
        dh1, dh3 = _swiglu_bwd(dh, h1, h3, ends)
        dxs = grouped_mm(dh1, w1c, ends) + grouped_mm(dh3, w3c, ends)
        dw1 = grouped_mm(dh1.t(), xs, ends)
        dw3 = grouped_mm(dh3.t(), xs, ends)
        t1, t3, t2 = ctx.param_dtype
        return dxs, dw1.to(t1), dw3.to(t3), dw2.to(t2), None


class _CombineK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, weights, order, inverse, ends, top_k):
        y = y.contiguous()
        n = weights.shape[0]
        d = y.shape[1]
        out = torch.empty((n, d), dtype=y.dtype, device=y.device)
        bf, ve = _rows(y.dtype, d, y, out)
        check_launch("moe_combine_fwd", _lib().moe_combine_launch(
            bf, ve, y.data_ptr(), weights.data_ptr(), inverse.data_ptr(), ends.data_ptr(),
            ends.numel(), top_k, n, d, out.data_ptr(), _stream(y)))
        _count()
        ctx.save_for_backward(y, weights, order, ends)
        ctx.top_k = top_k
        return out

    @staticmethod
    def backward(ctx, dout):
        y, weights, order, ends = ctx.saved_tensors
        dout = dout.to(y.dtype).contiguous()
        d = y.shape[1]
        dys = torch.empty_like(y)
        dweights = torch.empty_like(weights)
        bf, ve = _rows(y.dtype, d, dout, y, dys)
        check_launch("moe_combine_bwd", _lib().moe_combine_bwd_launch(
            bf, ve, dout.data_ptr(), y.data_ptr(), weights.data_ptr(), order.data_ptr(),
            ends.data_ptr(), ends.numel(), ctx.top_k, order.numel(), d, dys.data_ptr(),
            dweights.data_ptr(), _stream(y)))
        _count()
        return dys, dweights, None, None, None, None


def _count_load(loads, pairs: int) -> None:
    """The tracing counters of one forward from the held experts' loads
    (pairs a held expert, f32)."""
    tracing.count("moe.expert_load_max_over_mean", loads.max() / loads.mean().clamp(min=1e-30))
    tracing.count("moe.not_held_share", 1.0 - loads.sum() / pairs)


def held_experts_card(x, gate_weight, expert_bias, w1, w3, w2, first: int, top_k: int,
                      scale: float):
    """``held_experts`` on the card: the kernels around the grouped products."""
    held = w1.shape[0]
    logits = F.linear(x.to(torch.float32), gate_weight.to(torch.float32))
    weights, _, keys = _Route.apply(logits, expert_bias.to(torch.float32), top_k, first, held,
                                    scale)
    order, inverse, ends = _sort(keys, held)
    if tracing.counting():
        ends_f = ends.to(torch.float32)
        _count_load(torch.diff(ends_f, prepend=torch.zeros(1, device=ends.device)),
                    keys.numel())
    xs = _GatherK.apply(x, order, inverse, ends, top_k)
    y = _GroupedSwiGLUK.apply(xs, w1, w3, w2, ends)
    return _CombineK.apply(y, weights, order, inverse, ends, top_k)


def held_experts(x, gate_weight, expert_bias, w1, w3, w2, first: int, top_k: int,
                 scale: float):
    """The expert layer's part of the result that the experts held here
    give: x (N, D) in the compute dtype; ``gate_weight`` (E, D) and
    ``expert_bias`` (E,) over all E experts; w1, w3 (held, F, D) and w2
    (held, D, F) of experts first..first + held - 1. Returns (N, D) in x's
    dtype. A CUDA tensor takes the kernels (``held_experts_card``); a CPU
    tensor the plain version (``held_experts_reference``)."""
    if x.is_cuda:
        return held_experts_card(x, gate_weight, expert_bias, w1, w3, w2, first, top_k, scale)
    return held_experts_reference(x, gate_weight, expert_bias, w1, w3, w2, first, top_k, scale)


def held_experts_reference(x, gate_weight, expert_bias, w1, w3, w2, first: int, top_k: int,
                           scale: float):
    """Plain version, the CPU path: every held expert over the tokens that
    picked it, by boolean masks (reads the sizes on the host), in x's dtype
    with f32 combine."""
    held = w1.shape[0]
    weights, picks = route(x, gate_weight, expert_bias, top_k, scale)
    if tracing.counting():
        local = picks.reshape(-1) - first
        mine = local[(local >= 0) & (local < held)]
        _count_load(torch.bincount(mine, minlength=held).to(torch.float32), picks.numel())
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dt = x.dtype
    for e in range(held):
        hit = picks == first + e
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = F.silu(F.linear(xe, w1[e].to(dt))) * F.linear(xe, w3[e].to(dt))
        ye = F.linear(h, w2[e].to(dt))
        we = (weights * hit)[rows].sum(-1)
        out = out.index_add(0, rows, ye.to(torch.float32) * we[:, None])
    return out.to(dt)


held_experts.launches = 0
