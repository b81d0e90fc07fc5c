"""LFM2's kernels on the card at the benchmark cell's shapes
(``lfm2_8b_a1b_l6_e8.loop128``: minibatches of 512 boards of 81 cells, width
2048), each beside its bound, its plain version and, where one PyTorch call
computes the same, that call:

  * RMSNorm (the LayerNorm pair's RMS mode) at width 2048 over 512 x 81 rows
    and at the heads' 64 over 512 x 81 x 40 rows (32 query and 8 key heads);
  * the short convolution pair at (512, 81, 3 x 2048);
  * the expert layer's ``moe_*`` kernels (router top 4, sort, gather,
    SwiGLU, combine) and its grouped products (the library's grouped GEMM),
    forward and backward over 41,472 tokens, 8 of 32 experts held;
  * K8 and K9, the packed attention pair, at (512, 81, 32 heads, 64).

    python -m rl_selfplay_mnk_tpu_torch.utils.lfm2_study [--out FILE]

prints one JSON line of the rows (``chip_smoke.py`` puts them in its
``kernels`` line). Each kernel's outputs on the timed inputs are first held
to its plain version's (``check``: the bf16 limit of the card tests, each
row's ``error`` its worst share of it); the rows are returned only when
every one is within, else ``rows`` raises naming those that are not. Device times from ``torch.profiler`` (the kernels by
name), call times from CUDA events; bounds from the bytes and operations the
inputs need at the card's published peaks (``chip_smoke.py``'s)."""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from ..ops import attention as attn
from ..ops import layer_norm as ln
from ..ops import moe
from ..ops.short_conv import short_conv_bwd, short_conv_fwd, short_conv_reference
from .env_step_study import event_ms, profiled_ms

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
BOARDS, CELLS, D, FE, HEADS, KV, DH, EXPERTS, HELD, TOP_K = 512, 81, 2048, 1792, 32, 8, 64, 32, 8, 4
EPS = 1e-5


def bound(nbytes: float, ops: float, dtype: str = "bfloat16"):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


BF16_LIMIT = 2.0 ** -7  # of the plain output's largest magnitude
# gradients through three bf16 roundings, summed in another order
# (tests/test_torch_lfm2.py bf16_close)
BF16_GRAD_LIMIT = 2.0 ** -6
ATTN_RTOL, ATTN_ATOL_OF_MAX = 2.0 ** -7, 2.0 ** -10  # chip_smoke.py's, elementwise


def check(name, got, want, limit=BF16_LIMIT, elementwise=False) -> float:
    """The worst error of ``got`` against the plain ``want`` as a share of
    its limit: ``limit`` x max|want|, or (``elementwise``) the attention
    kernels' 2^-7 |want| + 2^-10 max|want| per element; inf where ``got``
    is not finite."""
    g, w = got.detach().float(), want.detach().float()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    err = (g - w).abs()
    top = float(w.abs().max())
    if elementwise:
        return float((err / (ATTN_RTOL * w.abs() + ATTN_ATOL_OF_MAX * top)).max())
    return float(err.max()) / (limit * top)


def _grad_fn(fn, leaves, dy):
    """A function that runs fn's backward alone (the graph kept)."""
    out = fn()
    return lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)


def _row(name, shape, ms, call_ms, plain_ms, library_ms, nbytes, ops, dtype="bfloat16",
         **more):
    b_ms, b_by = bound(nbytes, ops, dtype)
    return {"name": name, "shape": list(shape), "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by, **more}


def time_rms_norm(dev, rows: int, width: int) -> dict:
    g = torch.Generator(device=dev).manual_seed(width)
    x = torch.randn(rows, width, device=dev, generator=g).bfloat16().requires_grad_()
    w = (torch.rand(width, device=dev, generator=g) + 0.5).requires_grad_()
    dy = torch.randn(rows, width, device=dev, generator=g).bfloat16()
    y, rstd = ln.rms_norm_fwd(x, w, EPS, stats=True)
    fwd = lambda: ln.rms_norm_fwd(x, w, EPS, stats=True)  # noqa: E731
    bwd = lambda: ln.rms_norm_bwd(x, dy, w, rstd)  # noqa: E731
    want = ln.rms_norm_reference(x, w, EPS)
    error = max([check("y", y, want)] + [check(n, a, e) for n, a, e in zip(
        ("dx", "dw"), bwd(), torch.autograd.grad(want, (x, w), dy))])
    wb = w.detach().bfloat16().requires_grad_()
    with torch.no_grad():
        plain = profiled_ms(lambda: ln.rms_norm_reference(x, w, EPS), 20)
        lib = profiled_ms(lambda: F.rms_norm(x, (width,), wb, EPS), 20)
    elems = rows * width
    return _row(
        f"rms_norm_{width}", (rows, width), profiled_ms(fwd, 20, "ln_rows_rms"), event_ms(fwd, 20),
        plain, lib, 2 * elems * 2 + rows * 4 + width * 4, 4 * elems, "float32",
        backward=_row(
            f"rms_norm_{width}.backward", (rows, width), profiled_ms(bwd, 20, "ln_rows_rms"),
            event_ms(bwd, 20),
            profiled_ms(_grad_fn(lambda: ln.rms_norm_reference(x, w, EPS), (x, w), dy), 10),
            profiled_ms(_grad_fn(lambda: F.rms_norm(x, (width,), wb, EPS), (x, wb), dy), 10),
            3 * elems * 2 + rows * 4 + 2 * width * 4, 6 * elems, "float32"),
        library="F.rms_norm on bf16 (backward: autograd's)", error=error)


def time_short_conv(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(5)
    bcx = torch.randn(BOARDS, CELLS, 3 * D, device=dev, generator=g).bfloat16().requires_grad_()
    w = torch.randn(D, 3, device=dev, generator=g).requires_grad_()
    dy = torch.randn(BOARDS, CELLS, D, device=dev, generator=g).bfloat16()
    fwd = lambda: short_conv_fwd(bcx, w)  # noqa: E731
    bwd = lambda: short_conv_bwd(bcx, w, dy)  # noqa: E731
    want = short_conv_reference(bcx, w)
    error = max([check("y", fwd(), want)] + [check(n, a, e) for n, a, e in zip(
        ("dbcx", "dw"), bwd(), torch.autograd.grad(want, (bcx, w), dy))])
    with torch.no_grad():
        plain = profiled_ms(lambda: short_conv_reference(bcx, w), 10)
    rows = BOARDS * CELLS
    return _row(
        "short_conv", (BOARDS, CELLS, 3 * D), profiled_ms(fwd, 20, "short_conv_"),
        event_ms(fwd, 20), plain, None, 4 * rows * D * 2 + D * 12, 8 * rows * D, "float32",
        backward=_row(
            "short_conv.backward", (BOARDS, CELLS, 3 * D), profiled_ms(bwd, 20, "short_conv_"),
            event_ms(bwd, 20),
            profiled_ms(_grad_fn(lambda: short_conv_reference(bcx, w), (bcx, w), dy), 5), None,
            7 * rows * D * 2 + 2 * D * 12, 16 * rows * D, "float32"),
        library=None, error=error)


def _split(fn, iters=5) -> dict:
    """Device ms a call of fn's ``moe_*`` kernels, its grouped products and
    all of its kernels."""
    return {key: profiled_ms(fn, iters, match) for key, match in
            (("moe", "moe_"), ("grouped", "GroupProblemShape"), ("all", ""))}


def time_experts(dev) -> list:
    n = BOARDS * CELLS
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(n, D, device=dev, generator=g).bfloat16().requires_grad_()
    gate = (torch.randn(EXPERTS, D, device=dev, generator=g) / D ** 0.5).requires_grad_()
    bias = torch.zeros(EXPERTS, device=dev)
    ws = [(torch.randn(HELD, a, b, device=dev, generator=g) / b ** 0.5).requires_grad_()
          for a, b in ((FE, D), (FE, D), (D, FE))]
    dy = torch.randn(n, D, device=dev, generator=g).bfloat16()
    leaves = (x, gate, *ws)

    def card():
        return moe.held_experts(x, gate, bias, *ws, 0, TOP_K, 1.0)

    def plain():
        return moe.held_experts_reference(x, gate, bias, *ws, 0, TOP_K, 1.0)

    y, want = card(), plain()
    error = max([check("y", y, want)] + [check(n, a, e, BF16_GRAD_LIMIT) for n, a, e in zip(
        ("dx", "dgate", "dw1", "dw3", "dw2"), torch.autograd.grad(y, leaves, dy),
        torch.autograd.grad(want, leaves, dy))])
    with torch.no_grad():
        picks = moe.route(x, gate, bias, TOP_K, 1.0)[1]
        held = int((picks < HELD).sum())
        fwd = _split(card)
    bwd = _split(_grad_fn(card, leaves, dy))
    call = event_ms(lambda: torch.autograd.grad(card(), leaves, dy), 5)
    loop = profiled_ms(lambda: torch.autograd.grad(plain(), leaves, dy), 3)
    # moe_*: route (logits in, picks out), sort, gather, SwiGLU, combine;
    # bytes of the held pairs' rows and the tokens' rows, as kernel_work
    fwd_bytes = held * (3 * D + 3 * FE) * 2 + n * D * 2 + n * (EXPERTS * 4 + TOP_K * 32)
    bwd_bytes = held * (4 * D + 8 * FE) * 2 + n * D * 2 + n * (EXPERTS * 4 + TOP_K * 8)
    # plain: the whole layer's loop (expert_gemm's plain_ms too)
    dispatch = _row(
        "moe_dispatch", (n, D), fwd["moe"] + bwd["moe"], call, loop, None,
        fwd_bytes + bwd_bytes, 0.0, held_rows=held, forward_ms=fwd["moe"],
        backward_ms=bwd["moe"], library=None, error=error)
    ops = 3 * (3 * 2 * held * D * FE)  # forward 3 products, backward 6
    weights = HELD * 3 * D * FE * 2 * 4  # read forward, read and written backward, read twice
    products = _row(
        "expert_gemm", (held, D, FE), fwd["grouped"] + bwd["grouped"], call, loop,
        fwd["grouped"] + bwd["grouped"], weights + held * (2 * D + 3 * FE) * 2 * 3, ops,
        held_rows=held, forward_ms=fwd["grouped"], backward_ms=bwd["grouped"],
        library="torch._grouped_mm (the port's own call); plain: a loop of F.linear an expert",
        error=error)
    return [dispatch, products]


def time_packed_attention(dev) -> list:
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, do = (torch.randn(BOARDS, CELLS, HEADS * DH, device=dev, generator=g).bfloat16()
                   for _ in range(4))
    fwd = lambda: attn.attention_packed_fwd(q, k, v, HEADS, DH)  # noqa: E731
    bwd = lambda: attn.attention_packed_bwd(q, k, v, do, HEADS, DH)  # noqa: E731

    def heads(t):
        return t.view(BOARDS, CELLS, HEADS, DH).transpose(1, 2).requires_grad_()

    want_o = attn.attention_packed_reference(q, k, v, HEADS, DH)
    want_g = attn.attention_packed_bwd_reference(q, k, v, do, HEADS, DH)
    error_fwd = check("o", fwd(), want_o, elementwise=True)
    error_bwd = max(check(n, a, e, elementwise=True) for n, a, e in zip(
        ("dq", "dk", "dv"), bwd(), want_g))
    qh, kh, vh = heads(q), heads(k), heads(v)
    doh = do.view(BOARDS, CELLS, HEADS, DH).transpose(1, 2)
    with torch.no_grad():
        plain = profiled_ms(lambda: attn.attention_packed_reference(q, k, v, HEADS, DH), 5)
        lib = profiled_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), 20)
    plain_bwd = profiled_ms(lambda: attn.attention_packed_bwd_reference(q, k, v, do, HEADS, DH),
                            5)
    lib_bwd = profiled_ms(_grad_fn(lambda: F.scaled_dot_product_attention(qh, kh, vh),
                                   (qh, kh, vh), doh), 20)
    elems = BOARDS * CELLS * HEADS * DH
    flops = BOARDS * HEADS * CELLS * CELLS * DH
    shape = (BOARDS, CELLS, HEADS, DH)
    return [
        _row("K8", shape, profiled_ms(fwd, 20, "attn_packed_fwd"), event_ms(fwd, 20), plain, lib,
             4 * elems * 2, 4 * flops, library="F.scaled_dot_product_attention on bf16",
             error=error_fwd),
        _row("K9", shape, profiled_ms(bwd, 20, "attn_packed_bwd"), event_ms(bwd, 20), plain_bwd,
             lib_bwd, 7 * elems * 2, 10 * flops,
             library="F.scaled_dot_product_attention's backward on bf16", error=error_bwd),
    ]


def rows(dev) -> list:
    """Every row, each kernel's outputs held to its plain version's on the
    timed inputs first (``error``: the worst share of the limit, forward
    and backward); raises naming the rows past 1."""
    out = [time_rms_norm(dev, BOARDS * CELLS, D), time_rms_norm(dev, BOARDS * CELLS * 40, DH),
           time_short_conv(dev)]
    out += time_experts(dev)
    out += time_packed_attention(dev)
    bad = {r["name"]: r["error"] for r in out if not r["error"] <= 1.0}
    if bad:
        raise AssertionError(f"lfm2_study: past the bf16 limit (share of it): {bad}")
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None, help="also write the JSON line here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lfm2_study: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    line = json.dumps({"lfm2_kernels": rows(torch.device("cuda")),
                       "card": torch.cuda.get_device_name(0)})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
