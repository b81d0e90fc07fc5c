"""Where the tensor-core packed attention backward (K9 in bf16) stands on the card.

Usage (from the repository root, one card)::

    python -m rl_selfplay_mnk_tpu_torch.utils.attn_bwd_study --numerics
    python -m rl_selfplay_mnk_tpu_torch.utils.attn_bwd_study --phases

``--numerics``: at the packed shapes chip_smoke.py checks first, with its
inputs (the same seeds), the tensor-core kernel, its first version (the FMA
kernel) and the plain version against each other and against the plain
version's arithmetic in f64 with the same bf16 rounding points (p before dv,
ds before dq and dk, the outputs). Each line gives, for dq, dk and dv, the
worst error as a share of chip_smoke.py's bf16 limit, the elements past half
of it, and the share of differing elements over the share allowed.

``--phases``: the kernel's time at the update minibatch and at 384 boards,
whole and with its first pass, its second pass or both compiled out (a
patched copy of ``csrc/`` built under ``_build/study/``): staging and
storing alone, and what each pass adds.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess

import torch

from ..ops import attention as attn
from ..ops import cuda_build

# chip_smoke.py's bf16 limit: |got - want| <= RTOL |want| + ATOL_OF_MAX max|want|,
# at most DIFFER_SHARE of the elements (plus 4) differing.
RTOL, ATOL_OF_MAX, DIFFER_SHARE = 2.0**-7, 2.0**-10, 2.0**-9
SHAPES = ((4096, 169, 2, 64), (384, 169, 2, 64), (256, 169, 2, 64), (384, 81, 3, 32))
PASS_LOOP = "for (int item = warp; item < nh * kKT; item += kMmaWarps) {"


def inputs(b, l, h, dh, dev, seed=0):
    """chip_smoke.py's attn_inputs for a packed shape: q, k, v, dO in bf16."""
    g = torch.Generator(device=dev).manual_seed(seed + 7 * b + l)
    return [torch.randn((b, l, h * dh), device=dev, generator=g).to(torch.bfloat16)
            for _ in range(4)]


def f64_reference(q, k, v, do, h, dh):
    """The plain version's arithmetic in f64, rounded to bf16 where it rounds."""
    qf, kf, vf, gf = (attn._packed_to_heads(t, h, dh).double() for t in (q, k, v, do))
    scale = 1.0 / dh**0.5
    p = torch.softmax(torch.matmul(qf, kf.transpose(1, 2)) * scale, -1)
    dp = torch.matmul(gf, vf.transpose(1, 2))
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(torch.bfloat16).double()
    grads = (torch.matmul(ds, kf), torch.matmul(ds.transpose(1, 2), qf),
             torch.matmul(p.to(torch.bfloat16).double().transpose(1, 2), gf))
    return tuple(attn._heads_to_packed(t.to(torch.bfloat16), q.shape[0], h) for t in grads)


def against(got, want) -> str:
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ratio = err / (RTOL * w.abs() + ATOL_OF_MAX * float(w.abs().max()))
    differ = float((err > 0).sum()) / (DIFFER_SHARE * err.numel() + 4)
    return f"{float(ratio.max()):.2f} (past half: {int((ratio > 0.5).sum())}, differ {differ:.2f})"


def numerics(dev) -> None:
    for b, l, h, dh in SHAPES:
        q, k, v, do = inputs(b, l, h, dh, dev)
        out = {"tensor cores": attn.attention_packed_bwd(q, k, v, do, h, dh),
               "first version": attn.attention_packed_bwd(q, k, v, do, h, dh, kernel="fma"),
               "plain": attn.attention_packed_bwd_reference(q, k, v, do, h, dh),
               "f64": f64_reference(q, k, v, do, h, dh)}
        torch.cuda.synchronize()
        for got, want in (("tensor cores", "plain"), ("first version", "plain"),
                          ("tensor cores", "f64"), ("first version", "f64"), ("plain", "f64")):
            print(f"{(b, l, h, dh)} {got} vs {want}: " + "; ".join(
                f"{name} {against(g, w)}" for name, g, w in zip(("dq", "dk", "dv"), out[got],
                                                               out[want])), flush=True)
        del out
        torch.cuda.empty_cache()


def start_patched_build(name: str, skip: tuple):
    """nvcc on csrc/attention_bwd.cu with the passes in ``skip`` (1, 2)
    compiled out; returns (the running nvcc, the library it writes)."""
    out = cuda_build.BUILD_DIR / "study" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC_DIR, out / "csrc")
    src = out / "csrc" / "attention_bwd.cu"
    loops = src.read_text().split(PASS_LOOP)
    if len(loops) != 3:
        raise RuntimeError(f"expected two pass loops in {src}, found {len(loops) - 1}")
    heads = [PASS_LOOP.replace("item = warp;", "item = warp + (1 << 20);") if p in skip
             else PASS_LOOP for p in (1, 2)]
    src.write_text(loops[0] + heads[0] + loops[1] + heads[1] + loops[2])
    so = out / "libattention_bwd.so"
    return subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(src)]), so


def load_patched(job) -> ctypes.CDLL:
    proc, so = job
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed for {so}")
    lib = ctypes.CDLL(str(so))
    lib.attn_packed_bwd_mma_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.attn_packed_bwd_mma_launch.restype = ctypes.c_int
    return lib


def event_ms(fn, iters=50) -> float:
    for _ in range(5):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phases(dev) -> None:
    variants = {"whole": (), "second pass only": (1,), "first pass only": (2,),
                "staging and storing only": (1, 2)}
    jobs = {name: start_patched_build(name.replace(" ", "_"), skip)
            for name, skip in variants.items()}
    libs = {name: load_patched(job) for name, job in jobs.items()}
    for b, l, h, dh in SHAPES[:2]:
        q, k, v, do = inputs(b, l, h, dh, dev, seed=5)
        outs = [torch.empty_like(q) for _ in range(3)]
        heads = attn._mma_heads("packed_bwd", l, dh, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for name, lib in libs.items():
            def launch(lib=lib):
                code = lib.attn_packed_bwd_mma_launch(
                    1, *(t.data_ptr() for t in (q, k, v, do, *outs)), b, l, h, dh, heads, stream)
                cuda_build.check_launch(name, code)
            print(f"{(b, l, h, dh)} {name}: {event_ms(launch):.4f} ms", flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--numerics", action="store_true")
    parser.add_argument("--phases", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_bwd_study: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(torch.cuda.get_device_name(0), flush=True)
    if args.numerics:
        numerics(dev)
    if args.phases:
        phases(dev)


if __name__ == "__main__":
    main()
