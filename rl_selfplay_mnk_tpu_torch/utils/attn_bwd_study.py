"""Where the tensor-core attention backwards (K9, K4 and K7 in bf16) stand on the card.

Usage (from the repository root, one card)::

    python -m rl_selfplay_mnk_tpu_torch.utils.attn_bwd_study --numerics
    python -m rl_selfplay_mnk_tpu_torch.utils.attn_bwd_study --numerics --seeds 0 1 2 --kernels packed_bwd
    python -m rl_selfplay_mnk_tpu_torch.utils.attn_bwd_study --phases
    python -m rl_selfplay_mnk_tpu_torch.utils.attn_bwd_study --phases --kernels folded_bwd infold_bwd

``--numerics``: at the shapes chip_smoke.py checks first (K9 at its packed
shapes, K4 at its folded ones, K7 at its board ones), with its inputs (the
same seeds), the tensor-core kernel, its first version (the FMA kernel) and
the plain version against each other and against the plain version's
arithmetic in f64 with the same bf16 rounding points (p before dv, ds
before dq and dk, the outputs). Each line gives, for dq, dk and dv, the
worst error as a share of chip_smoke.py's bf16 limit, the elements past half
of it, and the share of differing elements over the share allowed; then the
tensor-core kernel's worst element against the plain version, with the
plain and the f64 value there. ``--seeds`` draws the inputs from each seed
given (0, chip_smoke.py's, by default; a seed moves the generator's seed as
``inputs`` says) and ends with one line a shape: the tensor-core kernel's
worst share of the limit over those seeds for dq, dk and dv, against the
plain version and against the f64 computation.

``--phases``: each kernel's time at its update minibatch and at 384 boards
(K9 at (B, 169, 2, 64), at (384, 81, 3, 32) and at the two minibatches with
heads below 16 channels, K4 and K7 at (B, 81, 4, 14)), whole and with its
first pass, its second pass or both compiled out (patched copies of
``csrc/`` built under ``_build/study/``): staging and storing alone, and
what each pass adds. For K7 also with its on-chip transpose compiled out,
besides both passes: what the transpose adds. ``--kernels`` picks among
``packed_bwd`` (K9), ``folded_bwd`` (K4) and ``infold_bwd`` (K7); all three
by default.
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
# The two pass loops of each tensor-core backward, and K7's transpose.
PASS_LOOP = "for (int item = warp; item < nh * kKT; item += kMmaWarps) {"
K7_TRANSPOSE = ("for (int t = 0; t < 4; ++t) transpose_slab<kTokens>(rows + t * rslab, ld, "
                "cols + t * tslab, width);")
# kernel -> (its source, the file that holds its pass loops, ints after the
# seven pointers of its launch entry, the (B, L, H, Dh) it is timed at). K4
# and K7 share their passes (attn_mma.cuh, fold_bwd_passes): a patched copy
# of csrc/ builds one source, so it changes one kernel.
PHASE_KERNELS = {
    "packed_bwd": ("attention_bwd", "attention_bwd.cu", 5,
                   SHAPES[:2] + ((384, 81, 3, 32), (8192, 81, 4, 14), (2048, 169, 8, 12))),
    "folded_bwd": ("attention_folded_bwd", "attn_mma.cuh", 4,
                   ((8192, 81, 4, 14), (384, 81, 4, 14))),
    "infold_bwd": ("attention_board", "attn_mma.cuh", 5, ((8192, 81, 4, 14), (384, 81, 4, 14))),
}


# kernel -> the (B, L, H, Dh) --numerics checks: chip_smoke.py's largest
# and first shapes of the kernel's group; for K9 also the two update
# minibatches with heads below 16 channels (9x9 with four heads of 14, 13x13
# with eight of 12), where K9 sums S, S^T and dP^T a depth pair at a time.
NUMERICS_SHAPES = {
    "packed_bwd": SHAPES + ((8192, 81, 4, 14), (2048, 169, 8, 12)),
    "folded_bwd": ((8192, 81, 4, 14), (383, 81, 4, 14), (64, 169, 8, 12)),
    "infold_bwd": ((8192, 81, 4, 14), (2048, 169, 8, 12), (384, 169, 8, 12)),
}


def inputs(b, l, h, dh, dev, seed=0, folded=False):
    """chip_smoke.py's attn_inputs: q, k, v, dO in bf16, packed (B, L, H*Dh)
    or folded (B*H, Dh, L)."""
    g = torch.Generator(device=dev).manual_seed(seed + 7 * b + l)
    shape = (b * h, dh, l) if folded else (b, l, h * dh)
    return [torch.randn(shape, device=dev, generator=g).to(torch.bfloat16) for _ in range(4)]


def f64_reference(q, k, v, do, h, dh, folded=False):
    """The plain version's arithmetic in f64, rounded to bf16 where it rounds."""
    if folded:
        qf, kf, vf, gf = (t.transpose(1, 2).double() for t in (q, k, v, do))
    else:
        qf, kf, vf, gf = (attn._packed_to_heads(t, h, dh).double() for t in (q, k, v, do))
    scale = 1.0 / dh**0.5
    p = torch.softmax(torch.matmul(qf, kf.transpose(1, 2)) * scale, -1)
    dp = torch.matmul(gf, vf.transpose(1, 2))
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(torch.bfloat16).double()
    grads = (torch.matmul(ds, kf), torch.matmul(ds.transpose(1, 2), qf),
             torch.matmul(p.to(torch.bfloat16).double().transpose(1, 2), gf))
    if folded:
        return tuple(t.to(torch.bfloat16).transpose(1, 2).contiguous() for t in grads)
    return tuple(attn._heads_to_packed(t.to(torch.bfloat16), q.shape[0], h) for t in grads)


def shares(got, want) -> tuple:
    """(the worst error as a share of the limit, elements past half of it,
    differing elements as a share of those allowed)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ratio = err / (RTOL * w.abs() + ATOL_OF_MAX * float(w.abs().max()))
    differ = float((err > 0).sum()) / (DIFFER_SHARE * err.numel() + 4)
    return float(ratio.max()), int((ratio > 0.5).sum()), differ


def against(got, want) -> str:
    worst, past_half, differ = shares(got, want)
    return f"{worst:.2f} (past half: {past_half}, differ {differ:.2f})"


def worst_element(got, want, f64) -> str:
    """got's element farthest from want as a share of the limit, with want's
    and the f64 computation's value there."""
    g, w = got.float(), want.float()
    ratio = (g - w).abs() / (RTOL * w.abs() + ATOL_OF_MAX * float(w.abs().max()))
    at = int(ratio.flatten().argmax())
    return (f"{float(ratio.flatten()[at]):.2f} at {at}: got {float(g.flatten()[at]):.6f}, "
            f"plain {float(w.flatten()[at]):.6f}, f64 {float(f64.float().flatten()[at]):.6f}")


def numerics(dev, kernels, seeds=(0,)) -> dict:
    """Prints the comparisons above at every shape and seed; returns
    {(kernel, shape): {"plain" | "f64": {"dq" | "dk" | "dv": worst share}}},
    the tensor-core kernel's worst over the seeds (its worst error or its
    share of differing elements, whichever is larger)."""
    worst = {}
    for kernel in kernels:
        wrapper = getattr(attn, f"attention_{kernel}")
        reference = getattr(attn, f"attention_{kernel}_reference")
        folded = kernel == "folded_bwd"
        for b, l, h, dh in NUMERICS_SHAPES[kernel]:
            shape = (b, l, h, dh)
            mine = worst.setdefault((kernel, shape), {"plain": {}, "f64": {}})
            for seed in seeds:
                q, k, v, do = inputs(b, l, h, dh, dev, seed=seed, folded=folded)
                extra = () if folded else (h, dh)
                out = {"tensor cores": wrapper(q, k, v, do, *extra),
                       "first version": wrapper(q, k, v, do, *extra, kernel="fma"),
                       "plain": reference(q, k, v, do, *extra),
                       "f64": f64_reference(q, k, v, do, h, dh, folded)}
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                tag = f"{kernel} {shape} seed {seed}"
                for got, want in (("tensor cores", "plain"), ("first version", "plain"),
                                  ("tensor cores", "f64"), ("first version", "f64"),
                                  ("plain", "f64")):
                    print(f"{tag} {got} vs {want}: " + "; ".join(
                        f"{name} {against(g, w)}" for name, g, w in zip(("dq", "dk", "dv"), out[got],
                                                                       out[want])), flush=True)
                for want in ("plain", "f64"):
                    for name, g, w in zip(("dq", "dk", "dv"), out["tensor cores"], out[want]):
                        ratio, _, differ = shares(g, w)
                        mine[want][name] = max(mine[want].get(name, 0.0), ratio, differ)
                for name, g, w, e in zip(("dq", "dk", "dv"), out["tensor cores"], out["plain"],
                                         out["f64"]):
                    print(f"{tag} tensor cores' worst {name}: {worst_element(g, w, e)}", flush=True)
                del out
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            print(f"{kernel} {shape} seeds {' '.join(map(str, seeds))}: tensor cores' worst share "
                  "of the limit " + "; ".join(
                      f"vs {want} " + ", ".join(f"{name} {mine[want][name]:.2f}"
                                                for name in ("dq", "dk", "dv"))
                      for want in ("plain", "f64")), flush=True)
    return worst


def start_patched_build(kernel: str, name: str, skip: tuple):
    """nvcc on the kernel's source with the passes in ``skip`` (1, 2) and,
    for K7, the transpose ("transpose") compiled out; returns (the running
    nvcc, the library it writes)."""
    source, loops_in = PHASE_KERNELS[kernel][:2]
    out = cuda_build.BUILD_DIR / "study" / kernel / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC_DIR, out / "csrc")
    src = out / "csrc" / f"{source}.cu"
    if "transpose" in skip:
        text = src.read_text()
        if text.count(K7_TRANSPOSE) != 1:
            raise RuntimeError(f"expected one K7 transpose in {src}, found {text.count(K7_TRANSPOSE)}")
        src.write_text(text.replace(K7_TRANSPOSE, ""))
    patched = out / "csrc" / loops_in
    loops = patched.read_text().split(PASS_LOOP)
    if len(loops) != 3:
        raise RuntimeError(f"expected two pass loops in {patched}, found {len(loops) - 1}")
    heads = [PASS_LOOP.replace("item = warp;", "item = warp + (1 << 20);") if p in skip
             else PASS_LOOP for p in (1, 2)]
    patched.write_text(loops[0] + heads[0] + loops[1] + heads[1] + loops[2])
    so = out / f"lib{source}.so"
    return subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(src)]), so


def load_patched(kernel: str, job):
    """The patched library's launch entry of ``kernel``."""
    proc, so = job
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed for {so}")
    lib = ctypes.CDLL(str(so))
    attn._bind_bwd_mma(lib, kernel, PHASE_KERNELS[kernel][2])
    return getattr(lib, f"attn_{kernel}_mma_launch")


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


def phase_args(kernel: str, b: int, l: int, h: int, dh: int, dev) -> tuple:
    """(q, k, v, dO in the kernel's layout, the ints of its launch entry)."""
    if kernel == "folded_bwd":
        return (inputs(b, l, h, dh, dev, seed=5, folded=True),
                (b * h, dh, l, attn._mma_heads(kernel, l, dh, dev)))
    per_block = (attn._mma_heads(kernel, l, dh, dev) if kernel == "packed_bwd"
                 else attn.board_mma_plan(kernel, b, l, h, dh, dev).per_block)
    return inputs(b, l, h, dh, dev, seed=5), (b, l, h, dh, per_block)


def phases(dev, kernels) -> None:
    variants = {"whole": (), "second pass only": (1,), "first pass only": (2,),
                "staging and storing only": (1, 2)}
    jobs = {}
    for kernel in kernels:
        mine = dict(variants)
        if kernel == "infold_bwd":
            mine["staging, transpose and storing only"] = mine.pop("staging and storing only")
            mine["staging and storing only"] = (1, 2, "transpose")
        for name, skip in mine.items():
            jobs[kernel, name] = start_patched_build(kernel, name.replace(" ", "_").replace(",", ""),
                                                     skip)
    entries = {key: load_patched(key[0], job) for key, job in jobs.items()}
    stream = torch.cuda.current_stream(dev).cuda_stream
    for kernel in kernels:
        for b, l, h, dh in PHASE_KERNELS[kernel][3]:
            tensors, ints = phase_args(kernel, b, l, h, dh, dev)
            outs = [torch.empty_like(tensors[0]) for _ in range(3)]
            for (of, name), entry in entries.items():
                if of != kernel:
                    continue

                def launch(entry=entry):
                    code = entry(1, *(t.data_ptr() for t in (*tensors, *outs)), *ints, stream)
                    cuda_build.check_launch(entry.__name__, code)
                print(f"{kernel} {(b, l, h, dh)} {name}: {event_ms(launch):.4f} ms", flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--numerics", action="store_true")
    parser.add_argument("--phases", action="store_true")
    parser.add_argument("--kernels", nargs="+", choices=tuple(PHASE_KERNELS),
                        default=list(PHASE_KERNELS),
                        help="the kernels --numerics checks and --phases times")
    parser.add_argument("--seeds", nargs="+", type=int, default=[0],
                        help="the input seeds --numerics draws (0 is chip_smoke.py's)")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_bwd_study: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(torch.cuda.get_device_name(0), flush=True)
    if args.numerics:
        numerics(dev, args.kernels, args.seeds)
    if args.phases:
        phases(dev, args.kernels)


if __name__ == "__main__":
    main()
