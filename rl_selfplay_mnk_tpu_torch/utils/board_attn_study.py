"""Where the tensor-core board forwards (K5 and K6 in bf16) stand on the card.

Usage (from the repository root, one card)::

    python -m rl_selfplay_mnk_tpu_torch.utils.board_attn_study --staging
    python -m rl_selfplay_mnk_tpu_torch.utils.board_attn_study --phases

``--staging``: K5's two ways to give the tensor cores a head whose rows are
not 16-byte words (Dh = 14 and 12), at the board shapes chip_smoke.py times.
(a) the kernel as built: whole board rows staged in 16-byte words, the
fragments from 32-bit and 16-bit shared loads at a head's columns, at its
block plan and forced to a board a block; (b) per-head slabs padded to 16
channels, staged in the widest word a head row allows (4 bytes at Dh = 14),
with ldmatrix fragments: that is K8's tensor-core kernel, launched here with
a block of min(H, 4) heads, so a board a block where H <= 4. Each line gives
the time between CUDA events and the worst error against the plain version
as a share of chip_smoke.py's bf16 limit.

``--numerics``: at the card tests' board shapes and inputs
(tests/test_torch_cuda.py, ``test_board_forwards_tensor_cores_within_tolerance``),
K5 and K6 on the tensor cores, their first versions, K8 and the plain
version against an f64 computation with the same bf16 rounding points (p
before P V, the output), and each against the plain version: the worst error
as a share of the bf16 limit.

``--blocks``: K5's time at every count of query tiles a block and K6's at
every count of heads a block that fits, at the batches the paths give them:
what the block-unit rule of ``attention.board_mma_plan`` is set from.

``--phases``: K5's and K6's times at the update minibatch and at 384 boards,
whole and with their products compiled out, and K6 also with its on-chip
transpose compiled out (patched copies of ``csrc/`` built under
``_build/study/``): staging and storing alone, what the transpose adds, and
what the products add.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess

import torch

from ..ops import attention as attn
from ..ops import cuda_build

# chip_smoke.py's bf16 limit: |got - want| <= RTOL |want| + ATOL_OF_MAX max|want|.
RTOL, ATOL_OF_MAX = 2.0**-7, 2.0**-10
SHAPES = ((8192, 81, 4, 14), (384, 81, 4, 14), (16, 81, 4, 14), (384, 169, 4, 14),
          (384, 169, 8, 12))
K5_ITEMS = "for (int item = warp; item < H * nt; item += kMmaWarps) {"
K6_ITEMS = "for (int item = warp; item < nh * q_tiles; item += kMmaWarps) {"
K6_TRANSPOSE = ("for (int t = 0; t < 3; ++t) transpose_slab<kTokens>(rows + t * rslab, ld, "
                "cols + t * tslab, width);")


def inputs(b, l, h, dh, dev, seed=5):
    """q, k, v in bf16, as chip_smoke.py's timings make them."""
    g = torch.Generator(device=dev).manual_seed(seed + 7 * b + l)
    return [torch.randn((b, l, h * dh), device=dev, generator=g).to(torch.bfloat16)
            for _ in range(3)]


def share_of_limit(got, want) -> float:
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (RTOL * w.abs() + ATOL_OF_MAX * float(w.abs().max()))).max())


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


def launcher(entry, tensors, out, args, dev):
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        code = entry(1, *(t.data_ptr() for t in (*tensors, out)), *args, stream)
        cuda_build.check_launch(entry.__name__, code)
    return launch


def staging(dev) -> None:
    board, heads = attn._board_lib(), attn._lib()
    for b, l, h, dh in SHAPES:
        q, k, v = inputs(b, l, h, dh, dev)
        want = attn.attention_lane_slice_reference(q, k, v, h, dh)
        per_block = attn.board_mma_plan("lane_slice_fwd", b, l, h, dh, dev).per_block
        ways = {
            f"(a) at its plan ({per_block} query tiles a block)":
                (board.attn_lane_slice_fwd_mma_launch, (b, l, h, dh, per_block)),
            "(a) a board a block": (board.attn_lane_slice_fwd_mma_launch, (b, l, h, dh, -(-l // 16))),
            f"(b) K8's slabs, {min(h, 4)} heads a block":
                (heads.attn_packed_fwd_mma_launch, (b, l, h, dh, min(h, 4))),
        }
        for name, (entry, args) in ways.items():
            out = torch.empty_like(q)
            launch = launcher(entry, (q, k, v), out, args, dev)
            ms = event_ms(launch)
            print(f"{(b, l, h, dh)} {name}: {ms:.4f} ms, worst error "
                  f"{share_of_limit(out, want):.2f} of the bf16 limit", flush=True)


CARD_TEST_BOARDS = (5, 16, 150)
CARD_TEST_SHAPES = [(l, h, dh) for l in (9, 81, 169, 192) for h, dh in ((4, 14), (8, 12), (2, 64))]


def f64_reference(q, k, v, h, dh):
    """The plain version's arithmetic in f64, p and the output rounded to bf16."""
    qf, kf, vf = (attn._packed_to_heads(t, h, dh).double() for t in (q, k, v))
    p = torch.softmax(torch.matmul(qf, kf.transpose(1, 2)) / dh**0.5, -1)
    o = torch.matmul(p.to(torch.bfloat16).double(), vf)
    return attn._heads_to_packed(o.to(torch.bfloat16), q.shape[0], h)


def numerics(dev) -> None:
    for b in CARD_TEST_BOARDS:
        for l, h, dh in CARD_TEST_SHAPES:
            g = torch.Generator(device=dev).manual_seed(b * 1000 + l)  # the card tests' inputs
            q, k, v = (torch.randn((b, l, h * dh), device=dev, generator=g).to(torch.bfloat16)
                       for _ in range(3))
            out = {"K5": attn.attention_lane_slice_fwd(q, k, v, h, dh),
                   "K5 first": attn.attention_lane_slice_fwd(q, k, v, h, dh, kernel="fma"),
                   "K6": attn.attention_infold_fwd(q, k, v, h, dh),
                   "K6 first": attn.attention_infold_fwd(q, k, v, h, dh, kernel="fma"),
                   "K8": attn.attention_packed_fwd(q, k, v, h, dh),
                   "plain": attn.attention_packed_reference(q, k, v, h, dh)}
            f64 = f64_reference(q, k, v, h, dh)
            print(f"{(b, l, h, dh)} vs plain: " + ", ".join(
                f"{name} {share_of_limit(o, out['plain']):.2f}" for name, o in out.items()
                if name != "plain") + "; vs f64: " + ", ".join(
                f"{name} {share_of_limit(o, f64):.2f}" for name, o in out.items()), flush=True)


def blocks(dev) -> None:
    board = attn._board_lib()
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for b, l, h, dh in ((8192, 81, 4, 14), (384, 81, 4, 14), (256, 81, 4, 14), (16, 81, 4, 14),
                        (384, 169, 4, 14), (16, 169, 4, 14), (384, 169, 8, 12), (16, 169, 8, 12)):
        q, k, v = inputs(b, l, h, dh, dev)
        out = torch.empty_like(q)
        plans = {kernel: attn.board_mma_plan(kernel, b, l, h, dh, dev).per_block
                 for kernel in ("lane_slice_fwd", "infold_fwd")}
        tiles = -(-l // 16)
        for kernel, counts in (("lane_slice_fwd", range(1, tiles + 1)),
                               ("infold_fwd", [n for n in range(1, h + 1)
                                               if board.attn_infold_fwd_mma_smem_bytes(l, dh, n)
                                               <= limit])):
            entry = getattr(board, f"attn_{kernel}_mma_launch")
            times = [f"{n}{'*' if n == plans[kernel] else ''} "
                     f"{event_ms(launcher(entry, (q, k, v), out, (b, l, h, dh, n), dev)):.4f}"
                     for n in counts]
            print(f"{(b, l, h, dh)} {kernel} ms by {'query tiles' if kernel == 'lane_slice_fwd' else 'heads'}"
                  f" a block (* the plan's): " + ", ".join(times), flush=True)


def start_patched_build(name: str, patches: dict):
    """nvcc on csrc/attention_board.cu with each key of ``patches`` replaced
    by its value; returns (the running nvcc, the library it writes)."""
    out = cuda_build.BUILD_DIR / "study" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC_DIR, out / "csrc")
    src = out / "csrc" / "attention_board.cu"
    text = src.read_text()
    for old, new in patches.items():
        if text.count(old) != 1:
            raise RuntimeError(f"expected one {old!r} in {src}, found {text.count(old)}")
        text = text.replace(old, new)
    src.write_text(text)
    so = out / "libattention_board.so"
    return subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(src)]), so


def load_patched(job) -> ctypes.CDLL:
    proc, so = job
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed for {so}")
    lib = ctypes.CDLL(str(so))
    for kernel in ("lane_slice_fwd", "infold_fwd"):
        entry = getattr(lib, f"attn_{kernel}_mma_launch")
        entry.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        entry.restype = ctypes.c_int
    return lib


def skipped(loop: str) -> str:
    return loop.replace("item = warp;", "item = warp + (1 << 20);")


def phases(dev) -> None:
    variants = {
        "whole": {},
        "staging, transpose and storing only": {K5_ITEMS: skipped(K5_ITEMS),
                                                K6_ITEMS: skipped(K6_ITEMS)},
        "staging and storing only": {K5_ITEMS: skipped(K5_ITEMS), K6_ITEMS: skipped(K6_ITEMS),
                                     K6_TRANSPOSE: ""},
    }
    jobs = {name: start_patched_build(name.replace(" ", "_").replace(",", ""), patches)
            for name, patches in variants.items()}
    libs = {name: load_patched(job) for name, job in jobs.items()}
    for b, l, h, dh in SHAPES[:2]:
        q, k, v = inputs(b, l, h, dh, dev)
        out = torch.empty_like(q)
        for kernel in ("lane_slice_fwd", "infold_fwd"):
            per_block = attn.board_mma_plan(kernel, b, l, h, dh, dev).per_block
            for name, lib in libs.items():
                if kernel == "lane_slice_fwd" and name.startswith("staging, transpose"):
                    continue  # K5 has no transpose: the same build as the last line
                launch = launcher(getattr(lib, f"attn_{kernel}_mma_launch"), (q, k, v), out,
                                  (b, l, h, dh, per_block), dev)
                print(f"{(b, l, h, dh)} {kernel} {name}: {event_ms(launch):.4f} ms", flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for mode in ("numerics", "staging", "blocks", "phases"):
        parser.add_argument(f"--{mode}", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("board_attn_study: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(torch.cuda.get_device_name(0), flush=True)
    for mode, run in (("numerics", numerics), ("staging", staging), ("blocks", blocks),
                      ("phases", phases)):
        if getattr(args, mode):
            run(dev)


if __name__ == "__main__":
    main()
