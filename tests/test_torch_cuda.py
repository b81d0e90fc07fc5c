"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they build the kernels with nvcc and need an NVIDIA card,
so they skip on a machine without CUDA. On the card::

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from rl_selfplay_mnk_tpu_torch.env import EnvConfig, make_env_state
from rl_selfplay_mnk_tpu_torch.ops import attention as attn
from rl_selfplay_mnk_tpu_torch.ops.env_step import fused_step, fused_step_reference
from rl_selfplay_mnk_tpu_torch.ops.resblock import (
    fused_residual_block,
    fused_residual_block_reference,
)
from rl_selfplay_mnk_tpu_torch.utils import attn_bwd_study

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def env_actions(rng, mask, play, t):
    """A random legal cell per env (cell 0 on a full board); for ``play``
    "wild", every third step a quarter of the envs play a cell that holds a
    stone, and every third another quarter an action off the board."""
    actions = np.where(mask, rng.random(mask.shape), -1).argmax(1)
    pick = rng.random(mask.shape[0]) < 0.25
    if play == "wild" and t % 3 == 1:
        occupied = np.where(~mask, rng.random(mask.shape), -1.0)
        actions = np.where(pick & (~mask).any(1), occupied.argmax(1), actions)
    elif play == "wild" and t % 3 == 2:
        off = np.array([-1, -5, mask.shape[1], 1000, 2**31 - 1, -(2**40)])
        actions = np.where(pick, rng.choice(off, mask.shape[0]), actions)
    return actions


# Games played past their end (no resets): a small board at an odd count
# above the bench's, the rollout batch, 13x13 at a ragged count, and the
# shapes where the kernel has work (bench.py's 8192 envs on 9x9, 13x13 at the
# rollout batch); then occupied cells and actions off the board.
@pytest.mark.parametrize("mnk,e,play", [
    pytest.param((3, 3, 3), 8191, "legal", id="mnk0-8191"),
    pytest.param((9, 9, 5), 384, "legal", id="mnk1-384"),
    pytest.param((13, 13, 5), 33, "legal", id="mnk2-33"),
    pytest.param((9, 9, 5), 8192, "legal", id="9x9x5-8192"),
    pytest.param((13, 13, 5), 384, "legal", id="13x13x5-384"),
    pytest.param((9, 9, 5), 8192, "wild", id="wild-9x9x5-8192"),
    pytest.param((13, 13, 5), 384, "wild", id="wild-13x13x5-384"),
    pytest.param((3, 3, 3), 257, "wild", id="wild-3x3x3-257"),
])
def test_env_step_kernel_bitwise(device, mnk, e, play):
    cfg = EnvConfig(*mnk)
    rng = np.random.default_rng(0)
    state = make_env_state(cfg, e, device)
    mask = np.ones((e, cfg.num_actions), bool)
    for t in range(cfg.num_actions + 2):
        actions = torch.as_tensor(env_actions(rng, mask, play, t), device=device)
        active = torch.as_tensor(rng.random(e) < 0.8, device=device)
        before = fused_step.launches
        got = fused_step(cfg, state, actions, active)
        assert fused_step.launches == before + 1
        want = fused_step_reference(cfg, state, actions, active)
        for g, w in zip(list(got[0]) + list(got[1:]), list(want[0]) + list(want[1:])):
            assert g.dtype == w.dtype and torch.equal(g, w)
        state = got[0]
        mask = got[3].cpu().numpy()


# Planes holding what a caller may put there: stacked stones, halves,
# negatives and, in some envs, infinities and NaN (every line count of the
# product is NaN then: no win); any player number, actions on and off the
# board. The float sums are exact, so the kernel's and the product's agree.
@pytest.mark.parametrize("mnk,e", [((9, 9, 5), 2048), ((13, 13, 5), 384), ((5, 5, 4), 64)])
def test_env_step_kernel_bitwise_on_any_plane_values(device, mnk, e):
    cfg = EnvConfig(*mnk)
    mn = cfg.num_actions
    rng = np.random.default_rng(1)
    values = np.array([0.0, 1.0, 2.0, 0.5, -1.0, 3.0], np.float32)
    for _ in range(4):
        planes = np.where(rng.random((e, 2, mn)) < 0.6, 0.0,
                          rng.choice(values, (e, 2, mn), p=[0.1, 0.6, 0.1, 0.1, 0.05, 0.05]))
        planes = planes.astype(np.float32)
        wild = rng.random((e, 2, mn)) < 0.002
        planes[wild] = rng.choice(np.array([np.inf, -np.inf, np.nan], np.float32), int(wild.sum()))
        state = make_env_state(cfg, e, device)._replace(
            boards=torch.as_tensor(planes.reshape(e, 2, *mnk[:2]), device=device),
            current_player=torch.as_tensor(rng.choice([0, 1, 1, 2, -1], e).astype(np.int32),
                                           device=device),
            move_count=torch.as_tensor(rng.integers(0, mn + 3, e).astype(np.int32), device=device))
        actions = torch.as_tensor(rng.integers(-3, mn + 3, e), device=device)
        active = torch.as_tensor(rng.random(e) < 0.8, device=device)
        got = fused_step(cfg, state, actions, active)
        want = fused_step_reference(cfg, state, actions, active)
        assert want[1].sum() > 0 and want[2].sum() > 0  # wins and dones to agree on
        for g, w in zip(list(got[0]) + list(got[1:]), list(want[0]) + list(want[1:])):
            assert g.dtype == w.dtype
            if g.dtype == torch.float32:
                assert torch.equal(g.isnan(), w.isnan())
                g, w = g.nan_to_num(nan=7.0), w.nan_to_num(nan=7.0)
            assert torch.equal(g, w)


def resblock_inputs(device, dtype, b, m, c):
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.relu(torch.randn(b, m * m, c, device=device, generator=g)).to(dtype)
    w1 = (torch.randn(9 * c, c, device=device, generator=g) * 0.1).to(dtype)
    w2 = (torch.randn(9 * c, c, device=device, generator=g) * 0.1).to(dtype)
    b1 = torch.randn(c, device=device, generator=g) * 0.1
    b2 = torch.randn(c, device=device, generator=g) * 0.1
    return x, w1, b1, w2, b2


# The registry's widths: 9x9 C = 32 at the rollout batch, a tournament
# half-pairing and one game of play; C = 80 and 128 on 9x9 and C = 64 on
# 13x13, whose weights the tensor-core kernel walks in output-channel slices
# or holds whole next to 13x13 activations.
RESBLOCK_CASES = [(384, 9, 32), (16, 9, 32), (1, 9, 32), (7, 9, 80), (5, 9, 128), (3, 13, 64)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2.0**-6)])
@pytest.mark.parametrize("b,m,c", RESBLOCK_CASES)
def test_resblock_kernel_within_tolerance(device, dtype, tol, b, m, c):
    args = resblock_inputs(device, dtype, b, m, c)
    got = fused_residual_block(*args, m, m).float()
    want = fused_residual_block_reference(*args, m, m).float()
    assert ((got - want).abs() <= tol + tol * want.abs()).all()


@pytest.mark.parametrize("b,m,c", RESBLOCK_CASES + [(8191, 9, 32), (16, 13, 128)])
def test_resblock_tensor_core_kernel_same_bits_twice(device, b, m, c):
    """bf16 takes the tensor-core kernel; two runs give the same bits, its
    shared memory is what the plan counted, and the first version (FMA)
    still agrees with the plain version on bf16."""
    from rl_selfplay_mnk_tpu_torch.ops import resblock

    args = resblock_inputs(device, torch.bfloat16, b, m, c)
    plan = resblock._card_mma_plan(b, c, m, m, device)  # raises if the kernel counts otherwise
    assert plan.boards >= 1 and plan.threads % 32 == 0
    first = fused_residual_block(*args, m, m)
    assert torch.equal(first, fused_residual_block(*args, m, m))
    fma = fused_residual_block(*args, m, m, kernel="fma").float()
    want = fused_residual_block_reference(*args, m, m).float()
    assert ((fma - want).abs() <= 2.0**-6 * (1 + want.abs())).all()


class EntrySpy:
    """A kernel library that records which launch entries are called."""

    def __init__(self, lib):
        self.lib, self.launched = lib, []

    def __getattr__(self, name):
        if name.endswith("_launch"):
            self.launched.append(name)
        return getattr(self.lib, name)


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "resblock_mma_launch"),
                                         (torch.float32, "resblock_launch")])
def test_resblock_dtype_picks_its_kernel(device, monkeypatch, dtype, entry):
    from rl_selfplay_mnk_tpu_torch.ops import resblock

    spy = EntrySpy(resblock._lib())
    monkeypatch.setattr(resblock, "_lib", lambda: spy)
    fused_residual_block(*resblock_inputs(device, dtype, 16, 9, 32), 9, 9)
    assert spy.launched == [entry]


# Attention kernels against their plain versions.
# f32: |kernel - plain| <= 2e-5 * (1 + |plain|): sums over Dh <= 64 and L <= 169
# terms in another order.
# bf16: both sides do the same f32 arithmetic up to the order of the sums, so an
# element differs only where that lands across a rounding step of the output (one
# ulp, at most 2^-7 of the value) or of a rounded p or ds (one term of a sum over
# L moves by 2^-7 of itself). Per output tensor: |kernel - plain| <= 2^-7 * |plain|
# + 2^-10 * max|plain|, and at most 2^-9 of the elements, plus 4, differ at all.
ATTN_F32_TOL = 2e-5
ATTN_BF16_RTOL, ATTN_BF16_ATOL_OF_MAX, ATTN_BF16_DIFFER_SHARE = 2.0**-7, 2.0**-10, 2.0**-9
ATTN_SHAPES = [(5, 81, 4, 14), (3, 169, 8, 12), (8, 9, 4, 14), (5, 81, 3, 32), (3, 169, 2, 64),
               (2, 25, 2, 8)]


def attn_inputs(device, dtype, b, l, h, dh, packed, n=4):
    g = torch.Generator(device=device).manual_seed(b * 1000 + l)
    shape = (b, l, h * dh) if packed else (b * h, dh, l)
    return [torch.randn(shape, device=device, generator=g).to(dtype) for _ in range(n)]


def assert_attn_close(got, want, dtype, what):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), what
    err = (got - want).abs()
    if dtype == torch.float32:
        limit = ATTN_F32_TOL * (1.0 + want.abs())
    else:
        limit = ATTN_BF16_RTOL * want.abs() + ATTN_BF16_ATOL_OF_MAX * want.abs().max()
        differ = int((err > 0).sum())
        assert differ <= ATTN_BF16_DIFFER_SHARE * err.numel() + 4, (
            f"{what}: {differ} of {err.numel()} elements differ")
    excess = (err / limit).max()
    assert excess <= 1, f"{what}: the worst error is {float(excess)} of its limit"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("packed", [False, True], ids=["folded", "packed"])
@pytest.mark.parametrize("b,l,h,dh", ATTN_SHAPES)
def test_attention_kernels_within_tolerance(device, dtype, packed, b, l, h, dh):
    q, k, v, do = attn_inputs(device, dtype, b, l, h, dh, packed)
    if packed:
        fwd, bwd, extra = attn.attention_packed_fwd, attn.attention_packed_bwd, (h, dh)
        fwd_ref, bwd_ref = attn.attention_packed_reference, attn.attention_packed_bwd_reference
    else:
        fwd, bwd, extra = attn.attention_folded_fwd, attn.attention_folded_bwd, ()
        fwd_ref, bwd_ref = attn.attention_folded_reference, attn.attention_folded_bwd_reference
    before = fwd.launches, bwd.launches
    got = fwd(q, k, v, *extra)
    grads = bwd(q, k, v, do, *extra)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    assert_attn_close(got, fwd_ref(q, k, v, *extra), dtype, "o")
    for name, g, w in zip(("dq", "dk", "dv"), grads, bwd_ref(q, k, v, do, *extra)):
        assert_attn_close(g, w, dtype, name)


# The one-block-per-board kernels: the registry's Dh < 32 shapes, a tournament
# half-pairing, an odd batch, a 3x3 board, a head of 32 and one of 64 (two
# channels a lane), and a width whose rows are not 16-byte aligned in bf16.
BOARD_SHAPES = [(16, 81, 4, 14), (5, 81, 4, 14), (3, 169, 8, 12), (8, 9, 4, 14), (5, 81, 3, 32),
                (3, 169, 2, 64), (2, 25, 2, 8), (3, 25, 3, 5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,h,dh", BOARD_SHAPES)
def test_board_attention_kernels_within_tolerance(device, dtype, b, l, h, dh):
    """K5 (lane slice), K6 and K7 (in-kernel fold) against their plain versions."""
    from rl_selfplay_mnk_tpu_torch.ops.cuda_build import KernelError

    q, k, v, do = attn_inputs(device, dtype, b, l, h, dh, packed=True)
    wrappers = (attn.attention_lane_slice_fwd, attn.attention_infold_fwd, attn.attention_infold_bwd)
    before = [w.launches for w in wrappers]
    if (l, h * dh, dtype) == (169, 128, torch.float32):
        # The lane-slice kernel holds the whole board: 3 x 169 x 132 f32 is
        # more than a block's shared memory. (The dispatch sends Dh >= 32 to
        # the packed pair; the in-kernel fold walks the heads in groups.)
        with pytest.raises(KernelError, match="shared memory"):
            attn.attention_lane_slice_fwd(q, k, v, h, dh)
        before[0] -= 1
    else:
        lane = attn.attention_lane_slice_fwd(q, k, v, h, dh)
        torch.cuda.synchronize()
        assert_attn_close(lane, attn.attention_lane_slice_reference(q, k, v, h, dh), dtype, "lane o")
    fold = attn.attention_infold_fwd(q, k, v, h, dh)
    grads = attn.attention_infold_bwd(q, k, v, do, h, dh)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [n + 1 for n in before]
    assert_attn_close(fold, attn.attention_infold_reference(q, k, v, h, dh), dtype, "infold o")
    want = attn.attention_infold_bwd_reference(q, k, v, do, h, dh)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert_attn_close(g, w, dtype, name)
    again = attn.attention_infold_bwd(q, k, v, do, h, dh)
    assert all(torch.equal(a, g) for a, g in zip(again, grads)), "the backward is not deterministic"


# The tensor-core folded forward (K3 in bf16): every token count of the
# registry's boards up to the kernel's limit, every head width it takes, a
# count of heads that leaves the last block of four short.
@pytest.mark.parametrize("l", [9, 81, 169, 192])
@pytest.mark.parametrize("dh", [8, 12, 14, 32, 64])
def test_folded_forward_tensor_cores_within_tolerance(device, l, dh):
    bh = 4 * 5 + 3
    q, k, v = attn_inputs(device, torch.bfloat16, bh, l, 1, dh, packed=False, n=3)
    before = attn.attention_folded_fwd.launches
    got = attn.attention_folded_fwd(q, k, v)
    again = attn.attention_folded_fwd(q, k, v)
    torch.cuda.synchronize()
    assert attn.attention_folded_fwd.launches == before + 2
    assert torch.equal(got, again), "the tensor-core forward is not deterministic"
    assert_attn_close(got, attn.attention_folded_reference(q, k, v), torch.bfloat16, "o")
    fma = attn.attention_folded_fwd(q, k, v, kernel="fma")
    assert_attn_close(fma, attn.attention_folded_reference(q, k, v), torch.bfloat16, "fma o")


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "attn_folded_fwd_mma_launch"),
                                         (torch.float32, "attn_folded_fwd_launch")])
def test_folded_forward_dtype_picks_its_kernel(device, monkeypatch, dtype, entry):
    spy = EntrySpy(attn._lib())
    monkeypatch.setattr(attn, "_lib", lambda: spy)
    attn.attention_folded_fwd(*attn_inputs(device, dtype, 8, 81, 4, 14, packed=False, n=3))
    assert spy.launched == [entry]


# The tensor-core folded backward (K4 in bf16), at the folded forward's
# cases: every token count of the registry's boards up to the kernel's limit,
# every head width it takes, a count of heads that leaves the last block of
# four short.
@pytest.mark.parametrize("l", [9, 81, 169, 192])
@pytest.mark.parametrize("dh", [8, 12, 14, 32, 64])
def test_folded_backward_tensor_cores_within_tolerance(device, l, dh):
    bh = 4 * 5 + 3
    q, k, v, do = attn_inputs(device, torch.bfloat16, bh, l, 1, dh, packed=False)
    before = attn.attention_folded_bwd.launches
    got = attn.attention_folded_bwd(q, k, v, do)
    again = attn.attention_folded_bwd(q, k, v, do)
    torch.cuda.synchronize()
    assert attn.attention_folded_bwd.launches == before + 2
    assert all(torch.equal(a, g) for a, g in zip(again, got)), \
        "the tensor-core backward is not deterministic"
    want = attn.attention_folded_bwd_reference(q, k, v, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_attn_close(g, w, torch.bfloat16, name)
    for name, g, w in zip(("dq", "dk", "dv"), attn.attention_folded_bwd(q, k, v, do, kernel="fma"),
                          want):
        assert_attn_close(g, w, torch.bfloat16, f"fma {name}")


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "attn_folded_bwd_mma_launch"),
                                         (torch.float32, "attn_folded_bwd_launch")])
def test_folded_backward_dtype_picks_its_kernel(device, monkeypatch, dtype, entry):
    spies = EntrySpy(attn._lib()), EntrySpy(attn._folded_bwd_lib())
    monkeypatch.setattr(attn, "_lib", lambda: spies[0])
    monkeypatch.setattr(attn, "_folded_bwd_lib", lambda: spies[1])
    attn.attention_folded_bwd(*attn_inputs(device, dtype, 8, 81, 4, 14, packed=False))
    assert spies[0].launched + spies[1].launched == [entry]


# The tensor-core packed forward (K8 in bf16): every token count of the
# registry's boards up to the kernel's limit, the registry's head widths of
# 64 and 32, and those of 12 and 14, whose rows are not whole 16-byte words;
# five boards, so that the last block of two or four heads is short where the
# count of heads allows it.
@pytest.mark.parametrize("l", [9, 81, 169, 192])
@pytest.mark.parametrize("h,dh", [(2, 64), (4, 64), (3, 32), (8, 12), (4, 14)])
def test_packed_forward_tensor_cores_within_tolerance(device, l, h, dh):
    b = 5
    q, k, v = attn_inputs(device, torch.bfloat16, b, l, h, dh, packed=True, n=3)
    before = attn.attention_packed_fwd.launches
    got = attn.attention_packed_fwd(q, k, v, h, dh)
    again = attn.attention_packed_fwd(q, k, v, h, dh)
    torch.cuda.synchronize()
    assert attn.attention_packed_fwd.launches == before + 2
    assert torch.equal(got, again), "the tensor-core forward is not deterministic"
    want = attn.attention_packed_reference(q, k, v, h, dh)
    assert_attn_close(got, want, torch.bfloat16, "o")
    fma = attn.attention_packed_fwd(q, k, v, h, dh, kernel="fma")
    assert_attn_close(fma, want, torch.bfloat16, "fma o")


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "attn_packed_fwd_mma_launch"),
                                         (torch.float32, "attn_packed_fwd_launch")])
def test_packed_forward_dtype_picks_its_kernel(device, monkeypatch, dtype, entry):
    spy = EntrySpy(attn._lib())
    monkeypatch.setattr(attn, "_lib", lambda: spy)
    attn.attention_packed_fwd(*attn_inputs(device, dtype, 8, 169, 2, 64, packed=True, n=3), 2, 64)
    assert spy.launched == [entry]


# The tensor-core packed backward (K9 in bf16), at the forward's cases: every
# token count of the registry's boards up to the kernel's limit, head widths
# of 64 and 32 and of 12 and 14 (rows not whole 16-byte words); five boards,
# so that the last block of several heads is short where the count allows it.
@pytest.mark.parametrize("l", [9, 81, 169, 192])
@pytest.mark.parametrize("h,dh", [(2, 64), (4, 64), (3, 32), (8, 12), (4, 14)])
def test_packed_backward_tensor_cores_within_tolerance(device, l, h, dh):
    b = 5
    q, k, v, do = attn_inputs(device, torch.bfloat16, b, l, h, dh, packed=True)
    before = attn.attention_packed_bwd.launches
    got = attn.attention_packed_bwd(q, k, v, do, h, dh)
    again = attn.attention_packed_bwd(q, k, v, do, h, dh)
    torch.cuda.synchronize()
    assert attn.attention_packed_bwd.launches == before + 2
    assert all(torch.equal(a, g) for a, g in zip(again, got)), \
        "the tensor-core backward is not deterministic"
    want = attn.attention_packed_bwd_reference(q, k, v, do, h, dh)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_attn_close(g, w, torch.bfloat16, name)
    for name, g, w in zip(("dq", "dk", "dv"), attn.attention_packed_bwd(q, k, v, do, h, dh,
                                                                       kernel="fma"), want):
        assert_attn_close(g, w, torch.bfloat16, f"fma {name}")


# K9 at the two update minibatches with heads below 16 channels (9x9 with
# four heads of 14, 13x13 with eight of 12), where it sums S (both passes)
# and dP^T a depth pair at a time: the unchanged bf16 limit against the
# plain version, the same bits twice, on the inputs of
# utils/attn_bwd_study.py --numerics --seeds 0 1 2 (seed 0 is chip_smoke.py's).
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("b,l,h,dh", [(8192, 81, 4, 14), (2048, 169, 8, 12)])
def test_packed_backward_at_the_tiny_head_minibatches(device, b, l, h, dh, seed):
    q, k, v, do = attn_bwd_study.inputs(b, l, h, dh, device, seed=seed)
    got = attn.attention_packed_bwd(q, k, v, do, h, dh)
    again = attn.attention_packed_bwd(q, k, v, do, h, dh)
    torch.cuda.synchronize()
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    for name, g, w in zip(("dq", "dk", "dv"), got,
                          attn.attention_packed_bwd_reference(q, k, v, do, h, dh)):
        assert_attn_close(g, w, torch.bfloat16, name)


# K9 at (384, 81, 3, 32), the head shape of the transformer_s and
# transformer_l updates (Dh = 32), where pass 1's S is summed a depth pair at
# a time: as one 16-deep product a step it put dq at 1.54 of the limit at
# seed 2, from the plain version and from the f64 computation alike
# (utils/attn_bwd_study.py --numerics --seeds 0 ... 9, NVIDIA H100 80GB HBM3,
# 700 W). At seed 4 the plain f32 version is itself 1.03 (dv) of the limit
# from the f64 computation, and the FMA first version too: there the
# tensor-core K9 is held against the f64 computation.
DH32_PLAIN_MISSES_F64 = (4,)


@pytest.mark.parametrize("seed", range(10))
def test_packed_backward_at_the_dh32_update_minibatch(device, seed):
    b, l, h, dh = 384, 81, 3, 32
    q, k, v, do = attn_bwd_study.inputs(b, l, h, dh, device, seed=seed)
    got = attn.attention_packed_bwd(q, k, v, do, h, dh)
    again = attn.attention_packed_bwd(q, k, v, do, h, dh)
    torch.cuda.synchronize()
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    want = (attn_bwd_study.f64_reference(q, k, v, do, h, dh) if seed in DH32_PLAIN_MISSES_F64
            else attn.attention_packed_bwd_reference(q, k, v, do, h, dh))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_attn_close(g, w, torch.bfloat16, name)


# On this file's own inputs at (2048, 169, 8, 12) the plain f32 version is
# itself 1.06 (dq) and 1.09 (dk) of the limit from the f64 computation with
# its rounding points, and the FMA first version 1.05 and 1.08 from the plain
# one (utils/attn_bwd_study.py --numerics, NVIDIA H100 80GB HBM3, 700 W): there
# the tensor-core K9 is held against the f64 computation, as the board
# forwards are at 150 boards.
def test_packed_backward_where_the_plain_version_misses_the_f64_computation(device):
    b, l, h, dh = 2048, 169, 8, 12
    q, k, v, do = attn_inputs(device, torch.bfloat16, b, l, h, dh, packed=True)
    got = attn.attention_packed_bwd(q, k, v, do, h, dh)
    for name, g, w in zip(("dq", "dk", "dv"), got,
                          attn_bwd_study.f64_reference(q, k, v, do, h, dh)):
        assert_attn_close(g, w, torch.bfloat16, name)


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "attn_packed_bwd_mma_launch"),
                                         (torch.float32, "attn_packed_bwd_launch")])
def test_packed_backward_dtype_picks_its_kernel(device, monkeypatch, dtype, entry):
    spies = EntrySpy(attn._lib()), EntrySpy(attn._bwd_lib())
    monkeypatch.setattr(attn, "_lib", lambda: spies[0])
    monkeypatch.setattr(attn, "_bwd_lib", lambda: spies[1])
    attn.attention_packed_bwd(*attn_inputs(device, dtype, 8, 169, 2, 64, packed=True), 2, 64)
    assert spies[0].launched + spies[1].launched == [entry]


# The tensor-core board forwards (K5 and K6 in bf16): every token count of the
# registry's boards up to the kernels' limit, the registry's Dh < 32 shapes
# (four heads of 14, eight of 12: rows that are whole 16-byte words where one
# head's are not) and two heads of 64, the widest head they take; 5 and 16
# boards, where a board's work splits over several blocks (query tiles for
# K5, heads for K6).
BOARD_MMA_SHAPES = [(l, h, dh) for l in (9, 81, 169, 192) for h, dh in ((4, 14), (8, 12), (2, 64))]
BOARD_FORWARDS = ((attn.attention_lane_slice_fwd, attn.attention_lane_slice_reference),
                  (attn.attention_infold_fwd, attn.attention_infold_reference))


def f64_forward(q, k, v, h, dh):
    """The plain version's arithmetic in f64, with its bf16 rounding points
    (p before P V, the output)."""
    qf, kf, vf = (attn._packed_to_heads(t, h, dh).double() for t in (q, k, v))
    p = torch.softmax(torch.matmul(qf, kf.transpose(1, 2)) / dh**0.5, -1)
    o = torch.matmul(p.to(torch.bfloat16).double(), vf)
    return attn._heads_to_packed(o.to(torch.bfloat16), q.shape[0], h)


def run_twice(fwd, q, k, v, h, dh):
    before = fwd.launches
    got = fwd(q, k, v, h, dh)
    again = fwd(q, k, v, h, dh)
    torch.cuda.synchronize()
    assert fwd.launches == before + 2
    assert torch.equal(got, again), f"{fwd.__name__}: the tensor-core forward is not deterministic"
    return got


@pytest.mark.parametrize("b", [5, 16])
@pytest.mark.parametrize("l,h,dh", BOARD_MMA_SHAPES)
def test_board_forwards_tensor_cores_within_tolerance(device, b, l, h, dh):
    q, k, v = attn_inputs(device, torch.bfloat16, b, l, h, dh, packed=True, n=3)
    for fwd, ref in BOARD_FORWARDS:
        got = run_twice(fwd, q, k, v, h, dh)
        want = ref(q, k, v, h, dh)
        assert_attn_close(got, want, torch.bfloat16, f"{fwd.__name__} o")
        assert_attn_close(fwd(q, k, v, h, dh, kernel="fma"), want, torch.bfloat16,
                          f"{fwd.__name__} fma o")


# 150 boards, more than the card's SMs (chip_smoke.py runs the plans of a
# board a block, at 8192, 2048 and 384 boards). The tensor-core
# kernels are held against the f64 computation, whose scores they share up
# to f32 rounding of each 16-deep product; the FMA first versions, which sum
# the scores in the plain version's order, against the plain version. At (9,
# 2, 64) the plain version rounds one p to the other side of a bf16 step
# from the f64 computation and is 1.08 of the limit from it, where the
# tensor-core K5, K6 and K8 are exact (utils/board_attn_study.py --numerics).
@pytest.mark.parametrize("l,h,dh", BOARD_MMA_SHAPES)
def test_board_forwards_at_150_boards_within_tolerance(device, l, h, dh):
    b = 150
    q, k, v = attn_inputs(device, torch.bfloat16, b, l, h, dh, packed=True, n=3)
    exact = f64_forward(q, k, v, h, dh)
    for fwd, ref in BOARD_FORWARDS:
        assert_attn_close(run_twice(fwd, q, k, v, h, dh), exact, torch.bfloat16, f"{fwd.__name__} o")
        assert_attn_close(fwd(q, k, v, h, dh, kernel="fma"), ref(q, k, v, h, dh), torch.bfloat16,
                          f"{fwd.__name__} fma o")


@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, "_mma_launch"), (torch.float32, "_launch")])
@pytest.mark.parametrize("kernel", ["lane_slice_fwd", "infold_fwd"])
def test_board_forward_dtype_picks_its_kernel(device, monkeypatch, dtype, suffix, kernel):
    spy = EntrySpy(attn._board_lib())
    monkeypatch.setattr(attn, "_board_lib", lambda: spy)
    getattr(attn, f"attention_{kernel}")(
        *attn_inputs(device, dtype, 8, 81, 4, 14, packed=True, n=3), 4, 14)
    assert spy.launched == [f"attn_{kernel}{suffix}"]


# The tensor-core in-kernel-fold backward (K7 in bf16), at the board
# forwards' cases: every token count up to the kernel's limit, four heads of
# 14, eight of 12 and two of 64; 5 and 16 boards, where a board's heads
# split over several blocks.
@pytest.mark.parametrize("b", [5, 16])
@pytest.mark.parametrize("l,h,dh", BOARD_MMA_SHAPES)
def test_infold_backward_tensor_cores_within_tolerance(device, b, l, h, dh):
    q, k, v, do = attn_inputs(device, torch.bfloat16, b, l, h, dh, packed=True)
    before = attn.attention_infold_bwd.launches
    got = attn.attention_infold_bwd(q, k, v, do, h, dh)
    again = attn.attention_infold_bwd(q, k, v, do, h, dh)
    torch.cuda.synchronize()
    assert attn.attention_infold_bwd.launches == before + 2
    assert all(torch.equal(a, g) for a, g in zip(again, got)), \
        "the tensor-core backward is not deterministic"
    want = attn.attention_infold_bwd_reference(q, k, v, do, h, dh)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_attn_close(g, w, torch.bfloat16, name)
    for name, g, w in zip(("dq", "dk", "dv"),
                          attn.attention_infold_bwd(q, k, v, do, h, dh, kernel="fma"), want):
        assert_attn_close(g, w, torch.bfloat16, f"fma {name}")


@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, "_mma_launch"), (torch.float32, "_launch")])
def test_infold_backward_dtype_picks_its_kernel(device, monkeypatch, dtype, suffix):
    spy = EntrySpy(attn._board_lib())
    monkeypatch.setattr(attn, "_board_lib", lambda: spy)
    attn.attention_infold_bwd(*attn_inputs(device, dtype, 8, 81, 4, 14, packed=True), 4, 14)
    assert spy.launched == [f"attn_infold_bwd{suffix}"]


def test_infold_walks_the_heads_in_groups_where_the_board_does_not_fit(device):
    """f32 at 13x13, d96: five slabs of the whole board exceed a block's
    shared memory, so the backward takes the heads in groups; same result."""
    b, l, h, dh = 3, 169, 8, 12
    threads, heads = attn._board_plan("in-kernel-fold backward", l, h, dh, 4, device)
    assert heads < h
    q, k, v, do = attn_inputs(device, torch.float32, b, l, h, dh, packed=True)
    want = attn.attention_infold_bwd_reference(q, k, v, do, h, dh)
    for name, g, w in zip(("dq", "dk", "dv"), attn.attention_infold_bwd(q, k, v, do, h, dh), want):
        assert_attn_close(g, w, torch.float32, name)


@pytest.mark.parametrize("route,counters", [
    ("folded", ("attention_folded_fwd", "attention_folded_bwd")),
    ("infold", ("attention_infold_fwd", "attention_infold_bwd")),
])
def test_forced_routes_agree_with_plain_autograd(device, route, counters):
    b, l, h, dh = 3, 25, 4, 14
    g = torch.Generator(device=device).manual_seed(1)
    q, k, v, w = (torch.randn((b, l, h, dh), device=device, generator=g) for _ in range(4))
    before = [getattr(attn, name).launches for name in counters]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (attn.tiny_head_attention(*leaves, route=route) * w).sum().backward()
    assert [getattr(attn, name).launches for name in counters] == [n + 1 for n in before]
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    s = torch.einsum("bihd,bjhd->bhij", plain[0], plain[1]) / dh**0.5
    (torch.einsum("bhij,bjhd->bihd", torch.softmax(s, -1), plain[2]) * w).sum().backward()
    for got, want in zip(leaves, plain):
        assert_attn_close(got.grad, want.grad, torch.float32, "grad")


@pytest.mark.parametrize("route,kernels", [
    ("folded", ("attention_folded_fwd", "attention_folded_bwd")),
    ("infold", ("attention_infold_fwd", "attention_infold_bwd")),
])
def test_forced_routes_in_bf16_run_the_tensor_core_pair(device, monkeypatch, route, kernels):
    """bf16 through the two routes a caller can force: the forward and the
    backward each launch their tensor-core kernel once, and the gradients
    are the plain version's backward of the same function."""
    b, l, h, dh = 3, 25, 4, 14
    spies = {name: EntrySpy(getattr(attn, name)()) for name in ("_lib", "_folded_bwd_lib",
                                                                 "_board_lib")}
    for name, spy in spies.items():
        monkeypatch.setattr(attn, name, lambda spy=spy: spy)
    g = torch.Generator(device=device).manual_seed(2)
    q, k, v, w = (torch.randn((b, l, h, dh), device=device, generator=g).to(torch.bfloat16)
                  for _ in range(4))
    before = [getattr(attn, name).launches for name in kernels]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    attn.tiny_head_attention(*leaves, route=route).backward(w)
    assert [getattr(attn, name).launches for name in kernels] == [n + 1 for n in before]
    launched = sorted(e for spy in spies.values() for e in spy.launched)
    assert launched == sorted(f"attn_{name.removeprefix('attention_')}_mma_launch"
                              for name in kernels)
    packed = [t.reshape(b, l, h * dh) for t in (q, k, v, w)]
    want = attn.attention_packed_bwd_reference(*packed, h, dh)
    for name, leaf, wg in zip(("dq", "dk", "dv"), leaves, want):
        assert_attn_close(leaf.grad.reshape(b, l, h * dh), wg, torch.bfloat16, name)


def test_no_gradient_forward_takes_the_lane_slice_kernel(device):
    q, k, v = (torch.randn((4, 81, 4, 14), device=device, dtype=torch.bfloat16).requires_grad_(True)
               for _ in range(3))
    names = ("attention_lane_slice_fwd", "attention_folded_fwd", "attention_infold_fwd",
             "attention_packed_fwd")
    before = [getattr(attn, name).launches for name in names]
    with torch.no_grad():
        out = attn.tiny_head_attention(q, k, v)
    assert out.grad_fn is None and out.shape == q.shape
    assert [getattr(attn, n).launches - b for n, b in zip(names, before)] == [1, 0, 0, 0]
    # 13x13 with eight heads of 12: more head rows a board than K5 is given.
    many = [torch.randn((4, 169, 8, 12), device=device, dtype=torch.bfloat16) for _ in range(3)]
    with torch.no_grad():
        out = attn.tiny_head_attention(*many)
    assert [getattr(attn, n).launches - b for n, b in zip(names, before)] == [1, 0, 0, 1]
    want = attn.attention_packed_reference(*(t.reshape(4, 169, 96) for t in many), 8, 12)
    assert_attn_close(out.reshape(4, 169, 96), want, torch.bfloat16, "o")


@pytest.mark.parametrize("b,l,h,dh", [(3, 25, 4, 14), (3, 25, 2, 32)])
def test_attention_function_backward_matches_plain_autograd(device, b, l, h, dh):
    """The Function's backward (the backward kernel) against autograd through
    the plain forward, in f32, through both branches of the dispatch."""
    g = torch.Generator(device=device).manual_seed(0)
    q, k, v, w = (torch.randn((b, l, h, dh), device=device, generator=g) for _ in range(4))

    def plain(q, k, v):
        s = torch.einsum("bihd,bjhd->bhij", q, k) / dh**0.5
        return torch.einsum("bhij,bjhd->bihd", torch.softmax(s, -1), v)

    grads = []
    for fn in (attn.tiny_head_attention, plain):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (fn(*leaves) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert_attn_close(got, want, torch.float32, "grad")
    gradient_bwd = {"folded": attn.attention_folded_bwd, "infold": attn.attention_infold_bwd}
    counters = (gradient_bwd[attn.GRADIENT_ROUTE], attn.attention_packed_bwd)
    assert counters[dh >= 32].launches > 0


def test_attention_no_grad_builds_no_graph(device):
    q, k, v = attn_inputs(device, torch.bfloat16, 2, 9, 2, 16, packed=True, n=3)
    q.requires_grad_(True)
    with torch.no_grad():
        out = attn.attention_packed(q, k, v, 2, 16)
    assert out.grad_fn is None and not out.requires_grad


def test_attention_raises_beyond_the_kernels_limits(device):
    from rl_selfplay_mnk_tpu_torch.ops.cuda_build import KernelError

    q = torch.zeros((2, 8, 200), device=device)
    with pytest.raises(KernelError):
        attn.attention_folded_fwd(q, q, q)
    q = torch.zeros((2, 9, 128), device=device)
    with pytest.raises(KernelError):
        attn.attention_packed_fwd(q, q, q, 1, 128)
    for q in (torch.zeros((2, 9, 128), device=device, dtype=torch.bfloat16),
              torch.zeros((2, 200, 64), device=device, dtype=torch.bfloat16)):
        with pytest.raises(KernelError):
            attn.attention_packed_bwd(q, q, q, q, 1, q.shape[2])


# LayerNorm (ops/layer_norm.py) against its plain version: every width a
# registry model normalises over but 1 (models/common.py's exact bias) and
# 64, at one row, a few, the rollout's 384 boards of 81 tokens and the
# update minibatch's 8192. Both sides do the same f32 arithmetic up to the
# order of its sums and round y and dx once, so y and dx differ by the
# dtype's part of the limit (bf16: the attention kernels' 2^-7 * |plain| +
# 2^-10 * max|plain|; f32: 2^-16 of each element and of the largest) plus
# 2^-16 of the magnitudes of the terms that the f32 sums cancel (dx at width
# 2 is such a remainder); dweight and dbias, f32 sums over the rows in
# another order, within 2^-16 of the sum of their terms' magnitudes.
LN_WIDTHS = (2, 56, 81, 96, 128, 162, 169, 256, 338)
LN_ROWS = (1, 7, 384 * 81, 8192 * 81)
LN_F32_TOL = 2.0**-16


def ln_inputs(device, dtype, rows, width, seed=0):
    """x with a mean of 1.5 (E[x^2] - E[x]^2 would lose digits), dy, and
    f32 weight and bias near 1 and 0."""
    g = torch.Generator(device=device).manual_seed(seed + rows + 1000 * width)
    x = (torch.randn(rows, width, device=device, generator=g) * 2.0 + 1.5).to(dtype)
    dy = torch.randn(rows, width, device=device, generator=g).to(dtype)
    weight = 1.0 + 0.2 * torch.randn(width, device=device, generator=g)
    bias = 0.2 * torch.randn(width, device=device, generator=g)
    return x, dy, weight, bias


def ln_forward_backward(fn, x, dy, weight, bias):
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, weight, bias)]
    y = fn(*leaves, 1e-6)
    y.backward(dy)
    return (y.detach(), *(t.grad for t in leaves))


def ln_terms(x, dy, weight):
    """The magnitudes of the terms each f32 result sums, in float64: dx =
    rstd * (g - mean(g) - xh * mean(g * xh)) with g = dy * weight; dweight =
    sum(dy * xh), dbias = sum(dy) over the rows; xh = (x - mean) * rstd
    counted as (|x| + |mean|) * rstd, since a rounding of the mean moves it
    by that much however near x is to the mean."""
    xf, dyf = x.double(), dy.double()
    mean = xf.mean(1, keepdim=True)
    rstd = torch.rsqrt(xf.var(1, unbiased=False, keepdim=True) + 1e-6)
    xh = (xf.abs() + mean.abs()) * rstd
    g = (dyf * weight.double()).abs()
    dx = rstd * (g + g.mean(1, keepdim=True) + xh * (g * xh).mean(1, keepdim=True))
    return {"y": None, "dx": dx, "dweight": (dyf.abs() * xh).sum(0), "dbias": dyf.abs().sum(0)}


def assert_ln_close(got, want, dtype, what, terms):
    got, want = got.double(), want.double()
    assert torch.isfinite(got).all(), what
    err = (got - want).abs()
    if what in ("dweight", "dbias"):
        limit = 0.0
    elif dtype == torch.float32:
        limit = LN_F32_TOL * (want.abs() + want.abs().max())
    else:
        limit = ATTN_BF16_RTOL * want.abs() + ATTN_BF16_ATOL_OF_MAX * want.abs().max()
    if terms is not None:
        limit = limit + LN_F32_TOL * terms
    excess = (err / limit).nan_to_num(nan=0.0, posinf=float("inf")).max()
    assert excess <= 1, f"{what}: the worst error is {float(excess)} of its limit"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", LN_ROWS)
@pytest.mark.parametrize("width", LN_WIDTHS)
def test_layer_norm_kernels_within_tolerance(device, dtype, rows, width):
    from rl_selfplay_mnk_tpu_torch.ops.layer_norm import layer_norm, layer_norm_reference

    x, dy, weight, bias = ln_inputs(device, dtype, rows, width)
    got = ln_forward_backward(layer_norm, x, dy, weight, bias)
    want = ln_forward_backward(layer_norm_reference, x, dy, weight, bias)
    assert got[0].dtype == got[1].dtype == dtype
    assert got[2].dtype == got[3].dtype == torch.float32
    terms = ln_terms(x, dy, weight)
    for name, g, w in zip(("y", "dx", "dweight", "dbias"), got, want):
        assert_ln_close(g, w, dtype, name, terms[name])


@pytest.mark.parametrize("width,rows", [(56, 8192 * 81), (162, 8192), (338, 4096), (2, 384)])
def test_layer_norm_same_bits_twice(device, width, rows):
    """No atomics: two runs give the same y, dx, dweight and dbias."""
    from rl_selfplay_mnk_tpu_torch.ops.layer_norm import layer_norm

    args = ln_inputs(device, torch.bfloat16, rows, width, seed=1)
    first = ln_forward_backward(layer_norm, *args)
    second = ln_forward_backward(layer_norm, *args)
    for name, a, b in zip(("y", "dx", "dweight", "dbias"), first, second):
        assert torch.equal(a, b), name


def test_layer_norm_replays_in_a_cuda_graph(device):
    """Forward and backward captured in a CUDA graph replay the eager bits."""
    from rl_selfplay_mnk_tpu_torch.ops.layer_norm import layer_norm

    x, dy, weight, bias = ln_inputs(device, torch.bfloat16, 384 * 81, 56, seed=2)
    eager = ln_forward_backward(layer_norm, x, dy, weight, bias)
    static = [t.detach().clone().requires_grad_(True) for t in (x, weight, bias)]
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):  # warm-up outside the capture, as the fused trainer does
        layer_norm(*static, 1e-6).backward(dy)
    torch.cuda.current_stream(device).wait_stream(side)
    for t in static:
        t.grad = None
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = layer_norm(*static, 1e-6)
        grads = torch.autograd.grad(y, static, dy)
    with torch.no_grad():  # other inputs first: the replay must read them
        for t, fresh in zip(static, (x, weight, bias)):
            t.copy_(fresh + 1.0)
    graph.replay()
    moved = ln_forward_backward(layer_norm, x + 1.0, dy, weight + 1.0, bias + 1.0)
    for name, g, w in zip(("y", "dx", "dweight", "dbias"), (y, *grads), moved):
        assert torch.equal(g, w), name
    assert not torch.equal(y, eager[0])


def test_layer_norm_counts_and_limits(device):
    """One launch a forward (no statistics without a gradient), two a
    backward; a width above the kernels' maximum raises; a transformer's
    forward takes the kernel for every norm and ATen's LayerNorm for none."""
    from torch.profiler import ProfilerActivity, profile

    from rl_selfplay_mnk_tpu_torch.models import create_model_from_architecture, init_network
    from rl_selfplay_mnk_tpu_torch.ops.cuda_build import KernelError
    from rl_selfplay_mnk_tpu_torch.ops.layer_norm import MAX_WIDTH, layer_norm, layer_norm_fwd
    from rl_selfplay_mnk_tpu_torch.utils.profiling import kernel_times

    x, dy, weight, bias = ln_inputs(device, torch.bfloat16, 100, 56)
    before = layer_norm.launches
    with torch.no_grad():
        layer_norm(x, weight, bias, 1e-6)
    assert layer_norm.launches == before + 1
    ln_forward_backward(layer_norm, x, dy, weight, bias)
    assert layer_norm.launches == before + 4
    assert layer_norm_fwd(x, weight, bias, 1e-6, stats=False)[1] is None
    wide = torch.zeros((3, MAX_WIDTH + 1), device=device, dtype=torch.bfloat16)
    ones = torch.ones(MAX_WIDTH + 1, device=device)
    with pytest.raises(KernelError, match="width"):
        layer_norm(wide, ones, ones, 1e-6)

    model, _ = create_model_from_architecture("transformer_b_s", (2, 9, 9), 81,
                                              dtype=torch.bfloat16)
    model = init_network(model).to(device)
    norms = sum(isinstance(m, torch.nn.LayerNorm) for m in model.modules())
    obs = torch.zeros((16, 2, 9, 9), device=device)
    before = layer_norm.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        logits, value = model(obs)
        (logits.sum() + value.sum()).backward()
        torch.cuda.synchronize()
    assert layer_norm.launches - before == 3 * norms
    names = list(kernel_times(prof))
    assert any("ln_rows_fwd" in n for n in names) and any("ln_rows_bwd" in n for n in names)
    assert not any("layer_norm" in n for n in names), names


# The fused trainer's graphs (alg/fused.py) at a small width of the default
# config: 9x9x5 resnet_b_s, 64 envs, 32 steps, batch 512 (4 minibatches an
# epoch), a pool of 4.
def fused_trainer(device, arch="resnet_b_s"):
    from rl_selfplay_mnk_tpu_torch.train import build_config
    from rl_selfplay_mnk_tpu_torch.train_fused import create_fused_trainer
    from rl_selfplay_mnk_tpu_torch.utils.hardware import detect_hardware_config

    config = build_config(arch)
    config.update(num_envs=64, n_steps=32, batch_size=512, opponent_pool=4)
    return create_fused_trainer(config, detect_hardware_config(str(device)), max_block=2)[0]


@pytest.mark.parametrize("arch", ["resnet_b_s", "transformer_b_s"])
def test_fused_scan_matches_step_dispatch(device, arch):
    """Two iterations by the step dispatch, twice, and by the graphs: where
    the two eager runs give the same bits the graphs give them too, else
    they stay within the eager runs' spread."""
    from rl_selfplay_mnk_tpu_torch.alg import fused
    from rl_selfplay_mnk_tpu_torch.train_fused import run_block

    finals = []
    for dispatch in ("step", "step", "scan"):
        trainer = fused_trainer(device, arch)
        rows = run_block(trainer, dispatch, 0, 2, 1.0)
        finals.append((rows, {k: v.clone() for k, v in trainer.state_tensors().items()}))
        if dispatch == "scan":
            assert trainer.graph_replays == 2 * (3 + 32 + trainer.config.updates_per_iteration)
            assert set(trainer.graphs) == set(fused.PIECES)

    def spread(a, b):
        return max([(a[0] - b[0]).abs().max().item()]
                   + [(a[1][k].float() - b[1][k].float()).abs().max().item() for k in a[1]])

    eager, scan = spread(finals[0], finals[1]), spread(finals[0], finals[2])
    assert (scan == 0.0) if eager == 0.0 else scan <= eager, (eager, scan)


def test_fused_graph_replays_draw_fresh_numbers(device):
    """A replay of the draw and step graphs from one state and the same
    generator states gives the same actions; with the generators advanced,
    other actions: the replays take fresh numbers from the registered
    generators."""
    from rl_selfplay_mnk_tpu_torch.alg.fused import train_block

    trainer = fused_trainer(device)
    train_block(trainer, 0, 1)
    state = trainer.save_state(device)
    actions = []
    for advance in (False, False, True):
        if advance:
            state["generator"] = trainer.generator.get_state()
            state["policy_generator"] = trainer.policy_generator.get_state()
        trainer.load_state(state)
        trainer.replay("draw")
        trainer.replay("step", 4)
        actions.append(trainer.traj["actions"][:4].clone())
    assert torch.equal(actions[0], actions[1])
    assert not torch.equal(actions[0], actions[2])


def test_fused_graph_inserts_only_on_the_cadence(device):
    """The captured masked insert writes a pool slot at iteration 20 and at
    no other: a block over 19 and 20 adds one member with the block's
    weight, a block over 21 and 22 none."""
    from rl_selfplay_mnk_tpu_torch.alg.fused import train_block

    trainer = fused_trainer(device)
    pool = trainer.pool
    before = {k: v.clone() for k, v in pool.tensors().items()}
    train_block(trainer, 19, 2, 0.5)
    assert int(pool.size) == 2 and int(pool.next_idx) == 2
    assert float(pool.weights[1]) == 0.5
    assert not torch.equal(pool.stacked["conv_in.weight"][1], before["stacked/conv_in.weight"][1])
    assert all(torch.equal(pool.stacked[k][i], before[f"stacked/{k}"][i])
               for k in pool.stacked for i in (0, 2, 3))
    after = {k: v.clone() for k, v in pool.tensors().items()}
    train_block(trainer, 21, 2, 0.25)
    assert all(torch.equal(v, after[k]) for k, v in pool.tensors().items())
