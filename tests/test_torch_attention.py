"""The port's attention (plain versions, used on CPU tensors) against the JAX
package's Pallas kernels in interpret mode and its XLA reference, on the
same numpy arrays: the folded and the packed pair, forward and backward,
``tiny_head_attention`` with its autograd gradient through both branches of
the dispatch, then the one-block-per-board kernels' plain versions (lane
slice, in-kernel fold), the kernel each forward takes by dtype and the
block-unit rule of the tensor-core board kernels, the kernel each backward
takes by dtype, ``attention_infold`` against ``jax.grad`` and the
dispatch's choice of route. Float32 on the CPU, and bf16 to pin where p and
ds are rounded, in the folded, the packed and the in-kernel-fold pair."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_selfplay_mnk_tpu.ops import pallas_attention as jattn
from rl_selfplay_mnk_tpu_torch.ops import attention as tattn
from rl_selfplay_mnk_tpu_torch.ops.cuda_build import KernelError

# One intra-op thread: the tensors here are tiny, and several test processes
# with a thread pool each spend their time waiting on one another.
torch.set_num_threads(1)

# As tests/test_pallas_attention.py: f32 sums in another order.
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
BWD_TOL = dict(rtol=2e-4, atol=2e-4)


def arrays(seed, shape, n):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def to_torch(xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def test_folded_forward_matches_pallas_interpret_and_xla():
    xs = arrays(0, (12, 14, 25), 3)
    got = tattn.attention_folded_reference(*to_torch(xs)).numpy()
    js = [jnp.asarray(x) for x in xs]
    np.testing.assert_allclose(
        got, np.asarray(jattn._attention_fwd_pallas(*js, tile_heads=4, interpret=True)), **FWD_TOL)
    np.testing.assert_allclose(got, np.asarray(jattn._attention_xla(*js)), **FWD_TOL)
    # On CPU tensors the wrapper and the autograd function are the plain version.
    np.testing.assert_array_equal(tattn.attention_folded_fwd(*to_torch(xs)).numpy(), got)
    np.testing.assert_array_equal(tattn.attention_folded(*to_torch(xs)).numpy(), got)


def test_folded_backward_matches_pallas_interpret():
    xs = arrays(1, (8, 14, 25), 4)
    want = jattn._attention_bwd_pallas(*[jnp.asarray(x) for x in xs], tile_heads=4, interpret=True)
    got = tattn.attention_folded_bwd_reference(*to_torch(xs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL)
    for g, w in zip(tattn.attention_folded_bwd(*to_torch(xs)), got):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("b,l,h,dh", [(2, 25, 4, 14), (2, 25, 2, 64)])
def test_packed_pair_matches_pallas_interpret(b, l, h, dh):
    xs = arrays(2, (b, l, h * dh), 4)
    js = [jnp.asarray(x) for x in xs]
    want = jattn._attention_packed_fwd_pallas(*js[:3], h=h, dh=dh, tile_batch=2, interpret=True)
    got = tattn.attention_packed_reference(*to_torch(xs[:3]), h, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    np.testing.assert_array_equal(tattn.attention_packed_fwd(*to_torch(xs[:3]), h, dh).numpy(),
                                  got.numpy())
    want = jattn._attention_packed_bwd_pallas(*js, h=h, dh=dh, tile_batch=2, interpret=True)
    got = tattn.attention_packed_bwd_reference(*to_torch(xs), h, dh)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL)
    for g, w in zip(tattn.attention_packed_bwd(*to_torch(xs), h, dh), got):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_folded_and_packed_are_one_function():
    b, l, h, dh = 3, 9, 2, 8
    q, k, v, g = to_torch(arrays(3, (b, l, h, dh), 4))

    def fold(t):
        return t.permute(0, 2, 3, 1).reshape(b * h, dh, l)

    def unfold(t):
        return t.reshape(b, h, dh, l).permute(0, 3, 1, 2).reshape(b, l, h * dh)

    pack = [t.reshape(b, l, h * dh) for t in (q, k, v, g)]
    np.testing.assert_allclose(
        unfold(tattn.attention_folded_reference(fold(q), fold(k), fold(v))).numpy(),
        tattn.attention_packed_reference(*pack[:3], h, dh).numpy(), rtol=1e-6, atol=1e-6)
    for a, c in zip(tattn.attention_folded_bwd_reference(*(fold(t) for t in (q, k, v, g))),
                    tattn.attention_packed_bwd_reference(*pack, h, dh)):
        np.testing.assert_allclose(unfold(a).numpy(), c.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,l,h,dh,branch", [(2, 9, 2, 8, "folded"), (2, 9, 2, 32, "packed")])
def test_tiny_head_attention_and_gradient_match_jax(b, l, h, dh, branch, monkeypatch):
    """Both branches of the dispatch: the forward and the autograd gradient
    (through the Function's backward) against the JAX function and jax.grad
    with its kernels in interpret mode."""
    xs = arrays(4, (b, l, h, dh), 4)
    w = jnp.asarray(xs[3])

    def loss_j(q, k, v):
        return jnp.sum(jattn.tiny_head_attention(q, k, v, interpret=True) * w)

    js = [jnp.asarray(x) for x in xs[:3]]
    want = jattn.tiny_head_attention(*js, interpret=True)
    want_grads = jax.grad(loss_j, argnums=(0, 1, 2))(*js)

    calls = []
    for name in ("attention_folded_bwd", "attention_packed_bwd"):
        inner = getattr(tattn, name)
        monkeypatch.setattr(tattn, name,
                            lambda *a, _inner=inner, _name=name: calls.append(_name) or _inner(*a))
    leaves = [t.requires_grad_(True) for t in to_torch(xs[:3])]
    got = tattn.tiny_head_attention(*leaves)
    assert got.shape == (b, l, h, dh)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)
    (got * torch.from_numpy(xs[3])).sum().backward()
    assert calls == [f"attention_{branch}_bwd"]
    for t, wg in zip(leaves, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg), **BWD_TOL)


def test_function_saves_inputs_only_and_casts_the_gradient():
    q, k, v = (t.requires_grad_(True) for t in to_torch(arrays(5, (4, 8, 9), 3), torch.bfloat16))
    out = tattn.attention_folded(q, k, v)
    assert out.dtype == torch.bfloat16
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3 and all(s.shape == q.shape for s in saved)
    g = torch.from_numpy(arrays(6, (4, 8, 9), 1)[0])  # an f32 gradient
    out.backward(g.to(torch.bfloat16))
    want = tattn.attention_folded_bwd_reference(q.detach(), k.detach(), v.detach(),
                                                g.to(torch.bfloat16))
    for t, w in zip((q, k, v), want):
        assert t.grad.dtype == torch.bfloat16 and torch.equal(t.grad, w)
    with torch.no_grad():
        assert tattn.attention_folded(q, k, v).grad_fn is None


def test_bf16_rounding_points_match_pallas_interpret():
    """bf16 inputs: p is rounded to bf16 before P.V and before dv, ds before
    dq and dk, and the outputs to bf16. Held against the Pallas kernels in
    interpret mode within two bf16 ulps of the result's size (one from each
    side's sum order flipping a rounding), far below what a missing rounding
    point would move."""
    xs = arrays(7, (6, 14, 25), 4)
    ts = to_torch(xs, torch.bfloat16)
    js = [jnp.asarray(x).astype(jnp.bfloat16) for x in xs]
    tol = dict(rtol=2.0**-7, atol=2.0**-7)
    want = jattn._attention_fwd_pallas(*js[:3], tile_heads=2, interpret=True)
    got = tattn.attention_folded_reference(*ts[:3])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)
    want = jattn._attention_bwd_pallas(*js, tile_heads=2, interpret=True)
    for g, w in zip(tattn.attention_folded_bwd_reference(*ts), want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)), **tol)
    # The rounding points themselves: the plain version's p~ and ds~ are bf16 values.
    q, k, v, do = (t.transpose(1, 2) for t in ts)
    p = tattn._probabilities_reference(q, k)
    o_unrounded_p = torch.matmul(p, v.float()).to(torch.bfloat16)
    assert not torch.equal(o_unrounded_p.transpose(1, 2), got)


@pytest.mark.parametrize("b,l,h,dh", [(2, 25, 2, 64), (2, 25, 4, 14)])
def test_packed_bf16_rounding_points_match_pallas_interpret(b, l, h, dh):
    """The packed forward with bf16 inputs: p is rounded to bf16 before P.V
    and the output to bf16, as ``_packed_fwd_kernel`` does. Held against it in
    interpret mode within two bf16 ulps of the result's size, as the folded
    pair above; the tensor-core K8 follows these rounding points."""
    xs = arrays(18, (b, l, h * dh), 3)
    ts = to_torch(xs, torch.bfloat16)
    js = [jnp.asarray(x).astype(jnp.bfloat16) for x in xs]
    want = jattn._attention_packed_fwd_pallas(*js, h=h, dh=dh, tile_batch=2, interpret=True)
    got = tattn.attention_packed_reference(*ts, h, dh)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2.0**-7, atol=2.0**-7)
    # The rounding point itself: with p left in f32 the output is another one.
    q, k, v = (tattn._packed_to_heads(t, h, dh) for t in ts)
    p = tattn._probabilities_reference(q, k)
    o_unrounded_p = tattn._heads_to_packed(torch.matmul(p, v.float()).to(torch.bfloat16), b, h)
    assert not torch.equal(o_unrounded_p, got)


@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "mma"), (torch.float32, "fma")])
def test_packed_forward_kernel_follows_the_dtype(dtype, kernel):
    """K8 takes the tensor-core kernel for bf16 and the FMA kernel (its first
    version) for f32, whose products on the tensor cores would round to TF32."""
    assert tattn.packed_fwd_kernel_for(dtype) == kernel
    with pytest.raises(ValueError, match="attention_packed_fwd: unsupported dtype"):
        tattn.packed_fwd_kernel_for(torch.float16)


@pytest.mark.parametrize("kernel", [None, "mma", "fma"])
def test_packed_forward_on_cpu_tensors_is_the_plain_version_for_any_kernel(kernel):
    xs = to_torch(arrays(19, (2, 9, 2 * 32), 3), torch.bfloat16)
    before = tattn.attention_packed_fwd.launches
    got = tattn.attention_packed_fwd(*xs, 2, 32, kernel=kernel)
    assert tattn.attention_packed_fwd.launches == before
    assert torch.equal(got, tattn.attention_packed_reference(*xs, 2, 32))


@pytest.mark.parametrize("b,l,h,dh", [(2, 25, 2, 64), (2, 25, 4, 14)])
def test_packed_bwd_bf16_rounding_points_match_pallas_interpret(b, l, h, dh):
    """The packed backward with bf16 inputs: row = rowsum(dp * p) over the f32
    p, ds rounded to bf16 before dq and dk, p rounded to bf16 before dv, and
    the outputs to bf16, as ``_packed_bwd_kernel`` does. Held against it in
    interpret mode within two bf16 ulps of the result's size, as the forward
    above; the tensor-core K9 follows these rounding points."""
    xs = arrays(20, (b, l, h * dh), 4)
    ts = to_torch(xs, torch.bfloat16)
    js = [jnp.asarray(x).astype(jnp.bfloat16) for x in xs]
    want = jattn._attention_packed_bwd_pallas(*js, h=h, dh=dh, tile_batch=2, interpret=True)
    got = tattn.attention_packed_bwd_reference(*ts, h, dh)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                   rtol=2.0**-7, atol=2.0**-7)
    # The rounding points themselves: with ds left in f32, dq and dk are
    # other ones; with p left in f32, dv is another one.
    q, k, v, do = (tattn._packed_to_heads(t, h, dh).float() for t in ts)
    p = tattn._probabilities_reference(q, k)
    dp = torch.matmul(do, v.transpose(1, 2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) / dh**0.5

    def packed(t):
        return tattn._heads_to_packed(t.to(torch.bfloat16), b, h)

    assert not torch.equal(packed(torch.matmul(ds, k)), got[0])
    assert not torch.equal(packed(torch.matmul(ds.transpose(1, 2), q)), got[1])
    assert not torch.equal(packed(torch.matmul(p.transpose(1, 2), do)), got[2])


@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "mma"), (torch.float32, "fma")])
def test_packed_backward_kernel_follows_the_dtype(dtype, kernel):
    """K9 takes the tensor-core kernel for bf16 and the FMA kernel (its first
    version) for f32, whose products on the tensor cores would round to TF32."""
    assert tattn.packed_bwd_kernel_for(dtype) == kernel
    with pytest.raises(ValueError, match="attention_packed_bwd: unsupported dtype"):
        tattn.packed_bwd_kernel_for(torch.float16)


@pytest.mark.parametrize("kernel", [None, "mma", "fma"])
def test_packed_backward_on_cpu_tensors_is_the_plain_version_for_any_kernel(kernel):
    xs = to_torch(arrays(21, (2, 9, 2 * 32), 4), torch.bfloat16)
    before = tattn.attention_packed_bwd.launches
    got = tattn.attention_packed_bwd(*xs, 2, 32, kernel=kernel)
    assert tattn.attention_packed_bwd.launches == before
    for g, w in zip(got, tattn.attention_packed_bwd_reference(*xs, 2, 32)):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the one-block-per-board kernels' plain versions (lane slice, in-kernel fold)
# ---------------------------------------------------------------------------

BOARD_SHAPES = [(4, 81, 8, 12), (2, 25, 4, 14)]  # as tests/test_pallas_attention.py


@pytest.mark.parametrize("b,l,h,dh", BOARD_SHAPES)
def test_lane_slice_forward_matches_pallas_interpret(b, l, h, dh):
    xs = arrays(8, (b, l, h * dh), 3)
    want = jattn._attention_lane_slice_fwd_pallas(
        *[jnp.asarray(x) for x in xs], h=h, dh=dh, tile_batch=2, interpret=True)
    got = tattn.attention_lane_slice_reference(*to_torch(xs), h, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    # On CPU tensors the wrapper is the plain version, and counts no launch.
    before = tattn.attention_lane_slice_fwd.launches
    np.testing.assert_array_equal(
        tattn.attention_lane_slice_fwd(*to_torch(xs), h, dh).numpy(), got.numpy())
    assert tattn.attention_lane_slice_fwd.launches == before


@pytest.mark.parametrize("b,l,h,dh", BOARD_SHAPES)
def test_infold_pair_matches_pallas_interpret(b, l, h, dh):
    xs = arrays(9, (b, l, h * dh), 4)
    js = [jnp.asarray(x) for x in xs]
    want = jattn._attention_infold_fwd_pallas(*js[:3], h=h, dh=dh, tile_batch=2, interpret=True)
    got = tattn.attention_infold_reference(*to_torch(xs[:3]), h, dh)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    np.testing.assert_array_equal(tattn.attention_infold_fwd(*to_torch(xs[:3]), h, dh).numpy(),
                                  got.numpy())
    want = jattn._attention_infold_bwd_pallas(*js, h=h, dh=dh, tile_batch=2, interpret=True)
    got = tattn.attention_infold_bwd_reference(*to_torch(xs), h, dh)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL)
    for g, w in zip(tattn.attention_infold_bwd(*to_torch(xs), h, dh), got):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("b,l,h,dh", BOARD_SHAPES)
def test_infold_pair_bf16_rounding_points_match_pallas_interpret(b, l, h, dh):
    """The in-kernel-fold pair with bf16 inputs: p rounded to bf16 before P.V
    and dv, row = rowsum(dp * p) over the f32 p, ds rounded to bf16 before dq
    and dk, the outputs to bf16, as ``_infold_fwd_kernel`` and
    ``_infold_bwd_kernel`` do. Held against them in interpret mode within two
    bf16 ulps of the result's size, as the packed pair above; the
    tensor-core K6 and K7 are held against these plain versions on the
    card."""
    xs = arrays(24, (b, l, h * dh), 4)
    ts = to_torch(xs, torch.bfloat16)
    js = [jnp.asarray(x).astype(jnp.bfloat16) for x in xs]
    tol = dict(rtol=2.0**-7, atol=2.0**-7)
    want = jattn._attention_infold_fwd_pallas(*js[:3], h=h, dh=dh, tile_batch=2, interpret=True)
    got = tattn.attention_infold_reference(*ts[:3], h, dh)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)
    want = jattn._attention_infold_bwd_pallas(*js, h=h, dh=dh, tile_batch=2, interpret=True)
    got = tattn.attention_infold_bwd_reference(*ts, h, dh)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)), **tol)
    # The rounding points themselves: with ds left in f32, dq and dk are
    # other ones; with p left in f32, dv is another one.
    q, k, v, do = (tattn._packed_to_heads(t, h, dh).float() for t in ts)
    p = tattn._probabilities_reference(q, k)
    dp = torch.matmul(do, v.transpose(1, 2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) / dh**0.5

    def packed(t):
        return tattn._heads_to_packed(t.to(torch.bfloat16), b, h)

    assert not torch.equal(packed(torch.matmul(ds, k)), got[0])
    assert not torch.equal(packed(torch.matmul(ds.transpose(1, 2), q)), got[1])
    assert not torch.equal(packed(torch.matmul(p.transpose(1, 2), do)), got[2])


@pytest.mark.parametrize("name", ["lane_slice_fwd", "infold_fwd"])
@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "mma"), (torch.float32, "fma")])
def test_board_forward_kernel_follows_the_dtype(name, dtype, kernel):
    """K5 and K6 take the tensor-core kernel for bf16 and the FMA kernel (their
    first version) for f32, whose products on the tensor cores would round to
    TF32."""
    kernel_for = getattr(tattn, f"{name}_kernel_for")
    assert kernel_for(dtype) == kernel
    with pytest.raises(ValueError, match=f"attention_{name}: unsupported dtype"):
        kernel_for(torch.float16)


@pytest.mark.parametrize("kernel", [None, "mma", "fma"])
@pytest.mark.parametrize("name", ["lane_slice", "infold"])
def test_board_forward_on_cpu_tensors_is_the_plain_version_for_any_kernel(name, kernel):
    xs = to_torch(arrays(22, (2, 9, 4 * 14), 3), torch.bfloat16)
    wrapper = getattr(tattn, f"attention_{name}_fwd")
    before = wrapper.launches
    got = wrapper(*xs, 4, 14, kernel=kernel)
    assert wrapper.launches == before
    assert torch.equal(got, getattr(tattn, f"attention_{name}_reference")(*xs, 4, 14))


@pytest.mark.parametrize("name", ["lane_slice", "infold"])
def test_board_forward_rejects_an_unknown_kernel(name):
    xs = to_torch(arrays(23, (2, 9, 2 * 8), 3), torch.bfloat16)
    with pytest.raises(ValueError, match="unknown kernel 'wgmma'"):
        getattr(tattn, f"attention_{name}_fwd")(*xs, 2, 8, kernel="wgmma")


@pytest.mark.parametrize("name", ["folded_bwd", "infold_bwd"])
@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "mma"), (torch.float32, "fma")])
def test_backward_kernel_follows_the_dtype(name, dtype, kernel):
    """K4 and K7 take the tensor-core kernel for bf16 and the FMA kernel
    (their first version) for f32, whose products on the tensor cores would
    round to TF32."""
    kernel_for = getattr(tattn, f"{name}_kernel_for")
    assert kernel_for(dtype) == kernel
    with pytest.raises(ValueError, match=f"attention_{name}: unsupported dtype"):
        kernel_for(torch.float16)


def backward_call(name, seed, h=4, dh=14):
    """The wrapper of K4 or K7 and its plain version, with bf16 inputs in
    its layout, as a function of ``kernel``."""
    if name == "folded_bwd":
        xs = to_torch(arrays(seed, (2 * h, dh, 9), 4), torch.bfloat16)
        return (lambda **kw: tattn.attention_folded_bwd(*xs, **kw),
                lambda: tattn.attention_folded_bwd_reference(*xs))
    xs = to_torch(arrays(seed, (2, 9, h * dh), 4), torch.bfloat16)
    return (lambda **kw: tattn.attention_infold_bwd(*xs, h, dh, **kw),
            lambda: tattn.attention_infold_bwd_reference(*xs, h, dh))


@pytest.mark.parametrize("kernel", [None, "mma", "fma"])
@pytest.mark.parametrize("name", ["folded_bwd", "infold_bwd"])
def test_backward_on_cpu_tensors_is_the_plain_version_for_any_kernel(name, kernel):
    wrapper = getattr(tattn, f"attention_{name}")
    call, plain = backward_call(name, 25)
    before = wrapper.launches
    got = call(kernel=kernel)
    assert wrapper.launches == before
    for g, w in zip(got, plain()):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["folded_bwd", "infold_bwd"])
def test_backward_rejects_an_unknown_kernel(name):
    call, _ = backward_call(name, 26, h=2, dh=8)
    with pytest.raises(ValueError, match="unknown kernel 'wgmma'"):
        call(kernel="wgmma")


class FakeBoardLib:
    """The shared-memory sizes and limits of csrc/attention_board.cu, as a
    card-free stand-in: a K6 block of n heads takes 20,000 n bytes, a K7
    block 28,000 n."""

    def board_attn_max_tokens(self):
        return 192

    def board_attn_max_head_dim(self):
        return 64

    def attn_infold_fwd_mma_smem_bytes(self, l, dh, heads):
        return 20_000 * heads

    def attn_infold_bwd_mma_smem_bytes(self, l, dh, heads):
        return 28_000 * heads


@pytest.mark.parametrize("kernel,b,per_block,blocks_per_board", [
    ("lane_slice_fwd", 8192, 6, 1),  # more boards than fit at once: a board a block
    ("lane_slice_fwd", 384, 6, 1),   # 384 of 528 resident
    ("lane_slice_fwd", 256, 3, 2),   # 512 of 528
    ("lane_slice_fwd", 16, 1, 6),    # every query tile its own block
    ("infold_fwd", 8192, 3, 2),      # at most three heads fit the budget
    ("infold_fwd", 200, 2, 2),       # 400 of 528 with two heads; 800 with one
    ("infold_fwd", 100, 1, 4),       # 400 of 528 with one head
    ("infold_fwd", 16, 1, 4),
])
def test_board_mma_plan_splits_a_board_while_all_blocks_stay_resident(
        monkeypatch, kernel, b, per_block, blocks_per_board):
    """The rule of ``board_mma_plan`` at 9x9 with four heads of 14 on a card
    of 132 SMs: the fewest units a block with which every block is resident
    at once, else the most (K6 within its shared-memory budget)."""
    blocks_an_sm = {"lane_slice_fwd": {n: 4 for n in range(1, 7)},
                    "infold_fwd": {1: 4, 2: 4, 3: 3}}
    monkeypatch.setattr(tattn, "_board_lib", FakeBoardLib)
    monkeypatch.setattr(tattn, "_board_mma_resources", lambda kernel, l, h, dh, n, device: (
        128, 0, 20_000 * n, blocks_an_sm[kernel][n]))
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: SimpleNamespace(
        multi_processor_count=132, shared_memory_per_block_optin=232_448))
    plan = tattn.board_mma_plan.__wrapped__(kernel, b, 81, 4, 14, "cuda")
    assert (plan.per_block, plan.blocks_per_board, plan.blocks) == (
        per_block, blocks_per_board, b * blocks_per_board)
    assert plan.unit == ("query tiles" if kernel == "lane_slice_fwd" else "heads")


@pytest.mark.parametrize("b,per_block,blocks_per_board", [
    (8192, 2, 2),  # more boards than fit at once: at most two heads fit the budget
    (256, 2, 2),   # 512 of 528 resident with two heads a block
    (100, 1, 4),   # 400 of 528 with one head
    (16, 1, 4),    # a tournament half-pairing: every head its own block
])
def test_board_mma_plan_splits_the_backward_by_heads(monkeypatch, b, per_block, blocks_per_board):
    """K7 (``"infold_bwd"``) at 9x9 with four heads of 14 on a card of 132
    SMs: the backward needs all of a head's queries, so its unit is heads, as
    K6's; the same rule, within the shared-memory budget of K6."""
    blocks_an_sm = {1: 4, 2: 4}
    monkeypatch.setattr(tattn, "_board_lib", FakeBoardLib)
    monkeypatch.setattr(tattn, "_board_mma_resources", lambda kernel, l, h, dh, n, device: (
        168, 0, 28_000 * n, blocks_an_sm[n]))
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: SimpleNamespace(
        multi_processor_count=132, shared_memory_per_block_optin=232_448))
    plan = tattn.board_mma_plan.__wrapped__("infold_bwd", b, 81, 4, 14, "cuda")
    assert (plan.unit, plan.per_block, plan.blocks_per_board, plan.blocks) == (
        "heads", per_block, blocks_per_board, b * blocks_per_board)


def test_board_mma_plan_raises_where_a_block_cannot_fit(monkeypatch):
    monkeypatch.setattr(tattn, "_board_lib", FakeBoardLib)
    monkeypatch.setattr(tattn, "_board_mma_resources",
                        lambda *args: (168, 0, 240_000, 0))
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: SimpleNamespace(
        multi_processor_count=132, shared_memory_per_block_optin=232_448))
    with pytest.raises(KernelError, match="240000 bytes of shared memory"):
        tattn.board_mma_plan.__wrapped__("lane_slice_fwd", 16, 169, 8, 64, "cuda")
    with pytest.raises(KernelError, match="beyond the kernel's"):
        tattn.board_mma_plan.__wrapped__("infold_fwd", 16, 200, 4, 14, "cuda")
    with pytest.raises(KernelError, match="240000 bytes of shared memory"):
        tattn.board_mma_plan.__wrapped__("infold_bwd", 16, 169, 8, 64, "cuda")
    with pytest.raises(KernelError, match="beyond the kernel's"):
        tattn.board_mma_plan.__wrapped__("infold_bwd", 16, 81, 4, 96, "cuda")


def test_board_plain_versions_are_the_packed_function():
    """Column slices, row slices of the transposed board and the packed
    reshape separate the same heads: one function, three ways to write it."""
    b, l, h, dh = 3, 9, 4, 6
    ts = to_torch(arrays(10, (b, l, h * dh), 4))
    packed = tattn.attention_packed_reference(*ts[:3], h, dh)
    for fn in (tattn.attention_lane_slice_reference, tattn.attention_infold_reference):
        np.testing.assert_allclose(fn(*ts[:3], h, dh).numpy(), packed.numpy(), rtol=1e-6, atol=1e-6)
    for g, w in zip(tattn.attention_infold_bwd_reference(*ts, h, dh),
                    tattn.attention_packed_bwd_reference(*ts, h, dh)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,l,h,dh", [(2, 25, 4, 14), (2, 9, 8, 12)])
def test_attention_infold_and_gradient_match_jax(b, l, h, dh, monkeypatch):
    """``attention_infold`` (the forward, and autograd through the Function's
    backward) against the JAX package's ``_attention_infold`` and jax.grad
    with its kernels in interpret mode; then the same through the forced
    route of ``tiny_head_attention``."""
    xs = arrays(11, (b, l, h * dh), 4)
    w = jnp.asarray(xs[3])

    def loss_j(q, k, v):
        return jnp.sum(jattn._attention_infold(q, k, v, h, dh, 2, True) * w)

    js = [jnp.asarray(x) for x in xs[:3]]
    want = jattn._attention_infold(*js, h, dh, 2, True)
    want_grads = jax.grad(loss_j, argnums=(0, 1, 2))(*js)

    calls = []
    inner = tattn.attention_infold_bwd
    monkeypatch.setattr(tattn, "attention_infold_bwd",
                        lambda *a: calls.append("attention_infold_bwd") or inner(*a))
    leaves = [t.requires_grad_(True) for t in to_torch(xs[:3])]
    got = tattn.attention_infold(*leaves, h, dh)
    saved = got.grad_fn.saved_tensors
    assert len(saved) == 3 and all(s.shape == leaves[0].shape for s in saved)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)
    (got * torch.from_numpy(xs[3])).sum().backward()
    assert calls == ["attention_infold_bwd"]
    for t, wg in zip(leaves, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg), **BWD_TOL)

    forced = [t.detach().clone().reshape(b, l, h, dh).requires_grad_(True) for t in leaves]
    out = tattn.tiny_head_attention(*forced, route="infold")
    np.testing.assert_array_equal(out.detach().reshape(b, l, h * dh).numpy(), got.detach().numpy())
    (out * torch.from_numpy(xs[3]).reshape(b, l, h, dh)).sum().backward()
    assert calls == ["attention_infold_bwd"] * 2
    for t, first in zip(forced, leaves):
        np.testing.assert_array_equal(t.grad.reshape(b, l, h * dh).numpy(), first.grad.numpy())


def test_infold_function_casts_the_gradient_to_the_inputs_type():
    q, k, v = (t.requires_grad_(True) for t in to_torch(arrays(12, (2, 9, 16), 3), torch.bfloat16))
    out = tattn.attention_infold(q, k, v, 2, 8)
    assert out.dtype == torch.bfloat16
    g = torch.from_numpy(arrays(13, (2, 9, 16), 1)[0])
    torch.autograd.backward(out, g.to(torch.bfloat16))
    want = tattn.attention_infold_bwd_reference(q.detach(), k.detach(), v.detach(),
                                                g.to(torch.bfloat16), 2, 8)
    for t, w in zip((q, k, v), want):
        assert t.grad.dtype == torch.bfloat16 and torch.equal(t.grad, w)


@pytest.mark.parametrize("route,dh", [("folded", 14), ("infold", 14), (None, 14), (None, 32)],
                         ids=["folded", "infold", "lane_slice", "packed"])
def test_every_route_is_the_same_function_without_a_gradient(route, dh):
    """The two routes a caller can force and the two the dispatch takes by
    itself without a gradient (Dh < 32: lane slice; Dh >= 32: packed)."""
    b, l, h = 2, 9, 4
    q, k, v = to_torch(arrays(14, (b, l, h, dh), 3))
    want = tattn.attention_packed_reference(*(t.reshape(b, l, h * dh) for t in (q, k, v)), h, dh)
    with torch.no_grad():
        got = tattn.tiny_head_attention(q, k, v, route=route)
    assert got.shape == (b, l, h, dh)
    np.testing.assert_allclose(got.reshape(b, l, h * dh).numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_dispatch_takes_the_forward_only_kernel_without_a_gradient(monkeypatch):
    """Dh < 32: no gradient recorded -> the lane-slice forward on the packed
    interface (the packed forward past ``LANE_SLICE_MAX_HEAD_ROWS`` head rows
    a board); a gradient recorded -> ``GRADIENT_ROUTE``; Dh >= 32 -> the
    packed pair either way. Only the routes of ``ROUTES`` can be forced."""
    calls = []
    for name in ("attention_folded_fwd", "attention_infold_fwd", "attention_packed_fwd",
                 "attention_lane_slice_fwd"):
        inner = getattr(tattn, name)
        monkeypatch.setattr(tattn, name,
                            lambda *a, _inner=inner, _name=name: calls.append(_name) or _inner(*a))
    q, k, v = (t.requires_grad_(True) for t in to_torch(arrays(15, (2, 9, 2, 8), 3)))
    with torch.no_grad():
        out = tattn.tiny_head_attention(q, k, v)
    assert out.grad_fn is None
    tattn.tiny_head_attention(q.detach(), k.detach(), v.detach())
    tattn.tiny_head_attention(q, k, v)
    wide = to_torch(arrays(16, (2, 9, 2, 32), 3))
    with torch.no_grad():
        tattn.tiny_head_attention(*wide)
    assert calls == ["attention_lane_slice_fwd", "attention_lane_slice_fwd",
                     f"attention_{tattn.GRADIENT_ROUTE}_fwd", "attention_packed_fwd"]
    del calls[:]
    many = [t.requires_grad_(True) for t in to_torch(arrays(17, (1, 169, 8, 12), 3))]  # 13x13, d96
    assert 4 * 169 <= tattn.LANE_SLICE_MAX_HEAD_ROWS < 8 * 169
    with torch.no_grad():
        tattn.tiny_head_attention(*many)
        tattn.tiny_head_attention(*(t[:, :, :4] for t in many))
    tattn.tiny_head_attention(*many)
    assert calls == ["attention_packed_fwd", "attention_lane_slice_fwd",
                     f"attention_{tattn.GRADIENT_ROUTE}_fwd"]
    assert tattn.ROUTES == ("folded", "infold")
    for route in ("lane_slice", "packed", "xla"):
        with pytest.raises(ValueError, match="route must be one of"):
            tattn.tiny_head_attention(q, k, v, route=route)


def test_backward_study_numerics_draws_every_seed_given(monkeypatch):
    """``attn_bwd_study --numerics --seeds`` reaches ``inputs(..., seed=)``
    once a shape and seed, and the worst shares it returns cover dq, dk and
    dv against the plain version and the f64 computation. On the CPU the
    wrappers are the plain versions, so the shares against the plain version
    are 0; no timing or card is involved."""
    from rl_selfplay_mnk_tpu_torch.utils import attn_bwd_study as study

    args = study.parse_args(["--numerics", "--seeds", "0", "5", "11", "--kernels", "packed_bwd"])
    assert (args.numerics, args.seeds, args.kernels) == (True, [0, 5, 11], ["packed_bwd"])
    assert study.parse_args(["--numerics"]).seeds == [0]
    assert {(8192, 81, 4, 14), (2048, 169, 8, 12)} <= set(study.NUMERICS_SHAPES["packed_bwd"])
    shapes = ((2, 9, 2, 14), (1, 25, 3, 12))
    monkeypatch.setitem(study.NUMERICS_SHAPES, "packed_bwd", shapes)
    drawn, inputs = [], study.inputs

    def recording(b, l, h, dh, dev, seed=0, folded=False):
        drawn.append(((b, l, h, dh), seed))
        return inputs(b, l, h, dh, dev, seed=seed, folded=folded)

    monkeypatch.setattr(study, "inputs", recording)
    worst = study.numerics(torch.device("cpu"), args.kernels, args.seeds)
    assert drawn == [(shape, seed) for shape in shapes for seed in (0, 5, 11)]
    assert set(worst) == {("packed_bwd", shape) for shape in shapes}
    for shares in worst.values():
        assert shares["plain"] == {"dq": 0.0, "dk": 0.0, "dv": 0.0}
        assert set(shares["f64"]) == {"dq", "dk", "dv"}
        assert all(0.0 <= x < float("inf") for x in shares["f64"].values())
    # Another seed draws other inputs.
    assert not torch.equal(inputs(2, 9, 2, 14, "cpu", seed=0)[0], inputs(2, 9, 2, 14, "cpu", seed=5)[0])
