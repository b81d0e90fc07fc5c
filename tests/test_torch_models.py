"""The port's ResNet against the JAX package's, through the converter:
parameter counts, train-mode forward with the running-statistic update,
eval forward, gradients, BatchNorm folding, and the plain residual-block
kernel against the Pallas kernel in interpret mode. Then the transformer
families (plain, no-FFN speed tier, SGR) the same way: forward, gradients,
parameter counts, the converter's round trip, a committed 13x13 export, and
the distributions ``init_network`` draws from. Then the CNN family and
``mlp_tiny``: forwards in both modes, running statistics, gradients, the
folded forward, the converter's round trip and the parameter counts of all
19 registry names. Float32 on the CPU."""

import pathlib


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from rl_selfplay_mnk_tpu.models import create_model_from_architecture as jax_create
from rl_selfplay_mnk_tpu.models import init_network as jax_init
from rl_selfplay_mnk_tpu.models import make_apply_fns as jax_apply_fns
from rl_selfplay_mnk_tpu.models.fold_bn import fold_batchnorm as jax_fold
from rl_selfplay_mnk_tpu.ops.pallas_resnet import conv_kernel_to_im2col as jax_im2col
from rl_selfplay_mnk_tpu.ops.pallas_resnet import fused_residual_block as jax_resblock
from rl_selfplay_mnk_tpu_torch.models import (
    create_model_from_architecture,
    eval_apply,
    flax_to_state_dict,
    fold_batchnorm,
    init_network,
    snapshot,
    state_dict_to_flax,
)
from rl_selfplay_mnk_tpu_torch.models.common import conv3x3
from rl_selfplay_mnk_tpu_torch.ops.resblock import (
    conv_kernel_to_im2col,
    fused_residual_block,
    fused_residual_block_reference,
)

# One intra-op thread: the tensors here are tiny, and several test processes
# with a thread pool each spend their time waiting on one another.
torch.set_num_threads(1)

# Forward/gradient tolerance: f32 convolutions and reductions in another
# order than XLA's, through 9 conv + BN layers and two LayerNorm heads.
ATOL = RTOL = 1e-4

EXPECTED_PARAMS_9x9 = {
    "resnet_s": 383_291,
    "resnet_l": 2_453_819,
    "resnet_b_s": 118_203,
    "resnet_b_l": 665_627,
    "resnet_b_s_w": 118_587,
    "resnet_b_l_w": 679_739,
}


def count(model):
    return sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("name", sorted(EXPECTED_PARAMS_9x9))
def test_parameter_counts_match_reference(name):
    model, _ = create_model_from_architecture(name, (2, 9, 9), 81)
    assert count(model) == EXPECTED_PARAMS_9x9[name]


def test_parameter_count_13x13():
    model, _ = create_model_from_architecture("resnet_b_s", (2, 13, 13), 169)
    assert count(model) == 163_875


@pytest.mark.parametrize("name", ["cnn_b_s", "cnn_l", "mlp_tiny", "nope"])
def test_unported_or_unknown_names_raise(name):
    """Every name of the JAX registry is ported now; only an unknown one raises."""
    from rl_selfplay_mnk_tpu.models.registry import ARCHITECTURE_REGISTRY as jax_registry

    if name in jax_registry:
        model, params = create_model_from_architecture(name, (2, 9, 9), 81)
        assert count(model) > 0 and params == {"obs_shape": [2, 9, 9], "action_dim": 81}
    else:
        with pytest.raises(ValueError, match="Unknown architecture"):
            create_model_from_architecture(name, (2, 9, 9), 81)


def test_init_network_is_orthogonal_with_head_gains():
    model, _ = create_model_from_architecture("resnet_b_s", (2, 5, 5), 25)
    init_network(model, torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    w = model.blocks[0].conv1.weight.reshape(32, -1)
    np.testing.assert_allclose((w @ w.T).numpy(), 2.0 * np.eye(32), atol=1e-5)
    w = model.heads.policy_head.dense2.weight
    np.testing.assert_allclose((w @ w.T).numpy(), 1e-4 * np.eye(25), atol=1e-8)
    assert float(model.blocks[0].conv1.bias.abs().max()) == 0.0


def jax_variables(seed=0, m=5, n=5):
    """Initialised flax resnet_b_s variables with every leaf perturbed, so
    biases, norms and running statistics are all non-trivial."""
    module, _ = jax_create("resnet_b_s", (2, m, n), m * n)
    variables = jax_init(module, (2, m, n), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        x = np.asarray(x, np.float32)
        if path[-1].key == "var":
            return (x * rng.uniform(0.5, 2.0, x.shape)).astype(np.float32)
        return (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(perturb, variables)
    return module, variables


def port_model(variables, m=5, n=5):
    model, _ = create_model_from_architecture("resnet_b_s", (2, m, n), m * n)
    model.load_state_dict(flax_to_state_dict(variables))
    return model


def boards(seed, b=16, m=5, n=5):
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, 3, size=(b, m, n))
    return np.stack([owner == 1, owner == 2], axis=1).astype(np.float32)


def assert_tree_close(a, b, atol=ATOL, rtol=RTOL):
    flat_a = jax.tree_util.tree_flatten_with_path(a)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert len(flat_a) == len(flat_b)
    for path, x in flat_a:
        np.testing.assert_allclose(np.asarray(x), np.asarray(flat_b[path]), atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


def test_converter_round_trip():
    _, variables = jax_variables(1)
    assert_tree_close(state_dict_to_flax(flax_to_state_dict(variables)), variables, 0, 0)


def test_train_forward_and_batch_stats_match_flax():
    module, variables = jax_variables(2)
    model = port_model(variables)
    obs = boards(3)
    _, train_apply = jax_apply_fns(module)
    (lj, vj), bs_j = train_apply(variables, jnp.asarray(obs))
    lt, vt = model(torch.from_numpy(obs), train=True)
    np.testing.assert_allclose(np.asarray(lj), lt.detach().numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(np.asarray(vj), vt.detach().numpy(), atol=ATOL, rtol=RTOL)
    # flax updates the running variance with the BIASED batch variance.
    assert_tree_close(state_dict_to_flax(model.state_dict())["batch_stats"], bs_j, 1e-5, 1e-5)


def test_eval_forward_matches_flax_and_folding_changes_nothing():
    module, variables = jax_variables(4)
    model = port_model(variables)
    obs = boards(5)
    eval_j, _ = jax_apply_fns(module)
    lj, vj = eval_j(variables, jnp.asarray(obs))
    lfj, vfj = eval_j(jax_fold(variables), jnp.asarray(obs))
    folded = fold_batchnorm(model)
    lt, vt = eval_apply(folded, torch.from_numpy(obs))
    lu, vu = eval_apply(model, torch.from_numpy(obs))  # folds on the way
    with torch.no_grad():  # unfolded plain-conv eval path
        x = torch.relu(model.bn_in(conv3x3(torch.from_numpy(obs), model.conv_in, torch.float32), False))
        for blk in model.blocks:
            x = blk(x, False, torch.float32)
        lc, vc = model.heads(x.permute(0, 2, 3, 1), torch.float32)
    for l, v in ((lj, vj), (lfj, vfj), (lu, vu), (lc, vc)):
        np.testing.assert_allclose(np.asarray(l), lt.numpy(), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(np.asarray(v), vt.numpy(), atol=ATOL, rtol=RTOL)
    assert not model.folded and folded.folded
    assert_tree_close(state_dict_to_flax(model.state_dict()), variables, 0, 0)


def test_gradients_match_flax():
    module, variables = jax_variables(6)
    model = port_model(variables)
    obs = boards(7)
    rng = np.random.default_rng(8)
    r1 = rng.normal(size=(16, 25)).astype(np.float32)
    r2 = rng.normal(size=(16, 1)).astype(np.float32)
    _, train_apply = jax_apply_fns(module)

    def loss_j(params):
        (l, v), _ = train_apply({"params": params, "batch_stats": variables["batch_stats"]},
                                jnp.asarray(obs))
        return jnp.sum(l * r1) + jnp.sum(v * r2)

    grads_j = jax.grad(loss_j)(variables["params"])
    lt, vt = model(torch.from_numpy(obs), train=True)
    ((lt * torch.from_numpy(r1)).sum() + (vt * torch.from_numpy(r2)).sum()).backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    grads.update({k: torch.zeros_like(b) for k, b in model.named_buffers()})
    assert_tree_close(state_dict_to_flax(grads)["params"], grads_j, atol=2e-4, rtol=1e-3)


def test_plain_resblock_matches_pallas_interpret():
    """At tests/test_pallas.py's sizes (8 boards, 5x5, C=16); tolerance as there."""
    rng = np.random.default_rng(0)
    b, m, n, c = 8, 5, 5, 16
    x = rng.normal(size=(b, m, n, c)).astype(np.float32)
    k1 = (rng.normal(size=(3, 3, c, c)) * 0.1).astype(np.float32)
    b1 = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    k2 = (rng.normal(size=(3, 3, c, c)) * 0.1).astype(np.float32)
    b2 = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    want = jax_resblock(
        jnp.asarray(x.reshape(b, m * n, c)), jax_im2col(jnp.asarray(k1)), jnp.asarray(b1),
        jax_im2col(jnp.asarray(k2)), jnp.asarray(b2), m, n, tile_boards=4, interpret=True,
    )
    w1 = conv_kernel_to_im2col(torch.from_numpy(k1.transpose(3, 2, 0, 1).copy()))
    w2 = conv_kernel_to_im2col(torch.from_numpy(k2.transpose(3, 2, 0, 1).copy()))
    np.testing.assert_array_equal(w1.numpy(), np.asarray(jax_im2col(jnp.asarray(k1))))
    args = (torch.from_numpy(x.reshape(b, m * n, c)), w1, torch.from_numpy(b1), w2,
            torch.from_numpy(b2), m, n)
    got = fused_residual_block_reference(*args)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=2e-5, atol=2e-5)
    # On a CPU tensor the wrapper is the plain version.
    np.testing.assert_array_equal(fused_residual_block(*args).numpy(), got.numpy())

    dn = ("NHWC", "HWIO", "NHWC")
    h = jnp.maximum(lax.conv_general_dilated(x, k1, (1, 1), "SAME", dimension_numbers=dn) + b1, 0)
    y = lax.conv_general_dilated(h, k2, (1, 1), "SAME", dimension_numbers=dn) + b2
    np.testing.assert_allclose(np.asarray(jnp.maximum(y + x, 0)).reshape(b, m * n, c),
                               got.numpy(), rtol=2e-5, atol=2e-5)


def test_plain_resblock_matches_unfolded_conv_block():
    _, variables = jax_variables(9)
    model = port_model(variables)
    folded = fold_batchnorm(model)
    rng = np.random.default_rng(10)
    x = torch.from_numpy(np.maximum(rng.normal(size=(6, 32, 5, 5)), 0).astype(np.float32))
    x_cl = x.permute(0, 2, 3, 1).reshape(6, 25, 32).contiguous()
    with torch.no_grad():
        for blk, fblk in zip(model.blocks, folded.blocks):
            want = blk(x, False, torch.float32).permute(0, 2, 3, 1).reshape(6, 25, 32)
            got = fused_residual_block_reference(x_cl, *fblk.kernel_weights, 5, 5)
            np.testing.assert_allclose(want.numpy(), got.numpy(), atol=ATOL, rtol=RTOL)


# The H100's limits as PyTorch reports them: SMs and shared memory per block
# with the opt-in.
H100 = {"sms": 132, "smem_per_block": 232448}


@pytest.mark.parametrize("batch,c,m,boards,slice_channels,whole,threads", [
    (16, 32, 9, 1, 32, True, 192),      # a tournament half-pairing: 16 blocks on 16 SMs
    (1, 32, 9, 1, 32, True, 192),       # one game of play
    (132, 32, 9, 1, 32, True, 192),     # no more boards than SMs: still one a block
    (384, 32, 9, 3, 32, True, 512),     # the rollout: ceil(384 / 132) boards, 16 warps
    (8191, 32, 9, 8, 32, True, 512),    # at most eight a block; warps walk 41 tiles
    (256, 64, 9, 1, 64, True, 192),     # two boards would not fit next to both weights
    (7, 80, 9, 1, 80, False, 192),      # weights of one conv at a time
    (5, 128, 9, 1, 32, False, 192),     # slices of 32 output channels
    (3, 64, 13, 1, 64, True, 352),      # 11 position tiles of 16
    (16, 128, 13, 1, 32, False, 352),
])
def test_resblock_tensor_core_plan_on_an_h100(batch, c, m, boards, slice_channels, whole, threads):
    from rl_selfplay_mnk_tpu_torch.ops.resblock import mma_block_plan, mma_smem_bytes

    plan = mma_block_plan(batch, c, m, m, **H100)
    assert (plan.boards, plan.slice_channels, plan.whole_weights, plan.threads) == (
        boards, slice_channels, whole, threads)
    assert plan.smem_bytes == mma_smem_bytes(c, boards, m, m, slice_channels, whole)
    assert plan.smem_bytes <= H100["smem_per_block"]
    assert c % plan.slice_channels == 0 and plan.slice_channels % 16 == 0


def test_resblock_tensor_core_plan_follows_the_cards_limits():
    from rl_selfplay_mnk_tpu_torch.ops.cuda_build import KernelError
    from rl_selfplay_mnk_tpu_torch.ops.resblock import mma_block_plan

    # A card with 60 KiB a block: 9x9 C = 32 no longer holds both convs' weights.
    small = mma_block_plan(16, 32, 9, 9, sms=132, smem_per_block=61440)
    assert (small.boards, small.slice_channels, small.whole_weights) == (1, 32, False)
    # Fewer SMs: 384 boards come six a block.
    few = mma_block_plan(384, 32, 9, 9, sms=64, smem_per_block=232448)
    assert few.boards == 6 and few.threads == 512
    with pytest.raises(KernelError, match="shared memory"):
        mma_block_plan(1, 128, 13, 13, sms=132, smem_per_block=65536)
    with pytest.raises(ValueError, match="multiple of 16"):
        mma_block_plan(1, 24, 9, 9, **H100)


@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "mma"), (torch.float32, "fma")])
def test_dtype_picks_tensor_cores_for_bf16_and_fma_for_f32(dtype, kernel):
    """K2 and K3 launch the tensor-core kernel for bf16 and the FMA kernel
    (the first version) for f32, whose products on the tensor cores would
    round to TF32."""
    from rl_selfplay_mnk_tpu_torch.ops.attention import folded_fwd_kernel_for
    from rl_selfplay_mnk_tpu_torch.ops.resblock import kernel_for

    assert kernel_for(dtype) == kernel
    assert folded_fwd_kernel_for(dtype) == kernel
    for pick in (kernel_for, folded_fwd_kernel_for):
        with pytest.raises(ValueError, match="unsupported dtype"):
            pick(torch.float16)


# ---------------------------------------------------------------------------
# transformer families
# ---------------------------------------------------------------------------

TRANSFORMERS = ["transformer_b_s", "transformer_b_s_w", "transformer_c_s"]
ALL_TRANSFORMERS = ["transformer_s", "transformer_l", "transformer_b_s", "transformer_b_l",
                    "transformer_c_s", "transformer_c_l", "transformer_b_s_w", "transformer_b_l_w"]
EXPORT = (pathlib.Path(__file__).resolve().parent.parent / "evidence"
          / "exports_full13_transformer_b_s_w" / "model_00340.msgpack")


def jax_transformer(name, seed, m, n):
    """Initialised flax variables with every leaf perturbed, so biases,
    norms and the zero-initialised gates are all non-trivial."""
    module, _ = jax_create(name, (2, m, n), m * n)
    variables = jax_init(module, (2, m, n), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    variables = jax.tree.map(
        lambda x: (np.asarray(x, np.float32) + 0.05 * rng.normal(size=x.shape)).astype(np.float32),
        variables)
    return module, variables


def port_transformer(name, variables, m, n):
    model, _ = create_model_from_architecture(name, (2, m, n), m * n)
    model.load_state_dict(flax_to_state_dict(variables))
    return model


@pytest.mark.parametrize("name", ALL_TRANSFORMERS)
def test_transformer_parameter_counts_match_flax(name):
    module, _ = jax_create(name, (2, 9, 9), 81)
    variables = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 2, 9, 9)), train=False))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(variables))
    model, _ = create_model_from_architecture(name, (2, 9, 9), 81)
    assert count(model) == want


@pytest.mark.parametrize("m", [3, 5])
@pytest.mark.parametrize("name", TRANSFORMERS)
def test_transformer_forward_gradients_and_round_trip_match_flax(name, m):
    module, variables = jax_transformer(name, 11, m, m)
    model = port_transformer(name, variables, m, m)
    assert count(model) == sum(x.size for x in jax.tree.leaves(variables))
    assert_tree_close(state_dict_to_flax(flax_to_state_dict(variables), model.num_heads),
                      variables, 0, 0)

    obs = boards(12, 8, m, m)
    eval_j, train_j = jax_apply_fns(module)
    lj, vj = eval_j(variables, jnp.asarray(obs))
    for train in (False, True):  # no batch-dependent layer: one forward
        lt, vt = model(torch.from_numpy(obs), train=train)
        np.testing.assert_allclose(np.asarray(lj), lt.detach().numpy(), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(np.asarray(vj), vt.detach().numpy(), atol=ATOL, rtol=RTOL)
    frozen = snapshot(model)
    lf, vf = eval_apply(frozen, torch.from_numpy(obs))
    assert torch.equal(lf, lt.detach()) and torch.equal(vf, vt.detach())
    assert frozen is not model and not any(p.requires_grad for p in frozen.parameters())

    rng = np.random.default_rng(13)
    r1 = rng.normal(size=(8, m * m)).astype(np.float32)
    r2 = rng.normal(size=(8, 1)).astype(np.float32)

    def loss_j(params):
        (l, v), _ = train_j({"params": params, "batch_stats": {}}, jnp.asarray(obs))
        return jnp.sum(l * r1) + jnp.sum(v * r2)

    grads_j = jax.grad(loss_j)(variables["params"])
    ((lt * torch.from_numpy(r1)).sum() + (vt * torch.from_numpy(r2)).sum()).backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert_tree_close(state_dict_to_flax(grads, model.num_heads)["params"], grads_j,
                      atol=2e-4, rtol=1e-3)


def test_committed_13x13_export_gives_the_same_forward():
    """A committed export of the 13x13 run (d128, H2, no FFN), read by the
    JAX package's loader, through the converter: the two forwards agree."""
    from rl_selfplay_mnk_tpu.utils.model_export import load_any_model

    module, variables, metadata = load_any_model(str(EXPORT.parent), EXPORT.stem)
    assert metadata.architecture_name == "transformer_b_s_w"
    variables = jax.tree.map(lambda x: np.asarray(x, np.float32), dict(variables))
    model = port_transformer("transformer_b_s_w", variables, 13, 13)
    obs = boards(14, 2, 13, 13)
    eval_j, _ = jax_apply_fns(module)
    lj, vj = eval_j(variables, jnp.asarray(obs))
    lt, vt = eval_apply(model, torch.from_numpy(obs))
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(np.asarray(vj), vt.numpy(), atol=ATOL, rtol=RTOL)
    assert float(np.abs(lt.numpy()).max()) > 0.1  # trained weights, not an init


@pytest.mark.parametrize("name", ["transformer_l", "transformer_c_l"])
def test_init_network_transformer_distributions(name):
    """torch's generator gives other numbers than JAX's, so the two inits are
    held together by their distributions: the body at flax's default
    (truncated normal of variance 1 / fan_in), embeddings normal(0.02), the
    SGR gates at their constants, the heads orthogonal."""
    model, _ = create_model_from_architecture(name, (2, 9, 9), 81)
    init_network(model, torch.Generator().manual_seed(0))
    module, _ = jax_create(name, (2, 9, 9), 81)
    params = jax_init(module, (2, 9, 9), jax.random.PRNGKey(0))["params"]
    flax = state_dict_to_flax(model.state_dict(), model.num_heads)["params"]
    block = "SGRBlock_0" if "SGRBlock_0" in params else "EncoderLayer_0"

    def std(tree, *path):
        for key in path:
            tree = tree[key]
        return float(np.asarray(tree).std())

    attn = "MultiHeadDotProductAttention_0"
    body = [(block, attn, "query", "kernel"), (block, attn, "out", "kernel"),
            (block, "Dense_0", "kernel"), (block, "Dense_1", "kernel")]
    d = params["cell_embed"]["kernel"].shape[1]
    for path, fan_in in zip(body, (d, d, d, 4 * d)):
        assert std(flax, *path) == pytest.approx(fan_in**-0.5, rel=0.03), path
        assert std(flax, *path) == pytest.approx(std(params, *path), rel=0.05), path
        bias = np.asarray(flax[path[0]][path[1]][path[2]]["bias"] if len(path) == 4
                          else flax[path[0]][path[1]]["bias"])
        assert float(np.abs(bias).max()) == 0.0
    w = model.layers[0].attn.query.weight.detach()
    assert float(w.abs().max()) <= 2.0 * d**-0.5 / 0.87962566103423978 + 1e-6  # truncated at 2 sigma
    assert std(flax, "pos_embed") == pytest.approx(0.02, rel=0.03)
    assert std(flax, "pos_embed") == pytest.approx(std(params, "pos_embed"), rel=0.05)
    # The cell embedding has 2 * d values: a loose bound on its std, and the reference's.
    assert std(flax, "cell_embed", "kernel") == pytest.approx(0.02, rel=0.2)
    assert float(np.abs(flax["cell_embed"]["bias"]).max()) == 0.0
    if block == "SGRBlock_0":
        for gate in ("gate1", "gate2"):
            np.testing.assert_array_equal(flax[block][gate]["kernel"], params[block][gate]["kernel"])
            np.testing.assert_array_equal(flax[block][gate]["bias"], params[block][gate]["bias"])
            assert float(flax[block][gate]["bias"][0]) == 2.0
    np.testing.assert_array_equal(flax[block]["LayerNorm_0"]["scale"], 1.0)
    w = model.heads.policy_head.dense2.weight.detach()
    np.testing.assert_allclose((w @ w.T).numpy(), 1e-4 * np.eye(81), atol=1e-8)
    w = model.heads.value_head.dense1.weight.detach()  # (hidden, 81): orthonormal columns * sqrt 2
    np.testing.assert_allclose((w.T @ w).numpy(), 2.0 * np.eye(81), atol=1e-5)


# ---------------------------------------------------------------------------
# the CNN family and mlp_tiny
# ---------------------------------------------------------------------------


def jax_model(name, seed, m, n):
    """Initialised flax variables of any registry name with every leaf
    perturbed (running variances scaled, so they stay positive)."""
    module, _ = jax_create(name, (2, m, n), m * n)
    variables = jax_init(module, (2, m, n), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        x = np.asarray(x, np.float32)
        if path[-1].key == "var":
            return (x * rng.uniform(0.5, 2.0, x.shape)).astype(np.float32)
        return (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32)

    return module, jax.tree_util.tree_map_with_path(perturb, variables)


def test_registry_holds_the_jax_names_with_the_same_parameter_counts():
    from rl_selfplay_mnk_tpu.models.registry import ARCHITECTURE_REGISTRY as jax_registry
    from rl_selfplay_mnk_tpu_torch.models import ARCHITECTURE_REGISTRY

    assert sorted(ARCHITECTURE_REGISTRY) == sorted(jax_registry) and len(jax_registry) == 19


@pytest.mark.parametrize("name", ["cnn_s", "cnn_l", "cnn_b_s", "cnn_b_l", "mlp_tiny"])
def test_cnn_and_mlp_parameter_counts_match_flax(name):
    module, _ = jax_create(name, (2, 9, 9), 81)
    variables = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 2, 9, 9)), train=False))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(variables["params"]))
    model, _ = create_model_from_architecture(name, (2, 9, 9), 81)
    assert count(model) == want


@pytest.mark.parametrize("name,m", [("cnn_b_s", 5), ("cnn_s", 3), ("mlp_tiny", 3), ("mlp_tiny", 5)])
def test_cnn_and_mlp_forwards_statistics_gradients_and_folding_match_flax(name, m):
    module, variables = jax_model(name, 21, m, m)
    model, _ = create_model_from_architecture(name, (2, m, m), m * m)
    model.load_state_dict(flax_to_state_dict(variables))
    assert_tree_close(state_dict_to_flax(model.state_dict()), variables, 0, 0)
    obs = boards(22, 16, m, m)
    eval_j, train_j = jax_apply_fns(module)

    # Eval mode: running statistics; the folded copy gives the same, as in flax.
    lj, vj = eval_j(variables, jnp.asarray(obs))
    lfj, vfj = eval_j(jax_fold(variables), jnp.asarray(obs))
    frozen = snapshot(model)
    assert not any(p.requires_grad for p in frozen.parameters())
    assert getattr(frozen, "folded", False) == name.startswith("cnn")
    for lt, vt in (eval_apply(model, torch.from_numpy(obs)), eval_apply(frozen, torch.from_numpy(obs))):
        for want_l, want_v in ((lj, vj), (lfj, vfj)):
            np.testing.assert_allclose(np.asarray(want_l), lt.numpy(), atol=ATOL, rtol=RTOL)
            np.testing.assert_allclose(np.asarray(want_v), vt.numpy(), atol=ATOL, rtol=RTOL)
    if name.startswith("cnn"):
        folded_flax = state_dict_to_flax(frozen.state_dict())
        assert_tree_close(folded_flax, jax.tree.map(np.asarray, jax_fold(variables)), 1e-5, 1e-5)

    # Train mode: batch statistics, the running ones updated, and the gradients.
    rng = np.random.default_rng(23)
    r1 = rng.normal(size=(16, m * m)).astype(np.float32)
    r2 = rng.normal(size=(16, 1)).astype(np.float32)

    def loss_j(params):
        (l, v), stats = train_j({"params": params, "batch_stats": variables["batch_stats"]},
                                jnp.asarray(obs))
        return jnp.sum(l * r1) + jnp.sum(v * r2), ((l, v), stats)

    (_, ((lj, vj), stats_j)), grads_j = jax.value_and_grad(loss_j, has_aux=True)(variables["params"])
    lt, vt = model(torch.from_numpy(obs), train=True)
    np.testing.assert_allclose(np.asarray(lj), lt.detach().numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(np.asarray(vj), vt.detach().numpy(), atol=ATOL, rtol=RTOL)
    assert_tree_close(state_dict_to_flax(model.state_dict())["batch_stats"], stats_j, 1e-5, 1e-5)
    ((lt * torch.from_numpy(r1)).sum() + (vt * torch.from_numpy(r2)).sum()).backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    grads.update({k: torch.zeros_like(b) for k, b in model.named_buffers()})
    got = state_dict_to_flax(grads)["params"]
    if name == "mlp_tiny":
        # The value head normalises one element: exactly its bias.
        assert float(model.heads.value_head.ln1.weight.grad.abs().max()) == 0.0
        # The policy head normalises two elements (one token, two planes): y is
        # +-1 up to eps / (d^2 + eps), and the gradient that reaches the plane
        # projection, and through it the trunk (the value head passes none
        # back), is made of that remainder alone (about 1e-3 here). flax's
        # variance, E[x^2] - E[x]^2 in f32, loses those digits; F.layer_norm
        # keeps them. So these leaves are held against the same layers in
        # float64, and against flax only to the size of its own error.
        want = mlp_policy_path_gradients_float64(model, obs, r1)
        pairs = {
            "Dense_0": (got.pop("Dense_0"), grads_j.pop("Dense_0")),
            "plane_proj": (got["ActorCriticHeads_0"]["policy_head"].pop("plane_proj"),
                           grads_j["ActorCriticHeads_0"]["policy_head"].pop("plane_proj")),
        }
        for layer, (ours, flax_s) in pairs.items():
            for leaf in ("kernel", "bias"):
                np.testing.assert_allclose(ours[leaf], want[layer][leaf], atol=2e-5, rtol=1e-3)
                np.testing.assert_allclose(ours[leaf], np.asarray(flax_s[leaf]), atol=2e-3, rtol=0)
    assert_tree_close(got, grads_j, atol=2e-4, rtol=1e-3)


def mlp_policy_path_gradients_float64(model, obs, r1):
    """d(sum(logits * r1)) / d(trunk Dense, plane_proj) of ``mlp_tiny`` through
    its policy head, every step in float64 and the variance in two passes;
    leaves in flax's layout."""
    def layer_norm(x, ln):
        c = x - x.mean(-1, keepdim=True)
        return (c * torch.rsqrt((c * c).mean(-1, keepdim=True) + ln.eps)
                * ln.weight.detach().double() + ln.bias.detach().double())

    def leaves(layer, grad):
        return [t.detach().double().requires_grad_(grad) for t in (layer.weight, layer.bias)]

    head = model.heads.policy_head
    dense, proj = leaves(model.dense, True), leaves(head.plane_proj, True)
    x = torch.from_numpy(obs).double().reshape(obs.shape[0], -1)
    x = torch.relu(F.linear(x, *dense))
    x = torch.relu(layer_norm(F.linear(x, *proj), head.ln1))
    x = torch.relu(layer_norm(F.linear(x, *leaves(head.dense1, False)), head.ln2))
    (F.linear(x, *leaves(head.dense2, False)) * torch.from_numpy(r1).double()).sum().backward()
    return {name: {"kernel": w.grad.T.float().numpy(), "bias": b.grad.float().numpy()}
            for name, (w, b) in (("Dense_0", dense), ("plane_proj", proj))}


@pytest.mark.parametrize("route", ["folded", "infold"])
def test_attention_fn_reaches_every_layer_and_changes_nothing_on_the_cpu(route):
    """A transformer built with a forced route calls it in every layer; on
    the CPU every route is the same function."""
    from rl_selfplay_mnk_tpu_torch.ops.attention import tiny_head_attention

    calls = []

    def forced(q, k, v):
        calls.append(q.shape)
        return tiny_head_attention(q, k, v, route=route)

    _, variables = jax_transformer("transformer_c_s", 31, 3, 3)
    plain = port_transformer("transformer_c_s", variables, 3, 3)
    model, _ = create_model_from_architecture("transformer_c_s", (2, 3, 3), 9, attention_fn=forced)
    model.load_state_dict(plain.state_dict())
    obs = torch.from_numpy(boards(32, 4, 3, 3))
    want = eval_apply(plain, obs)
    got = eval_apply(model, obs)
    assert calls == [(4, 9, 4, 14)] * 2
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=1e-6, rtol=1e-6)
    assert eval_apply(snapshot(model), obs)[0].shape == (4, 9) and len(calls) == 4
