"""The LayerNorm kernels' row plan at every width the registry's models
normalise over, and the wrapper on CPU tensors: the plain version, bit for
bit the port's LayerNorm before the kernels (x cast to f32, F.layer_norm,
cast back; width 1 exactly its bias), forward and gradients, with no launch
counted. The kernels themselves are held to the plain version on the card
(``tests/test_torch_cuda.py``)."""

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from rl_selfplay_mnk_tpu_torch.models.common import LAYER_NORM_EPS
from rl_selfplay_mnk_tpu_torch.models.common import layer_norm as model_layer_norm
from rl_selfplay_mnk_tpu_torch.ops import layer_norm as ln
from rl_selfplay_mnk_tpu_torch.ops.cuda_build import KernelError

torch.set_num_threads(1)

# Every width a registry model normalises over, on 9x9 and 13x13: mlp_tiny's
# value (1) and policy (2) heads, the transformers' d (56, 96, 128, 192,
# 256), the heads' planes over the cells (81, 162; 169, 338) and hidden
# widths (64, 128, 256).
REGISTRY_WIDTHS = (1, 2, 56, 64, 81, 96, 128, 162, 169, 192, 256, 338)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def test_registry_widths_are_the_ones_planned_for():
    from rl_selfplay_mnk_tpu_torch.models.registry import (
        ARCHITECTURE_REGISTRY,
        create_model_from_architecture,
    )

    widths = set()
    for m in (9, 13):
        for name in ARCHITECTURE_REGISTRY:
            model, _ = create_model_from_architecture(name, (2, m, m), m * m)
            widths |= {mod.normalized_shape[0] for mod in model.modules()
                       if isinstance(mod, nn.LayerNorm)}
    assert widths == set(REGISTRY_WIDTHS)
    assert max(widths) <= ln.MAX_WIDTH


def assert_plan_is_the_least(plan, width, itemsize, address):
    """The widest load that fits, the fewest lanes, the fewest loads a lane."""
    row_bytes = width * itemsize
    assert plan.vector_bytes in (16, 8, 4, 2) and plan.vector_bytes >= itemsize
    assert row_bytes % plan.vector_bytes == 0 and address % plan.vector_bytes == 0
    wider = [b for b in (16, 8, 4, 2) if b > plan.vector_bytes]
    assert not any(row_bytes % b == 0 and address % b == 0 for b in wider)
    assert plan.vector_elems * itemsize == plan.vector_bytes
    vectors = width // plan.vector_elems
    assert plan.lanes in (1, 2, 4, 8, 16, 32) and plan.lanes * plan.rows_per_warp == 32
    assert plan.lanes == 32 or (plan.lanes >= vectors and plan.lanes // 2 < vectors)
    per_lane = plan.vectors_per_lane
    assert per_lane in (1, 2, 4, 8, 16)
    assert plan.lanes * per_lane >= vectors and (per_lane == 1 or plan.lanes * per_lane // 2 < vectors)
    # csrc/layer_norm.cu kMaxPerLane: the kernels' largest instantiation
    assert plan.vector_elems * per_lane <= 16


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", REGISTRY_WIDTHS)
def test_row_plan_at_the_registry_widths(width, dtype):
    itemsize = DTYPES[dtype].itemsize
    assert_plan_is_the_least(ln.row_plan(width, itemsize), width, itemsize, 0)


@pytest.mark.parametrize("width,itemsize,plan", [
    (56, 2, (16, 8, 8, 4, 1)),    # the transformers' d in bf16: 7 loads, four rows a warp
    (56, 4, (16, 4, 16, 2, 1)),   # the same in f32
    (64, 2, (16, 8, 8, 4, 1)),
    (96, 2, (16, 8, 16, 2, 1)),
    (128, 2, (16, 8, 16, 2, 1)),
    (128, 4, (16, 4, 32, 1, 1)),  # a warp a row
    (192, 2, (16, 8, 32, 1, 1)),
    (256, 2, (16, 8, 32, 1, 1)),
    (81, 2, (2, 1, 32, 1, 4)),    # odd widths load an element at a time
    (169, 2, (2, 1, 32, 1, 8)),
    (162, 2, (4, 2, 32, 1, 4)),   # 324 bytes: 4-byte loads
    (338, 2, (4, 2, 32, 1, 8)),
    (2, 2, (4, 2, 1, 32, 1)),     # mlp_tiny's policy head: a lane a row
    (1, 2, (2, 1, 1, 32, 1)),
    (512, 4, (16, 4, 32, 1, 4)),  # the widest the kernels take
    (511, 4, (4, 1, 32, 1, 16)),
])
def test_row_plan_examples(width, itemsize, plan):
    assert tuple(ln.row_plan(width, itemsize)) == plan


@pytest.mark.parametrize("address,plan", [
    (0x7f0000000100, (16, 8, 8, 4, 1)),
    (0x7f0000000108, (8, 4, 16, 2, 1)),
    (0x7f0000000104, (4, 2, 32, 1, 1)),
    (0x7f0000000102, (2, 1, 32, 1, 2)),
])
def test_row_plan_narrows_to_the_address(address, plan):
    """d = 56 in bf16, from tensors at addresses 16, 8, 4 and 2-byte aligned."""
    assert tuple(ln.row_plan(56, 2, address)) == plan


def test_row_plan_fits_the_kernels_at_every_width():
    for itemsize in (2, 4):
        for address in (0, itemsize):  # 16-byte aligned, aligned to one element only
            for width in range(1, ln.MAX_WIDTH + 1):
                assert_plan_is_the_least(ln.row_plan(width, itemsize, address), width, itemsize,
                                         address)


@pytest.mark.parametrize("width", [0, ln.MAX_WIDTH + 1, 722])
def test_row_plan_raises_outside_the_kernels_widths(width):
    with pytest.raises(KernelError, match="width"):
        ln.row_plan(width, 2)


def layer_norm_before_the_kernels(x, layer):
    """models/common.py's LayerNorm as it was before the kernels."""
    xf = x.to(torch.float32)
    if layer.normalized_shape == (1,):
        y = (xf - xf) * layer.weight + layer.bias
    else:
        y = F.layer_norm(xf, layer.normalized_shape, layer.weight, layer.bias, layer.eps)
    return y.to(x.dtype)


def norm_and_inputs(width, dtype, seed=0):
    g = torch.Generator().manual_seed(seed + width)
    layer = nn.LayerNorm(width, eps=LAYER_NORM_EPS)
    with torch.no_grad():
        layer.weight.copy_(1.0 + 0.2 * torch.randn(width, generator=g))
        layer.bias.copy_(0.2 * torch.randn(width, generator=g))
    x = (torch.randn(3, 5, width, generator=g) * 2.0 + 1.5).to(dtype)
    dy = torch.randn(3, 5, width, generator=g).to(dtype)
    return layer, x, dy


def forward_and_gradients(fn, layer, x, dy):
    layer.zero_grad()
    x = x.clone().requires_grad_(True)
    y = fn(x, layer)
    y.backward(dy)
    return y.detach(), x.grad, layer.weight.grad.clone(), layer.bias.grad.clone()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", REGISTRY_WIDTHS)
def test_cpu_layer_norm_is_the_plain_path_bit_for_bit(width, dtype):
    layer, x, dy = norm_and_inputs(width, DTYPES[dtype])
    got = forward_and_gradients(model_layer_norm, layer, x, dy)
    want = forward_and_gradients(layer_norm_before_the_kernels, layer, x, dy)
    for name, g, w in zip(("y", "dx", "dweight", "dbias"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    if width == 1:  # exactly the bias, and no gradient into x
        assert torch.equal(got[0], layer.bias.expand_as(got[0]).to(x.dtype))
        assert not got[1].any()


def test_cpu_layer_norm_counts_no_launch():
    layer, x, dy = norm_and_inputs(56, torch.float32)
    before = ln.layer_norm.launches
    forward_and_gradients(model_layer_norm, layer, x, dy)
    with torch.no_grad():
        ln.layer_norm(x, layer.weight, layer.bias, layer.eps)
    assert ln.layer_norm.launches == before


def test_cpu_layer_norm_at_width_two_agrees_with_float64():
    """mlp_tiny's policy norm: two elements, so var = ((x0 - x1) / 2)^2 and
    each normalised element is +-|x0 - x1| / sqrt((x0 - x1)^2 + 4 eps); the
    gradient through it is held to a float64 two-pass computation."""
    layer, x, dy = norm_and_inputs(2, torch.float32)
    got = forward_and_gradients(model_layer_norm, layer, x, dy)
    x64 = x.double().requires_grad_(True)
    w64, b64 = (p.detach().double().requires_grad_(True) for p in (layer.weight, layer.bias))
    mean = x64.mean(-1, keepdim=True)
    var = ((x64 - mean) ** 2).mean(-1, keepdim=True)
    y64 = (x64 - mean) / torch.sqrt(var + layer.eps) * w64 + b64
    y64.backward(dy.double())
    for g, w in zip(got, (y64.detach(), x64.grad, w64.grad, b64.grad)):
        torch.testing.assert_close(g.double(), w, rtol=1e-5, atol=1e-5)
