"""The FLOP, byte and bound arithmetic against hand counts at small
shapes, and the model FLOPs against torch's own count of the reference's
forward."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import reference, spec, yardstick

TINY = {"family": "resnet", "mnk": [3, 3, 3], "channels": 2, "num_blocks": 1, "head_hidden": 4,
        "batchnorm_eps": 1e-5, "layernorm_eps": 1e-6}


def test_forward_flops_by_hand():
    body = 2 * 9 * 9 * 2 * 2 + 2 * (2 * 9 * 9 * 2 * 2)  # conv_in, two block convs
    heads = 2 * 9 * 2 * 3 + (2 * 18 * 4 + 2 * 9 * 4) + (2 * 4 * 9 + 2 * 4)
    assert yardstick.forward_flops(TINY) == body + heads


@pytest.mark.parametrize("name", ["resnet_b_s", "transformer_b_s"])
def test_forward_flops_match_torch_count_of_the_reference(name):
    cfg = spec.load("configs", name)
    weights = reference.make_weights(cfg, 1, "cpu")
    obs = torch.zeros((1, 2, 9, 9))
    with FlopCounterMode(display=False) as counter:
        reference.forward(cfg, weights, obs, True)
    assert counter.get_total_flops() == yardstick.forward_flops(cfg)


@pytest.mark.parametrize("mnk", [(3, 3, 3), (9, 9, 5), (13, 13, 5), (6, 7, 4)])
def test_num_lines_matches_the_reference_lines(mnk):
    assert yardstick.num_lines(*mnk) == reference.line_matrix(*mnk, "cpu").shape[1]


def test_k1_bound_by_hand():
    nbytes = 2 * (2 * 9 * 4 + 4 + 4 + 8 + 1) + 2 * (2 * 9 * 4 + 4 + 4 + 4 + 1 + 9)
    assert nbytes == 366
    assert yardstick.k1_bound_s((3, 3, 3), 2) == pytest.approx(366 / 3.35e12, rel=1e-12)


def test_k2_bound_by_hand():
    nbytes = 2 * (2 * 81 * 32) * 2 + 2 * (9 * 32 * 32) * 2 + 2 * 32 * 4
    ops = 2 * (2 * 2 * 81 * 9 * 32 * 32)
    want = max(nbytes / 3.35e12, ops / 989e12)
    assert yardstick.k2_bound_s((9, 9, 5), 2, 32) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("backward,nbytes,ops", [(False, 4 * 16 * 2, 4 * 2 * 1 * 4 * 4 * 2),
                                                 (True, 7 * 16 * 2, 10 * 2 * 1 * 4 * 4 * 2)])
def test_attention_bound_by_hand(backward, nbytes, ops):
    got = yardstick.attention_bound_s(2, 4, 1, 2, backward)
    assert got == pytest.approx(max(nbytes / 3.35e12, ops / 989e12), rel=1e-12)


def test_iteration_flops_and_kernel_work_count_the_cell():
    cfg, traffic = spec.cell("transformer_b_s.fused384")
    f = yardstick.forward_flops(cfg)
    e, t = 384, 256
    assert yardstick.iteration_flops(cfg, traffic) == f * ((2 * t + 1) * e + 3 * 4 * e * t)
    work = yardstick.kernel_work(cfg, traffic)
    assert set(work) == {"K1", "K3", "K4", "K5"}
    assert work["K5"][1] == pytest.approx(
        (2 * t + 1) * 2 * yardstick.attention_bound_s(e, 81, 4, 14, False))
    assert work["K4"][1] == pytest.approx(48 * 2 * yardstick.attention_bound_s(8192, 81, 4, 14,
                                                                                True))
    cfg, traffic = spec.cell("resnet_b_s.loop8192")
    work = yardstick.kernel_work(cfg, traffic)
    assert set(work) == {"K1", "K2"}
    assert work["K1"][1] == pytest.approx(2 * 32 * yardstick.k1_bound_s((9, 9, 5), 8192))
    assert work["K2"][1] == pytest.approx(32 * 4 * yardstick.k2_bound_s((9, 9, 5), 8192, 32))


def test_busy_time_is_the_union_of_kernel_intervals():
    from portbench import trace

    kernels = [(0.0, 10.0, "a"), (5.0, 12.0, "b"), (20.0, 25.0, "a"), (30.0, 31.0, "c")]
    merged = trace.busy_intervals(kernels)
    assert merged == [[0.0, 12.0], [20.0, 25.0], [30.0, 31.0]]
    assert trace.kernel_seconds(kernels)["a"] == [pytest.approx(15.0 / 1e6), 2]
    gaps = trace.idle_gaps(merged, [(0.0, 40.0, "outer"), (11.0, 22.0, "inner")])
    assert gaps == [["host: inner", 8e-6], ["host: outer", 5e-6]]
    assert math.isclose(sum(e - s for s, e in merged), 18.0)
