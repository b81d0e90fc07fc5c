"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they build the kernels with nvcc and need an NVIDIA card,
so they skip on a machine without CUDA. On the card::

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from rl_selfplay_mnk_tpu_torch.env import EnvConfig, make_env_state
from rl_selfplay_mnk_tpu_torch.ops.env_step import fused_step, fused_step_reference
from rl_selfplay_mnk_tpu_torch.ops.resblock import (
    fused_residual_block,
    fused_residual_block_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("mnk,e", [((3, 3, 3), 8191), ((9, 9, 5), 384), ((13, 13, 5), 33)])
def test_env_step_kernel_bitwise(device, mnk, e):
    cfg = EnvConfig(*mnk)
    rng = np.random.default_rng(0)
    state = make_env_state(cfg, e, device)
    mask = np.ones((e, cfg.num_actions), bool)
    for _ in range(cfg.num_actions + 2):
        actions = torch.as_tensor(np.where(mask, rng.random(mask.shape), -1).argmax(1), device=device)
        active = torch.as_tensor(rng.random(e) < 0.8, device=device)
        before = fused_step.launches
        got = fused_step(cfg, state, actions, active)
        assert fused_step.launches == before + 1
        want = fused_step_reference(cfg, state, actions, active)
        for g, w in zip(list(got[0]) + list(got[1:]), list(want[0]) + list(want[1:])):
            assert g.dtype == w.dtype and torch.equal(g, w)
        state = got[0]
        mask = got[3].cpu().numpy()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2.0**-6)])
@pytest.mark.parametrize("b,m,c", [(384, 9, 32), (7, 9, 80), (5, 9, 128), (3, 13, 64)])
def test_resblock_kernel_within_tolerance(device, dtype, tol, b, m, c):
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.relu(torch.randn(b, m * m, c, device=device, generator=g)).to(dtype)
    w1 = (torch.randn(9 * c, c, device=device, generator=g) * 0.1).to(dtype)
    w2 = (torch.randn(9 * c, c, device=device, generator=g) * 0.1).to(dtype)
    b1 = torch.randn(c, device=device, generator=g) * 0.1
    b2 = torch.randn(c, device=device, generator=g) * 0.1
    got = fused_residual_block(x, w1, b1, w2, b2, m, m).float()
    want = fused_residual_block_reference(x, w1, b1, w2, b2, m, m).float()
    assert ((got - want).abs() <= tol + tol * want.abs()).all()
