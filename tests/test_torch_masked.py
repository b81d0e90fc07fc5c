"""The port's masked distribution ops against the JAX package's
(float32 on the CPU; tolerance 1e-6 absolute)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rl_selfplay_mnk_tpu.ops import masked as jm
from rl_selfplay_mnk_tpu_torch.ops import masked as tm

# One intra-op thread: the tensors here are tiny, and several test processes
# with a thread pool each spend their time waiting on one another.
torch.set_num_threads(1)

TOL = 1e-6


def inputs(seed=0, rows=16, a=9):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(rows, a)).astype(np.float32) * 3
    mask = rng.random((rows, a)) < 0.5
    mask[0] = False  # an all-masked row
    mask[1] = True
    mask[2] = False
    mask[2, 4] = True  # a single legal cell
    return logits, mask


def test_mask_logits_log_prob_entropy_match_jax():
    logits, mask = inputs()
    ml_j = jm.mask_logits(jnp.asarray(logits), jnp.asarray(mask))
    ml_t = tm.mask_logits(torch.from_numpy(logits), torch.from_numpy(mask))
    np.testing.assert_array_equal(np.asarray(ml_j), ml_t.numpy())
    assert np.all(ml_t.numpy()[0] == 0.0)  # all-masked row falls back to uniform

    rng = np.random.default_rng(1)
    legal = np.where(mask | ~mask.any(1, keepdims=True), rng.random(mask.shape), -1).argmax(1)
    np.testing.assert_allclose(
        np.asarray(jm.log_prob(ml_j, jnp.asarray(legal))),
        tm.log_prob(ml_t, torch.from_numpy(legal)).numpy(), atol=TOL,
    )
    ent_t = tm.entropy(ml_t)
    np.testing.assert_allclose(np.asarray(jm.entropy(ml_j)), ent_t.numpy(), atol=TOL)
    assert abs(float(ent_t[2])) < TOL  # one legal cell: zero entropy
    np.testing.assert_allclose(float(ent_t[0]), np.log(9), atol=TOL)


def test_entropy_gradient_is_finite_and_matches_jax():
    logits, mask = inputs(2)
    x = torch.from_numpy(logits).requires_grad_(True)
    tm.entropy(tm.mask_logits(x, torch.from_numpy(mask))).sum().backward()
    assert torch.isfinite(x.grad).all()
    gj = jax.grad(lambda l: jm.entropy(jm.mask_logits(l, jnp.asarray(mask))).sum())(
        jnp.asarray(logits)
    )
    np.testing.assert_allclose(np.asarray(gj), x.grad.numpy(), atol=1e-5)


def test_masked_sample_with_injected_noise_is_gumbel_max():
    logits, mask = inputs(3, rows=64)
    u = np.random.default_rng(4).random(logits.shape).astype(np.float32)
    ml = tm.mask_logits(torch.from_numpy(logits), torch.from_numpy(mask))
    got = tm.masked_sample(ml, noise=torch.from_numpy(u)).numpy()
    want = (ml.numpy() - np.log(-np.log(u))).argmax(1)
    np.testing.assert_array_equal(got, want)
    legal_rows = mask.any(1)
    assert mask[legal_rows, got[legal_rows]].all()


def test_random_masked_actions_legal_and_deterministic_matches_jax():
    _, mask = inputs(5, rows=64)
    g = torch.Generator().manual_seed(0)
    acts = tm.random_masked_actions(torch.from_numpy(mask), g).numpy()
    rows = mask.any(1)
    assert mask[rows, acts[rows]].all()
    np.testing.assert_array_equal(
        np.asarray(jm.random_masked_actions(jax.random.PRNGKey(0), jnp.asarray(mask), True)),
        tm.random_masked_actions(torch.from_numpy(mask), deterministic=True).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jm.masked_argmax(jnp.asarray(mask, jnp.float32))),
        tm.masked_argmax(torch.from_numpy(mask).float()).numpy(),
    )
