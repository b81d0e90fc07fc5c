"""The port's ZeRO-1 learner (``alg/zero_epochs.py``) against the JAX
package's (``parallel/zero.py``, ``alg/zero_epochs.py``): the flat layout
and its padding, the eligibility rule against ``train.create_learner``'s,
and one ZeRO update of ``transformer_b_s`` over the grouped layout with the
watch on, two gloo ranks against JAX's shard_map program on the
conftest's 2-device mesh: parameters within atol 1e-5, rtol 1e-4, metrics
within 1e-5 / 1e-4, the watch record within ``test_torch_watch``'s limits
(flax's LayerNorm loses digits of the gradients, ROADMAP Queue 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl_selfplay_mnk_tpu import env as jenv
from rl_selfplay_mnk_tpu import train as jtrain
from rl_selfplay_mnk_tpu.alg import ppo as jppo
from rl_selfplay_mnk_tpu.alg import zero_epochs as jzero
from rl_selfplay_mnk_tpu.models import create_model_from_architecture as jax_create
from rl_selfplay_mnk_tpu.models import init_network as jax_init
from rl_selfplay_mnk_tpu.parallel.mesh import make_mesh
from rl_selfplay_mnk_tpu.parallel.mesh import shard_batched as jax_shard_batched
from rl_selfplay_mnk_tpu.utils.hardware import detect_hardware_config as jax_hw
from rl_selfplay_mnk_tpu_torch.alg.zero_epochs import FlatLayout, zero_eligible
from rl_selfplay_mnk_tpu_torch.models import create_model_from_architecture, flax_to_state_dict
from rl_selfplay_mnk_tpu_torch.models.convert import flax_param_paths
from rl_selfplay_mnk_tpu_torch.parallel.launch import RankGroup
from test_torch_ppo import make_trajectory

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
MNK = (3, 3, 3)


@pytest.fixture(scope="module")
def transformer_params():
    module, _ = jax_create("transformer_b_s", (2, 3, 3), 9)
    return jax_init(module, (2, 3, 3), jax.random.PRNGKey(0))["params"]


@pytest.mark.parametrize("d", [2, 3, 4])
def test_flat_layout_and_padding_match_jax(d, transformer_params):
    """The flat f32 vector's total and padded length equal JAX's for d
    ranks; each rank's chunk is padded / d; the port's vector, read in the
    JAX package's leaf order, has JAX's leaf sizes; each element's leaf is its segment;
    the unflatten puts every leaf back."""
    params = transformer_params
    _, _, sizes_j, _, padded_j = jzero._flat_layout(params, d)
    flat_j = np.asarray(jzero._flatten_tree(params, padded_j))
    model, _ = create_model_from_architecture("transformer_b_s", (2, 3, 3), 9)
    model.load_state_dict(flax_to_state_dict({"params": jax.tree.map(np.asarray, params)}))
    names = [n for n, _ in model.named_parameters()]
    tensors = [p for _, p in model.named_parameters()]
    layout = FlatLayout(tensors, d)
    assert (layout.total, layout.padded, layout.chunk) == (sum(sizes_j), padded_j, padded_j // d)
    flat = layout.flatten(tensors)
    assert flat.shape == (padded_j,) and torch.all(flat[layout.total:] == 0)
    # Leaf by leaf the same sizes (torch keeps some kernels transposed, so the
    # element order within a leaf is the package's own; AdamW is elementwise).
    paths = flax_param_paths(names)
    sizes = dict(zip((paths[n] for n in names), layout.sizes))
    assert [sizes[p] for p in jppo.tree_path_norms(params)] == list(sizes_j)
    assert np.all(flat_j[layout.total:] == 0)
    segments = torch.cat([layout.segments(r, "cpu") for r in range(d)])
    assert torch.equal(torch.bincount(segments, minlength=len(tensors) + 1)[:len(tensors)],
                       torch.tensor(layout.sizes))
    for t, back in zip(tensors, layout.unflatten(flat)):
        assert torch.equal(t.detach(), back)


@pytest.mark.parametrize("arch,devices,shuffle,requested", [
    ("mlp_tiny", 2, "grouped", True),
    ("mlp_tiny", 2, "tiled", True),
    ("cnn_b_s", 2, "grouped", True),
    ("mlp_tiny", 1, "grouped", True),
    ("mlp_tiny", 2, "grouped", False),
])
def test_zero_eligibility_is_jaxs_rule(arch, devices, shuffle, requested):
    """``zero_eligible`` against the ``zero_update`` that the JAX package's
    ``create_learner`` sets on a mesh of ``devices``."""
    config = jtrain.get_default_config()
    config.update(mnk=MNK, num_envs=8, n_steps=8, batch_size=16, architecture_name=arch,
                  shuffle=shuffle, zero_sharded_optimizer=requested)
    mesh = make_mesh(devices) if devices > 1 else None
    learner = jtrain.create_learner(config, jax_hw(), mesh)[0]
    has_bn = bool(jax.tree.leaves(learner.batch_stats))
    assert zero_eligible(requested, devices, shuffle, has_bn) == learner.config.zero_update


@pytest.fixture(scope="module")
def zero_update():
    """JAX's ZeRO update (prepare + one epoch of four minibatches) on the
    2-device mesh, and the port's over two gloo ranks from the same
    weights, trajectory and indices."""
    e, t, batch, lr = 8, 8, 16, 1e-3
    module, _ = jax_create("transformer_b_s", (2, 3, 3), 9)
    variables = jax.tree.map(np.asarray, jax_init(module, (2, 3, 3), jax.random.PRNGKey(0)))
    params = variables["params"]
    traj, final = make_trajectory(6, t, e, 3, 3)
    cfg = jppo.PPOConfig(env=jenv.EnvConfig(*MNK), num_envs=e, n_steps=t, batch_size=batch,
                         ppo_epochs=1, shuffle="grouped", shard_groups=2, group_size=4,
                         zero_update=True, watch=True, watch_hist_bins=6)
    epoch_keys = jax.random.split(jax.random.PRNGKey(5), 1)
    idx = [np.asarray(jppo._minibatch_indices(cfg, k)).astype(np.int64) for k in epoch_keys]
    ranks = RankGroup("torch_rank_workers:update", 2, dict(
        arch="transformer_b_s", variables=variables, mnk=MNK, traj=traj, final=final,
        epoch_indices=idx, shuffle="grouped", batch_size=batch, lr=lr, zero=True,
        watch_bins=6), device="cpu")
    # JAX's shard_map program while the ranks run.
    mesh = make_mesh(2)
    optimizer = optax.adamw(lambda c: lr, eps=1e-5, weight_decay=0.01)
    _, flats = jppo._update_prepare_impl(
        module, cfg, params, {}, {k: jnp.asarray(v) for k, v in traj.items() if k != "dones"},
        jnp.asarray(traj["dones"]), {k: jnp.asarray(v) for k, v in final.items()})
    flats = jax_shard_batched(flats, mesh, flats["adv"].shape[0])
    opt_state = jax.jit(jzero.zero_opt_init, static_argnames=("optimizer", "mesh"))(
        optimizer, params, mesh)
    params_j, _, sums = jzero.zero_update_epochs(
        module, cfg, optimizer, mesh, params, opt_state, flats, jnp.float32(0.04), epoch_keys,
        jppo.zero_metric_sums(cfg, params))
    fin = jax.tree.map(np.asarray, jppo.finalize_metric_sums(cfg, sums))
    ranks, _ = ranks.wait()
    return dict(params_j=jax.tree.map(np.asarray, params_j), fin=fin, ranks=ranks,
                params0=params, padded=jzero._flat_layout(params, 2)[4])


def test_zero_update_matches_jax_on_the_mesh(zero_update):
    """Parameters (the all-gathered chunks) on both ranks and the global
    metrics; the moments are 2N/d a rank."""
    z = zero_update
    for rank in z["ranks"]:
        assert rank["count"] == 4
        flat = dict(jax.tree_util.tree_flatten_with_path(rank["variables"]["params"])[0])
        for path, x in jax.tree_util.tree_flatten_with_path(z["params_j"])[0]:
            np.testing.assert_allclose(x, flat[path], atol=ATOL, rtol=RTOL,
                                       err_msg=jax.tree_util.keystr(path))
        for key in ("actor_loss", "critic_loss", "entropy_loss", "grad_norm", "approx_kl",
                    "explained_variance", "clip_fraction"):
            np.testing.assert_allclose(float(z["fin"][key]), rank["metrics"][key], atol=ATOL,
                                       rtol=RTOL, err_msg=key)
        assert rank["padded"] == z["padded"] and rank["moments"] == z["padded"]  # 2 x N/2
    moved = np.abs(z["params_j"]["cell_embed"]["kernel"] -
                   z["params0"]["cell_embed"]["kernel"]).max()
    assert moved > 1e-4


def test_zero_watch_record_matches_jax(zero_update):
    """The per-leaf RMS gradient norms and signed-log histograms, recovered
    from each rank's chunk by the leaf segments and summed over the ranks,
    against JAX's: norms within 2e-3 relative + 1e-5, counts equal but for
    at most 4 elements a leaf across a bin edge, the same totals; leaves
    whose gradient is zero in exact arithmetic hold rounding noise below
    1e-6 on both sides (``test_torch_watch``'s rule)."""
    z = zero_update
    want = {f"gradients/{n}/norm": float(v)
            for n, v in jppo.tree_path_norms(z["fin"]["layer_grad_norms"]).items()}
    for n, c in jppo.tree_path_norms(z["fin"]["layer_grad_hists"]).items():
        want[f"gradients/{n}/hist"] = [int(x) for x in c]
    for rank in z["ranks"]:
        got = rank["watch"]
        assert set(got) == set(want)
        for key, w in want.items():
            g = got[key]
            if key.endswith("/norm"):
                if w < 1e-6:
                    assert g < 1e-6, key
                else:
                    assert g == pytest.approx(w, rel=2e-3, abs=1e-5), key
                continue
            leaf_norm = want[key[:-len("/hist")] + "/norm"]
            assert sum(g["counts"]) == sum(w), key
            if leaf_norm >= 1e-6:
                moved = np.abs(np.array(g["counts"]) - np.array(w)).sum() // 2
                assert moved <= 4, (key, g["counts"], w)
