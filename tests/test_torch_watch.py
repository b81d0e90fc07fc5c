"""The port's watch record (``run.watch`` in the reference) against the JAX
package's: the signed-log gradient histograms on the same arrays, one
update's gradient norms and histograms and the parameters' norms and
histograms from the same weights, trajectory and indices, the keys under
which both log them, and the trainer's watch cadence and flags."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl_selfplay_mnk_tpu import env as jenv
from rl_selfplay_mnk_tpu.alg import ppo as jppo
from rl_selfplay_mnk_tpu.models import create_model_from_architecture as jax_create
from rl_selfplay_mnk_tpu.models import init_network as jax_init
from rl_selfplay_mnk_tpu_torch import env as tenv
from rl_selfplay_mnk_tpu_torch.alg import ppo as tppo
from rl_selfplay_mnk_tpu_torch.models import create_model_from_architecture, flax_to_state_dict
from rl_selfplay_mnk_tpu_torch.models.convert import flax_param_paths
from rl_selfplay_mnk_tpu_torch.train import config_from_args, get_default_config, train_mnk
from rl_selfplay_mnk_tpu_torch.utils.metrics import MetricsLogger
from test_torch_ppo import make_trajectory

# One intra-op thread: the tensors here are tiny, and several test processes
# with a thread pool each spend their time waiting on one another.
torch.set_num_threads(1)


def gradient_like(seed, n):
    """Values over every bin: magnitudes log-uniform from 1e-14 to 1e4 of
    either sign, zeros, and each bin edge with its float32 neighbours."""
    rng = np.random.default_rng(seed)
    x = (10.0 ** rng.uniform(-14, 4, n) * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    edges = np.array(jppo.grad_hist_edges(6), np.float32)
    special = np.concatenate([np.zeros(7, np.float32), edges, np.nextafter(edges, np.inf),
                              np.nextafter(edges, -np.inf)])
    x[:special.size] = special[:n]
    return rng.permutation(x)


@pytest.mark.parametrize("bins", [6, 3])
def test_gradient_histogram_counts_and_edges_equal_jax(bins):
    """The same arrays give the same counts, exactly, and the same edges."""
    assert tppo.grad_hist_edges(bins) == jppo.grad_hist_edges(bins)
    for seed, n in ((0, 200_000), (1, 97), (2, 5000)):
        x = gradient_like(seed, n)
        want = np.asarray(jppo._grad_hist_counts(jnp.asarray(x), bins)).astype(np.int64)
        got = torch.bincount(tppo.grad_hist_index(torch.from_numpy(x), bins),
                             minlength=2 * bins + 1).numpy()
        np.testing.assert_array_equal(got, want)


def test_grad_watch_adds_each_leaf_at_its_offset():
    """``GradWatch`` bins all leaves in one scatter: each leaf's counts are
    its own, and its norm is the RMS of its per-update norms."""
    leaves = [torch.from_numpy(gradient_like(s, n)) for s, n in ((3, 50), (4, 7), (5, 300))]
    watch = tppo.GradWatch(["a/kernel", "b/bias", "c/scale"], leaves, 6)
    for scale in (1.0, 2.0):
        grads = [g * scale for g in leaves]
        watch.add(grads, torch._foreach_norm(grads))
    out = watch.fetch()
    for name, g in zip(("a/kernel", "b/bias", "c/scale"), leaves):
        want = sum(torch.bincount(tppo.grad_hist_index(g * s, 6), minlength=13) for s in (1.0, 2.0))
        assert out[f"gradients/{name}/hist"]["counts"] == want.tolist()
        assert out[f"gradients/{name}/hist"]["edges"] == tppo.grad_hist_edges(6)
        rms = float(torch.sqrt((g.norm() ** 2 + (2 * g).norm() ** 2) / 2))
        assert out[f"gradients/{name}/norm"] == pytest.approx(rms, rel=1e-6)


def watched_update(arch):
    """Prepare + one epoch of 4 minibatches in both packages with the watch
    on, from the same weights, trajectory and indices (the pattern of
    ``test_torch_ppo.one_update_matches_jax``); returns (JAX record, port
    record), each ``gradients/...`` and ``parameters/...`` with 16-bin
    parameter histograms."""
    m = n = k = 3
    e, t, batch = 8, 8, 16
    module, _ = jax_create(arch, (2, m, n), m * n)
    variables = jax.tree.map(np.asarray, jax_init(module, (2, m, n), jax.random.PRNGKey(0)))
    traj, final = make_trajectory(1, t, e, m, n)
    cfg_j = jppo.PPOConfig(env=jenv.EnvConfig(m, n, k), num_envs=e, n_steps=t, batch_size=batch,
                           ppo_epochs=1, watch=True, watch_hist_bins=6)
    cfg_t = tppo.PPOConfig(env=tenv.EnvConfig(m, n, k), num_envs=e, n_steps=t, batch_size=batch,
                           ppo_epochs=1, watch_hist_bins=6)
    lr = 1e-3
    optimizer = optax.chain(optax.clip_by_global_norm(0.5),
                            optax.adamw(lambda c: lr, eps=1e-5, weight_decay=0.01))

    traj_j = {k_: jnp.asarray(v) for k_, v in traj.items() if k_ != "dones"}
    bs_j, flats_j = jppo._update_prepare_impl(
        module, cfg_j, variables["params"], variables["batch_stats"], traj_j,
        jnp.asarray(traj["dones"]), {k_: jnp.asarray(v) for k_, v in final.items()})
    epoch_keys = jax.random.split(jax.random.PRNGKey(5), 1)
    params_j, _, _, sums_j = jppo._update_epochs_impl(
        module, cfg_j, optimizer, variables["params"], bs_j,
        optimizer.init(variables["params"]), flats_j, jnp.float32(0.04), epoch_keys,
        jppo.zero_metric_sums(cfg_j, variables["params"]))
    fin = jppo.finalize_metric_sums(cfg_j, sums_j)
    want = {f"gradients/{name}/norm": float(v)
            for name, v in jppo.tree_path_norms(fin["layer_grad_norms"]).items()}
    for name, counts in jppo.tree_path_norms(fin["layer_grad_hists"]).items():
        want[f"gradients/{name}/hist"] = {"_type": "histogram", "counts": [int(c) for c in counts],
                                          "edges": jppo.grad_hist_edges(6)}
    norms, hists = jppo._param_stats_jit(params_j, 16)
    want.update({f"parameters/{name}/norm": float(v)
                 for name, v in jppo.tree_path_norms(norms).items()})
    flat = jppo.tree_path_norms(hists)
    for name in flat:
        if name.endswith("/counts"):
            base = name[:-len("/counts")]
            want[f"parameters/{base}/hist"] = {"_type": "histogram",
                                               "counts": [int(c) for c in flat[name]],
                                               "edges": [float(x) for x in flat[base + "/edges"]]}
    idx = np.asarray(jppo._minibatch_indices(cfg_j, epoch_keys[0]))

    model, _ = create_model_from_architecture(arch, (2, m, n), m * n)
    model.load_state_dict(flax_to_state_dict(variables))
    opt = tppo.PPOOptimizer(model.parameters(), lambda c: lr)
    learner = tppo.PPOLearner(model, cfg_t, opt, torch.Generator(), "cpu")
    watch = learner.grad_watch()
    flats_t = tppo._update_prepare_impl(model, cfg_t, {k_: torch.from_numpy(np.array(v))
                                                       for k_, v in traj.items()},
                                        {k_: torch.from_numpy(np.array(v)) for k_, v in final.items()})
    tppo._update_epochs_impl(model, cfg_t, opt, flats_t, 0.04,
                             [torch.from_numpy(idx.astype(np.int64))], watch)
    got = watch.fetch()
    got.update(learner.param_stats(16))
    return want, got


@pytest.mark.parametrize("arch", ["resnet_b_s", "transformer_b_s"])
def test_one_watched_update_matches_jax(arch):
    """The same keys, and for every leaf whose gradient is not zero:
    norms within 2e-3 relative + 1e-5 (flax's LayerNorm over the heads' two
    planes loses digits of the gradients, ROADMAP Queue 3, found in the JAX
    package); histogram counts equal but for values that land across a bin
    edge, at most 4 of a leaf's elements, with the same totals; the gradient
    edges equal, the parameter edges within 2e-6 (``jnp.linspace`` and
    ``torch.linspace`` round otherwise).

    Some leaves have a gradient that is zero in exact arithmetic: a conv's
    bias before a BatchNorm, the attention's key bias (the softmax does not
    see it), the value head's first bias before its LayerNorm. Both packages
    log rounding noise there (norms of 1e-9 to 1e-7), whose bins and whose
    AdamW steps are noise too: for those the norms are below 1e-6 on both
    sides and the totals equal."""
    want, got = watched_update(arch)
    assert set(got) == set(want)
    noise = {key.split("/", 1)[1].rsplit("/", 1)[0] for key, w in want.items()
             if key.startswith("gradients/") and key.endswith("/norm") and w < 1e-6}
    assert len(noise) < len([k for k in want if k.startswith("gradients/")]) // 8
    for key, w in want.items():
        g = got[key]
        leaf = key.split("/", 1)[1].rsplit("/", 1)[0]
        if leaf in noise:
            if key.startswith("gradients/") and key.endswith("/norm"):
                assert g < 1e-6, key
            elif key.endswith("/hist"):
                assert sum(g["counts"]) == sum(w["counts"]), key
            continue
        if key.endswith("/norm"):
            assert g == pytest.approx(w, rel=2e-3, abs=1e-5), key
            continue
        assert g["_type"] == "histogram" and sum(g["counts"]) == sum(w["counts"]), key
        moved = np.abs(np.array(g["counts"]) - np.array(w["counts"])).sum() // 2
        assert moved <= 4, (key, g["counts"], w["counts"])
        if key.startswith("gradients/"):
            assert g["edges"] == w["edges"]
        else:
            np.testing.assert_allclose(g["edges"], w["edges"], rtol=2e-6, atol=2e-6, err_msg=key)


def test_watch_keys_are_the_flax_paths_of_every_parameter():
    """Each torch parameter of every family maps to one leaf path of the JAX
    package's ``params`` tree, and the paths are the tree's."""
    for arch in ("transformer_c_s", "cnn_b_s", "mlp_tiny"):  # the two others: above
        module, _ = jax_create(arch, (2, 3, 3), 9)
        params = jax_init(module, (2, 3, 3), jax.random.PRNGKey(0))["params"]
        model, _ = create_model_from_architecture(arch, (2, 3, 3), 9)
        paths = flax_param_paths(name for name, _ in model.named_parameters())
        assert sorted(paths.values()) == sorted(jppo.tree_path_norms(params)), arch
        assert len(paths) == len(list(model.parameters()))


def test_train_mnk_logs_the_watch_record_at_iterations_0_and_20_only(tmp_path):
    config = get_default_config()
    config.update(mnk=(3, 3, 3), num_envs=8, n_steps=8, batch_size=32, ppo_epochs=1,
                  total_environment_steps=8 * 8 * 22, validation_interval=100,
                  architecture_name="mlp_tiny", export_dir=str(tmp_path / "models"),
                  watch_histograms=True)
    assert config["watch_interval"] == 20 and config["watch_grad_hist_bins"] == 6
    with MetricsLogger(run_name="watch", config=config, out_dir=str(tmp_path)) as logger:
        summary = train_mnk(config, logger, device="cpu")
    assert summary["errors"] == []
    records = [json.loads(line) for line in open(logger.jsonl_path)][1:]
    watched = [r for r in records if any(k.startswith("gradients/") for k in r)]
    assert [r["_step"] for r in watched] == [1 * 64, 21 * 64]
    for r in watched:
        assert all(k.startswith(("gradients/", "parameters/")) for k in r if not k.startswith("_"))
        assert {k.rsplit("/", 1)[1] for k in r if not k.startswith("_")} == {"norm", "hist"}
        hist = r["gradients/Dense_0/kernel/hist"]
        assert hist["_type"] == "histogram" and len(hist["counts"]) == 13
        assert sum(hist["counts"]) == 2 * 18 * 64  # two updates of Dense_0's 18 x 64 kernel


def test_trainer_flags_of_the_jax_command_line():
    config = config_from_args(
        "--pool-eviction adaptive --pool-weighted --watch-interval 5 --watch-histograms "
        "--matchmaking pfsp_hard --resume --checkpoint-interval 7".split())
    assert (config["pool_eviction"], config["pool_weighted"], config["watch_interval"],
            config["watch_histograms"], config["matchmaking"], config["resume"],
            config["checkpoint_interval"]) == ("adaptive", True, 5, True, "pfsp_hard", True, 7)
    plain = config_from_args([])
    assert (plain["watch_interval"], plain["matchmaking"], plain["resume"]) == (20, None, False)
    with pytest.raises(SystemExit):
        config_from_args(["--matchmaking", "elo"])
