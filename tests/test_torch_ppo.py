"""The port's PPO against the JAX package's: GAE, the lr and entropy
schedules, one update (prepare + one epoch) from the same parameters,
trajectory and minibatch indices, and the trainer's run and log keys."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl_selfplay_mnk_tpu import env as jenv
from rl_selfplay_mnk_tpu import train as jtrain
from rl_selfplay_mnk_tpu.alg import ppo as jppo
from rl_selfplay_mnk_tpu.alg.gae import compute_gae as jax_gae
from rl_selfplay_mnk_tpu.alg.schedules import entropy_coef_at as jax_entropy_coef_at
from rl_selfplay_mnk_tpu.alg.schedules import make_lr_schedule as jax_lr_schedule
from rl_selfplay_mnk_tpu.models import create_model_from_architecture as jax_create
from rl_selfplay_mnk_tpu.models import init_network as jax_init
from rl_selfplay_mnk_tpu_torch import env as tenv
from rl_selfplay_mnk_tpu_torch.alg import ppo as tppo
from rl_selfplay_mnk_tpu_torch.alg.gae import compute_gae
from rl_selfplay_mnk_tpu_torch.alg.schedules import entropy_coef_at, make_lr_schedule
from rl_selfplay_mnk_tpu_torch.models import (
    create_model_from_architecture,
    flax_to_state_dict,
    state_dict_to_flax,
)
from rl_selfplay_mnk_tpu_torch.train import get_default_config, train_mnk
from rl_selfplay_mnk_tpu_torch.utils.metrics import MetricsLogger

# One intra-op thread: the tensors here are tiny, and several test processes
# with a thread pool each spend their time waiting on one another.
torch.set_num_threads(1)


def test_gae_matches_jax():
    rng = np.random.default_rng(0)
    t, e = 17, 6
    rewards = rng.choice([-1.0, 0.0, 1.0], size=(t, e)).astype(np.float32)
    values = rng.uniform(-1, 1, size=(t, e)).astype(np.float32)
    dones = rng.random((t, e)) < 0.2
    last = rng.uniform(-1, 1, size=(e,)).astype(np.float32)
    aj, rj = jax_gae(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(dones),
                     jnp.asarray(last), 0.99, 0.95)
    at, rt = compute_gae(torch.from_numpy(rewards), torch.from_numpy(values),
                         torch.from_numpy(dones), torch.from_numpy(last), 0.99, 0.95)
    np.testing.assert_allclose(np.asarray(aj), at.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(rj), rt.numpy(), atol=1e-6)


@pytest.mark.parametrize("decay,warmup", [(False, 5_000_000), (True, 400_000), (True, 0)])
def test_lr_schedule_matches_jax(decay, warmup):
    args = dict(base_lr=5e-4, warmup_env_steps=warmup, total_env_steps=3_000_000,
                num_envs=384, n_steps=256, updates_per_iteration=48, decay=decay)
    sj, st = jax_lr_schedule(**args), make_lr_schedule(**args)
    for count in [0, 1, 47, 48, 100, 48 * 5 - 1, 48 * 17, 48 * 30, 48 * 200]:
        assert st(count) == pytest.approx(float(sj(count)), rel=1e-6)


def test_entropy_schedule_matches_jax():
    cfg = get_default_config()
    for sch in (cfg["entropy_coef_schedule"], {"type": "exponential", "params": {"decay_rate": 0.5}},
                None, {"type": "linear", "params": {"final_coef": 0.001, "total_steps": 1000}}):
        for it in (0, 1, 5, 50, 5000):
            assert entropy_coef_at(0.04, sch, it, 10, 10) == jax_entropy_coef_at(0.04, sch, it, 10, 10)


def make_trajectory(seed, t, e, m, n):
    """A legal-looking trajectory: random boards, their masks, legal actions,
    log-probs near uniform, rewards, values and dones."""
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, 3, size=(t, e, m, n))
    owner[..., 0, 0] = 0  # at least one legal cell
    obs = np.stack([owner == 1, owner == 2], axis=2).astype(np.uint8)
    mask = (owner == 0).reshape(t, e, m * n)
    actions = np.where(mask, rng.random(mask.shape), -1).argmax(-1).astype(np.int32)
    traj = {
        "obs": obs,
        "mask": mask,
        "actions": actions,
        "log_probs": (np.log(1.0 / mask.sum(-1)) + rng.normal(0, 0.1, (t, e))).astype(np.float32),
        "rewards": rng.choice([-1.0, 0.0, 0.0, 1.0], size=(t, e)).astype(np.float32),
        "values": rng.uniform(-0.5, 0.5, size=(t, e)).astype(np.float32),
        "dones": rng.random((t, e)) < 0.15,
    }
    f_owner = rng.integers(0, 3, size=(e, m, n))
    final = {"observation": np.stack([f_owner == 1, f_owner == 2], axis=1).astype(np.float32),
             "action_mask": (f_owner == 0).reshape(e, m * n)}
    return traj, final


def one_update_matches_jax(arch, first_layer):
    """Prepare + one epoch of 4 minibatches with the JAX epoch's own
    indices injected: parameters within 1e-5 (absolute) + 1e-4 (relative)
    after four AdamW steps at lr 1e-3, running statistics within 1e-5."""
    m = n = k = 3
    e, t, batch = 8, 8, 16
    module, _ = jax_create(arch, (2, m, n), m * n)
    variables = jax_init(module, (2, m, n), jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, variables)
    traj, final = make_trajectory(1, t, e, m, n)
    cfg_j = jppo.PPOConfig(env=jenv.EnvConfig(m, n, k), num_envs=e, n_steps=t,
                           batch_size=batch, ppo_epochs=1)
    cfg_t = tppo.PPOConfig(env=tenv.EnvConfig(m, n, k), num_envs=e, n_steps=t,
                           batch_size=batch, ppo_epochs=1)
    lr = 1e-3
    optimizer = optax.chain(optax.clip_by_global_norm(0.5),
                            optax.adamw(lambda c: lr, eps=1e-5, weight_decay=0.01))

    # JAX: prepare, then one epoch with a known key.
    traj_j = {k_: jnp.asarray(v) for k_, v in traj.items() if k_ != "dones"}
    bs_j, flats_j = jppo._update_prepare_impl(
        module, cfg_j, variables["params"], variables["batch_stats"], traj_j,
        jnp.asarray(traj["dones"]), {k_: jnp.asarray(v) for k_, v in final.items()},
    )
    epoch_keys = jax.random.split(jax.random.PRNGKey(5), 1)
    params_j, bs_j, _, sums_j = jppo._update_epochs_impl(
        module, cfg_j, optimizer, variables["params"], bs_j,
        optimizer.init(variables["params"]), flats_j, jnp.float32(0.04), epoch_keys,
        jppo.zero_metric_sums(),
    )
    idx = np.asarray(jppo._minibatch_indices(cfg_j, epoch_keys[0]))

    # Port: the same parameters, trajectory and indices.
    model, _ = create_model_from_architecture(arch, (2, m, n), m * n)
    model.load_state_dict(flax_to_state_dict(variables))
    opt = tppo.PPOOptimizer(model.parameters(), lambda c: lr)
    traj_t = {k_: torch.from_numpy(np.array(v)) for k_, v in traj.items()}
    final_t = {k_: torch.from_numpy(np.array(v)) for k_, v in final.items()}
    flats_t = tppo._update_prepare_impl(model, cfg_t, traj_t, final_t)
    np.testing.assert_allclose(np.asarray(flats_j["adv"]), flats_t["adv"].numpy(), atol=1e-5)
    metrics = tppo._update_epochs_impl(model, cfg_t, opt, flats_t, 0.04,
                                       [torch.from_numpy(idx.astype(np.int64))])
    assert opt.count == cfg_t.num_minibatches == 4

    got = state_dict_to_flax(model.state_dict(), getattr(model, "num_heads", None))
    for tree_j, tree_t, atol, rtol in ((params_j, got["params"], 1e-5, 1e-4),
                                       (bs_j, got["batch_stats"], 1e-5, 1e-5)):
        flat_t = dict(jax.tree_util.tree_flatten_with_path(tree_t)[0])
        for path, x in jax.tree_util.tree_flatten_with_path(tree_j)[0]:
            np.testing.assert_allclose(np.asarray(x), flat_t[path], atol=atol, rtol=rtol,
                                       err_msg=jax.tree_util.keystr(path))
    moved = np.abs(np.asarray(params_j[first_layer]["kernel"]) -
                   np.asarray(variables["params"][first_layer]["kernel"])).max()
    assert moved > 1e-4  # the update did move the parameters
    for key in ("actor_loss", "critic_loss", "entropy_loss", "grad_norm", "approx_kl"):
        np.testing.assert_allclose(float(sums_j[key]) / 4, float(metrics[key]), atol=1e-5, rtol=1e-4)


def test_one_update_matches_jax():
    one_update_matches_jax("resnet_b_s", "Conv_0")


def test_one_transformer_update_matches_jax():
    """The same for ``transformer_b_s``: the update runs the attention's
    backward (the plain version on the CPU) under autograd."""
    one_update_matches_jax("transformer_b_s", "cell_embed")


def test_minibatch_indices_cover_every_row_once():
    cfg = tppo.PPOConfig(env=tenv.EnvConfig(3, 3, 3), num_envs=8, n_steps=16, batch_size=32)
    g = torch.Generator().manual_seed(0)
    idx = tppo._minibatch_indices(cfg, g, "cpu")
    assert idx.shape == (4, 32) and sorted(idx.flatten().tolist()) == list(range(128))
    grouped = tppo.PPOConfig(env=tenv.EnvConfig(3, 3, 3), num_envs=8, n_steps=16,
                             batch_size=32, shuffle="grouped", group_size=8)
    idx = tppo._minibatch_indices(grouped, g, "cpu")
    assert idx.shape == (4, 4) and sorted(idx.flatten().tolist()) == list(range(16))


def jax_training_keys():
    """The metric keys the JAX trainer logs each iteration."""
    keys = []

    class Capture:
        def log(self, metrics, step=None):
            keys.extend(metrics)

    fields = {f: 0.0 for f in ("mean_reward", "mean_length", "actor_loss", "critic_loss",
                               "entropy_loss", "grad_norm", "clip_fraction",
                               "explained_variance", "approx_kl", "fps", "rollout_time",
                               "learn_time")}
    jtrain.log_training_metrics(Capture(), jppo.TrainingMetrics(**fields), 0, 0, 0.0, 0.0, echo=False)
    return set(keys) | {"training/opponent_source"}


def test_train_mnk_cpu_runs_logs_jax_keys_and_validates(tmp_path):
    config = get_default_config()
    config.update(mnk=(3, 3, 3), num_envs=8, n_steps=16, batch_size=32,
                  total_environment_steps=8 * 16 * 6, validation_episodes=16,
                  export_dir=str(tmp_path / "models"))
    with MetricsLogger(run_name="cpu", config=config, out_dir=str(tmp_path)) as logger:
        summary = train_mnk(config, logger, device="cpu")
    assert summary["errors"] == [] and len(summary["iterations"]) == 6
    for it in summary["iterations"]:
        assert all(np.isfinite(v) for v in it.values())
    assert len(summary["validations"]) == 1
    import json

    records = [json.loads(line) for line in open(logger.jsonl_path)][1:]
    logged = set().union(*(set(r) for r in records)) - {"_step", "_time"}
    val_keys = {f"validation/vs_benchmark/{k}" for k in
                ("win_rate", "loss_rate", "draw_rate", "score_rate", "games_played")}
    assert jax_training_keys() | val_keys <= logged
    assert not any(k.startswith("error/") for k in logged)


def test_train_mnk_cpu_runs_a_transformer_with_snapshots_and_validation(tmp_path):
    """Two tiny iterations of a transformer: every opponent is a frozen
    snapshot (no BatchNorm to fold), and the second iteration validates."""
    from rl_selfplay_mnk_tpu_torch.train import build_config

    config = build_config("transformer_b_s", (3, 3, 3), 32, 8 * 16 * 2)
    assert (config["learning_rate"], config["entropy_coef"]) == (12e-4, 0.10)
    config.update(num_envs=8, n_steps=16, validation_episodes=16, validation_interval=1,
                  export_dir=str(tmp_path / "models"))
    with MetricsLogger(run_name="cpu_tfm", config=config, out_dir=str(tmp_path)) as logger:
        summary = train_mnk(config, logger, device="cpu")
    assert summary["errors"] == [] and len(summary["iterations"]) == 2
    for it in summary["iterations"]:
        assert all(np.isfinite(v) for v in it.values())
    assert len(summary["validations"]) == 1
    assert type(summary["model"]).__name__ == "TransformerActorCritic"


def test_build_config_is_the_13x13_recipe():
    """``--arch transformer_b_s_w --mnk 13 13 5 --batch-size 4096`` against the
    JAX package's own 13x13 recipe, key by key."""
    from rl_selfplay_mnk_tpu.train_all import apply_family_hparams
    from rl_selfplay_mnk_tpu_torch.train import build_config, config_from_args

    want = jtrain.get_default_config()
    want.update(architecture_name="transformer_b_s_w", mnk=(13, 13, 5),
                total_environment_steps=600_000_000, batch_size=4096)
    want["entropy_coef_schedule"]["params"]["total_steps"] = 300_000_000
    apply_family_hparams(want, "transformer_b_s_w")
    got = config_from_args("--arch transformer_b_s_w --mnk 13 13 5 --batch-size 4096".split())
    for key in got:
        if key not in ("device", "run_name"):
            assert got[key] == want[key], key
    # The horizons belong to the command line's recipe, not to the board.
    plain = build_config("transformer_b_s_w", (13, 13, 5), 4096)
    assert plain["total_environment_steps"] == jtrain.get_default_config()["total_environment_steps"]
    assert plain["entropy_coef_schedule"]["params"]["total_steps"] == 125_000_000
    short = config_from_args("--mnk 13 13 5 --total-steps 1000".split())
    assert short["total_environment_steps"] == 1000


def test_rollout_with_injected_draws_is_reproducible():
    """Injected sampling noise and side draws fix the rollout: two learners
    with differently seeded generators collect the same trajectory."""
    cfg = tppo.PPOConfig(env=tenv.EnvConfig(3, 3, 3), num_envs=8, n_steps=12, batch_size=32)
    rng = np.random.default_rng(0)
    draws = {"noise": torch.from_numpy(rng.random((12, 8, 9)).astype(np.float32).clip(1e-7)),
             "sides": torch.from_numpy(rng.integers(0, 2, (12, 8)).astype(np.int32))}
    sides0 = torch.from_numpy(rng.integers(0, 2, 8).astype(np.int32))
    from rl_selfplay_mnk_tpu_torch.selfplay import Policy

    first_legal = Policy(apply=lambda p, obs, g=None, d=False: torch.argmax(obs["action_mask"].int(), -1))
    trajs = []
    for seed in (1, 2):
        model, _ = create_model_from_architecture("resnet_b_s", (2, 3, 3), 9)
        model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, jax_init(
            jax_create("resnet_b_s", (2, 3, 3), 9)[0], (2, 3, 3), jax.random.PRNGKey(0)))))
        learner = tppo.PPOLearner(model, cfg, tppo.PPOOptimizer(model.parameters(), lambda c: 1e-3),
                                  torch.Generator().manual_seed(seed), "cpu")
        learner.reset_envs(first_legal, agent_side=sides0)
        trajs.append(learner.rollout(first_legal, draws)[0])
    for key in trajs[0]:
        assert torch.equal(trajs[0][key], trajs[1][key]), key
    assert trajs[0]["dones"].any()
