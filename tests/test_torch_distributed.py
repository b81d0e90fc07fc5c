"""The port's data-parallel layer (``parallel/mesh.py``, the learner over
ranks in ``alg/ppo.py``, the trainers' multi-process paths) against the
JAX package on the conftest's virtual CPU mesh (``make_mesh(2)``), the
port's ranks on gloo, each group of ranks in processes of its own
(``parallel/launch.py``, at most 120 s, killed past it).

Pure functions: the env slice against ``shard_batched``'s shards at d = 2
and 4 and its guards; the shard-local grouped and the tiled layouts
against ``_minibatch_indices`` and ``_update_prepare_impl``. Two ranks
against JAX on the mesh: one rollout with train-mode BatchNorm, one
replicated update of a BatchNorm network, parameters within atol 1e-5,
rtol 1e-4 and metrics within 1e-5 / 1e-4 (``tests/test_torch_ppo.py``'s
one-rank limits). The trainers: world 2 against world 1 through
``train_mnk`` and the fused step driver in the same layout, rank-0-only
writes, a world-2 checkpoint resumed under world 1, and the refusals."""

import dataclasses
import json
import os

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
from rl_selfplay_mnk_tpu.ops import masked as jmasked
from rl_selfplay_mnk_tpu.parallel.mesh import env_sharding, make_mesh, replicated_sharding
from rl_selfplay_mnk_tpu.parallel.mesh import shard_batched as jax_shard_batched
from rl_selfplay_mnk_tpu.selfplay import wrapper as jw
from rl_selfplay_mnk_tpu_torch import env as tenv
from rl_selfplay_mnk_tpu_torch.alg import ppo as tppo
from rl_selfplay_mnk_tpu_torch.parallel.launch import RankGroup
from rl_selfplay_mnk_tpu_torch.parallel.mesh import env_shard, shard_batched
from rl_selfplay_mnk_tpu_torch.train import config_from_args, get_default_config, train_mnk
from rl_selfplay_mnk_tpu_torch.train_fused import resolve_dispatch, train_mnk_fused
from test_torch_ppo import make_trajectory

torch.set_num_threads(1)

WORKERS = "torch_rank_workers"
ATOL, RTOL = 1e-5, 1e-4
MNK = (3, 3, 3)


def assert_trees_close(want, got, atol=ATOL, rtol=RTOL):
    flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, x in jax.tree_util.tree_flatten_with_path(want)[0]:
        np.testing.assert_allclose(np.asarray(x), np.asarray(flat[path]), atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


# -- pure functions ---------------------------------------------------------


@pytest.mark.parametrize("d", [2, 4])
def test_env_slice_is_shard_batcheds_shard(d):
    """Rank r's rows are the shard ``shard_batched`` puts on device r; the
    replicated leaves stay whole."""
    rng = np.random.default_rng(d)
    tree = {"boards": rng.integers(0, 2, (8, 2, 3, 3)).astype(np.float32),
            "side": rng.integers(0, 2, (8,)).astype(np.int32),
            "table": rng.random((3, 5)).astype(np.float32)}
    placed = jax_shard_batched(tree, make_mesh(d), batch_size=8)
    for r in range(d):
        got = shard_batched({k: torch.from_numpy(v) for k, v in tree.items()}, d, r, 8)
        dev = make_mesh(d).devices[r]
        for k, leaf in placed.items():
            shard = next(s for s in leaf.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(np.asarray(shard.data), got[k].numpy(), err_msg=k)
        shard = env_shard(8, d, r)
        assert (shard.start, shard.stop) == (r * 8 // d, (r + 1) * 8 // d)


@pytest.mark.parametrize("leading", [(8, 4), (3, 5), (8, 3)])
def test_shard_batched_ambiguous_nests_raise_as_jax(leading):
    """Without ``batch_size``: two divisible leading dims, none, or one
    beside a non-divisible leaf raise in both packages."""
    tree = {"a": np.zeros((leading[0], 2), np.float32), "b": np.zeros((leading[1],), np.float32)}
    with pytest.raises(ValueError):
        jax_shard_batched(tree, make_mesh(2))
    with pytest.raises(ValueError):
        shard_batched({k: torch.from_numpy(v) for k, v in tree.items()}, 2, 0)


def jax_layout(shuffle, t=8, e=8, batch=16, group=4, seed=3):
    cfg = jppo.PPOConfig(env=jenv.EnvConfig(*MNK), num_envs=e, n_steps=t, batch_size=batch,
                         shuffle=shuffle, shard_groups=2, group_size=group)
    module, _ = jax_create("mlp_tiny", (2, 3, 3), 9)
    variables = jax_init(module, (2, 3, 3), jax.random.PRNGKey(0))
    traj, final = make_trajectory(seed, t, e, 3, 3)
    _, flats = jppo._update_prepare_impl(
        module, cfg, variables["params"], {},
        {k: jnp.asarray(v) for k, v in traj.items() if k != "dones"},
        jnp.asarray(traj["dones"]), {k: jnp.asarray(v) for k, v in final.items()})
    idx = np.asarray(jppo._minibatch_indices(cfg, jax.random.PRNGKey(seed)))
    return cfg, traj, final, flats, idx


@pytest.mark.parametrize("shuffle", ["grouped", "tiled"])
def test_shard_local_layouts_match_jax(shuffle):
    """Each rank's flatten of its envs and its part of the JAX package's
    indices gather exactly the rows that the JAX minibatch takes from that
    rank's shard: the shard-major grouped flatten with per-shard group ids,
    and the tiled row blocks."""
    cfg_j, traj, final, flats_j, idx = jax_layout(shuffle)
    cfg = tppo.PPOConfig(env=tenv.EnvConfig(*MNK), num_envs=8, n_steps=8, batch_size=16,
                         shuffle=shuffle, shard_groups=2, group_size=4)
    from rl_selfplay_mnk_tpu_torch.models import create_model_from_architecture

    model, _ = create_model_from_architecture("mlp_tiny", (2, 3, 3), 9)
    for r in range(2):
        sl = slice(4 * r, 4 * (r + 1))
        local = {k: torch.from_numpy(np.array(v[:, sl])) for k, v in traj.items()}
        fin = {k: torch.from_numpy(np.array(v[sl])) for k, v in final.items()}
        # a rank flattens its one shard (the ranks' flatten without a process group)
        one_shard = dataclasses.replace(cfg, shard_groups=1)
        flats = tppo._update_prepare_impl(model, one_shard, local, fin)
        rows = tppo.rank_indices(cfg, torch.from_numpy(idx.astype(np.int64)), 2, r)
        for j in range(cfg.num_minibatches):
            for key in ("obs", "mask", "actions", "old_logp"):
                got = tppo.gather_minibatch(flats[key], rows[j], shuffle == "grouped")
                x = np.asarray(flats_j[key])
                if shuffle == "grouped":  # JAX: (d, per) shard-major groups, (d, mb) ids
                    xs = x.reshape((2, -1) + x.shape[1:])
                    want = xs[r][idx[j, r]].reshape((-1,) + x.shape[2:])
                else:  # JAX: global env-major rows; rank r's block is its columns
                    cols = idx[j].reshape(2, -1)[r]
                    want = x[cols]
                np.testing.assert_array_equal(want, got.numpy(), err_msg=f"{key} mb {j}")


@pytest.mark.parametrize("shuffle", ["grouped", "tiled"])
def test_rank_draws_are_the_world_one_draw_sliced(shuffle):
    """A rank draws the whole batch's indices from the shared generator and
    keeps its part: the same generator state gives rank r of world 2 the
    columns of the world-1 draw in the same layout; each rank's rows are a
    permutation of its own rows."""
    cfg = tppo.PPOConfig(env=tenv.EnvConfig(*MNK), num_envs=8, n_steps=8, batch_size=16,
                         shuffle=shuffle, shard_groups=2, group_size=4)
    whole = tppo._minibatch_indices(cfg, torch.Generator().manual_seed(1), "cpu")
    for r in range(2):
        got = tppo._minibatch_indices(cfg, torch.Generator().manual_seed(1), "cpu", 2, r)
        assert torch.equal(got, tppo.rank_indices(cfg, whole, 2, r))
        n_local = 8 if shuffle == "grouped" else 32  # a shard's groups, or a rank's rows
        assert sorted(got.flatten().tolist()) == list(range(n_local))
    with pytest.raises(ValueError):
        tppo.rank_indices(tppo.PPOConfig(env=tenv.EnvConfig(*MNK), num_envs=8, n_steps=8,
                                         batch_size=16), whole, 2, 0)


# -- two ranks against JAX on the mesh --------------------------------------


def jax_rollout(module, variables, mesh, noise, sides_keys, first_sides, e, t_len):
    """The JAX package's rollout body on the 2-device mesh with the port's
    gumbel-max sampling on the injected uniforms: train-mode forward with
    batch statistics over the sharded batch, ``selfplay_step`` with the
    step's key (the sides), the first-legal opponent."""
    cfg = jenv.EnvConfig(*MNK)

    def opp(params, rng, obs, deterministic=False):
        return jnp.argmax(obs["action_mask"].astype(jnp.int32), -1).astype(jnp.int32)

    fwd = jax.jit(lambda p, bs, o: jppo._train_forward(module, p, bs, o))
    step = jax.jit(lambda s, a, k: jw.selfplay_step(cfg, opp, None, s, a, k))
    es, rs = env_sharding(mesh), replicated_sharding(mesh)
    sp, obs = jw.selfplay_reset(cfg, opp, None, e, jax.random.PRNGKey(0),
                                agent_side=jnp.asarray(first_sides))
    params = jax.device_put(variables["params"], rs)
    bs = jax.device_put(variables["batch_stats"], rs)
    out = {"values": [], "log_probs": [], "actions": [], "rewards": [], "dones": []}
    for t in range(t_len):
        logits, value, bs = fwd(params, bs, jax.device_put(obs["observation"], es))
        ml = jmasked.mask_logits(logits, obs["action_mask"])
        actions = jnp.argmax(ml - jnp.log(-jnp.log(jnp.asarray(noise[t]))), -1).astype(jnp.int32)
        out["log_probs"].append(np.asarray(jmasked.log_prob(ml, actions)))
        out["values"].append(np.asarray(value[:, 0]))
        out["actions"].append(np.asarray(actions))
        sp, obs, rewards, dones = step(sp, actions, sides_keys[t])
        out["rewards"].append(np.asarray(rewards))
        out["dones"].append(np.asarray(dones))
    return {k: np.stack(v) for k, v in out.items()}, jax.tree.map(np.asarray, bs)


def jax_update(module, variables, cfg_j, traj, final, epoch_keys):
    """JAX's update on the 2-device mesh: the trajectory sharded over its
    env axis, prepare (batch statistics and the advantage normalisation
    over the sharded batch), then the epochs."""
    mesh = make_mesh(2)
    lr = 1e-3
    optimizer = optax.chain(optax.clip_by_global_norm(0.5),
                            optax.adamw(lambda c: lr, eps=1e-5, weight_decay=0.01))
    es2 = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None, "env"))
    traj_j = {k: jax.device_put(jnp.asarray(v), es2) for k, v in traj.items()}
    final_j = jax_shard_batched({k: jnp.asarray(v) for k, v in final.items()}, mesh, 8)
    bs_j, flats_j = jax.jit(jppo._update_prepare_impl, static_argnums=(0, 1))(
        module, cfg_j, variables["params"], variables["batch_stats"],
        {k: v for k, v in traj_j.items() if k != "dones"}, traj_j["dones"], final_j)
    params_j, bs_j, _, sums_j = jax.jit(jppo._update_epochs_impl, static_argnums=(0, 1, 2))(
        module, cfg_j, optimizer, variables["params"], bs_j, optimizer.init(variables["params"]),
        flats_j, jnp.float32(0.04), epoch_keys, jppo.zero_metric_sums())
    return params_j, bs_j, sums_j


@pytest.fixture(scope="module")
def replicated_ranks():
    """One group of two ranks: the rollout and the replicated update of
    ``cnn_b_s`` (BatchNorm), from JAX's weights and draws."""
    module, _ = jax_create("cnn_b_s", (2, 3, 3), 9)
    variables = jax.tree.map(np.asarray, jax_init(module, (2, 3, 3), jax.random.PRNGKey(0)))
    e, t_len = 8, 6
    rng = np.random.default_rng(0)
    noise = rng.random((t_len, e, 9)).astype(np.float32).clip(1e-7, None)
    keys = [jax.random.PRNGKey(100 + t) for t in range(t_len)]
    sides = np.stack([np.asarray(jax.random.randint(jax.random.split(k)[0], (e,), 0, 2,
                                                    dtype=jnp.int32)) for k in keys])
    first_sides = rng.integers(0, 2, (e,)).astype(np.int32)
    traj, final = make_trajectory(4, 8, e, 3, 3)
    cfg_j = jppo.PPOConfig(env=jenv.EnvConfig(*MNK), num_envs=e, n_steps=8, batch_size=16,
                           ppo_epochs=2, shuffle="tiled", shard_groups=2)
    epoch_keys = jax.random.split(jax.random.PRNGKey(5), 2)
    idx = [np.asarray(jppo._minibatch_indices(cfg_j, k)).astype(np.int64) for k in epoch_keys]
    common = dict(arch="cnn_b_s", variables=variables, mnk=MNK)
    ranks = RankGroup(f"{WORKERS}:rollout_and_update", 2, dict(
        rollout_kwargs=dict(common, num_envs=e, n_steps=t_len, noise=noise, sides=sides,
                            first_sides=first_sides),
        update_kwargs=dict(common, traj=traj, final=final, epoch_indices=idx, shuffle="tiled",
                           batch_size=16, lr=1e-3)), device="cpu")
    # JAX on the mesh while the ranks run.
    want_roll = jax_rollout(module, variables, make_mesh(2), noise, keys, first_sides, e, t_len)
    want_update = jax_update(module, variables, cfg_j, traj, final, epoch_keys)
    results, _ = ranks.wait()
    roll, upd = [r[0] for r in results], [r[1] for r in results]
    return dict(variables=variables, roll=roll, upd=upd, want_roll=want_roll,
                want_update=want_update)


def test_two_rank_rollout_with_batch_statistics_matches_jax_on_the_mesh(replicated_ranks):
    """The ranks' rows of the trajectory, their finished-episode sums and
    the running statistics (from the batch statistics of both ranks' rows)
    against JAX's rollout on the 2-device mesh."""
    r = replicated_ranks
    want, bs_j = r["want_roll"]
    got = {k: np.concatenate([rank["traj"][k] for rank in r["roll"]], axis=1) for k in want}
    for k in ("actions", "dones"):
        np.testing.assert_array_equal(want[k], got[k].astype(want[k].dtype), err_msg=k)
    for k in ("values", "log_probs", "rewards"):
        np.testing.assert_allclose(want[k], got[k], atol=ATOL, rtol=RTOL, err_msg=k)
    d = want["dones"].astype(np.float32)
    assert r["roll"][0]["fin"][2] == r["roll"][1]["fin"][2] == d.sum()
    for rank in r["roll"]:
        assert_trees_close(bs_j, rank["variables"]["batch_stats"])


def test_two_rank_replicated_update_of_a_batchnorm_network_matches_jax(replicated_ranks):
    """Prepare + two epochs of ``cnn_b_s`` over the tiled layout: JAX's
    update on the 2-device mesh (batch statistics and the advantage
    normalisation over the sharded batch), the same indices injected into
    the ranks."""
    r = replicated_ranks
    variables = r["variables"]
    params_j, bs_j, sums_j = r["want_update"]
    for rank in r["upd"]:
        assert rank["count"] == 8
        assert_trees_close(jax.tree.map(np.asarray, params_j), rank["variables"]["params"])
        assert_trees_close(jax.tree.map(np.asarray, bs_j), rank["variables"]["batch_stats"])
        for key in ("actor_loss", "critic_loss", "entropy_loss", "grad_norm", "approx_kl",
                    "explained_variance", "clip_fraction"):
            np.testing.assert_allclose(float(sums_j[key]) / 8, rank["metrics"][key],
                                       atol=ATOL, rtol=RTOL, err_msg=key)
    moved = np.abs(np.asarray(params_j["Conv_0"]["kernel"]) -
                   variables["params"]["Conv_0"]["kernel"]).max()
    assert moved > 1e-4


# -- the trainers -----------------------------------------------------------


def tiny_config(name, iters, **kw):
    config = get_default_config()
    config.update(mnk=MNK, num_envs=8, n_steps=16, batch_size=32, validation_interval=1,
                  total_environment_steps=8 * 16 * iters, validation_episodes=16,
                  architecture_name="cnn_b_s", run_name=name, watch_interval=0, shuffle="tiled")
    config.update(kw)
    return config


@pytest.fixture(scope="module")
def trainer_ranks(tmp_path_factory):
    """One group of two ranks runs, in turn: a straight 3-iteration run, a
    2-iteration run that checkpoints, ZeRO-requested runs of
    ``transformer_b_s`` (grouped, eligible: a straight one and one that
    checkpoints) and of ``cnn_b_s`` (batch statistics, ineligible), and the
    fused step driver (checkpointing at each block's end)."""
    work = tmp_path_factory.mktemp("ranks")
    ckpt = str(work / "ckpt")
    runs = [
        tiny_config("straight", 3, multihost=True),
        tiny_config("cut", 2, multihost=True, checkpoint_interval=1, checkpoint_dir=ckpt),
        tiny_config("zero", 3, multihost=True, architecture_name="transformer_b_s",
                    shuffle="grouped", zero_sharded_optimizer=True, watch_interval=1),
        tiny_config("zero_cut", 2, multihost=True, architecture_name="transformer_b_s",
                    shuffle="grouped", zero_sharded_optimizer=True, checkpoint_interval=1,
                    checkpoint_dir=ckpt + "_zero"),
        tiny_config("zero_bn", 1, multihost=True, shuffle="grouped",
                    zero_sharded_optimizer=True),
        tiny_config("fused", 3, multihost=True, fused=True, checkpoint_interval=1,
                    checkpoint_dir=ckpt + "_fused"),
    ]
    ranks = RankGroup(f"{WORKERS}:train", 2, {"workdir": str(work), "runs": runs},
                      device="cpu")
    # One rank in the layout of two, while the ranks run.
    one = world_one(tiny_config("straight1", 3), tmp=tmp_path_factory.mktemp("one"))
    fused_one = world_one(tiny_config("fused1", 3), fused=True,
                          tmp=tmp_path_factory.mktemp("fused_one"))
    results, outputs = ranks.wait()
    return dict(work=work, ckpt=ckpt, results=results, outputs=outputs, one=one,
                fused_one=fused_one)


def world_one(config, fused=False, tmp=None):
    """The same run on one rank in the layout of two (``shard_groups``)."""
    config = dict(config, shard_groups=2, export_dir=str(tmp / "models"))
    config.pop("multihost", None)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        return (train_mnk_fused if fused else train_mnk)(config, device="cpu")
    finally:
        os.chdir(cwd)


def assert_runs_close(one, two):
    for a, b in zip(one["iterations"], two["iterations"]):
        for key in ("mean_reward", "mean_length"):
            assert a[key] == pytest.approx(b[key], abs=1e-6), key
        for key in ("actor_loss", "critic_loss", "entropy_loss", "grad_norm", "approx_kl",
                    "explained_variance"):
            np.testing.assert_allclose(a[key], b[key], atol=ATOL, rtol=RTOL, err_msg=key)
    assert len(one["iterations"]) == len(two["iterations"])
    state = one["model"].state_dict()
    for k, v in two["params"].items():
        np.testing.assert_allclose(state[k].numpy(), v, atol=ATOL, rtol=RTOL, err_msg=k)


def test_world_two_matches_world_one_through_train_mnk(trainer_ranks):
    """``train_mnk`` over two ranks against one rank in the same layout:
    the same episodes, metrics and parameters within the update's limits;
    both ranks end with the same weights."""
    res = trainer_ranks["results"]
    assert res[0][0]["errors"] == [] and len(res[0][0]["validations"]) == 2
    for k, v in res[0][0]["params"].items():
        np.testing.assert_array_equal(v, res[1][0]["params"][k], err_msg=k)
    one = trainer_ranks["one"]
    assert_runs_close(one, res[0][0])
    assert one["validations"] == res[0][0]["validations"]


def test_only_rank_zero_writes(trainer_ranks):
    """Exports, metric streams, stdout and checkpoints are rank 0's: rank
    1's directory stays empty and its output holds no iteration line."""
    work, outs = trainer_ranks["work"], trainer_ranks["outputs"]
    assert os.listdir(work / "rank1") == []
    runs = sorted(os.listdir(work / "rank0" / "runs"))
    assert runs == ["cut.jsonl", "fused.jsonl", "straight.jsonl", "zero.jsonl", "zero_bn.jsonl",
                    "zero_cut.jsonl"]
    assert "model_00003.msgpack" in os.listdir(work / "rank0" / "models" / "straight")
    assert "Iter " in outs[0] and "Iter " not in outs[1]
    assert "Running validation" in outs[0] and "Running validation" not in outs[1]
    assert os.listdir(trainer_ranks["ckpt"]) == ["step_1.pt"]


def test_zero_engages_where_the_jax_rule_engages_it(trainer_ranks):
    """``learner/zero_sharded`` 1 for the grouped transformer over two
    ranks, 0 with the JAX package's message for a BatchNorm network."""
    work, outs = trainer_ranks["work"], trainer_ranks["outputs"]

    def flag(run):
        records = [json.loads(ln) for ln in open(work / "rank0" / "runs" / f"{run}.jsonl")]
        return [r["learner/zero_sharded"] for r in records if "learner/zero_sharded" in r]

    assert flag("zero") == [1] and flag("zero_bn") == [0] and flag("straight") == [0]
    assert "ZeRO sharded learner engaged: moments sharded over 2 ranks" in outs[0]
    assert "zero_sharded_optimizer requested but ineligible" in outs[0]
    zero = trainer_ranks["results"][0][2]
    assert zero["errors"] == [] and np.isfinite(zero["iterations"][0]["actor_loss"])


def test_zero_checkpoint_resumes_under_world_one(trainer_ranks, tmp_path):
    """The ZeRO learner's checkpoint holds AdamW's state gathered over the
    ranks in the replicated learner's layout: one rank (no ZeRO there)
    resumes it for iteration 2 and ends where the straight ZeRO run of two
    ranks ended."""
    config = tiny_config("zero_cut", 3, architecture_name="transformer_b_s", shuffle="grouped",
                         zero_sharded_optimizer=True, resume=True,
                         checkpoint_dir=trainer_ranks["ckpt"] + "_zero")
    resumed = world_one(config, tmp=tmp_path)
    assert resumed["start_iteration"] == 2 and resumed["errors"] == []
    straight = trainer_ranks["results"][0][2]
    state = resumed["model"].state_dict()
    for k, v in straight["params"].items():
        np.testing.assert_allclose(state[k].numpy(), v, atol=ATOL, rtol=RTOL, err_msg=k)


def test_world_two_checkpoint_resumes_under_world_one(trainer_ranks, tmp_path):
    """A checkpoint written at iteration 1 by two ranks (the whole env
    batch) resumes on one rank for iteration 2, which ends within the
    update's limits of the straight two-rank run."""
    config = tiny_config("cut", 3, resume=True, checkpoint_dir=trainer_ranks["ckpt"])
    resumed = world_one(config, tmp=tmp_path)
    assert resumed["start_iteration"] == 2 and resumed["errors"] == []
    straight = trainer_ranks["results"][0][0]
    state = resumed["model"].state_dict()
    for k, v in straight["params"].items():
        np.testing.assert_allclose(state[k].numpy(), v, atol=ATOL, rtol=RTOL, err_msg=k)
    for key in ("actor_loss", "critic_loss", "grad_norm"):
        np.testing.assert_allclose(resumed["iterations"][0][key],
                                   straight["iterations"][2][key], atol=ATOL, rtol=RTOL)


def test_fused_step_driver_over_two_ranks_matches_one(trainer_ranks):
    """``train_mnk_fused`` over two ranks ("auto" resolves to "step" and
    says so) against one rank's step dispatch in the same layout."""
    two = trainer_ranks["results"][0][5]
    assert two["dispatch"] == "step" and two["errors"] == []
    assert "'auto' over 2 ranks: 'step'" in trainer_ranks["outputs"][0]
    one = trainer_ranks["fused_one"]
    assert one["dispatch"] == "step"
    assert_runs_close(one, two)


def test_fused_world_two_checkpoint_resumes_under_world_one(trainer_ranks, tmp_path):
    """The fused driver's checkpoint after its first block (iterations 0
    and 1) over two ranks (the whole env batch,
    ``FusedTrainer.global_state``) resumed on one rank for iteration 2 ends
    where the two ranks ended."""
    import shutil

    shutil.copytree(trainer_ranks["ckpt"] + "_fused", tmp_path / "ckpt")
    os.remove(tmp_path / "ckpt" / "step_2.pt")
    config = tiny_config("fused_resumed", 3, resume=True, checkpoint_dir=str(tmp_path / "ckpt"))
    resumed = world_one(config, fused=True, tmp=tmp_path)
    assert resumed["start_iteration"] == 2 and resumed["errors"] == []
    two = trainer_ranks["results"][0][5]
    state = resumed["model"].state_dict()
    for k, v in two["params"].items():
        np.testing.assert_allclose(state[k].numpy(), v, atol=ATOL, rtol=RTOL, err_msg=k)


def test_scan_over_ranks_and_multihost_without_a_run_name_are_refused():
    """Scan over more than one rank raises (and "auto" is "step" there);
    ``--multihost`` needs ``--run-name`` in both drivers and on the command
    line."""
    with pytest.raises(ValueError, match="not run over 2 ranks"):
        resolve_dispatch("scan", torch.device("cuda"), 2)
    assert resolve_dispatch("auto", torch.device("cpu"), 2) == "step"
    for driver in (train_mnk, train_mnk_fused):
        config = tiny_config(None, 1, multihost=True, num_processes=2, process_id=0)
        with pytest.raises(ValueError, match="run_name"):
            driver(config, device="cpu")
    with pytest.raises(SystemExit):
        config_from_args(["--multihost", "--num-processes", "2", "--process-id", "0"])
