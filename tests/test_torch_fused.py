"""The port's device-resident trainer (``DevicePool``, ``alg/fused.py``,
``train_fused.py``) against the JAX package's, on the CPU: the pool's
inserts, evictions and league records exactly, its draws by their noise and
by their frequencies, the device schedules, the in-place fold, the block
boundaries and the insert cadence; one fused iteration against the host
loop's rollout and update on the same draws; and ``train_mnk_fused`` end to
end (the host loop's keys, the JAX driver's validation and export
iterations, a bit-exact resume, a league run, the refusals)."""

import copy
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl_selfplay_mnk_tpu import train_fused as jtrain_fused
from rl_selfplay_mnk_tpu.alg import schedules as jschedules
from rl_selfplay_mnk_tpu.alg.fused import train_block as jtrain_block
from rl_selfplay_mnk_tpu.alg.ppo import PPOConfig as JPPOConfig
from rl_selfplay_mnk_tpu.env import EnvConfig as JEnvConfig
from rl_selfplay_mnk_tpu.models.registry import create_model_from_architecture as jcreate
from rl_selfplay_mnk_tpu.models.registry import init_network as jinit
from rl_selfplay_mnk_tpu.models.registry import make_apply_fns
from rl_selfplay_mnk_tpu.selfplay import opponent_pool as jpool
from rl_selfplay_mnk_tpu.selfplay.policies import make_network_policy
from rl_selfplay_mnk_tpu.selfplay.wrapper import selfplay_reset as jselfplay_reset
from rl_selfplay_mnk_tpu_torch import train_fused
from rl_selfplay_mnk_tpu_torch.alg import fused, schedules
from rl_selfplay_mnk_tpu_torch.alg.ppo import PPOLearner
from rl_selfplay_mnk_tpu_torch.models.convert import state_dict_to_flax
from rl_selfplay_mnk_tpu_torch.models.fold_bn import fold_batchnorm, fold_into, snapshot
from rl_selfplay_mnk_tpu_torch.models.registry import (
    create_model_from_architecture,
    eval_apply,
    init_network,
)
from rl_selfplay_mnk_tpu_torch.selfplay import opponent_pool as tpool
from rl_selfplay_mnk_tpu_torch.selfplay.policies import NNPolicy
from rl_selfplay_mnk_tpu_torch.train import create_learner, get_default_config, train_mnk
from rl_selfplay_mnk_tpu_torch.utils.hardware import detect_hardware_config

# One intra-op thread: the tensors here are tiny, and several test processes
# with a thread pool each spend their time waiting on one another.
torch.set_num_threads(1)


def state_dicts(arch, count, obs=(2, 3, 3)):
    """``count`` state dicts of ``arch``, each from its own seed, with
    BatchNorm statistics and scales away from their initial values."""
    out = []
    for seed in range(count):
        model, _ = create_model_from_architecture(arch, obs, obs[1] * obs[2])
        init_network(model, torch.Generator().manual_seed(seed))
        g = torch.Generator().manual_seed(100 + seed)
        with torch.no_grad():
            for mod in model.modules():
                if hasattr(mod, "running_var"):
                    mod.running_mean.copy_(torch.rand(mod.running_mean.shape, generator=g) - 0.5)
                    mod.running_var.copy_(torch.rand(mod.running_var.shape, generator=g) + 0.5)
                    mod.weight.copy_(torch.rand(mod.weight.shape, generator=g) + 0.5)
        out.append(model.state_dict())
    return out


def flax_of(state):
    return jax.tree.map(jnp.asarray, state_dict_to_flax(state))


def assert_pools_equal(tp, jp):
    """Every field, and every stacked slot through ``state_dict_to_flax``."""
    for name in ("size", "next_idx", "weights", "scores", "games"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                      err_msg=name)
    for k in range(tp.max_size):
        slot = flax_of({n: s[k] for n, s in tp.stacked.items()})
        want = jax.tree.map(lambda s, k=k: s[k], jp.stacked)
        for a, b in zip(jax.tree.leaves(slot), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("eviction", ["fifo", "adaptive"])
@pytest.mark.parametrize("arch", ["resnet_b_s", "cnn_b_s"])
def test_device_pool_equals_jax(arch, eviction):
    """Inserts below and at capacity, masked inserts either way, eviction
    once full, and league records with a finite and a non-finite score."""
    states = state_dicts(arch, 6)
    tp = tpool.pool_init(states[0], 3)
    jp = jpool.pool_init(flax_of(states[0]), 3)
    assert_pools_equal(tp, jp)
    steps = [("add", 1, 0.9), ("add_if", 2, 0.2, False), ("add_if", 2, 0.2, True),
             ("record", 1, 0.8, True), ("add", 3, 0.6), ("record", 0, float("nan"), True),
             ("record", 2, 1.7, True), ("record", 2, 0.1, False), ("add_if", 4, 0.05, True),
             ("add", 5, 0.4)]
    for op, *args in steps:
        if op == "add":
            i, w = args
            tpool.pool_add(tp, states[i], w, eviction)
            jp = jpool.pool_add(jp, flax_of(states[i]), w, eviction)
        elif op == "add_if":
            i, w, do = args
            tpool.pool_add_if(tp, states[i], torch.tensor(w), torch.tensor(do), eviction)
            jp = jpool.pool_add_if(jp, flax_of(states[i]), jnp.float32(w), jnp.bool_(do), eviction)
        else:
            slot, score, do = args
            tpool.pool_record_result_if(tp, torch.tensor(slot), torch.tensor(score),
                                        torch.tensor(do), 0.3)
            jp = jpool.pool_record_result_if(jp, jnp.int32(slot), jnp.float32(score),
                                             jnp.bool_(do), 0.3)
        assert_pools_equal(tp, jp)


def test_pfsp_slot_weights_equal_jax():
    scores = np.linspace(-0.2, 1.2, 29).astype(np.float32)
    for mode in ("uniform", "pfsp_hard", "pfsp_even"):
        for power in (1.0, 2.0, 3.0):
            got = tpool.pfsp_slot_weights(torch.from_numpy(scores), mode, power).numpy()
            want = np.asarray(jpool.pfsp_slot_weights(jnp.asarray(scores), mode, power))
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f"{mode} {power}")
    with pytest.raises(ValueError):
        tpool.pfsp_slot_weights(torch.from_numpy(scores), "nope")


def scored_pool(size, k=5):
    """A pool of ``size`` valid slots of ``k`` with weights and scores."""
    pool = tpool.pool_init({"x": torch.zeros(2)}, k)
    rng = np.random.default_rng(size)
    for i in range(size):
        tpool.pool_add(pool, {"x": torch.full((2,), float(i))}, float(rng.uniform(0.1, 2.0)))
    pool.scores.copy_(torch.from_numpy(rng.uniform(0.0, 1.0, k).astype(np.float32)))
    return pool


def numpy_logits(pool, mode):
    k, size = pool.max_size, int(pool.size)
    if mode is None:
        logits = np.log(np.maximum(pool.weights.numpy(), 1e-30))
    else:
        logits = np.log(np.asarray(jpool.pfsp_slot_weights(jnp.asarray(pool.scores.numpy()), mode)))
    logits = np.where(np.arange(k) < size, logits, -np.inf)
    return logits if size else np.zeros(k, np.float32)


@pytest.mark.parametrize("mode", [None, "pfsp_hard", "pfsp_even", "uniform"])
def test_pool_draws_take_the_argmax_of_the_noisy_logits(mode):
    """With injected uniforms a draw is historical where the first is below
    the pool share and the pool is not empty, and its slot is numpy's
    argmax of logits plus the gumbel noise of the others over the valid
    slots; the empty pool falls back to slot 0's."""
    rng = np.random.default_rng(0)
    for size in (0, 1, 3, 5):
        pool = scored_pool(size)
        u = rng.uniform(1e-6, 1.0, (20, 1 + pool.max_size)).astype(np.float32)
        hist, slot = tpool.draw_opponent(pool, torch.from_numpy(u), 0.15, mode)
        gumbel = -np.log(-np.log(u[:, 1:].astype(np.float64)))
        want = np.argmax(numpy_logits(pool, mode) + gumbel, axis=-1)
        np.testing.assert_array_equal(slot.numpy(), want)
        np.testing.assert_array_equal(hist.numpy(), (u[:, 0] < 0.15) & (size > 0))


@pytest.mark.parametrize("mode", [None, "pfsp_hard"])
def test_pool_draw_frequencies_match_jax_categorical(mode):
    """20k of the trainer's draws (``draw_opponent``, the historical share
    0.15 included) against ``jax.random.categorical`` on the same logits
    behind a ``jax.random.uniform`` below 0.15: the live network and every
    slot within 4 binomial sigmas of the other."""
    pool = scored_pool(4)
    n, k = 20_000, pool.max_size
    u = torch.rand((n, 1 + k), generator=torch.Generator().manual_seed(0))
    hist, slot = tpool.draw_opponent(pool, u, 0.15, mode)
    counts = np.bincount(np.where(hist.numpy(), slot.numpy(), k), minlength=k + 1)
    logits = jnp.asarray(numpy_logits(pool, mode))
    k_hist, k_slot = jax.random.split(jax.random.PRNGKey(0))
    jhist = np.asarray(jax.random.uniform(k_hist, (n,)) < 0.15)
    jslot = np.asarray(jax.random.categorical(k_slot, logits, shape=(n,)))
    jcounts = np.bincount(np.where(jhist, jslot, k), minlength=k + 1)
    p = np.append(0.15 * np.asarray(jax.nn.softmax(logits)), 0.85)
    sigma = np.sqrt(2 * n * p * (1 - p)) + 1e-9
    assert counts[4] == 0 and jcounts[4] == 0
    assert np.all(np.abs(counts - jcounts) <= 4 * sigma), (counts, jcounts)


@pytest.mark.parametrize("matchmaking", [None, "pfsp_hard"])
def test_fused_trainer_draws_through_draw_opponent(matchmaking):
    """``FusedTrainer.draw`` takes its flag and slot from ``draw_opponent``
    on the next 1 + K uniforms of the learner's generator, and stages the
    drawn member (or the live network) as the opponent."""
    hw = detect_hardware_config("cpu")
    trainer = train_fused.create_fused_trainer(tiny_config(matchmaking=matchmaking), hw)[0]
    trainer.pool_prob = 0.5
    for i, state in enumerate(state_dicts("cnn_b_s", 2)):
        tpool.pool_add(trainer.pool, state, 0.5 + i)
    trainer.pool.scores.copy_(torch.tensor([0.2, 0.9, 0.5]))
    seen = set()
    for _ in range(12):
        g = trainer.generator.get_state()
        trainer.draw()
        u = torch.rand((1 + trainer.pool.max_size,), generator=torch.Generator().set_state(g))
        hist, slot = tpool.draw_opponent(trainer.pool, u, 0.5, matchmaking)
        assert bool(trainer.hist) == bool(hist) and int(trainer.slot) == int(slot)
        seen.add((bool(hist), int(slot)))
        model = copy.deepcopy(trainer.model)
        if hist:
            model.load_state_dict(tpool.pool_member(trainer.pool, slot))
        for (name, a), b in zip(snapshot(model).state_dict().items(),
                                trainer.opponent.state_dict().values()):
            assert torch.equal(a, b), name
    assert any(h for h, _ in seen) and any(not h for h, _ in seen)


def test_device_schedules_equal_jax():
    its = [0, 1, 3, 7, 10, 25, 1000, 10**6]
    for sched in (None, {"type": "linear", "params": {"final_coef": 0.001, "total_steps": 640}},
                  {"type": "linear", "params": {"final_coef": 0.01, "total_steps": 125_000_000}},
                  {"type": "exponential", "params": {"decay_rate": 0.9}}):
        got_fn = schedules.make_entropy_coef_fn(0.04, sched, 8, 8)
        want_fn = jschedules.make_entropy_coef_fn(0.04, sched, 8, 8)
        for it in its:
            got = got_fn(torch.tensor(it))
            assert got.dtype == torch.float32 and got.shape == ()
            want = np.float32(want_fn(jnp.int32(it)))
            if sched and sched["type"] == "exponential":
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
            else:
                assert got.numpy() == want, (sched, it)
    for decay in (False, True):
        for warmup in (0, 5_000_000):
            args = (8e-4, warmup, 300_000_000, 384, 256, 48, decay)
            got_fn, want_fn = schedules.make_lr_fn(*args), jschedules.make_lr_schedule(*args)
            for count in (0, 1, 47, 48, 49, 960, 2403, 48 * 51, 48 * 3000, 48 * 10**5):
                assert got_fn(torch.tensor(count)).numpy() == np.float32(want_fn(count))


@pytest.mark.parametrize("arch", ["resnet_b_s", "cnn_b_s", "transformer_b_s"])
def test_fold_into_equals_fold_batchnorm(arch):
    dst_state, src_state = state_dicts(arch, 2, (2, 5, 5))
    model, _ = create_model_from_architecture(arch, (2, 5, 5), 25)
    model.load_state_dict(dst_state)
    dst = snapshot(model)
    model.load_state_dict(src_state)
    want = fold_batchnorm(model) if arch != "transformer_b_s" else snapshot(model)
    fold_into(dst, src_state)
    for (name, a), b in zip(dst.state_dict().items(), want.state_dict().values()):
        assert torch.equal(a, b), name
    for got_blk, want_blk in zip(getattr(dst, "blocks", ()), getattr(want, "blocks", ())):
        assert all(torch.equal(a, b) for a, b in zip(got_blk.kernel_weights, want_blk.kernel_weights))


def test_block_end_equals_jax():
    for vint in (1, 2, 5, 7):
        for total in (1, 2, 5, 11, 40):
            for start in range(total):
                assert train_fused._block_end(start, vint, total) == jtrain_fused._block_end(
                    start, vint, total)


def tiny_config(**overrides):
    config = get_default_config()
    config.update(mnk=(3, 3, 3), num_envs=8, n_steps=8, batch_size=32, ppo_epochs=1,
                  architecture_name="cnn_b_s", opponent_pool=3, validation_episodes=8,
                  entropy_coef_schedule=None, learning_rate=1e-3, lr_warmup_steps=0,
                  device="cpu", watch_interval=0)
    config.update(overrides)
    return config


@functools.lru_cache(maxsize=None)
def jax_block(matchmaking, pool_prob, it0=19, block_len=2, weight=0.7):
    """JAX ``train_block`` on its own tests' setup (3x3x3, cnn_b_s, 8 envs,
    8 steps): the pool and the stacked metrics."""
    env_cfg = JEnvConfig(3, 3, 3)
    module, _ = jcreate("cnn_b_s", (2, 3, 3), 9)
    variables = jinit(module, (2, 3, 3), jax.random.PRNGKey(0))
    policy_act = make_network_policy(make_apply_fns(module)[0])
    config = JPPOConfig(env=env_cfg, num_envs=8, n_steps=8, batch_size=32, ppo_epochs=1,
                        shuffle="global", group_size=32)
    optimizer = optax.flatten(optax.chain(optax.clip_by_global_norm(0.5),
                                          optax.adamw(1e-3, eps=1e-5, weight_decay=0.01)))
    opt_state = optimizer.init(variables["params"])
    sp_state, obs = jselfplay_reset(env_cfg, policy_act, variables, 8, jax.random.PRNGKey(1))
    pool = jpool.pool_add(jpool.pool_init(variables, max_size=3), variables, 1.0)
    ep_rew, ep_len = jnp.zeros((8,), jnp.float32), jnp.zeros((8,), jnp.float32)
    mm = (matchmaking, 2.0, 0.3) if matchmaking else ()
    carry, stacked = jtrain_block(
        module, config, optimizer, policy_act, jschedules.make_entropy_coef_fn(0.04, None, 8, 8),
        block_len, pool_prob, 20, variables["params"], variables["batch_stats"], opt_state, pool,
        sp_state, obs, ep_rew, ep_len, jax.random.PRNGKey(3), jnp.int32(it0), jnp.float32(weight), *mm)
    return carry[3], stacked


@pytest.mark.parametrize("matchmaking", [None, "pfsp_hard"])
def test_insert_cadence_and_pool_bookkeeping_equal_jax(matchmaking):
    """A 2-iteration block from iteration 19 with insert weight 0.7 inserts
    at iteration 20 only (the masked insert that both dispatches run); the
    pool's bookkeeping equals
    JAX ``train_block``'s on the same setup. With the league, the port plays
    JAX's historical draws (pool_prob 0.9, so some happen) and each
    recorded score is the EMA of the port's own outcome."""
    pool_prob = 0.9 if matchmaking else 0.15
    jp, jstacked = jax_block(matchmaking, pool_prob)
    hw = detect_hardware_config("cpu")
    trainer = train_fused.create_fused_trainer(tiny_config(matchmaking=matchmaking), hw,
                                               max_block=2)[0]
    trainer.begin_block(19, 0.7, 2)
    hist = [bool(h) for h in np.asarray(jstacked["historical_opponent"])]
    outcomes = []
    for j, it in enumerate((19, 20)):
        draws = {"historical": hist[j], "slot": 0} if matchmaking else None
        row = trainer.iteration(draws)
        outcomes.append(row[-3:])
        assert int(trainer.pool.size) == (1 if it == 19 else 2)
    tp = trainer.pool
    for name in ("size", "next_idx", "weights", "games"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                      err_msg=name)
    assert float(tp.weights[1]) == pytest.approx(0.7)
    want = 0.5
    for h, (rew, _, cnt) in zip(hist, outcomes):
        if h and matchmaking:  # the slot-0 member was drawn and scored
            mean = float(rew) / max(float(cnt), 1.0) if float(cnt) > 0 else 0.0
            want = 0.7 * want + 0.3 * min(max((mean + 1.0) / 2.0, 0.0), 1.0)
    assert float(tp.scores[0]) == pytest.approx(want, abs=1e-6)
    np.testing.assert_array_equal(tp.scores[1:].numpy(), np.asarray(jp.scores)[1:])
    if matchmaking:
        assert any(hist) and float(tp.games[0]) == sum(hist)
        column = fused.METRIC_KEYS.index("historical_opponent")
        assert [bool(h) for h in trainer.stacked[:, column]] == hist


@pytest.mark.parametrize("historical", [False, True])
def test_fused_iteration_equals_the_host_loop(historical):
    """One fused iteration with injected draws (the historical flag, the
    slot, the rollout noise and sides, the minibatch indices) against the
    host loop's rollout and update on the same opponent and draws. The
    historical case plays a pool member inserted from another network.
    Tolerance: the rollout is bitwise; the update differs only in AdamW's
    lr (a float32 device tensor against a Python float) and the entropy
    coefficient's rounding: the metrics within 1e-4 relative, the parameters
    within 1e-5 absolute (a hundredth of the lr: a bias that BatchNorm
    follows has a gradient of rounding noise, which AdamW scales up)."""
    config = tiny_config(architecture_name="resnet_b_s", ppo_epochs=2, batch_size=16,
                         entropy_coef_schedule={"type": "linear",
                                                "params": {"final_coef": 0.001,
                                                           "total_steps": 1000}})
    hw = detect_hardware_config("cpu")
    trainer = train_fused.create_fused_trainer(config, hw, max_block=1)[0]
    other = state_dicts("resnet_b_s", 1)[0]
    tpool.pool_add(trainer.pool, other, 1.0)
    trainer.begin_block(3, 1.0, 1)

    host, _, lr_schedule, _ = create_learner(config, hw)
    policy_generator = torch.Generator().manual_seed(config["seed"] + 2)
    host.reset_envs(NNPolicy(eval_apply, snapshot(host.model), policy_generator))
    host.optimizer.count = 3 * config["ppo_epochs"] * 4
    for name in ("agent_side", "pending_resets"):
        assert torch.equal(getattr(host._sp_state, name), getattr(trainer.sp, name))

    rng = np.random.default_rng(7)
    t, e, a = 8, 8, 9
    draws = {"noise": torch.from_numpy(rng.uniform(1e-6, 1.0, (t, e, a)).astype(np.float32)),
             "sides": torch.from_numpy(rng.integers(0, 2, (t, e)).astype(np.int32)),
             "epoch_indices": [torch.from_numpy(rng.permutation(64).reshape(4, 16))
                               for _ in range(2)],
             "historical": historical, "slot": 1}
    row = dict(zip(fused.METRIC_KEYS, trainer.iteration(draws)))

    if historical:
        opp_model, _ = create_model_from_architecture("resnet_b_s", (2, 3, 3), 9)
        opp_model.load_state_dict(other)
        opponent = snapshot(opp_model)
    else:
        opponent = snapshot(host.model)
    traj, fin = host.rollout(NNPolicy(eval_apply, opponent, policy_generator),
                             {"noise": draws["noise"], "sides": draws["sides"]})
    for k, v in traj.items():
        assert torch.equal(v, trainer.traj[k]), k
    assert torch.equal(fin, trainer.fin)
    ent = schedules.entropy_coef_at(0.04, config["entropy_coef_schedule"], 3, 8, 8)
    metrics = host.update(traj, ent, draws["epoch_indices"])
    assert row["historical_opponent"].item() == float(historical)
    assert row["entropy_coef"].item() == pytest.approx(ent, rel=1e-6)
    for k, v in metrics.items():
        np.testing.assert_allclose(row[k].item(), v.item(), rtol=1e-4, atol=1e-6, err_msg=k)
    for (name, p), q in zip(trainer.model.state_dict().items(), host.model.state_dict().values()):
        np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
    assert float(trainer.optimizer.lr) == pytest.approx(lr_schedule(host.optimizer.count - 1),
                                                        rel=1e-6)
    # Iteration 3 is no multiple of 20: the masked insert left the pool alone.
    assert int(trainer.pool.size) == 2


def read_stream(path):
    records = [json.loads(line) for line in open(path)]
    return [r for r in records if r.get("_type") != "config"]


def run_fused(tmp_path, name, iterations, **overrides):
    config = tiny_config(validation_interval=2, export_dir=str(tmp_path / "models"),
                         run_name=name, total_environment_steps=iterations * 64)
    config.update(overrides)
    return config, train_fused.train_mnk_fused(config)


def test_train_mnk_fused_micro_end_to_end(tmp_path, monkeypatch):
    """The host loop's keys; validations and exports at the JAX driver's
    iteration numbers; the pool inserts at iteration 0 only."""
    monkeypatch.chdir(tmp_path)
    config, summary = run_fused(tmp_path, "fused", 7)
    assert summary["dispatch"] == "step" and not summary["errors"]
    assert len(summary["iterations"]) == 7
    host = train_mnk(dict(config, run_name="host"))
    fused_keys = {k for r in read_stream(summary["jsonl_path"]) for k in r}
    host_keys = {k for r in read_stream(host["jsonl_path"]) for k in r}
    promotion = {"validation/new_benchmark_step"}
    assert fused_keys - promotion == host_keys - promotion
    assert set(summary["iterations"][0]) == set(host["iterations"][0])
    # The JAX driver's blocks: validation and export after each block end
    # that is a positive multiple of the interval, and a last export.
    ends, i = [], 0
    while i < 7:
        ends.append(jtrain_fused._block_end(i, 2, 7))
        i = ends[-1] + 1
    want = [e for e in ends if e > 0 and e % 2 == 0]
    assert len(summary["validations"]) == len(want) == 3
    exported = sorted(p.name for p in (tmp_path / "models" / "fused").glob("*.msgpack"))
    assert exported == [f"model_{i:05d}.msgpack" for i in want + [7]]
    for m in summary["iterations"]:
        assert all(math.isfinite(v) for v in m.values())


def test_train_mnk_fused_resume_is_bit_exact(tmp_path, monkeypatch):
    """A run cut after its first block (a checkpoint at iteration 2) and
    resumed to iteration 6 ends with the uninterrupted run's weights, pool
    and metrics, bit for bit."""
    monkeypatch.chdir(tmp_path)
    _, straight = run_fused(tmp_path, "straight", 6, checkpoint_interval=2)
    _, cut = run_fused(tmp_path, "cut", 3, checkpoint_interval=2)
    assert len(cut["iterations"]) == 3
    _, resumed = run_fused(tmp_path, "cut", 6, checkpoint_interval=2, resume=True)
    assert resumed["start_iteration"] == 3 and not resumed["errors"]
    timing = {"fps", "rollout_time", "learn_time"}

    def untimed(its):
        return [{k: v for k, v in m.items() if k not in timing} for m in its]

    assert untimed(resumed["iterations"]) == untimed(straight["iterations"][3:])
    assert resumed["opponent_sources"] == straight["opponent_sources"][3:]
    for a, b in zip(straight["model"].state_dict().values(), resumed["model"].state_dict().values()):
        assert torch.equal(a, b)
    steps = [r["_step"] for r in read_stream(resumed["jsonl_path"]) if "training/actor_loss" in r]
    assert steps == [64 * (i + 1) for i in range(6)]


def test_train_mnk_fused_league_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _, summary = run_fused(tmp_path, "league", 5, matchmaking="pfsp_even",
                           pool_eviction="adaptive", pool_weighted=True)
    assert len(summary["iterations"]) == 5 and not summary["errors"]
    assert len(summary["validations"]) == 2


@pytest.mark.parametrize("error,stops", [("kernel", True), ("other", False)])
def test_train_mnk_fused_stops_on_kernel_errors_only(tmp_path, monkeypatch, error, stops):
    """A kernel that fails to build or launch ends the run; any other error
    in a block is logged, the block's changes to the train state are put
    back, and the next block runs, as in the JAX driver."""
    from rl_selfplay_mnk_tpu_torch.ops.cuda_build import KernelError

    monkeypatch.chdir(tmp_path)
    calls = []

    def failing_iteration(trainer, draws=None):
        # What each failing block starts from, then a change it leaves half done.
        calls.append({k: v.clone() for k, v in trainer.state_tensors().items()})
        with torch.no_grad():
            next(trainer.model.parameters()).add_(1.0)
        trainer.pool.size.add_(1)
        trainer.pool.weights.mul_(2.0)
        if error == "kernel":
            raise KernelError("CUDA kernel env_step failed to launch: cudaError 700")
        raise ValueError("bad batch")

    monkeypatch.setattr(fused.FusedTrainer, "iteration", failing_iteration)
    if stops:
        with pytest.raises(KernelError):
            run_fused(tmp_path, "errors", 5)
        assert len(calls) == 1
    else:
        _, summary = run_fused(tmp_path, "errors", 5)
        assert len(summary["errors"]) == 2 and not summary["iterations"]  # blocks 0-2, 3-4
        assert len(calls) == 2
        for k, v in calls[0].items():  # the second block starts where the first did
            assert torch.equal(v, calls[1][k]), k


@pytest.mark.parametrize("override,match", [
    ({"opponents_per_iteration": 2}, "mixed-opponent"),
    ({"matchmaking": "nope"}, "matchmaking"),
    ({"pool_eviction": "lru"}, "pool_eviction"),
    ({"fused_dispatch": "scan"}, "needs the card"),
    ({"fused_dispatch": "graphs"}, "fused_dispatch"),
    ({"update_chunks": 2}, "update_chunks"),
], ids=lambda v: str(v) if isinstance(v, str) else next(iter(v)))
def test_train_mnk_fused_refuses(tmp_path, monkeypatch, override, match):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match=match):
        run_fused(tmp_path, "refused", 1, **override)


def test_auto_dispatch_is_scan_on_the_card_and_step_off_it():
    """The graphs were no slower on the card at every width measured (384
    envs and the bench's 8192), so "auto" takes them there; off the card
    it takes the eager pieces, and an explicit "scan" raises."""
    assert train_fused.resolve_dispatch("auto", torch.device("cuda")) == "scan"
    assert train_fused.resolve_dispatch("auto", torch.device("cpu")) == "step"
    assert train_fused.resolve_dispatch("step", torch.device("cuda")) == "step"
    with pytest.raises(ValueError, match="needs the card"):
        train_fused.resolve_dispatch("scan", torch.device("cpu"))


def test_fused_trainer_refuses_capture_on_the_cpu():
    hw = detect_hardware_config("cpu")
    trainer = train_fused.create_fused_trainer(tiny_config(), hw)[0]
    with pytest.raises(ValueError, match="need the card"):
        fused.train_block(trainer, 0, 1)
    assert not trainer.graphs


def test_fused_trainer_needs_a_device_optimizer():
    hw = detect_hardware_config("cpu")
    learner = create_learner(tiny_config(), hw)[0]
    assert isinstance(learner, PPOLearner)
    with pytest.raises(ValueError, match="DeviceOptimizer"):
        fused.FusedTrainer(learner, None, torch.Generator(), None, None)
