"""The port's spans (``utils/tracing.py``) and their reading
(``utils/profiling.py``'s ``layer_report``): off, a host-loop iteration
makes no span; on, both training loops give the span tree, each child
inside its parent; a span on the profiler's clock encloses the ops run in
it and its range is in the trace; the fused metrics line's rollout and
learn seconds are the spans', not the iteration's wall; the attribution of
kernels to spans by their launch calls on a synthetic trace. Marked
``cuda`` (skipped without a card): a span gets its kernel by correlation in
a card-only trace, and the kernels of a graph replay go to ``update``."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rl_selfplay_mnk_tpu_torch import train_fused
from rl_selfplay_mnk_tpu_torch.models.fold_bn import snapshot
from rl_selfplay_mnk_tpu_torch.models.registry import eval_apply
from rl_selfplay_mnk_tpu_torch.selfplay.policies import NNPolicy
from rl_selfplay_mnk_tpu_torch.train import create_learner, get_default_config, train_mnk
from rl_selfplay_mnk_tpu_torch.utils import tracing
from rl_selfplay_mnk_tpu_torch.utils.hardware import detect_hardware_config
from rl_selfplay_mnk_tpu_torch.utils.metrics import NullMetricsLogger
from rl_selfplay_mnk_tpu_torch.utils.profiling import layer_report, trace_events

# One intra-op thread: the tensors here are tiny, and several test processes
# with a thread pool each spend their time waiting on one another.
torch.set_num_threads(1)


def tiny_config(tmp_path, **overrides):
    config = get_default_config()
    config.update(mnk=(3, 3, 3), num_envs=8, n_steps=8, batch_size=32, ppo_epochs=1,
                  architecture_name="cnn_b_s", opponent_pool=3, validation_episodes=8,
                  validation_interval=2, entropy_coef_schedule=None, lr_warmup_steps=0,
                  watch_interval=0, total_environment_steps=8 * 8 * 5,
                  export_dir=str(tmp_path / "models"), run_name="spans")
    config.update(overrides)
    return config


@pytest.fixture
def spans():
    tracing.clear()
    tracing.enable()
    yield
    tracing.disable()
    tracing.clear()


def children(recs, i):
    return [r["name"] for r in recs if r["parent"] == i]


def assert_nested(recs):
    for r in recs:
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] is not None:
            p = recs[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] and r["end_ns"] <= p["end_ns"], (p, r)


def test_off_a_host_loop_iteration_records_nothing_and_makes_no_span(tmp_path, monkeypatch):
    made = []
    init = tracing.Span.__init__

    def counted(self, *args):
        made.append(args)
        init(self, *args)

    monkeypatch.setattr(tracing.Span, "__init__", counted)
    learner = create_learner(tiny_config(tmp_path), detect_hardware_config("cpu"))[0]
    generator = torch.Generator().manual_seed(0)
    metrics = learner.learn(NNPolicy(eval_apply, snapshot(learner.model), generator), 0.01)
    assert tracing.records() == [] and made == []
    assert tracing.span("rollout") is tracing.span("update")  # the shared no-op
    assert metrics.rollout_time > 0 and metrics.learn_time > 0
    assert metrics.fps == 8 * 8 / metrics.rollout_time


def test_the_host_loop_gives_the_span_tree(tmp_path, spans):
    summary = train_mnk(tiny_config(tmp_path), NullMetricsLogger(), device="cpu")
    recs = tracing.records()
    assert_nested(recs)
    iterations = [i for i, r in enumerate(recs) if r["name"] == "iteration"]
    assert len(iterations) == len(summary["iterations"]) == 5
    for i in iterations:
        assert recs[i]["parent"] is None
        assert children(recs, i) == ["opponent", "rollout", "update", "read"]
        update = next(j for j, r in enumerate(recs) if r["parent"] == i and r["name"] == "update")
        assert children(recs, update) == ["update.prepare", "update.epochs"]
    validations = [r for r in recs if r["name"] == "validation"]
    assert len(validations) == len(summary["validations"]) == 2
    assert all(r["parent"] is None for r in validations)
    assert all(r["device_s"] is None for r in recs)  # no event pair on the CPU


def test_the_fused_step_dispatch_gives_the_span_tree(tmp_path, spans):
    summary = train_fused.train_mnk_fused(tiny_config(tmp_path), NullMetricsLogger(),
                                          device="cpu")
    assert summary["dispatch"] == "step" and not summary["errors"]
    recs = tracing.records()
    assert_nested(recs)
    blocks = [i for i, r in enumerate(recs) if r["name"] == "block"]
    assert len(blocks) == len(summary["block_walls"]) == 2  # iterations 0-2, 3-4
    iterations = 0
    for b in blocks:
        assert recs[b]["parent"] is None
        names = children(recs, b)
        assert names[-1] == "read" and set(names[:-1]) == {"iteration"}
        for i in (j for j, r in enumerate(recs) if r["parent"] == b and r["name"] == "iteration"):
            iterations += 1
            assert children(recs, i) == ["rollout", "update", "finish"]
    assert iterations == len(summary["iterations"]) == 5
    walls = [(recs[b]["end_ns"] - recs[b]["start_ns"]) / 1e9 for b in blocks]
    assert [w for _, w in summary["block_walls"]] == pytest.approx(walls, abs=1e-9)
    assert sum(r["name"] == "validation" and r["parent"] is None for r in recs) == 2


def test_the_fused_metrics_line_times_the_rollout_and_update_spans(tmp_path, spans):
    summary = train_fused.train_mnk_fused(tiny_config(tmp_path), NullMetricsLogger(),
                                          device="cpu")
    recs = tracing.records()
    walls = [(r["end_ns"] - r["start_ns"]) / 1e9 for r in recs if r["name"] == "iteration"]
    phases = {name: [(r["end_ns"] - r["start_ns"]) / 1e9 for r in recs if r["name"] == name]
              for name in ("rollout", "update")}
    for j, (m, wall) in enumerate(zip(summary["iterations"], walls, strict=True)):
        assert m["rollout_time"] + m["learn_time"] <= wall
        assert m["rollout_time"] != m["learn_time"]
        assert m["rollout_time"] == pytest.approx(phases["rollout"][j], abs=1e-9)
        assert m["learn_time"] == pytest.approx(phases["update"][j], abs=1e-9)
        assert m["fps"] == pytest.approx(8 * 8 / m["rollout_time"])


def test_a_span_on_the_profilers_clock_encloses_its_ops(spans):
    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            time.sleep(0.002)
            (a @ a).sum()
            time.sleep(0.002)
    (rec,) = tracing.records()
    events = prof.profiler.kineto_results.events()
    ops = [e for e in events if e.name() in ("aten::mm", "aten::sum")]
    assert {e.name() for e in ops} == {"aten::mm", "aten::sum"}
    for e in ops:
        assert rec["start_ns"] < e.start_ns() and e.end_ns() < rec["end_ns"]
    (outer,) = [e for e in events if e.name() == "outer"]
    assert abs(outer.start_ns() - rec["start_ns"]) < 1_000_000


def test_kernels_go_to_the_span_that_launched_them():
    """A synthetic trace (ns): a block over an iteration over a rollout and
    an update whose epochs launch one graph of three nodes; one kernel
    whose launch call is not in the trace."""
    recs = [{"name": "block", "parent": None, "start_ns": 0, "end_ns": 100},
            {"name": "iteration", "parent": 0, "start_ns": 10, "end_ns": 90},
            {"name": "rollout", "parent": 1, "start_ns": 10, "end_ns": 40},
            {"name": "update", "parent": 1, "start_ns": 40, "end_ns": 80},
            {"name": "update.epochs", "parent": 3, "start_ns": 50, "end_ns": 80}]
    launches = {1: 15, 2: 20, 3: 45, 4: 55, 7: 95}
    kernels = [(100, 110, 1, "a"), (120, 130, 2, "b"), (150, 160, 3, "c"), (170, 180, 4, "g1"),
               (180, 190, 4, "g2"), (195, 200, 4, "g3"), (210, 220, 6, "lost")]
    out = layer_report(kernels, launches, recs, minibatches=2)
    assert out["kernels"] == 7 and out["unattributed"] == 1 and out["unspanned"] == 0
    rollout, update = out["layers"]["rollout"], out["layers"]["update"]
    assert rollout["launches"] == 2 and rollout["idle_share"] == pytest.approx(1 / 3)
    assert update["launches"] == 4 and update["idle_share"] == pytest.approx(0.3)
    assert rollout["idle_s"] == pytest.approx(10e-9) and update["idle_s"] == pytest.approx(35e-9)
    assert out["idle_by_span"] == pytest.approx({"rollout": 10e-9, "update": 20e-9,
                                                 "update.epochs": 15e-9, "unspanned": 10e-9})
    assert out["update_launches_per_minibatch"] == 2.0
    assert out["update_launches_per_minibatch_by_time"] == 2.0


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_span_gets_its_kernel_by_correlation_in_a_card_only_trace(device, spans):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracing.span("sleep"):
            torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
    kernels, launches = trace_events(prof)
    recs = tracing.records()
    out = layer_report(kernels, launches, recs, layers=("sleep",))
    assert len(kernels) == 1 and out["unattributed"] == out["unspanned"] == 0
    assert out["layers"]["sleep"]["launches"] == 1
    assert recs[0]["device_s"] > 0


@pytest.mark.cuda
def test_the_kernels_of_a_minibatch_replay_go_to_update(device, spans):
    from rl_selfplay_mnk_tpu_torch.alg.fused import train_block
    from rl_selfplay_mnk_tpu_torch.train import build_config
    from rl_selfplay_mnk_tpu_torch.train_fused import create_fused_trainer, run_block

    config = build_config("resnet_b_s")
    config.update(num_envs=64, n_steps=32, batch_size=512, opponent_pool=4)
    trainer = create_fused_trainer(config, detect_hardware_config(str(device)), max_block=2)[0]
    train_block(trainer, 0, 1)  # the capture
    trainer.replay("prepare")  # the minibatch counter back to 0
    torch.cuda.synchronize()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracing.span("update"):
            trainer.replay("minibatch")
        torch.cuda.synchronize()
    kernels, launches = trace_events(prof)
    out = layer_report(kernels, launches, tracing.records())
    assert len(kernels) > 1 and out["unattributed"] == out["unspanned"] == 0
    assert out["layers"]["update"]["launches"] == len(kernels)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_block(trainer, "scan", 1, 1, 1.0)  # the block's fills too are under a span
    out = layer_report(*trace_events(prof), tracing.records(),
                       minibatches=trainer.config.updates_per_iteration)
    assert out["unattributed"] == out["unspanned"] == 0
    assert out["update_launches_per_minibatch"] == out["update_launches_per_minibatch_by_time"]


@pytest.mark.parametrize("cell", ["resnet_b_s.fused384", "transformer_b_s.loop8192"])
def test_the_span_report_covers_a_cells_window_on_the_cpu(cell, capsys):
    """``tools/span_report.py`` on a tiny cell: the window is spanned, each
    validation read; off, the line has the benchmark's two numbers only."""
    import importlib.util
    import json
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / "span_report.py"
    spec = importlib.util.spec_from_file_location("span_report", path)
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    tiny = {"num_envs": 16, "n_steps": 8, "batch_size": 64, "validation_episodes": 4}
    lines = []
    threads = torch.get_num_threads()  # the report sets the benchmark's
    try:
        for on in (0, 1):
            capsys.readouterr()
            assert report.main(["--workload", cell, "--seed", str(2**31 + 17), "--seconds", "0",
                                "--spans", str(on)], device="cpu", traffic_overrides=tiny) == 0
            lines.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    finally:
        torch.set_num_threads(threads)
    off, on = lines
    assert not tracing._enabled and tracing.records()
    tracing.clear()
    assert off["iterations"] == on["iterations"] == 5
    assert "coverage" not in off and off["env_steps_per_s"] > 0 and off["setup_s"] > 0
    assert 0.9 < on["coverage"] <= 1.0
    assert on["validation_ms"] > 0 and on["capture_s"] is None  # no capture on the CPU
    assert on["layers_device_s"] == {"short_conv": 0.0, "moe": 0.0} and on["counters"] == {}
