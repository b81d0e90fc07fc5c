"""The port's bench and batch entry points against the JAX package's: the
bench's JSON line and refusals, each batch entry's configs and run names,
the sweep's sampled hyper-parameters and a two-trial micro sweep, and the
sweep's wandb path."""

import importlib.util
import json
import pathlib
import random
import sys
import types

import pytest
import torch

from rl_selfplay_mnk_tpu import sweep as jsweep
from rl_selfplay_mnk_tpu import train_all as jtrain_all
from rl_selfplay_mnk_tpu import train_all_13 as jtrain_all_13
from rl_selfplay_mnk_tpu import train_short as jtrain_short
from rl_selfplay_mnk_tpu import train_worker as jtrain_worker
from rl_selfplay_mnk_tpu_torch import bench, sweep, train_all, train_all_13, train_short, train_worker

# One intra-op thread: the tensors here are tiny, and several test processes
# with a thread pool each spend their time waiting on one another.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY = ["--num-envs", "16", "--n-steps", "8", "--batch-size", "64", "--iters", "1", "--warmup", "0",
        "--mnk", "3", "3", "3", "--arch", "mlp_tiny", "--device", "cpu"]


def jax_bench():
    """The JAX package's ``bench.py`` (at the repository root) as a module."""
    spec = importlib.util.spec_from_file_location("jax_bench", REPO / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bench_prints_one_json_line_with_the_jax_keys(capsys):
    record = bench.main(TINY)
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == record
    assert set(record) == {"metric", "value", "unit", "vs_baseline", "vs_north_star"}
    assert (record["metric"], record["unit"]) == ("env_steps_per_sec", "steps/s")
    assert record["value"] > 0
    reference = jax_bench()
    assert bench.REFERENCE_MEASURED_STEPS_PER_SEC == reference.REFERENCE_MEASURED_STEPS_PER_SEC
    assert bench.NORTH_STAR_STEPS_PER_SEC == reference.NORTH_STAR_STEPS_PER_SEC
    assert record["vs_baseline"] == round(record["value"] / 273.0, 2)
    assert "# card: cpu" in out.err and "# rollout fps" in out.err


@pytest.mark.parametrize("flag", [["--mnk", "3", "3", "3"], ["--batch-size", "64"],
                                  ["--num-envs", "16"], ["--n-steps", "8"], ["--iters", "1"],
                                  ["--warmup", "0"]], ids=lambda f: f[0])
def test_bench_learning_mode_refuses_throughput_flags(flag):
    with pytest.raises(SystemExit) as exc:
        bench.main(["--mode", "learning", "--device", "cpu", *flag])
    assert flag[0] in str(exc.value.code) and "ignored" in str(exc.value.code)


@pytest.mark.parametrize("flag", [["--update-chunks", "2"], ["--use-pallas"]],
                         ids=lambda f: f[0])
def test_bench_refuses_the_flags_it_does_not_port(flag):
    for mode in ("throughput", "learning"):
        for fused in ([], ["--fused"]):
            with pytest.raises(SystemExit) as exc:
                bench.main(["--mode", mode, "--device", "cpu", *fused, *flag])
            assert isinstance(exc.value.code, str) and f"{flag[0]} is not ported" in exc.value.code


# The fused bench is the 9x9x5 headline with batch 8192: 32 envs x 256
# steps make one minibatch.
FUSED_TINY = ["--fused", "--num-envs", "32", "--n-steps", "256", "--iters", "1", "--warmup", "0",
              "--arch", "mlp_tiny", "--device", "cpu"]


def test_bench_fused_prints_one_json_line_with_the_jax_keys(capsys):
    record = bench.main(FUSED_TINY)
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == record
    assert set(record) == {"metric", "value", "unit", "vs_baseline", "vs_north_star"}
    assert (record["metric"], record["unit"]) == ("env_steps_per_sec", "steps/s")
    assert record["value"] > 0
    assert record["vs_baseline"] == round(record["value"] / 273.0, 2)
    assert "# card: cpu" in out.err and "# fused dispatch step" in out.err


@pytest.mark.parametrize("flag", [["--mnk", "5", "5", "4"], ["--batch-size", "4096"]],
                         ids=lambda f: f[0])
def test_bench_fused_refuses_another_board_or_batch(flag):
    """As the JAX bench does: the fused throughput mode is the 9x9x5 headline."""
    with pytest.raises(SystemExit) as exc:
        bench.main(FUSED_TINY + flag)
    assert "9x9x5 headline only" in str(exc.value.code)


def test_bench_dispatch_needs_fused_and_scan_needs_the_card():
    """``--dispatch`` picks the fused trainer's dispatch: refused without
    ``--fused``; its CUDA graphs (``scan``) are refused on the CPU."""
    with pytest.raises(SystemExit) as exc:
        bench.main(["--device", "cpu", "--dispatch", "step"])
    assert "add --fused" in str(exc.value.code)
    with pytest.raises(ValueError, match="needs the card"):
        bench.main(FUSED_TINY + ["--dispatch", "scan"])


class Capture:
    """Stands in for ``train_mnk`` and ``MetricsLogger``: records each run's
    config and logger arguments."""

    def __init__(self):
        self.runs = []

    def install(self, monkeypatch, *modules):
        capture = self

        class Logger:
            def __init__(self, **kwargs):
                capture.runs.append({"logger": {k: v for k, v in kwargs.items() if k != "config"},
                                     "config": dict(kwargs["config"])})

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

        for module in modules:
            monkeypatch.setattr(module, "MetricsLogger", Logger)
            monkeypatch.setattr(module, "train_mnk", lambda config, logger=None: None)


@pytest.mark.parametrize("entry", ["train_all", "train_all_13", "train_worker_9x9",
                                   "train_worker_13x13", "train_short"])
def test_batch_entries_run_the_jax_configs_and_names(monkeypatch, entry):
    """Each batch entry hands ``train_mnk`` the JAX entry's configs, run
    names, projects, groups and tags, in the same order (``device`` is the
    port's own key)."""
    ours, theirs = Capture(), Capture()
    ours.install(monkeypatch, train_all)
    theirs.install(monkeypatch, jtrain_all, jtrain_all_13, jtrain_worker, jtrain_short)
    short = ["--learning_rate", "3e-4", "--entropy_coef", "0.02", "--architecture_name", "cnn_b_s",
             "--seed", "4", "--run-name", "s", "--mnk", "3", "3", "3", "--num-envs", "8",
             "--n-steps", "8", "--batch-size", "32", "--total-steps", "128"]
    calls = {
        "train_all": (lambda: train_all.main(["--device", "cpu"]), jtrain_all.main),
        "train_all_13": (lambda: train_all_13.main(["--device", "cpu"]), jtrain_all_13.main),
        "train_worker_9x9": (lambda: train_worker.main(["resnet_b_s", "9x9", "--device", "cpu"]),
                             lambda: jtrain_worker.run_training("resnet_b_s", "9x9")),
        "train_worker_13x13": (
            lambda: train_worker.main(["transformer_b_s_w", "13x13", "--device", "cpu"]),
            lambda: jtrain_worker.run_training("transformer_b_s_w", "13x13")),
        "train_short": (lambda: train_short.main(short + ["--device", "cpu"]),
                        lambda: jtrain_short.main(short)),
    }
    port_call, jax_call = calls[entry]
    port_call()
    jax_call()
    assert len(ours.runs) == len(theirs.runs) >= 1
    for got, want in zip(ours.runs, theirs.runs):
        assert got["logger"] == want["logger"]
        assert got["config"]["device"] == "cpu"
        for key, value in got["config"].items():
            if key != "device":
                assert value == want["config"][key], key


def test_train_worker_needs_its_two_arguments(capsys):
    with pytest.raises(SystemExit):
        train_worker.main(["resnet_b_s"])


def test_sweep_samples_the_jax_hyper_parameters_and_runs_two_trials(tmp_path, monkeypatch):
    """A two-trial micro sweep on the CPU (the JAX package's
    ``test_sweep_micro_two_trials``): the trials' hyper-parameters are those
    the JAX sweep samples from the same seed, every trial runs clean, and
    each is scored against random in the summary."""
    monkeypatch.chdir(tmp_path)
    rows = sweep.main(["--trials", "2", "--seed", "1", "--eval-episodes", "8", "--device", "cpu",
                       "--mnk", "3", "3", "3", "--num-envs", "8", "--n-steps", "8",
                       "--batch-size", "32", "--total-steps", str(8 * 8 * 2)])
    rng = random.Random(1)
    want = [jsweep.sample_config(rng) for _ in range(2)]
    assert sweep.SEARCH_SPACE == jsweep.SEARCH_SPACE
    assert [(r["learning_rate"], r["entropy_coef"], r["architecture_name"])
            for r in sorted(rows, key=lambda r: r["trial"])] == \
           [(round(w["learning_rate"], 8), round(w["entropy_coef"], 6), w["architecture_name"])
            for w in want]
    for t in range(2):
        lines = [json.loads(line) for line in open(tmp_path / "runs" / f"sweep_1_{t}.jsonl")]
        assert not any(k.startswith("error/") for rec in lines for k in rec)
        assert sum(1 for r in lines if "training/mean_reward" in r) == 2
    summary = json.load(open(tmp_path / "runs" / "sweep_1_summary.json"))
    assert len(summary["trials"]) == 2
    assert all(0.0 <= r["score_rate_vs_random"] <= 1.0 for r in summary["trials"])


def test_sweep_wandb_without_the_package_exits_with_a_message(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    with pytest.raises(SystemExit) as exc:
        sweep.main(["--wandb", "--trials", "1"])
    assert "--wandb needs the wandb package" in str(exc.value.code)
    with pytest.raises(SystemExit, match="would be ignored"):
        sweep.main(["--wandb", "--seed", "3"])


def test_sweep_wandb_agent_wiring(tmp_path, monkeypatch):
    """With a stand-in ``wandb`` module: the sweep is made from
    ``sweep_config.yaml``, the agent runs the trial function, and the trial
    hands ``run.config``'s hyper-parameters to ``train_short`` (the JAX
    package's ``test_sweep_wandb_agent_wiring``)."""
    pytest.importorskip("yaml")
    calls = {}

    class Run:
        config = {"learning_rate": 3e-4, "entropy_coef": 0.02, "architecture_name": "cnn_b_s"}

    mock = types.ModuleType("wandb")
    mock.init = lambda *a, **k: Run()

    def make_sweep(cfg, project=None):
        calls["sweep_cfg"], calls["project"] = cfg, project
        return "sweep-xyz"

    def agent(sweep_id, function=None, count=None):
        calls["sweep_id"], calls["count"] = sweep_id, count
        function()

    mock.sweep, mock.agent = make_sweep, agent
    monkeypatch.setitem(sys.modules, "wandb", mock)
    monkeypatch.setattr(sweep, "train_short_main", lambda argv: calls.setdefault("argv", argv))
    sweep.main(["--wandb", "--trials", "3"])
    assert calls["project"] == "mnk_b_sweeps" and calls["sweep_id"] == "sweep-xyz"
    assert calls["count"] == 3 and calls["sweep_cfg"]["program"] is not None
    assert calls["argv"] == ["--learning_rate", "0.0003", "--entropy_coef", "0.02",
                             "--architecture_name", "cnn_b_s"]
