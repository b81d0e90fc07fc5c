"""A whole run of each training loop on the CPU at a tiny size (the harness's look
for a card skipped), its last line, and the comparison turning ``correct``
false under each fault the cells can have and under the float8 control."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import check, control, run, spec

TINY = {"num_envs": 32, "n_steps": 16, "batch_size": 128, "validation_episodes": 8}
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def tiny_run(cell: str, trace: int = 0, seed: int = 3_000_000_123) -> dict:
    return run.run(["--workload", cell, "--seed", str(seed), "--seconds", "0", "--trace",
                    str(trace)], device="cpu", traffic_overrides=TINY,
                   dispatch="step" if "fused" in cell else None)


@pytest.mark.parametrize("cell", ["resnet_b_s.fused384", "transformer_b_s.loop8192"])
def test_a_sound_run_is_correct_and_prints_the_contract_keys(cell):
    out = tiny_run(cell)
    assert list(out) == KEYS  # ``checks`` comes last
    assert out["correct"] is True
    assert out["attempted"] == 5 and out["failed"] == 0
    assert set(out["metrics"]) == {"env_steps_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["checks"]) == set(check.NUMBERS) | {"iteration_errors"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())


def test_a_traced_run_reports_per_layer_metrics_only():
    out = tiny_run("transformer_b_s.loop8192", trace=1)
    names = set(spec.metric_names("transformer_b_s.loop8192"))
    assert out["metrics"] and set(out["metrics"]) <= names
    assert "env_steps_per_s" not in out["metrics"]
    assert 0 < out["metrics"]["mfu"]["value"] < 100
    assert out["correct"] is True


def test_an_iteration_that_raises_is_failed_and_not_correct(monkeypatch):
    """The program's loop logs an iteration that raises and goes on; the
    run counts it as failed and is not correct, whatever iteration 0 read."""
    from rl_selfplay_mnk_tpu_torch.alg import ppo

    update, calls = ppo.PPOLearner.update, [0]

    def flaky(self, *a, **k):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("planted")
        return update(self, *a, **k)

    monkeypatch.setattr(ppo.PPOLearner, "update", flaky)
    out = tiny_run("transformer_b_s.loop8192")
    assert out["failed"] == 1
    assert out["checks"]["iteration_errors"] == {"value": 1, "limit": 0}
    assert out["correct"] is False


FAULTED = (
    "import json, sys; sys.path.insert(0, sys.argv[1]); import torch; torch.set_num_threads(2)\n"
    "from portbench import control, run\n"
    "control.FAULTS[sys.argv[2]]()\n"
    "out = run.run(['--workload', sys.argv[3], '--seed', '77', '--seconds', '0', '--trace', '0'],"
    " device='cpu', traffic_overrides=json.loads(sys.argv[4]),"
    " dispatch='step' if 'fused' in sys.argv[3] else None)\n"
    "print(json.dumps(out))\n")


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
@pytest.mark.parametrize("cell", ["resnet_b_s.fused384", "transformer_b_s.loop8192"])
def test_a_broken_timed_path_is_not_correct(fault, cell):
    res = subprocess.run([sys.executable, "-c", FAULTED, str(spec.ROOT.parent), fault, cell,
                          json.dumps(TINY)], capture_output=True, text=True, check=True)
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is False
    over = [k for k, c in out["checks"].items() if c["value"] > c["limit"]]
    assert over, out["checks"]


def test_a_step_that_leaves_the_state_unchanged_reads_one():
    """The change of a step that returns its state unchanged is 0, so each
    leaf's gap is its whole change: 1 by the measure, over every limit."""
    want = {"a": torch.ones(3), "b": torch.full((2,), 2.0)}
    got = {k: torch.zeros_like(v) for k, v in want.items()}
    gaps = check._leaf_gaps(got, want, list(want))
    assert max(gaps.values()) == 1.0
    for cell in ("resnet_b_s.fused384", "transformer_b_s.fused384", "resnet_b_s.loop8192",
                 "transformer_b_s.loop8192"):
        assert check.load_limits(cell)["change_gap"] < 1.0


@pytest.mark.parametrize("cell", ["resnet_b_s.fused384", "transformer_b_s.loop8192"])
def test_the_float8_control_is_not_correct(cell):
    rec = control.readings(cell, [5], 1, device="cpu", traffic_overrides=TINY,
                           dispatch="step" if "fused" in cell else None)[0]
    limits = check.load_limits(cell)
    assert all(v <= limits[k] for k, v in rec["program"].items() if k in limits)
    assert any(v > limits[k] for k, v in rec["control"].items() if k in limits)


def test_without_a_card_it_exits_non_zero_and_prints_nothing(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "resnet_b_s.fused384", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_a_checkout_without_the_program_exits_non_zero(tmp_path):
    shutil.copytree(spec.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "resnet_b_s.fused384", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True)
    assert res.returncode != 0
    assert res.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "resnet_b_s.fused384", "--seed", "2147483651", "--seconds", "1",
                          "--trace", "0"], cwd=spec.ROOT.parent, capture_output=True, text=True,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
