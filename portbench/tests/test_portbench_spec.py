"""Every cell, configuration, traffic mix and metric is found by name, and
a new one is found by adding files alone."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import reference, spec

BENCH = json.loads(spec.BENCHMARK.read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_found_and_agrees_with_benchmark_json(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    cfg, traffic = spec.cell(cell)
    assert cfg["name"] == entry["config"]
    assert traffic["name"] == entry["traffic"]
    assert spec.chips(cell) == entry["chips"] == 1
    limits = json.loads((spec.ROOT / "limits" / f"{cell}.json").read_text())
    assert set(limits) - {"readings"} == {"env_mismatch", "logp_gap", "value_gap", "opp_z", "loss_gap",
                           "grad_gap", "change_gap"}


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file_states_its_source_and_cuts(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = json.loads((spec.ROOT.parent / entry["file"]).read_text())
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert reference.parameter_count(cfg) == cfg["parameters"]


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_is_found_and_agrees_with_benchmark_json(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    reader = spec.load_metric(name)
    assert (reader.UNIT, reader.LAYER, reader.SOURCE, reader.MOVES) == (
        entry["unit"], entry["layer"], entry["source"], entry["moves"])
    for cell in entry["workloads"]:
        assert name in spec.metric_names(cell)


def test_metric_names_follow_the_cell():
    assert "K2_roofline" in spec.metric_names("resnet_b_s.fused384")
    assert "K2_roofline" not in spec.metric_names("transformer_b_s.fused384")
    assert "K4_roofline" in spec.metric_names("transformer_b_s.loop8192")


@pytest.mark.parametrize("kind", ["configs", "traffic", "cells", "metrics"])
def test_a_missing_name_is_refused(kind):
    with pytest.raises(SystemExit):
        if kind == "metrics":
            spec.load_metric("no_such_metric")
        else:
            spec.load(kind, "no_such_name")


def test_new_cell_and_metric_need_new_files_only(tmp_path):
    """In a copy of the benchmark, a new traffic mix, cell, limits file and
    metric reader are found, and no file that was there changes."""
    root = tmp_path / "repo"
    shutil.copytree(spec.ROOT, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = dict(BENCH)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    mix = json.loads((root / "portbench/traffic/fused384.json").read_text())
    mix.update(name="fused768", num_envs=768)
    (root / "portbench/traffic/fused768.json").write_text(json.dumps(mix))
    (root / "portbench/cells/resnet_b_s.fused768.json").write_text(
        json.dumps({"config": "resnet_b_s", "traffic": "fused768"}))
    shutil.copy(root / "portbench/limits/resnet_b_s.fused384.json",
                root / "portbench/limits/resnet_b_s.fused768.json")
    (root / "portbench/metrics/validation_ms.py").write_text(
        'UNIT = "ms"\nLAYER = "Validation"\nSOURCE = "program_span"\n'
        'MOVES = "env_steps_per_s"\n\n\ndef read(ctx, yardstick):\n'
        '    return ctx["spans_ms"].get("validation")\n')
    bench["workloads"] = BENCH["workloads"] + [{"name": "resnet_b_s.fused768",
                                               "config": "resnet_b_s", "traffic": "fused768",
                                               "chips": 1, "why": "wider"}]
    bench["per_layer"] = BENCH["per_layer"] + [{"name": "validation_ms", "unit": "ms",
                                               "better": "lower", "source": "program_span",
                                               "layer": "Validation",
                                               "moves": "env_steps_per_s",
                                               "workloads": ["resnet_b_s.fused768"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys; sys.path.insert(0, sys.argv[1]); from portbench import spec, check\n"
        "cfg, t = spec.cell('resnet_b_s.fused768')\n"
        "names = spec.metric_names('resnet_b_s.fused768')\n"
        "r = spec.load_metric('validation_ms').read({'spans_ms': {'validation': 2.5}}, None)\n"
        "print(json.dumps([cfg['name'], t['num_envs'], names, r,"
        " sorted(check.load_limits('resnet_b_s.fused768'))]))\n")
    out = subprocess.run([sys.executable, "-c", code, str(root)], capture_output=True, text=True,
                         check=True).stdout
    name, envs, names, value, limits = json.loads(out.strip().splitlines()[-1])
    assert (name, envs, value) == ("resnet_b_s", 768, 2.5)
    assert names == ["validation_ms"]  # the cell is in no other metric's list
    assert "env_mismatch" in limits
    for path, data in before.items():
        assert path.read_bytes() == data, path
