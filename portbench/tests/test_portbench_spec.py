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


FAMILY = '''"""A mixture of stacked dense maps over each cell's two planes, averaged."""

import torch

from .. import yardstick

BATCH_COUPLED = False


def body_shapes(cfg):
    e, d = cfg["num_experts"], cfg["embed_dim"]
    return {"experts.weight": ((e, d, 2), ("kernel", 2)), "experts.bias": ((d,), "zero")}, d


def body(cfg, p, obs, train, prec):
    b, c, m, n = obs.shape
    tokens = obs.permute(0, 2, 3, 1).reshape(b, m * n, c)
    y = torch.einsum("blc,edc->bled", prec.operand(tokens), prec.operand(p["experts.weight"]))
    return prec.product(y).mean(2) + p["experts.bias"]


def body_flops(cfg):
    m, n, _ = cfg["mnk"]
    return float(2 * m * n * cfg["num_experts"] * cfg["embed_dim"] * 2)


def kernel_work(cfg, traffic):
    return {"KX": ("expert_gemm", traffic["n_steps"] * yardstick.bound_s(1e6, 1e6, "bfloat16"))}
'''


def test_new_family_needs_new_files_only(tmp_path):
    """In a copy of the benchmark, a family file with a stacked tensor of a
    stated fan-in and a configuration that names it are found: the weights
    scale that tensor by its stated fan-in, and the forward, the FLOPs and
    the kernel work run through it; no file that was there changes."""
    root = tmp_path / "repo"
    shutil.copytree(spec.ROOT, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    (root / "portbench/families/tiny_mix.py").write_text(FAMILY)
    cfg = json.loads((root / "portbench/configs/transformer_b_s.json").read_text())
    cfg.update(name="tiny_mix", family="tiny_mix", mnk=[3, 3, 3], num_experts=4, embed_dim=6,
               head_hidden=4)
    (root / "portbench/configs/tiny_mix.json").write_text(json.dumps(cfg))
    code = (
        "import json, math, sys; sys.path.insert(0, sys.argv[1]); import torch\n"
        "from portbench import reference, spec, yardstick\n"
        "cfg = spec.load('configs', 'tiny_mix')\n"
        "fam = spec.family(cfg)\n"
        "w = reference.make_weights(cfg, 11, 'cpu')\n"
        "drawn = sum(math.prod(s) for s, i in reference.param_shapes(cfg).values()\n"
        "            if reference.init_kind(i)[0] in ('kernel', 'embed'))\n"
        "flat = torch.randn(drawn, generator=torch.Generator().manual_seed(11))\n"
        "want = flat[:48].view(4, 6, 2) * (1.0 / math.sqrt(2))\n"
        "logits, value = reference.forward(cfg, w, torch.zeros((5, 2, 3, 3)), True)\n"
        "work = yardstick.kernel_work(cfg, spec.load('traffic', 'fused384'))\n"
        "print(json.dumps([spec.families(), fam.__name__, torch.equal(w['experts.weight'], want),\n"
        "                  list(logits.shape), list(value.shape),\n"
        "                  yardstick.forward_flops(cfg) - fam.body_flops(cfg), sorted(work)]))\n")
    out = subprocess.run([sys.executable, "-c", code, str(root)], capture_output=True, text=True,
                         check=True).stdout
    found, module, scaled, logits, value, head_flops, kernels = json.loads(
        out.strip().splitlines()[-1])
    assert "tiny_mix" in found and module == "portbench.families.tiny_mix"
    assert scaled  # 1 / sqrt(2), the stated fan-in, not 1 / sqrt(6 * 2)
    assert (logits, value) == ([5, 9], [5])
    cells, c, h = 9, 6, 4
    assert head_flops == 2 * cells * c * 3 + 2 * (2 * cells) * h + 2 * cells * h + 2 * h * cells \
        + 2 * h
    assert kernels == ["K1", "KX"]
    for path, data in before.items():
        assert path.read_bytes() == data, path
