"""Rules of the port: it never imports JAX, the JAX package, or a package the
machine with the card does not promise (pandas, a plotting package; the one
exception is matplotlib for the tournament's optional PNG, imported in a
function under ``try``/``except ImportError`` in ``compare/visualizer.py``),
and its entry points (training, tournament, play, loading, the ranks of a
data-parallel run) run on the card unless the CPU is asked for, raising
without CUDA."""

import ast
import inspect
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from rl_selfplay_mnk_tpu_torch.train import get_default_config, train_mnk
from rl_selfplay_mnk_tpu_torch.utils.hardware import resolve_device

# One intra-op thread: the tensors here are tiny, and several test processes
# with a thread pool each spend their time waiting on one another.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "orbax", "msgpack", "rl_selfplay_mnk_tpu",
             "pandas", "matplotlib", "plotly")
PORT_FILES = sorted((REPO / "rl_selfplay_mnk_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


# Imports that one file may make where a failed import is handled: the PNG
# chart, written where matplotlib imports.
OPTIONAL_IMPORTS = {"rl_selfplay_mnk_tpu_torch/compare/visualizer.py": {"matplotlib"}}


def optional_import_nodes(tree):
    """Import nodes inside a ``try`` that catches ImportError, in a function."""
    out = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Try) and any(
                    isinstance(h.type, ast.Name) and h.type.id == "ImportError"
                    for h in node.handlers):
                out.update(id(n) for stmt in node.body for n in ast.walk(stmt))
    return out


def imported_roots(path, optional=()):
    """The top-level packages a source imports; those in ``optional`` are
    not counted where a failed import is handled in a function."""
    tree = ast.parse(path.read_text(), filename=str(path))
    guarded = optional_import_nodes(tree) if optional else set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [alias.name.split(".")[0] for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots = [node.module.split(".")[0]]
        else:
            continue
        for root in roots:
            if not (root in optional and id(node) in guarded):
                yield root


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_import_no_jax(path):
    optional = OPTIONAL_IMPORTS.get(str(path.relative_to(REPO)), set())
    bad = sorted(set(imported_roots(path, optional)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def test_the_optional_chart_import_is_the_only_one():
    """The visualizer imports matplotlib only where a failed import is
    handled; read without that allowance it does import it, so the rule
    above still sees every other import."""
    path = REPO / "rl_selfplay_mnk_tpu_torch" / "compare" / "visualizer.py"
    assert "matplotlib" in set(imported_roots(path))
    assert "matplotlib" not in set(imported_roots(path, {"matplotlib"}))
    assert (REPO / "rl_selfplay_mnk_tpu_torch" / "parallel" / "mesh.py") in PORT_FILES


BLOCKED_IMPORT = """
import importlib, importlib.abc, importlib.util, pkgutil, sys
FORBIDDEN = {forbidden!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import rl_selfplay_mnk_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(len(names))
"""


def test_port_imports_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", BLOCKED_IMPORT.format(forbidden=FORBIDDEN)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    config = get_default_config()
    config.update(mnk=(3, 3, 3), num_envs=8, n_steps=16, batch_size=32,
                  total_environment_steps=8 * 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_mnk(config)
    assert resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_take_no_plain_route_off_the_cpu():
    """Only a CPU tensor gets the plain version; any other device either
    launches the kernel or raises."""
    from rl_selfplay_mnk_tpu_torch.env import EnvConfig, make_env_state
    from rl_selfplay_mnk_tpu_torch.ops.env_step import fused_step
    from rl_selfplay_mnk_tpu_torch.ops.resblock import fused_residual_block

    x = torch.empty((2, 25, 16), device="meta")
    w = torch.empty((144, 16), device="meta")
    b = torch.empty((16,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_residual_block(x, w, b, w, b, 5, 5)
    state = make_env_state(EnvConfig(3, 3, 3), 2, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_step(EnvConfig(3, 3, 3), state, torch.empty((2,), dtype=torch.int64, device="meta"))

    from rl_selfplay_mnk_tpu_torch.ops import attention

    folded = torch.empty((4, 8, 9), device="meta")
    packed = torch.empty((2, 9, 16), device="meta")
    for call in (
        lambda: attention.attention_folded_fwd(folded, folded, folded),
        lambda: attention.attention_folded_bwd(folded, folded, folded, folded),
        lambda: attention.attention_packed_fwd(packed, packed, packed, 2, 8),
        lambda: attention.attention_packed_bwd(packed, packed, packed, packed, 2, 8),
        lambda: attention.attention_lane_slice_fwd(packed, packed, packed, 2, 8),
        lambda: attention.attention_infold_fwd(packed, packed, packed, 2, 8),
        lambda: attention.attention_infold_bwd(packed, packed, packed, packed, 2, 8),
        lambda: attention.attention_folded(folded, folded, folded),
        lambda: attention.attention_packed(packed, packed, packed, 2, 8),
        lambda: attention.attention_infold(packed, packed, packed, 2, 8),
        lambda: attention.tiny_head_attention(*[torch.empty((2, 9, 2, 8), device="meta")] * 3),
        lambda: attention.tiny_head_attention(*[torch.empty((2, 9, 2, 32), device="meta")] * 3),
        *(lambda route=route: attention.tiny_head_attention(
            *[torch.empty((2, 9, 2, 8), device="meta")] * 3, route=route)
          for route in attention.ROUTES),
        lambda: attention.tiny_head_attention(
            *[torch.empty((2, 9, 2, 8), device="meta", requires_grad=True)] * 3),
    ):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def test_no_gradient_route_takes_no_transpose_and_one_kernel(monkeypatch):
    """Dh < 32 without a gradient: the forward-only kernel gets the caller's
    own memory, reshaped, and its result goes back reshaped; no layout
    operation copies anything and no other wrapper is called."""
    from rl_selfplay_mnk_tpu_torch.ops import attention

    seen = []

    def lane_slice(q, k, v, h, dh):
        seen.append((q, k, v, h, dh))
        return torch.full_like(q, 7.0)

    def other(*args, **kwargs):
        raise AssertionError("the no-gradient route called another attention wrapper")

    monkeypatch.setattr(attention, "attention_lane_slice_fwd", lane_slice)
    for name in ("attention_folded", "attention_packed", "attention_infold", "attention_folded_fwd",
                 "attention_packed_fwd", "attention_infold_fwd", "attention_packed_reference",
                 "attention_lane_slice_reference", "attention_infold_reference"):
        monkeypatch.setattr(attention, name, other)
    # As the models give them: one projection's (B, L, H * Dh) viewed as heads.
    inputs = [torch.randn(3, 9, 56).reshape(3, 9, 4, 14) for _ in range(3)]
    with torch.no_grad():
        out = attention.tiny_head_attention(*inputs)
    (q, k, v, h, dh), = seen
    assert (h, dh) == (4, 14)
    for got, given in zip((q, k, v), inputs):
        assert got.shape == (3, 9, 56) and got.is_contiguous()
        assert got.data_ptr() == given.data_ptr()  # a view, not a copy
    assert out.shape == (3, 9, 4, 14) and out.is_contiguous() and bool((out == 7.0).all())


ATTENTION_LIBRARY_CALLS = ("scaled_dot_product_attention", "torch.compile", "bmm(", "einsum(",
                           "matmul(", " @ ", "baddbmm(")


def test_attention_module_computes_attention_in_its_kernels_only():
    """Outside its ``*_reference`` functions ``ops/attention.py`` calls no
    library routine for the attention arithmetic: no fused attention, no
    compiled plain version, no batched matrix product."""
    path = REPO / "rl_selfplay_mnk_tpu_torch" / "ops" / "attention.py"
    source = path.read_text()
    tree = ast.parse(source)
    references = [n for n in ast.walk(tree)
                  if isinstance(n, ast.FunctionDef) and n.name.endswith("_reference")]
    assert len(references) >= 4
    lines = source.splitlines()
    for node in references:
        for i in range(node.lineno - 1, node.end_lineno):
            lines[i] = ""
    rest = "\n".join(lines[ast.get_docstring(tree).count("\n") + 2:])
    for call in ATTENTION_LIBRARY_CALLS:
        assert call not in rest, f"ops/attention.py uses {call!r} outside a *_reference function"
    assert "matmul(" in source  # the plain versions do use it


@pytest.mark.parametrize("entry", ["make_env_state", "selfplay_reset", "validate"])
def test_env_entry_points_default_to_the_card(monkeypatch, entry):
    """Without a ``device`` the env, the self-play reset and validation run
    on the card, and raise without CUDA instead of using the CPU."""
    from rl_selfplay_mnk_tpu_torch.env import EnvConfig, make_env_state
    from rl_selfplay_mnk_tpu_torch.selfplay import RandomPolicy
    from rl_selfplay_mnk_tpu_torch.selfplay.validation import validate
    from rl_selfplay_mnk_tpu_torch.selfplay.wrapper import selfplay_reset

    cfg, policy = EnvConfig(3, 3, 3), RandomPolicy(torch.Generator().manual_seed(0))
    calls = {
        "make_env_state": lambda *dev: make_env_state(cfg, 4, *dev),
        "selfplay_reset": lambda *dev: selfplay_reset(cfg, policy, 4, *dev),
        "validate": lambda *dev: validate(cfg, policy, policy, 4, *dev),
    }
    assert calls[entry]("cpu") is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


@pytest.mark.parametrize("entry", ["compare_models", "play", "replay", "load_any_model",
                                   "load_policy_from_arg", "ModelInfo", "MatchRunner",
                                   "play_batch_games"])
def test_serving_entry_points_default_to_the_card(monkeypatch, tmp_path, capsys, entry):
    """The tournament, play and loading entry points run on the card unless
    the caller names the CPU, and raise without CUDA instead of using it."""
    from rl_selfplay_mnk_tpu_torch import compare_models, play
    from rl_selfplay_mnk_tpu_torch.compare.match_runner import GameConfig, MatchRunner, play_batch_games
    from rl_selfplay_mnk_tpu_torch.compare.model_loader import ModelLoader
    from rl_selfplay_mnk_tpu_torch.env import EnvConfig
    from rl_selfplay_mnk_tpu_torch.models import create_model_from_architecture, init_network
    from rl_selfplay_mnk_tpu_torch.selfplay import RandomPolicy
    from rl_selfplay_mnk_tpu_torch.utils.model_export import ModelExporter, load_any_model

    run = str(tmp_path / "run")
    exporter = ModelExporter("run", base_dir=str(tmp_path))
    for iteration in (0, 1):
        model, arch_params = create_model_from_architecture("mlp_tiny", (2, 3, 3), 9)
        init_network(model, torch.Generator().manual_seed(iteration))
        exporter.export_model(model, "mlp_tiny", arch_params, iteration)
    board = ["--board", "3", "3", "3"]
    mnk = ["--m", "3", "--n", "3", "--k", "3"]
    act = RandomPolicy().apply
    record = tmp_path / "game.json"
    record.write_text('{"mnk": [3, 3, 3], "players": ["a", "b"], "moves": [0, 3, 1, 4, 2], "winner": 0}')
    calls = {
        "compare_models": lambda *dev: compare_models.main(
            [run, "--games", "2", *board, "--output", str(tmp_path / "out"),
             *(["--device", *dev] if dev else [])]),
        "play": lambda *dev: play.main(["--p1", run, "--p2", "random", *mnk, "--seed", "0",
                                        *(["--device", *dev] if dev else [])]),
        "replay": lambda *dev: play.main(["--import_game", str(record), "--delay", "0",
                                          *(["--device", *dev] if dev else [])]) or True,
        "load_any_model": lambda *dev: load_any_model(run, "model_00001", torch.float32, *dev),
        "load_policy_from_arg": lambda *dev: play.load_policy_from_arg(run, (3, 3), *dev),
        "ModelInfo": lambda *dev: ModelLoader(*dev).load_from_paths([run])[0].load_model(),
        "MatchRunner": lambda *dev: MatchRunner(GameConfig(3, 3, 3), 0, *dev),
        "play_batch_games": lambda *dev: play_batch_games(EnvConfig(3, 3, 3), act, act, None, None,
                                                          4, 0, None, *dev),
    }
    assert calls[entry]("cpu") is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


@pytest.mark.parametrize("entry", ["train", "bench", "train_all", "train_all_13", "train_worker",
                                   "train_short", "sweep", "train_fused", "bench_fused",
                                   "baseline_config1"])
def test_trainer_entry_points_default_to_the_card(monkeypatch, tmp_path, entry):
    """The trainer's command line, the bench and the batch entries run on
    the card unless ``--device cpu`` is given, and raise without CUDA. The
    batch entries' ``train_mnk`` is replaced by its first step, the device's
    resolution (their six full-size runs are no test); the trainer runs
    zero iterations on 3x3x3, the bench one tiny iteration; ``--fused`` takes
    both through the fused trainer."""
    from rl_selfplay_mnk_tpu_torch import baseline_config1, bench, sweep, train, train_all, \
        train_all_13, train_short, train_worker
    from rl_selfplay_mnk_tpu_torch.utils.hardware import detect_hardware_config

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(train_all, "train_mnk",
                        lambda config, logger=None: detect_hardware_config(config["device"]))

    def on(dev):
        return ["--device", *dev] if dev else []

    tiny = ["--mnk", "3", "3", "3", "--num-envs", "8", "--batch-size", "32"]
    calls = {
        "train": lambda *dev: train.main(tiny + ["--total-steps", "8", "--run-name", "r",
                                                 "--export-dir", str(tmp_path / "m"), *on(dev)]),
        "bench": lambda *dev: bench.main(["--num-envs", "16", "--n-steps", "8", "--batch-size", "64",
                                          "--iters", "1", "--warmup", "0", "--mnk", "3", "3", "3",
                                          "--arch", "mlp_tiny", *on(dev)]),
        "train_all": lambda *dev: train_all.main(on(dev)),
        "train_all_13": lambda *dev: train_all_13.main(on(dev)),
        "train_worker": lambda *dev: train_worker.main(["cnn_b_s", "13x13", *on(dev)]),
        "train_short": lambda *dev: train_short.main(on(dev)),
        "sweep": lambda *dev: sweep.main(["--trials", "1", *on(dev)]),
        "train_fused": lambda *dev: train.main(tiny + ["--fused", "--total-steps", "8",
                                                       "--run-name", "f", "--export-dir",
                                                       str(tmp_path / "m"), *on(dev)]),
        "bench_fused": lambda *dev: bench.main(["--fused", "--num-envs", "32", "--n-steps", "256",
                                                "--iters", "1", "--warmup", "0",
                                                "--arch", "mlp_tiny", *on(dev)]),
        "baseline_config1": lambda *dev: baseline_config1.main(["--iters", "1", *on(dev)]),
    }
    calls[entry]("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


@pytest.mark.parametrize("fused", [False, True])
def test_multihost_entry_points_default_to_the_card(monkeypatch, fused):
    """A rank of ``train --multihost`` takes its card unless ``--device``
    names another, and raises without CUDA before it joins the group (the
    CPU ranks: ``tests/test_torch_distributed.py``)."""
    from rl_selfplay_mnk_tpu_torch import train
    from rl_selfplay_mnk_tpu_torch.parallel.mesh import rank_device

    assert rank_device(None, 1) == torch.device("cuda:1")
    assert rank_device("cuda", 0) == torch.device("cuda:0")
    assert rank_device("cpu", 1) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--multihost", "--run-name", "r", "--num-processes", "2", "--process-id", "0",
            "--coordinator-address", "localhost:1", "--mnk", "3", "3", "3"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(argv + (["--fused"] if fused else []))


def test_launched_ranks_default_to_the_card():
    """``parallel.launch`` starts ranks on their cards unless a device is
    named; without CUDA each rank raises and the launch reports it."""
    from rl_selfplay_mnk_tpu_torch.parallel.launch import launch

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch("torch_rank_workers:first_legal", 2, timeout=60)


def test_count_params_is_the_one_entry_point_that_needs_no_card(monkeypatch):
    """``count_params`` is exempt from "the card unless the caller asks for
    the CPU": it runs no forward and no kernel, only reads the shapes of a
    module it builds, so it takes no device and works where CUDA is absent."""
    from rl_selfplay_mnk_tpu_torch import count_params

    assert "device" not in inspect.signature(count_params.param_counts).parameters
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    counts = count_params.param_counts("transformer_b_s", 9, 9)
    assert sum(counts.values()) > 0 and all(isinstance(c, int) for c in counts.values())


@pytest.mark.parametrize("error,stops", [("kernel", True), ("other", False)])
def test_train_mnk_stops_on_kernel_errors_only(monkeypatch, tmp_path, error, stops):
    """A kernel that fails to build or launch ends the run; any other error
    in an iteration is logged and the loop goes on, as in the JAX trainer."""
    from rl_selfplay_mnk_tpu_torch.alg.ppo import PPOLearner
    from rl_selfplay_mnk_tpu_torch.ops.cuda_build import KernelError
    from rl_selfplay_mnk_tpu_torch.utils.metrics import MetricsLogger

    calls = []

    def failing_learn(self, *args, **kwargs):
        calls.append(1)
        if error == "kernel":
            raise KernelError("CUDA kernel env_step failed to launch: cudaError 700")
        raise ValueError("bad batch")

    monkeypatch.setattr(PPOLearner, "learn", failing_learn)
    config = get_default_config()
    config.update(mnk=(3, 3, 3), num_envs=8, n_steps=16, batch_size=32,
                  total_environment_steps=8 * 16 * 3, export_dir=str(tmp_path / "models"))
    with MetricsLogger(run_name="errors", config=config, out_dir=str(tmp_path)) as logger:
        if stops:
            with pytest.raises(KernelError):
                train_mnk(config, logger, device="cpu")
        else:
            summary = train_mnk(config, logger, device="cpu")
            assert len(summary["errors"]) == 3
    assert len(calls) == (1 if stops else 3)


CSRC = REPO / "rl_selfplay_mnk_tpu_torch" / "csrc"
# What the tensor-core kernels may include: the CUDA runtime's own headers and the port's.
KERNEL_INCLUDES = {"cuda_bf16.h", "cuda_runtime.h", "stdint.h", "math.h", "attn_common.cuh",
                   "mma_common.cuh", "attn_mma.cuh"}
LIBRARY_KERNEL_NAMES = ("cublas", "cudnn", "cutlass", "cute::", "cufft", "cusparse", "thrust",
                        "cub::", "torch", "aten", "c10", "scaled_dot_product", "flash")


def code_of(path):
    """A CUDA source with its comments taken out."""
    text = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


@pytest.mark.parametrize("name", ["resblock.cu", "attention.cu", "attention_bwd.cu",
                                  "attention_board.cu", "mma_common.cuh", "attn_mma.cuh",
                                  "attention_folded_bwd.cu"])
def test_tensor_core_sources_call_no_library_kernel(name):
    """The bf16 K2-K9 compute inside their own bodies: no header
    beyond CUDA's runtime ones and the port's, no library GEMM, convolution
    or attention, and the products are the port's own ``mma.sync`` wrapper:
    in the kernel's source, or, for K4, in the [channel][token] backward core
    of ``attn_mma.cuh`` that it calls (and that K7 shares), which holds them."""
    code = code_of(CSRC / name)
    includes = set(re.findall(r'#include\s*[<"]([^>"]+)[>"]', code))
    assert includes <= KERNEL_INCLUDES, f"{name} includes {sorted(includes - KERNEL_INCLUDES)}"
    lowered = code.lower()
    for library in LIBRARY_KERNEL_NAMES:
        assert library not in lowered, f"{name} names {library!r}"
    own_products = code.count("mma_bf16_16816(") >= 2 and "ldmatrix_x4" in code
    if name.endswith(".cu"):
        assert '#include "mma_common.cuh"' in code
        shared_core = '#include "attn_mma.cuh"' in code and "fold_bwd_passes<kKT, kDK>(" in code
        assert own_products or shared_core
    elif name == "mma_common.cuh":
        assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in code
    else:
        assert '#include "mma_common.cuh"' in code
        assert own_products
