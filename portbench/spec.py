"""Finding a cell, its configuration, its traffic and its per-layer
metrics by name: each lives in a file of its own under this folder, so a
later change adds one by adding a file (and its line in
``BENCHMARK.json``), and edits none.

  cells/<cell>.json      {"config": <name>, "traffic": <name>}
  configs/<name>.json    the network, board and family hyper-parameters
  traffic/<name>.json    the runner, envs, steps, batch, epochs, opponents,
                         validation
  metrics/<name>.py      a reader: ``UNIT``, ``LAYER``, ``SOURCE``,
                         ``MOVES`` and ``read(ctx, yardstick)``
  limits/<cell>.json     the limit of each number that decides ``correct``
  families/<family>.py   a network family (``family``): its body's
                         parameters, plain float32 body, FLOPs and kernels
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"


def load(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"portbench: no {kind[:-1] if kind.endswith('s') else kind} named "
                         f"{name!r} ({path})")
    return json.loads(path.read_text())


def cell(name: str):
    """(configuration, traffic) of the cell ``name``."""
    c = load("cells", name)
    cfg = load("configs", c["config"])
    family(cfg)
    return cfg, load("traffic", c["traffic"])


def benchmark() -> dict:
    return json.loads(BENCHMARK.read_text()) if BENCHMARK.is_file() else {}


def chips(name: str) -> int:
    """The cards the cell asks for in ``BENCHMARK.json`` (1 without it)."""
    for w in benchmark().get("workloads", []):
        if w["name"] == name:
            return int(w["chips"])
    return 1


def metric_names(cell_name: str) -> list:
    """The per-layer metrics that ``BENCHMARK.json`` lists for the cell (a
    metric without ``workloads`` is every cell's); without the file, every
    reader under ``metrics/``."""
    listed = benchmark().get("per_layer")
    if listed is None:
        return sorted(p.stem for p in (ROOT / "metrics").glob("*.py"))
    return [m["name"] for m in listed if cell_name in m.get("workloads", [cell_name])]


def load_metric(name: str):
    """The reader module ``metrics/<name>.py``."""
    path = ROOT / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"portbench: no metric reader named {name!r} ({path})")
    mod_spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def families() -> list:
    return sorted(p.stem for p in (ROOT / "families").glob("*.py") if p.stem != "__init__")


def family(cfg: dict):
    """The module ``families/<cfg["family"]>.py``, which defines

      body_shapes(cfg) -> (dict, width)   name -> (shape, init) of the body's
                                          parameters and buffers, in the
                                          program's state-dict naming and
                                          order, and the width the heads read
      body(cfg, p, obs, train, prec)      the plain float32 body -> features
      body_flops(cfg) -> float            model FLOPs of one board's body
      kernel_work(cfg, traffic) -> dict   kernel -> (symbol substring, least
                                          seconds an iteration)
      BATCH_COUPLED                       True where a layer mixes boards in
                                          train mode (BatchNorm)

    A family builds on what every family shares, and may use these names:
    from ``reference``, the precisions' ``operand`` and ``product`` and the
    layers ``_linear``, ``_conv``, ``_layer_norm``, ``_attention`` and
    ``_batch_norm``; from ``yardstick``, the least times ``bound_s``,
    ``k2_bound_s`` and ``attention_bound_s``. It imports them inside the
    package (``from .. import reference``), and nothing of the program."""
    name = cfg["family"]
    if not (name.isidentifier() and (ROOT / "families" / f"{name}.py").is_file()):
        raise ValueError(f"unknown family {name!r}; families found: {', '.join(families())}")
    module = importlib.import_module(f"{__package__}.families.{name}")
    return module
