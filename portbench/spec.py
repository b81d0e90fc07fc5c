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
    return load("configs", c["config"]), load("traffic", c["traffic"])


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
