"""Experiment tracking to a local JSONL file (counterpart of the JAX
package's ``utils/metrics.py``, without wandb): the same record layout, a
config record first, then ``{"_step", "_time", **metrics}`` lines."""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """``log(dict, step)`` / ``finish()``; one JSONL file per run."""

    def __init__(
        self,
        run_name: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
        out_dir: str = "runs",
    ):
        self.config = dict(config or {})
        self.run_name = run_name or time.strftime("%Y%m%d_%H%M%S")
        os.makedirs(out_dir, exist_ok=True)
        self._path = os.path.join(out_dir, f"{self.run_name}.jsonl")
        self._fh = open(self._path, "a")
        self._fh.write(json.dumps({"_type": "config", "config": _jsonable(self.config)}) + "\n")
        self._fh.flush()

    @property
    def jsonl_path(self) -> str:
        return self._path

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        record = {"_step": step, "_time": time.time(), **_jsonable(metrics)}
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def finish(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()


def _jsonable(d: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        # Non-finite floats as strings: strict JSON readers reject NaN tokens.
        if isinstance(v, float) and not math.isfinite(v):
            out[k] = str(v)
            continue
        try:
            json.dumps(v, allow_nan=False)
            out[k] = v
        except (TypeError, ValueError):
            out[k] = str(v)
    return out
