"""Experiment tracking to a local JSONL file (counterpart of the JAX
package's ``utils/metrics.py``, without wandb): the same record layout, a
config record first (with the run's project, group and tags), then
``{"_step", "_time", **metrics}`` lines; ``NullMetricsLogger`` for the ranks
that do not write."""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """``log(dict, step)`` / ``finish()``; one JSONL file per run, appended
    to when the run's name comes back (a resumed run)."""

    def __init__(
        self,
        run_name: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
        out_dir: str = "runs",
        project: str = "mnk",
        group: Optional[str] = None,
        tags: Optional[list] = None,
    ):
        self.config = dict(config or {})
        self.run_name = run_name or time.strftime("%Y%m%d_%H%M%S")
        self.project, self.group, self.tags = project, group, list(tags or [])
        os.makedirs(out_dir, exist_ok=True)
        self._path = os.path.join(out_dir, f"{self.run_name}.jsonl")
        self._fh = open(self._path, "a")
        self._fh.write(json.dumps({"_type": "config", "config": _jsonable(self.config),
                                   "project": project, "group": group, "tags": self.tags}) + "\n")
        self._fh.flush()

    @property
    def jsonl_path(self) -> str:
        return self._path

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        record = {"_step": step, "_time": time.time(), **_jsonable(metrics)}
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def drop_after(self, step: int) -> int:
        """Remove the records logged at an env step past ``step`` (a run
        resumed from a checkpoint at ``step`` logs them again); returns how
        many went."""
        self._fh.close()
        with open(self._path) as f:
            lines = f.readlines()
        kept = [line for line in lines if (json.loads(line).get("_step") or 0) <= step]
        with open(self._path, "w") as f:
            f.writelines(kept)
        self._fh = open(self._path, "a")
        return len(lines) - len(kept)

    def finish(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()


class NullMetricsLogger:
    """The logger of a rank other than 0 in a data-parallel run: every rank
    drives the same loop, only rank 0 writes (``parallel.mesh.is_coordinator``).
    ``MetricsLogger``'s surface, writing nothing."""

    def __init__(self, run_name: Optional[str] = None, config: Optional[Dict[str, Any]] = None,
                 **_):
        self.config = dict(config or {})
        self.run_name = run_name or time.strftime("%Y%m%d_%H%M%S")
        self.jsonl_path = os.devnull

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        pass

    def drop_after(self, step: int) -> int:
        return 0

    def finish(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


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
