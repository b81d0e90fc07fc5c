"""Tournament model discovery and lazy loading (counterpart of the JAX
package's ``compare/model_loader.py``).

Accepts files, directories and globs, drops duplicates by (run_name,
iteration), loads weights lazily and can unload them. "Loaded" means a
``(snapshot, policy_act)`` pair on the loader's device: the model in the
device's compute dtype (bf16 on the card), BatchNorm folded where it has
any; unloading drops the references so the memory is freed.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

import torch

from ..models.fold_bn import snapshot
from ..models.registry import eval_apply
from ..selfplay.policies import make_network_policy
from ..utils.hardware import resolve_device
from ..utils.model_export import ModelMetadata, get_models_from_directory, load_any_model


@dataclass
class ModelInfo:
    model_dir: str
    model_id: str
    run_name: str
    iteration: int
    architecture_name: str
    device: Any = None  # None = the card
    metadata: Optional[ModelMetadata] = None
    _loaded: Optional[Tuple[Any, Callable]] = field(default=None, repr=False)

    @property
    def unique_id(self) -> str:
        return f"{self.run_name}/{self.model_id}"

    def load_model(self) -> Tuple[Any, Callable]:
        """Returns (snapshot, policy_act). Cached until unload."""
        if self._loaded is None:
            device = resolve_device(self.device)
            # The eval path of training: bf16 compute on the card, f32
            # parameters; eval-mode forwards with BatchNorm folded.
            dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
            model, self.metadata = load_any_model(self.model_dir, self.model_id, dtype, device)
            self._loaded = (snapshot(model), make_network_policy(eval_apply))
        return self._loaded

    def unload_model(self, hard: bool = False) -> None:
        del hard  # one memory tier: drop the references either way
        self._loaded = None


class ModelLoader:
    """Collects ModelInfo entries from a mix of path specs; the models load
    onto ``device`` (None = the card)."""

    def __init__(self, device=None):
        self.device = device

    def load_from_paths(self, paths: List[str]) -> List[ModelInfo]:
        models: List[ModelInfo] = []
        seen = set()

        def add(model_dir: str, meta: dict) -> None:
            info = self._info_from_meta(model_dir, meta)
            if info and (info.run_name, info.iteration) not in seen:
                seen.add((info.run_name, info.iteration))
                models.append(info)

        for spec in paths:
            for path in sorted(glob.glob(spec)) or [spec]:
                if os.path.isdir(path):
                    for meta in get_models_from_directory(path):
                        add(path, meta)
                elif os.path.isfile(path) and path.endswith(".msgpack"):
                    model_dir = os.path.dirname(path) or "."
                    model_id = os.path.basename(path)[: -len(".msgpack")]
                    meta_path = os.path.join(model_dir, f"{model_id}.json")
                    if os.path.exists(meta_path):
                        with open(meta_path) as f:
                            add(model_dir, json.load(f))
        models.sort(key=lambda x: (x.run_name, x.iteration))
        return models

    def _info_from_meta(self, model_dir: str, meta: dict) -> Optional[ModelInfo]:
        try:
            return ModelInfo(
                model_dir=model_dir,
                model_id=meta["model_id"],
                run_name=meta.get("run_name") or os.path.basename(model_dir),
                iteration=meta.get("iteration", 0),
                architecture_name=meta.get("architecture", {}).get("name", "?"),
                device=self.device,
            )
        except KeyError:
            return None
