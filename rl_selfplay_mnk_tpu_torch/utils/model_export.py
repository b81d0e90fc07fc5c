"""Model export and import: weights plus a JSON metadata sidecar, in the JAX
package's files (counterpart of its ``utils/model_export.py``).

Each export writes ``<base_dir>/<run>/model_<iter:05d>.msgpack``, flax's
serialized variables (``utils/flax_msgpack.py`` writes and reads them;
``models/convert.py`` maps them to and from a ``state_dict``), and
``model_<iter:05d>.json``::

    {"model_id", "iteration",
     "architecture": {"name", "params"},
     "export_timestamp", "is_benchmark_breaker", "run_name"}

so either package loads what the other exported. ``load_any_model`` rebuilds
the module from the registry and restores its weights without knowing the
architecture beforehand; it puts the model on the card unless the caller
names another device.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from datetime import datetime
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models.convert import flax_to_state_dict, state_dict_to_flax
from ..models.registry import create_model_from_architecture
from . import flax_msgpack
from .hardware import resolve_device


@dataclass
class ModelMetadata:
    """Metadata stored alongside exported models."""

    model_id: str
    iteration: int
    architecture_name: str
    architecture_params: Dict[str, Any]
    export_timestamp: str
    is_benchmark_breaker: bool
    run_name: Optional[str]
    extra: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "model_id": self.model_id,
            "iteration": self.iteration,
            "architecture": {
                "name": self.architecture_name,
                "params": self.architecture_params,
            },
            "export_timestamp": self.export_timestamp,
            "is_benchmark_breaker": self.is_benchmark_breaker,
            "run_name": self.run_name,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ModelMetadata":
        architecture = data.get("architecture", {})
        return cls(
            model_id=data["model_id"],
            iteration=data.get("iteration", 0),
            architecture_name=architecture.get("name"),
            architecture_params=architecture.get("params", {}),
            export_timestamp=data.get("export_timestamp", ""),
            is_benchmark_breaker=data.get("is_benchmark_breaker", False),
            run_name=data.get("run_name"),
        )


class NullModelExporter:
    """Export facade that writes nothing: a train loop that must not touch
    the filesystem calls export at the same points all the same."""

    def __init__(self, run_name: Optional[str] = None, base_dir: str = "models"):
        self.run_name = run_name
        self.export_dir = os.path.join(base_dir, run_name or "null")

    def export_model(self, *args, **kwargs) -> str:
        return ""


def model_to_bytes(model: torch.nn.Module) -> bytes:
    """The model's weights as the bytes ``flax.serialization.to_bytes`` writes
    for the JAX package's variables of the same network."""
    variables = state_dict_to_flax(model.state_dict(), getattr(model, "num_heads", None))
    return flax_msgpack.packb(variables)


class ModelExporter:
    """Writes weight and metadata pairs under ``<base_dir>/<run>/``."""

    def __init__(self, run_name: Optional[str] = None, base_dir: str = "models"):
        self.run_name = run_name or datetime.now().strftime("%Y%m%d_%H%M%S")
        self.export_dir = os.path.join(base_dir, self.run_name)
        os.makedirs(self.export_dir, exist_ok=True)

    def export_model(
        self,
        model: torch.nn.Module,
        architecture_name: str,
        architecture_params: Dict[str, Any],
        iteration: int,
        is_benchmark_breaker: bool = False,
    ) -> str:
        model_id = f"model_{iteration:05d}"
        model_path = os.path.join(self.export_dir, f"{model_id}.msgpack")
        metadata_path = os.path.join(self.export_dir, f"{model_id}.json")

        with open(model_path, "wb") as f:
            f.write(model_to_bytes(model))

        metadata = ModelMetadata(
            model_id=model_id,
            iteration=iteration,
            architecture_name=architecture_name,
            architecture_params=architecture_params,
            export_timestamp=datetime.now().isoformat(),
            is_benchmark_breaker=is_benchmark_breaker,
            run_name=self.run_name,
        )
        with open(metadata_path, "w") as f:
            json.dump(metadata.to_dict(), f, indent=2)

        print(
            f"Exported model {model_id} (architecture: {architecture_name}) "
            f"to {model_path}"
        )
        return model_id


def load_any_model(
    model_dir: str, model_id: str, dtype: Any = torch.float32, device=None
) -> Tuple[torch.nn.Module, ModelMetadata]:
    """Load (model, metadata) from a directory: the registry's module for the
    sidecar's architecture, compute dtype ``dtype``, with the exported
    weights, on ``device`` (None = the card)."""
    device = resolve_device(device)
    metadata_path = os.path.join(model_dir, f"{model_id}.json")
    if not os.path.exists(metadata_path):
        raise FileNotFoundError(
            f"Metadata for model {model_id} not found in {model_dir}"
        )
    with open(metadata_path) as f:
        metadata = ModelMetadata.from_dict(json.load(f))

    model_path = os.path.join(model_dir, f"{model_id}.msgpack")
    if not os.path.exists(model_path):
        raise FileNotFoundError(f"Model weights {model_id} not found in {model_dir}")

    obs_shape = tuple(metadata.architecture_params["obs_shape"])
    action_dim = metadata.architecture_params["action_dim"]
    module, _ = create_model_from_architecture(
        metadata.architecture_name, obs_shape, action_dim, dtype=dtype
    )
    with open(model_path, "rb") as f:
        variables = flax_msgpack.unpackb(f.read())
    variables.setdefault("batch_stats", {})
    module.load_state_dict(flax_to_state_dict(variables), strict=True)
    return module.to(device), metadata


def get_models_from_directory(model_dir: str) -> List[Dict[str, Any]]:
    """List all model metadata dicts in a directory, sorted by iteration."""
    models: List[Dict[str, Any]] = []
    if not os.path.exists(model_dir):
        return models
    for filename in os.listdir(model_dir):
        if not filename.endswith(".json"):
            continue
        try:
            with open(os.path.join(model_dir, filename)) as f:
                metadata_dict = json.load(f)
            models.append(ModelMetadata.from_dict(metadata_dict).to_dict())
        except (json.JSONDecodeError, FileNotFoundError, KeyError, TypeError):
            # Not a model sidecar (stray config.json, partial write, ...):
            # skip it instead of aborting the whole discovery.
            continue
    models.sort(key=lambda x: x.get("iteration", 0))
    return models
