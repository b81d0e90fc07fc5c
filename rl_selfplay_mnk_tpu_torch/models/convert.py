"""Convert between the JAX package's ResNet variables and the port's state_dict.

The JAX side is a nested dict of numpy arrays,
``{"params": ..., "batch_stats": ...}``, as flax keeps it (no msgpack
needed). Conv kernels go HWIO <-> OIHW, Dense kernels (in, out) <-> Linear
(out, in), BatchNorm ``scale/bias/mean/var`` <-> ``weight/bias/
running_mean/running_var``, LayerNorm ``scale`` <-> ``weight``. The heads
flatten in the same (m, n, plane) order on both sides, so no weight needs a
permutation.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_HEAD_LAYERS = (
    ("plane_proj", "plane_proj", "dense"),
    ("LayerNorm_0", "ln1", "norm"),
    ("Dense_0", "dense1", "dense"),
    ("LayerNorm_1", "ln2", "norm"),
    ("Dense_1", "dense2", "dense"),
)
_LEAVES = {
    "conv": (("kernel", "weight"), ("bias", "bias")),
    "dense": (("kernel", "weight"), ("bias", "bias")),
    "norm": (("scale", "weight"), ("bias", "bias")),
    "bn": (("scale", "weight"), ("bias", "bias")),
}
_BN_STATS = (("mean", "running_mean"), ("var", "running_var"))


def _layers(num_blocks: int) -> Iterator[Tuple[tuple, str, str]]:
    """(flax scope path, torch module path, kind) for every layer."""
    yield ("Conv_0",), "conv_in", "conv"
    yield ("BatchNorm_0",), "bn_in", "bn"
    for i in range(num_blocks):
        scope = f"ResidualBlock_{i}"
        yield (scope, "Conv_0"), f"blocks.{i}.conv1", "conv"
        yield (scope, "BatchNorm_0"), f"blocks.{i}.bn1", "bn"
        yield (scope, "Conv_1"), f"blocks.{i}.conv2", "conv"
        yield (scope, "BatchNorm_1"), f"blocks.{i}.bn2", "bn"
    for head in ("policy_head", "value_head"):
        for flax_name, torch_name, kind in _HEAD_LAYERS:
            yield ("ActorCriticHeads_0", head, flax_name), f"heads.{head}.{torch_name}", kind


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _to_torch(value: np.ndarray, leaf: str, kind: str) -> torch.Tensor:
    a = np.asarray(value, dtype=np.float32)
    if leaf == "kernel" and kind == "conv":
        a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    elif leaf == "kernel" and kind == "dense":
        a = a.T  # (in, out) -> (out, in)
    return torch.tensor(np.ascontiguousarray(a))


def _to_flax(value: torch.Tensor, leaf: str, kind: str) -> np.ndarray:
    a = value.detach().to(torch.float32).cpu().numpy()
    if leaf == "kernel" and kind == "conv":
        a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    elif leaf == "kernel" and kind == "dense":
        a = a.T
    return np.ascontiguousarray(a)


def flax_to_state_dict(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX ResNet variables -> the port's ``ResNetActorCritic`` state_dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    num_blocks = sum(1 for k in params if k.startswith("ResidualBlock_"))
    out: Dict[str, torch.Tensor] = {}
    for path, module_path, kind in _layers(num_blocks):
        layer = _get(params, path)
        for flax_leaf, torch_leaf in _LEAVES[kind]:
            out[f"{module_path}.{torch_leaf}"] = _to_torch(layer[flax_leaf], flax_leaf, kind)
        if kind == "bn":
            layer_stats = _get(stats, path)
            for flax_leaf, torch_leaf in _BN_STATS:
                out[f"{module_path}.{torch_leaf}"] = _to_torch(layer_stats[flax_leaf], flax_leaf, kind)
    return out


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The port's ``ResNetActorCritic`` state_dict -> JAX ResNet variables."""
    block_ids = {int(m.group(1)) for k in state_dict if (m := re.match(r"blocks\.(\d+)\.", k))}
    params: dict = {}
    stats: dict = {}
    for path, module_path, kind in _layers(len(block_ids)):
        for flax_leaf, torch_leaf in _LEAVES[kind]:
            value = state_dict[f"{module_path}.{torch_leaf}"]
            _set(params, path + (flax_leaf,), _to_flax(value, flax_leaf, kind))
        if kind == "bn":
            for flax_leaf, torch_leaf in _BN_STATS:
                value = state_dict[f"{module_path}.{torch_leaf}"]
                _set(stats, path + (flax_leaf,), _to_flax(value, flax_leaf, kind))
    return {"params": params, "batch_stats": stats}
