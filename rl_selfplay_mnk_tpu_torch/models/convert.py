"""Convert between the JAX package's variables and the port's state_dict, for
the CNN, ResNet, transformer (plain and SGR) and MLP trees.

The JAX side is a nested dict of numpy arrays,
``{"params": ..., "batch_stats": ...}``, as flax keeps it (no msgpack
needed). Conv kernels go HWIO <-> OIHW, Dense kernels (in, out) <-> Linear
(out, in), BatchNorm ``scale/bias/mean/var`` <-> ``weight/bias/
running_mean/running_var``, LayerNorm ``scale`` <-> ``weight``. The heads
flatten in the same (m, n, plane) order on both sides, so no weight needs a
permutation.

flax's attention keeps ``query/key/value`` kernels as (D_in, H, Dh) with
bias (H, Dh) and ``out`` as (H, Dh, D_out) with bias (D_out): the heads are
merged by a reshape first and the matrix transposed after, in that order
(and the other way round on the way back, which needs the head count). The
positional embedding is a bare parameter, and a transformer's
``batch_stats`` is empty. Which tree it is shows in its keys: ``cell_embed``
marks a transformer (``SGRBlock_*`` scopes the SGR one), ``ResidualBlock_*``
a ResNet, a top-level ``Dense_0`` the MLP, and ``Conv_*`` alone the CNN. The
MLP flattens the observation as (plane, m, n) on both sides.

LFM2 (``models/lfm2.py``), which the JAX package has not, keeps its
state_dict as it is: each name split at its dots into nested scopes under
``params`` (a top-level ``final_norm`` marks it), every tensor in its own
layout and dtype.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Optional, Tuple

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
    "mha_in": (("kernel", "weight"), ("bias", "bias")),
    "mha_out": (("kernel", "weight"), ("bias", "bias")),
    "norm": (("scale", "weight"), ("bias", "bias")),
    "bn": (("scale", "weight"), ("bias", "bias")),
}
_BN_STATS = (("mean", "running_mean"), ("var", "running_var"))


def _head_layers() -> Iterator[Tuple[tuple, str, str]]:
    for head in ("policy_head", "value_head"):
        for flax_name, torch_name, kind in _HEAD_LAYERS:
            yield ("ActorCriticHeads_0", head, flax_name), f"heads.{head}.{torch_name}", kind


def _resnet_layers(num_blocks: int) -> Iterator[Tuple[tuple, str, str]]:
    """(flax scope path, torch module path, kind) for every ResNet layer."""
    yield ("Conv_0",), "conv_in", "conv"
    yield ("BatchNorm_0",), "bn_in", "bn"
    for i in range(num_blocks):
        scope = f"ResidualBlock_{i}"
        yield (scope, "Conv_0"), f"blocks.{i}.conv1", "conv"
        yield (scope, "BatchNorm_0"), f"blocks.{i}.bn1", "bn"
        yield (scope, "Conv_1"), f"blocks.{i}.conv2", "conv"
        yield (scope, "BatchNorm_1"), f"blocks.{i}.bn2", "bn"
    yield from _head_layers()


def _cnn_layers(num_convs: int) -> Iterator[Tuple[tuple, str, str]]:
    for i in range(num_convs):
        yield (f"Conv_{i}",), f"convs.{i}", "conv"
        yield (f"BatchNorm_{i}",), f"bns.{i}", "bn"
    yield from _head_layers()


def _mlp_layers() -> Iterator[Tuple[tuple, str, str]]:
    yield ("Dense_0",), "dense", "dense"
    yield from _head_layers()


def _transformer_layers(num_layers: int, gated: bool, has_ffn: bool):
    """(flax scope path, torch module path, kind) for every layer of a plain
    (``EncoderLayer_i``) or gated (``SGRBlock_i``) transformer; the bare
    ``pos_embed`` parameter is not a layer and is handled by the callers."""
    yield ("cell_embed",), "embed.cell_embed", "dense"
    for i in range(num_layers):
        scope = f"SGRBlock_{i}" if gated else f"EncoderLayer_{i}"
        attn = (scope, "MultiHeadDotProductAttention_0")
        yield (scope, "LayerNorm_0"), f"layers.{i}.ln1", "norm"
        for name in ("query", "key", "value"):
            yield attn + (name,), f"layers.{i}.attn.{name}", "mha_in"
        yield attn + ("out",), f"layers.{i}.attn.out", "mha_out"
        if gated:
            yield (scope, "gate1"), f"layers.{i}.gate1", "dense"
        if has_ffn:
            yield (scope, "LayerNorm_1"), f"layers.{i}.ln2", "norm"
            yield (scope, "Dense_0"), f"layers.{i}.dense1", "dense"
            yield (scope, "Dense_1"), f"layers.{i}.dense2", "dense"
        if gated:
            yield (scope, "gate2"), f"layers.{i}.gate2", "dense"
    yield from _head_layers()


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
    elif leaf == "kernel" and kind == "mha_in":
        a = a.reshape(a.shape[0], -1).T  # (in, H, Dh) -> (in, H*Dh) -> (H*Dh, in)
    elif leaf == "kernel" and kind == "mha_out":
        a = a.reshape(-1, a.shape[-1]).T  # (H, Dh, out) -> (H*Dh, out) -> (out, H*Dh)
    elif leaf == "bias" and kind == "mha_in":
        a = a.reshape(-1)  # (H, Dh) -> (H*Dh,)
    return torch.tensor(np.ascontiguousarray(a))


def _to_flax(value: torch.Tensor, leaf: str, kind: str, num_heads: Optional[int] = None) -> np.ndarray:
    a = value.detach().to(torch.float32).cpu().numpy()
    if leaf == "kernel" and kind == "conv":
        a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    elif leaf == "kernel" and kind == "dense":
        a = a.T
    elif leaf == "kernel" and kind == "mha_in":
        a = a.T.reshape(a.shape[1], num_heads, -1)  # (H*Dh, in) -> (in, H*Dh) -> (in, H, Dh)
    elif leaf == "kernel" and kind == "mha_out":
        a = a.T.reshape(num_heads, -1, a.shape[0])  # (out, H*Dh) -> (H*Dh, out) -> (H, Dh, out)
    elif leaf == "bias" and kind == "mha_in":
        a = a.reshape(num_heads, -1)
    return np.ascontiguousarray(a)


def _count(keys, prefix: str) -> int:
    return sum(1 for k in keys if k.startswith(prefix))


_NESTED_MARK = "final_norm"  # the top-level scope that only LFM2's tree has


def _flatten(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = torch.from_numpy(np.array(value))
    return out


def flax_to_state_dict(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX variables (any registry tree) -> the port's state_dict."""
    params = variables["params"]
    if _NESTED_MARK in params:
        return _flatten(params)
    stats = variables.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}
    if "cell_embed" in params:
        gated = _count(params, "SGRBlock_") > 0
        num_layers = _count(params, "SGRBlock_" if gated else "EncoderLayer_")
        first = params.get("SGRBlock_0" if gated else "EncoderLayer_0", {})
        layers = _transformer_layers(num_layers, gated, "Dense_0" in first)
        out["embed.pos_embed"] = _to_torch(params["pos_embed"], "pos_embed", "param")
    elif _count(params, "ResidualBlock_"):
        layers = _resnet_layers(_count(params, "ResidualBlock_"))
    elif "Dense_0" in params:
        layers = _mlp_layers()
    else:
        layers = _cnn_layers(_count(params, "Conv_"))
    for path, module_path, kind in layers:
        layer = _get(params, path)
        for flax_leaf, torch_leaf in _LEAVES[kind]:
            out[f"{module_path}.{torch_leaf}"] = _to_torch(layer[flax_leaf], flax_leaf, kind)
        if kind == "bn":
            layer_stats = _get(stats, path)
            for flax_leaf, torch_leaf in _BN_STATS:
                out[f"{module_path}.{torch_leaf}"] = _to_torch(layer_stats[flax_leaf], flax_leaf, kind)
    return out


def _indices(state_dict, pattern: str) -> set:
    return {int(m.group(1)) for k in state_dict if (m := re.match(pattern, k))}


def _port_layers(names) -> Iterator[Tuple[tuple, str, str]]:
    """The layer table of the model whose state_dict (or parameter) names
    are ``names``."""
    if "embed.cell_embed.weight" in names:
        return _transformer_layers(
            len(_indices(names, r"layers\.(\d+)\.")),
            gated="layers.0.gate1.weight" in names,
            has_ffn="layers.0.dense1.weight" in names,
        )
    if "conv_in.weight" in names:
        return _resnet_layers(len(_indices(names, r"blocks\.(\d+)\.")))
    if "dense.weight" in names:
        return _mlp_layers()
    return _cnn_layers(len(_indices(names, r"convs\.(\d+)\.")))


def flax_param_paths(names) -> Dict[str, str]:
    """torch parameter name -> the '/'-joined path of the same leaf in the
    JAX package's ``params`` tree (``Conv_0/kernel``, ``pos_embed``...), for
    the parameter names of any registry model. Each leaf holds the same
    numbers on both sides, laid out differently."""
    names = list(names)
    if any(n.startswith(_NESTED_MARK + ".") for n in names):
        return {n: n.replace(".", "/") for n in names}
    paths = {"embed.pos_embed": "pos_embed"} if "embed.pos_embed" in names else {}
    for path, module_path, kind in _port_layers(names):
        for flax_leaf, torch_leaf in _LEAVES[kind]:
            paths[f"{module_path}.{torch_leaf}"] = "/".join(path + (flax_leaf,))
    return paths


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor], num_heads: Optional[int] = None) -> dict:
    """The port's state_dict (any registry model) -> JAX variables. A
    transformer needs ``num_heads`` (the model's ``num_heads``): the merged
    projection weights do not tell how many heads they hold."""
    params: dict = {}
    stats: dict = {}
    if f"{_NESTED_MARK}.weight" in state_dict:
        for name, value in state_dict.items():
            _set(params, tuple(name.split(".")), value.detach().cpu().numpy())
        return {"params": params, "batch_stats": stats}
    layers = _port_layers(state_dict)
    if "embed.cell_embed.weight" in state_dict:
        if num_heads is None:
            raise ValueError("state_dict_to_flax: a transformer state_dict needs num_heads")
        params["pos_embed"] = _to_flax(state_dict["embed.pos_embed"], "pos_embed", "param")
    for path, module_path, kind in layers:
        for flax_leaf, torch_leaf in _LEAVES[kind]:
            value = state_dict[f"{module_path}.{torch_leaf}"]
            _set(params, path + (flax_leaf,), _to_flax(value, flax_leaf, kind, num_heads))
        if kind == "bn":
            for flax_leaf, torch_leaf in _BN_STATS:
                value = state_dict[f"{module_path}.{torch_leaf}"]
                _set(stats, path + (flax_leaf,), _to_flax(value, flax_leaf, kind))
    return {"params": params, "batch_stats": stats}
