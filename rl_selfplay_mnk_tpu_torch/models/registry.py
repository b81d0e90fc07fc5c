"""Architecture registry (counterpart of the JAX package's ``models/registry.py``).

This slice of the port holds the ResNet family. The JAX package's other
names (CNN, MLP and transformer families) are known here and raise a clear
``ValueError`` until they are ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from .common import RELU_GAIN, HeadMLP
from .resnet import ResNetActorCritic


def _resnet(channels, blocks, hidden):
    return lambda action_dim, obs_shape, dtype: ResNetActorCritic(
        action_dim, obs_shape, channels=channels, num_blocks=blocks,
        head_hidden=hidden, dtype=dtype,
    )


# name -> factory(action_dim, obs_shape, dtype) -> nn.Module
ARCHITECTURE_REGISTRY: Dict[str, Callable] = {
    "resnet_s": _resnet(64, 4, 256),
    "resnet_l": _resnet(128, 8, 256),
    "resnet_b_s": _resnet(32, 4, 128),
    "resnet_b_l": _resnet(80, 5, 256),
    "resnet_b_s_w": _resnet(64, 1, 128),
    "resnet_b_l_w": _resnet(128, 2, 256),
}

NOT_YET_PORTED = (
    "cnn_s", "cnn_l", "cnn_b_s", "cnn_b_l",
    "transformer_s", "transformer_l", "transformer_b_s", "transformer_b_l",
    "transformer_c_s", "transformer_c_l", "transformer_b_s_w", "transformer_b_l_w",
    "mlp_tiny",
)


def create_model_from_architecture(
    architecture_name: str,
    obs_shape: Tuple[int, int, int],
    action_dim: int,
    dtype=torch.float32,
):
    """Instantiate a registered architecture.

    Returns ``(module, architecture_params)``; the module's parameters are
    not initialised yet (``init_network``).
    """
    if architecture_name in NOT_YET_PORTED:
        raise ValueError(
            f"Architecture {architecture_name} is not ported to PyTorch yet. "
            "Ported: " + ", ".join(sorted(ARCHITECTURE_REGISTRY))
        )
    if architecture_name not in ARCHITECTURE_REGISTRY:
        raise ValueError(
            f"Unknown architecture: {architecture_name}. Known architectures: "
            + ", ".join(sorted(ARCHITECTURE_REGISTRY))
        )
    module = ARCHITECTURE_REGISTRY[architecture_name](action_dim, tuple(obs_shape), dtype)
    arch_params = {
        "obs_shape": [int(x) for x in obs_shape],
        "action_dim": int(action_dim),
    }
    return module, arch_params


@torch.no_grad()
def init_network(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """The JAX package's init policy, in place: orthogonal (gain sqrt 2) conv
    and linear weights with zero biases, ones/zeros norms, and the heads'
    last linear layer at gain 0.01 (policy) or 1.0 (value)."""
    for layer in module.modules():
        if isinstance(layer, (nn.Conv2d, nn.Linear)):
            nn.init.orthogonal_(layer.weight, gain=RELU_GAIN, generator=generator)
            nn.init.zeros_(layer.bias)
        elif isinstance(layer, nn.LayerNorm):
            nn.init.ones_(layer.weight)
            nn.init.zeros_(layer.bias)
    for layer in module.modules():
        if isinstance(layer, HeadMLP):
            nn.init.orthogonal_(layer.dense2.weight, gain=layer.final_gain, generator=generator)
    return module


def eval_apply(model: nn.Module, observation: torch.Tensor, action_mask=None):
    """Eval-mode forward -> (logits, value). Folds BatchNorm first when the
    model is not folded. ``action_mask`` is accepted for symmetry; masking
    is the caller's (``ops.masked``)."""
    del action_mask
    with torch.no_grad():
        return model(observation, train=False)


def train_apply(model: nn.Module, observation: torch.Tensor):
    """Train-mode forward -> (logits, value): batch-statistic BatchNorm,
    running statistics updated in place."""
    return model(observation, train=True)

