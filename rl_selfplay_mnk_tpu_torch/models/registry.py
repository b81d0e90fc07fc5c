"""Architecture registry (counterpart of the JAX package's ``models/registry.py``).

All 19 names of the JAX package: the CNN, ResNet and transformer families
(plain and SGR), their speed tiers and ``mlp_tiny``. A factory passes extra
keyword arguments on to its module (a transformer's ``attention_fn``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from .cnn import CnnActorCritic
from .common import RELU_GAIN, HeadMLP
from .mlp import MlpActorCritic
from .resnet import ResNetActorCritic
from .sgr_transformer import SGRTransformerActorCritic
from .transformer import TransformerActorCritic


def _cnn(channels, hidden):
    return lambda action_dim, obs_shape, dtype, **kwargs: CnnActorCritic(
        action_dim, obs_shape, channels=tuple(channels), head_hidden=hidden, dtype=dtype, **kwargs
    )


def _resnet(channels, blocks, hidden):
    return lambda action_dim, obs_shape, dtype, **kwargs: ResNetActorCritic(
        action_dim, obs_shape, channels=channels, num_blocks=blocks,
        head_hidden=hidden, dtype=dtype, **kwargs
    )


def _tfm(d, layers, heads, hidden, ffn=None, qkv=None):
    return lambda action_dim, obs_shape, dtype, **kwargs: TransformerActorCritic(
        action_dim, obs_shape, embed_dim=d, num_layers=layers, num_heads=heads,
        head_hidden=hidden, dtype=dtype, ffn_dim=ffn, qkv_features=qkv, **kwargs
    )


def _sgr(d, layers, heads, hidden):
    return lambda action_dim, obs_shape, dtype, **kwargs: SGRTransformerActorCritic(
        action_dim, obs_shape, embed_dim=d, num_layers=layers, num_heads=heads,
        head_hidden=hidden, dtype=dtype, **kwargs
    )


# name -> factory(action_dim, obs_shape, dtype, **module_kwargs) -> nn.Module
ARCHITECTURE_REGISTRY: Dict[str, Callable] = {
    "cnn_s": _cnn([64] * 4, 256),
    "cnn_l": _cnn([192] * 6, 256),
    "cnn_b_s": _cnn([56] * 4, 128),
    "cnn_b_l": _cnn([96] * 8, 256),
    "resnet_s": _resnet(64, 4, 256),
    "resnet_l": _resnet(128, 8, 256),
    "resnet_b_s": _resnet(32, 4, 128),
    "resnet_b_l": _resnet(80, 5, 256),
    "resnet_b_s_w": _resnet(64, 1, 128),
    "resnet_b_l_w": _resnet(128, 2, 256),
    "transformer_s": _tfm(96, 3, 3, 256),
    "transformer_l": _tfm(192, 5, 6, 256),
    "transformer_b_s": _tfm(56, 2, 4, 128),
    "transformer_b_l": _tfm(96, 5, 8, 256),
    "transformer_c_s": _sgr(56, 2, 4, 128),
    "transformer_c_l": _sgr(96, 5, 8, 256),
    "transformer_b_s_w": _tfm(128, 1, 2, 128, ffn=0),
    "transformer_b_l_w": _tfm(256, 1, 4, 256, ffn=512),
    "mlp_tiny": lambda action_dim, obs_shape, dtype, **kwargs: MlpActorCritic(
        action_dim, obs_shape, dtype=dtype, **kwargs
    ),
}


def create_model_from_architecture(
    architecture_name: str,
    obs_shape: Tuple[int, int, int],
    action_dim: int,
    dtype=torch.float32,
    **module_kwargs,
):
    """Instantiate a registered architecture.

    Returns ``(module, architecture_params)``; the module's parameters are
    not initialised yet (``init_network``).
    """
    if architecture_name not in ARCHITECTURE_REGISTRY:
        raise ValueError(
            f"Unknown architecture: {architecture_name}. Known architectures: "
            + ", ".join(sorted(ARCHITECTURE_REGISTRY))
        )
    module = ARCHITECTURE_REGISTRY[architecture_name](
        action_dim, tuple(obs_shape), dtype, **module_kwargs
    )
    arch_params = {
        "obs_shape": [int(x) for x in obs_shape],
        "action_dim": int(action_dim),
    }
    return module, arch_params


_TRUNCATED_STD = 0.87962566103423978  # std of a unit normal truncated at +-2


def _init_orthogonal(layer, generator):
    nn.init.orthogonal_(layer.weight, gain=RELU_GAIN, generator=generator)
    nn.init.zeros_(layer.bias)


def _init_lecun_normal(layer, generator):
    """flax's default kernel init: truncated normal (+-2 sigma) of variance
    1 / fan_in; zero bias."""
    std = math.sqrt(1.0 / layer.weight.shape[1]) / _TRUNCATED_STD
    nn.init.trunc_normal_(layer.weight, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
    nn.init.zeros_(layer.bias)


def _init_normal_002(layer, generator):
    nn.init.normal_(layer.weight, std=0.02, generator=generator)
    nn.init.zeros_(layer.bias)


def _init_gate(layer, generator):
    del generator
    nn.init.zeros_(layer.weight)
    nn.init.constant_(layer.bias, 2.0)


_INIT_SCHEMES = {
    "orthogonal": _init_orthogonal,
    "lecun_normal": _init_lecun_normal,
    "normal_0.02": _init_normal_002,
    "gate": _init_gate,
}


@torch.no_grad()
def init_network(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """The JAX package's init policy, in place, layer by layer.

    A conv or linear layer is initialised by its ``init_scheme`` attribute:
    ``orthogonal`` (gain sqrt 2, zero bias) where it has none, which covers
    the ResNet body and every head; in a transformer body ``lecun_normal``
    (flax's default), ``normal_0.02`` for the cell embedding and ``gate``
    (weight 0, bias 2.0) for the SGR gates. A ``pos_embed`` parameter is
    normal(0.02), norms are ones/zeros, and the heads' last linear layer is
    orthogonal at gain 0.01 (policy) or 1.0 (value).

    torch's generator gives other numbers than JAX's from the same seed: the
    two packages agree in distribution (and exactly in the constants), not
    value by value.
    """
    for layer in module.modules():
        if isinstance(layer, (nn.Conv2d, nn.Linear)):
            _INIT_SCHEMES[getattr(layer, "init_scheme", "orthogonal")](layer, generator)
        elif isinstance(layer, nn.LayerNorm):
            nn.init.ones_(layer.weight)
            nn.init.zeros_(layer.bias)
        pos_embed = getattr(layer, "pos_embed", None)
        if isinstance(pos_embed, nn.Parameter):
            nn.init.normal_(pos_embed, std=0.02, generator=generator)
    for layer in module.modules():
        if isinstance(layer, HeadMLP):
            nn.init.orthogonal_(layer.dense2.weight, gain=layer.final_gain, generator=generator)
    return module


def eval_apply(model: nn.Module, observation: torch.Tensor, action_mask=None):
    """Eval-mode forward -> (logits, value). A model with BatchNorm folds it
    first when it is not folded; one without runs as it is. ``action_mask`` is accepted for symmetry; masking
    is the caller's (``ops.masked``)."""
    del action_mask
    with torch.no_grad():
        return model(observation, train=False)


def train_apply(model: nn.Module, observation: torch.Tensor):
    """Train-mode forward -> (logits, value): batch-statistic BatchNorm with
    the running statistics updated in place, where the model has any."""
    return model(observation, train=True)

