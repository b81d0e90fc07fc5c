from .cnn import CnnActorCritic
from .convert import flax_to_state_dict, state_dict_to_flax
from .fold_bn import fold_batchnorm, snapshot
from .mlp import MlpActorCritic
from .registry import (
    ARCHITECTURE_REGISTRY,
    create_model_from_architecture,
    eval_apply,
    init_network,
    train_apply,
)
from .resnet import ResNetActorCritic
from .sgr_transformer import SGRTransformerActorCritic
from .transformer import TransformerActorCritic

__all__ = [
    "ARCHITECTURE_REGISTRY",
    "CnnActorCritic",
    "MlpActorCritic",
    "ResNetActorCritic",
    "SGRTransformerActorCritic",
    "TransformerActorCritic",
    "create_model_from_architecture",
    "init_network",
    "eval_apply",
    "train_apply",
    "fold_batchnorm",
    "snapshot",
    "flax_to_state_dict",
    "state_dict_to_flax",
]
