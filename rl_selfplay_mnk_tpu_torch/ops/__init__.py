from .masked import (
    entropy,
    log_prob,
    mask_logits,
    masked_argmax,
    masked_sample,
    random_masked_actions,
)

__all__ = [
    "mask_logits",
    "masked_sample",
    "masked_argmax",
    "log_prob",
    "entropy",
    "random_masked_actions",
]
