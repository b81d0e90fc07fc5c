"""Masked categorical distribution primitives (counterpart of the JAX
package's ``ops/masked.py``).

Illegal logits become -inf; a row with no legal action falls back to zeros
(uniform) so the softmax stays finite. All functions take float32 logits of
shape (..., A). Sampling takes its noise from outside (``noise``) or from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = float("-inf")


def mask_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Illegal logits -> -inf; all-masked rows -> zeros (uniform)."""
    masked = logits.masked_fill(~mask, NEG_INF)
    all_masked = ~mask.any(dim=-1, keepdim=True)
    return torch.where(all_masked, torch.zeros_like(logits), masked)


def masked_sample(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample from (already masked) logits by gumbel-max.

    ``noise`` is an injected tensor of uniforms in (0, 1) with the logits'
    shape; without it the uniforms come from ``generator``. Returns int64.
    """
    if noise is None:
        noise = torch.rand(logits.shape, generator=generator, device=logits.device)
        noise.clamp_(min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(noise))
    return torch.argmax(logits + gumbel, dim=-1)


def masked_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Deterministic action = argmax of the logits (first of ties)."""
    return torch.argmax(logits, dim=-1)


def log_prob(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """log pi(a) for the categorical defined by (masked) logits."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, actions.to(torch.int64)[..., None])[..., 0]


def entropy(logits: torch.Tensor) -> torch.Tensor:
    """Entropy of the categorical; -inf logits contribute exactly 0.

    The -inf log-probabilities are zeroed BEFORE the product: ``0 * -inf``
    is NaN, in the forward and in the backward pass alike.
    """
    logp = torch.log_softmax(logits, dim=-1)
    p = logp.exp()
    safe_logp = torch.where(p > 0, logp, torch.zeros_like(logp))
    return -(p * safe_logp).sum(dim=-1)


def random_masked_actions(
    mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Uniform random legal action per row; rows with no legal cell are
    uniform over all cells. Deterministic mode takes the first legal cell
    (index 0 when there is none)."""
    if deterministic:
        return torch.argmax(mask.to(torch.int32), dim=-1)
    logits = mask_logits(torch.zeros(mask.shape, dtype=torch.float32, device=mask.device), mask)
    return masked_sample(logits, generator, noise)
