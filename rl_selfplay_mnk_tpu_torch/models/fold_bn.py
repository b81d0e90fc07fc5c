"""BatchNorm folding for eval-mode (frozen-statistics) forwards.

Counterpart of the JAX package's ``models/fold_bn.py``. Eval-mode
BatchNorm is an affine map with constants, so a Conv -> BN pair folds into
the conv:

    W' = W * gamma / sqrt(var + eps)        (per output channel)
    b' = (b - mu) * gamma / sqrt(var + eps) + beta

``fold_batchnorm`` returns a folded copy of a ResNet or a CNN: the convs
carry the fold, the BN layers become the identity (gamma=1, beta=0, mu=0,
var=1-eps), the copy is marked ``folded`` and frozen, and each residual
block of a ResNet gets its weights in the residual-block kernel's layout
(im2col (9C, C) in the compute dtype, f32 biases). The source model is left
as it is.

``snapshot`` is what the trainer takes of the learner for an opponent, a
pool entry or the benchmark: the folded copy for a model with BatchNorm, a
frozen deep copy for one without (the transformer families, ``mlp_tiny``),
with its matrices in the compute dtype where the model can hold them so
(``compact``: LFM2).
``snapshot_from_state_dict`` rebuilds one from its ``state_dict()``, as a
checkpoint keeps it.

``fold_into`` is the fused trainer's staging of an opponent: it writes the
snapshot of a state dict into an existing snapshot's tensors, in place (the
fold for a model with BatchNorm, a copy for one without), so the opponent of
a captured CUDA graph keeps its buffers.
"""

from __future__ import annotations

import copy

import torch

from ..ops.resblock import conv_kernel_to_im2col


@torch.no_grad()
def fold_batchnorm(model):
    folded = copy.deepcopy(model)
    for conv, bn in folded.conv_bn_pairs():
        inv = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        conv.weight.mul_(inv[:, None, None, None])
        conv.bias.copy_((conv.bias - bn.running_mean) * inv + bn.bias)
        bn.weight.fill_(1.0)
        bn.bias.zero_()
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0 - bn.eps)
    return _mark_folded(folded)


def _mark_folded(folded):
    """Freeze a model whose convs hold the fold, mark it ``folded`` and give
    a ResNet's residual blocks their kernel weights."""
    dt = folded.dtype
    for blk in getattr(folded, "blocks", ()):  # a ResNet's residual blocks
        blk.kernel_weights = (
            conv_kernel_to_im2col(blk.conv1.weight).to(dt).contiguous(),
            blk.conv1.bias.to(torch.float32).contiguous(),
            conv_kernel_to_im2col(blk.conv2.weight).to(dt).contiguous(),
            blk.conv2.bias.to(torch.float32).contiguous(),
        )
    folded.folded = True
    folded.requires_grad_(False)
    return folded


@torch.no_grad()
def fold_into(folded, state) -> None:
    """Write ``snapshot`` of a model whose ``state_dict()`` is ``state``
    into ``folded`` (a snapshot of the same architecture), in place: the
    same bits as ``fold_batchnorm``, the residual blocks' kernel weights
    included; a plain copy for a model without BatchNorm."""
    dst = folded.state_dict()
    if not hasattr(folded, "conv_bn_pairs"):
        for name, t in dst.items():
            t.copy_(state[name])
        return
    prefix = {id(mod): name + "." for name, mod in folded.named_modules()}
    fold_keys = set()
    for conv, bn in folded.conv_bn_pairs():
        c, b = prefix[id(conv)], prefix[id(bn)]
        inv = state[b + "weight"] / torch.sqrt(state[b + "running_var"] + bn.eps)
        conv.weight.copy_(state[c + "weight"] * inv[:, None, None, None])
        conv.bias.copy_((state[c + "bias"] - state[b + "running_mean"]) * inv + state[b + "bias"])
        fold_keys.update(c + k for k in ("weight", "bias"))
        fold_keys.update(b + k for k in ("weight", "bias", "running_mean", "running_var"))
    for name, t in dst.items():
        if name not in fold_keys:  # the heads; folded BatchNorm stays the identity
            t.copy_(state[name])
    for blk in getattr(folded, "blocks", ()):
        for kw, conv in zip(blk.kernel_weights[0::2], (blk.conv1, blk.conv2)):
            kw.copy_(conv_kernel_to_im2col(conv.weight))
        for kb, conv in zip(blk.kernel_weights[1::2], (blk.conv1, blk.conv2)):
            kb.copy_(conv.bias)


def snapshot(model):
    """A frozen copy of ``model`` for eval-mode forwards."""
    if hasattr(model, "conv_bn_pairs"):
        return fold_batchnorm(model)
    return _compact(copy.deepcopy(model).requires_grad_(False))


def _compact(model):
    compact = getattr(model, "compact", None)
    return model if compact is None else compact()


@torch.no_grad()
def snapshot_from_state_dict(model, state_dict):
    """The snapshot whose ``state_dict()`` was ``state_dict``, rebuilt in
    ``model`` (a fresh model of the same architecture): the same weights,
    bit for bit, frozen, and folded where the model has BatchNorm."""
    model.load_state_dict(state_dict)
    if hasattr(model, "conv_bn_pairs"):
        return _mark_folded(model)
    return _compact(model.requires_grad_(False))
