"""Shared actor-critic head stack and the flax-convention norm layers.

Counterpart of the JAX package's ``models/common.py``. Both heads are:

  policy: 1x1 projection -> 2 planes -> flatten -> LN -> ReLU -> Linear(hidden)
          -> LN -> ReLU -> Linear(action_dim)
  value:  1x1 projection -> 1 plane  -> flatten -> LN -> ReLU -> Linear(hidden)
          -> LN -> ReLU -> Linear(1) -> tanh

The heads stay channels-last: the projection runs over the trailing channel
axis of (B, M, N, C) features and the flatten is in (m, n, plane) order, as
in the JAX package, so converted weights need no permutation.

Parameters are float32; a module's ``dtype`` is its compute dtype (bf16 on
the card, f32 on the CPU), and weights are cast to it at use, as flax does.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.layer_norm import layer_norm as ops_layer_norm

RELU_GAIN = math.sqrt(2.0)
LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm default (torch's is 1e-5)
BN_MOMENTUM = 0.9  # flax convention: running = m * running + (1 - m) * batch
BN_EPS = 1e-5


def linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def conv3x3(x: torch.Tensor, layer: nn.Conv2d, dtype) -> torch.Tensor:
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype), padding=1)


def layer_norm(x: torch.Tensor, layer: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with f32 statistics, output in x's dtype (flax semantics):
    ``ops.layer_norm`` (the kernels on the card)."""
    if layer.normalized_shape == (1,):
        # A norm over one element (mlp_tiny's value head) is exactly its bias.
        # F.layer_norm leaves a rounding of x - mean there, which 1/sqrt(eps)
        # = 1000 carries into the gradients.
        xf = x.to(torch.float32)
        return ((xf - xf) * layer.weight + layer.bias).to(x.dtype)
    return ops_layer_norm(x, layer.weight, layer.bias, layer.eps)


class BatchNorm(nn.Module):
    """BatchNorm over NCHW with flax ``nn.BatchNorm`` semantics.

    Train mode normalises with the batch statistics, computed in float32 as
    mean and E[x^2] - mean^2 (the biased variance, clipped at 0), and
    updates the running statistics in place with momentum 0.9 from that
    same biased variance. ``torch.nn.BatchNorm2d`` updates the running
    variance with the unbiased one instead, which drifts from the reference.
    Eval mode normalises with the running statistics.

    ``stat_sync`` (None on one rank) makes the statistics those of every
    rank's batch, as GSPMD's are over a sharded batch in the JAX package:
    it maps this rank's (2, C) means of x and x^2 to the means over ranks,
    differentiably (``parallel.mesh.DataParallel.batch_stats``).
    """

    def __init__(self, channels: int, momentum: float = BN_MOMENTUM, eps: float = BN_EPS):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.stat_sync = None
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.to(torch.float32)
        if train:
            mean = xf.mean(dim=(0, 2, 3))
            sq = (xf * xf).mean(dim=(0, 2, 3))
            if self.stat_sync is not None:
                mean, sq = self.stat_sync(torch.stack([mean, sq])).unbind(0)
            var = torch.clamp(sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None, None]) * mul[None, :, None, None]
        return (y + self.bias[None, :, None, None]).to(x.dtype)


class HeadMLP(nn.Module):
    """One head: plane projection + LayerNorm/ReLU MLP."""

    def __init__(self, channels: int, cells: int, planes: int, hidden: int,
                 out_dim: int, final_gain: float):
        super().__init__()
        self.final_gain = final_gain
        self.plane_proj = nn.Linear(channels, planes)
        self.ln1 = nn.LayerNorm(cells * planes, eps=LAYER_NORM_EPS)
        self.dense1 = nn.Linear(cells * planes, hidden)
        self.ln2 = nn.LayerNorm(hidden, eps=LAYER_NORM_EPS)
        self.dense2 = nn.Linear(hidden, out_dim)

    def forward(self, feats: torch.Tensor, dtype) -> torch.Tensor:
        # feats: (B, M, N, C) channels-last; flatten in (m, n, plane) order.
        x = linear(feats, self.plane_proj, dtype)
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(layer_norm(x, self.ln1))
        x = torch.relu(layer_norm(linear(x, self.dense1, dtype), self.ln2))
        return linear(x, self.dense2, dtype)


class ActorCriticHeads(nn.Module):
    """The policy/value head pair. Returns (logits f32, value f32 (B, 1))."""

    def __init__(self, channels: int, cells: int, action_dim: int, hidden: int):
        super().__init__()
        self.policy_head = HeadMLP(channels, cells, 2, hidden, action_dim, final_gain=0.01)
        self.value_head = HeadMLP(channels, cells, 1, hidden, 1, final_gain=1.0)

    def forward(self, feats: torch.Tensor, dtype):
        logits = self.policy_head(feats, dtype)
        value = torch.tanh(self.value_head(feats, dtype).to(torch.float32))
        return logits.to(torch.float32), value
