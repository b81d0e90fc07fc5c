"""CNN actor-critic (counterpart of the JAX package's ``models/cnn.py``): a
stack of 3x3 same-padding Conv + BatchNorm (momentum 0.9, eps 1e-5) + ReLU,
then the shared heads.

The JAX package has no hand-written kernel for this family, so the
convolutions are ``F.conv2d`` on NCHW activations in both modes. Train mode
normalises with batch statistics; eval mode with the running ones, or not at
all once ``models.fold_bn`` has folded them into the convs.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .common import ActorCriticHeads, BatchNorm, conv3x3


class CnnActorCritic(nn.Module):
    def __init__(self, action_dim: int, obs_shape, channels: Sequence[int] = (64, 64, 64),
                 head_hidden: int = 256, dtype=torch.float32):
        super().__init__()
        planes, m, n = obs_shape
        self.dtype = dtype
        self.folded = False
        widths = (planes, *channels)
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, 3, padding=1) for cin, cout in zip(widths, widths[1:])
        )
        self.bns = nn.ModuleList(BatchNorm(ch) for ch in channels)
        self.heads = ActorCriticHeads(channels[-1], m * n, action_dim, head_hidden)

    def conv_bn_pairs(self):
        return zip(self.convs, self.bns)

    def forward(self, obs: torch.Tensor, train: bool = False):
        """(B, 2, M, N) observation -> (logits (B, A) f32, value (B, 1) f32)."""
        x = obs
        for conv, bn in self.conv_bn_pairs():
            x = conv3x3(x, conv, self.dtype)
            if not self.folded:  # a folded BatchNorm is the identity
                x = bn(x, train)
            x = torch.relu(x)
        return self.heads(x.permute(0, 2, 3, 1), self.dtype)
