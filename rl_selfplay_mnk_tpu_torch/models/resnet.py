"""ResNet actor-critic (counterpart of the JAX package's ``models/resnet.py``).

conv-in (3x3 Conv + BN + ReLU), then N residual blocks
(Conv-BN-ReLU-Conv-BN + identity skip, ReLU after the add), then the shared
heads.

Train mode runs the convolutions as ``F.conv2d`` on NCHW activations with
batch-statistic BatchNorm. Eval mode needs BatchNorm folded into the convs
(``models/fold_bn.py``; an unfolded model is folded on the way) and runs
every residual block as ``ops.resblock.fused_residual_block`` on
channels-last activations: the CUDA kernel on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..ops.resblock import fused_residual_block
from .common import ActorCriticHeads, BatchNorm, conv3x3


class ResidualBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn1 = BatchNorm(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn2 = BatchNorm(channels)
        # Set by fold_batchnorm: (w1, b1, w2, b2) in the kernel's layout.
        self.kernel_weights: Optional[Tuple[torch.Tensor, ...]] = None

    def forward(self, x: torch.Tensor, train: bool, dtype) -> torch.Tensor:
        """NCHW conv path; BN with batch statistics (train) or running ones."""
        out = torch.relu(self.bn1(conv3x3(x, self.conv1, dtype), train))
        out = self.bn2(conv3x3(out, self.conv2, dtype), train)
        return torch.relu(out + x)


class ResNetActorCritic(nn.Module):
    def __init__(self, action_dim: int, obs_shape, channels: int = 64,
                 num_blocks: int = 4, head_hidden: int = 256, dtype=torch.float32):
        super().__init__()
        _, self.m, self.n = obs_shape
        self.channels = channels
        self.dtype = dtype
        self.folded = False
        self.conv_in = nn.Conv2d(obs_shape[0], channels, 3, padding=1)
        self.bn_in = BatchNorm(channels)
        self.blocks = nn.ModuleList(ResidualBlock(channels) for _ in range(num_blocks))
        self.heads = ActorCriticHeads(channels, self.m * self.n, action_dim, head_hidden)

    def conv_bn_pairs(self):
        yield self.conv_in, self.bn_in
        for blk in self.blocks:
            yield blk.conv1, blk.bn1
            yield blk.conv2, blk.bn2

    def forward(self, obs: torch.Tensor, train: bool = False):
        """(B, 2, M, N) observation -> (logits (B, A) f32, value (B, 1) f32)."""
        dt = self.dtype
        if train:
            x = torch.relu(self.bn_in(conv3x3(obs, self.conv_in, dt), True))
            for blk in self.blocks:
                x = blk(x, True, dt)
            return self.heads(x.permute(0, 2, 3, 1), dt)
        if not self.folded:
            from .fold_bn import fold_batchnorm

            return fold_batchnorm(self)(obs, train=False)
        b = obs.shape[0]
        x = torch.relu(conv3x3(obs, self.conv_in, dt))  # BN folded into conv_in
        x = x.permute(0, 2, 3, 1).reshape(b, self.m * self.n, self.channels).contiguous()
        for blk in self.blocks:
            x = fused_residual_block(x, *blk.kernel_weights, self.m, self.n)
        return self.heads(x.view(b, self.m, self.n, self.channels), dt)
