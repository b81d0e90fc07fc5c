"""The ResNet family: a 3x3 conv, BatchNorm and ReLU, then residual blocks
of two of each (``rl_selfplay_mnk_tpu_torch/models/resnet.py``). Train
mode takes BatchNorm's statistics over the batch, so the family mixes
boards; K2 is the program's BN-folded residual block of the opponent's
eval forward."""

from __future__ import annotations

import torch

from .. import reference as ref
from .. import yardstick

BATCH_COUPLED = True


def body_shapes(cfg: dict):
    c = cfg["channels"]
    out = {}

    def conv_bn(conv, bn, cin):
        out[f"{conv}.weight"] = ((c, cin, 3, 3), "kernel")
        out[f"{conv}.bias"] = ((c,), "zero")
        out[f"{bn}.weight"] = ((c,), "one")
        out[f"{bn}.bias"] = ((c,), "zero")
        out[f"{bn}.running_mean"] = ((c,), "buffer_zero")
        out[f"{bn}.running_var"] = ((c,), "buffer_one")

    conv_bn("conv_in", "bn_in", 2)
    for i in range(cfg["num_blocks"]):
        conv_bn(f"blocks.{i}.conv1", f"blocks.{i}.bn1", c)
        conv_bn(f"blocks.{i}.conv2", f"blocks.{i}.bn2", c)
    return out, c


def body(cfg, p, obs, train, prec):
    eps = cfg["batchnorm_eps"]
    x = torch.relu(ref._batch_norm(ref._conv(obs, p["conv_in.weight"], p["conv_in.bias"], prec),
                                   p, "bn_in", train, eps))
    for i in range(cfg["num_blocks"]):
        b = f"blocks.{i}"
        h = ref._conv(x, p[f"{b}.conv1.weight"], p[f"{b}.conv1.bias"], prec)
        h = torch.relu(ref._batch_norm(h, p, f"{b}.bn1", train, eps))
        h = ref._batch_norm(ref._conv(h, p[f"{b}.conv2.weight"], p[f"{b}.conv2.bias"], prec), p,
                            f"{b}.bn2", train, eps)
        x = torch.relu(h + x)
    return x.permute(0, 2, 3, 1)  # (B, M, N, C): the heads flatten in (m, n, plane) order


def body_flops(cfg: dict) -> float:
    m, n, _ = cfg["mnk"]
    cells, c = m * n, cfg["channels"]
    return float(2 * cells * 9 * 2 * c + cfg["num_blocks"] * 2 * (2 * cells * 9 * c * c))


def kernel_work(cfg: dict, traffic: dict) -> dict:
    """K2: the opponent's residual blocks a rollout step."""
    return {"K2": ("resblock", traffic["n_steps"] * cfg["num_blocks"]
                   * yardstick.k2_bound_s(cfg["mnk"], traffic["num_envs"], cfg["channels"]))}
