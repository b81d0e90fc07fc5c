"""Device choice and precision policy (counterpart of the JAX package's
``utils/hardware.py``): bf16 compute with f32 parameters on the card, f32
on the CPU.

Entry points run on ``cuda`` unless the caller asks for the CPU; without
CUDA they raise instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch


@dataclass(frozen=True)
class HardwareConfig:
    platform: str  # "gpu" | "cpu"
    num_devices: int
    compute_dtype: Any
    device_kind: str
    device: torch.device

    @property
    def is_accelerator(self) -> bool:
        return self.platform == "gpu"


def resolve_device(device=None) -> torch.device:
    """``None``/"cuda" -> the card (raises when CUDA is absent); any other
    device the caller names is taken as given."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --device cpu) to run on the CPU"
        )
    return dev


def detect_hardware_config(device: Optional[str] = None) -> HardwareConfig:
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        cfg = HardwareConfig(
            platform="gpu",
            num_devices=torch.cuda.device_count(),
            compute_dtype=torch.bfloat16,
            device_kind=torch.cuda.get_device_name(dev),
            device=dev,
        )
    else:
        cfg = HardwareConfig("cpu", 1, torch.float32, "cpu", dev)
    print(
        f"Hardware: {cfg.num_devices}x {cfg.device_kind} ({cfg.platform}), "
        f"compute dtype {str(cfg.compute_dtype).replace('torch.', '')}"
    )
    return cfg
