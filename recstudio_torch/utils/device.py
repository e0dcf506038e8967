"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: they take
``device="cuda"`` by default and raise when no GPU is present, so a run never
carries on quietly on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "recstudio_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
