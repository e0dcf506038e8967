"""Kernels of the port, each with its plain PyTorch version.

``fused_transformer_layer`` (K1) and ``fused_mha`` (K3) launch hand-written
CUDA kernels on CUDA tensors and use their plain versions on CPU tensors.
"""
from .attention import fused_mha, mha_plain
from .topk import topk
from .transformer_layer import (fused_transformer_layer, supports_fused_layer,
                                transformer_layer_plain)

KERNELS = (fused_transformer_layer, fused_mha)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


__all__ = ["fused_mha", "mha_plain", "topk", "fused_transformer_layer",
           "supports_fused_layer", "transformer_layer_plain", "KERNELS",
           "reset_launch_counts", "launch_counts"]
