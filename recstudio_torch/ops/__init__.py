"""Kernels of the port, each with its plain PyTorch version.

``fused_transformer_layer`` (K1), ``fused_transformer_layer_bwd`` (K2),
``fused_mha`` (K3) and the catalog log-partition kernels
``catalog_logsumexp_fwd`` (K7), ``catalog_logsumexp_dq`` (K8) and
``catalog_logsumexp_ditems`` (K9) launch hand-written CUDA kernels on CUDA
tensors and use their plain versions on CPU tensors.
"""
from .attention import fused_mha, mha_plain
from .softmax_z import (catalog_logsumexp, catalog_logsumexp_ditems,
                        catalog_logsumexp_ditems_plain, catalog_logsumexp_dq,
                        catalog_logsumexp_dq_plain, catalog_logsumexp_fwd, catalog_logsumexp_plain)
from .topk import topk
from .transformer_layer import (fused_transformer_layer, fused_transformer_layer_bwd,
                                supports_fused_layer, transformer_layer_bwd_plain,
                                transformer_layer_plain)

KERNELS = (fused_transformer_layer, fused_transformer_layer_bwd, fused_mha,
           catalog_logsumexp_fwd, catalog_logsumexp_dq, catalog_logsumexp_ditems)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


__all__ = ["fused_mha", "mha_plain", "topk", "fused_transformer_layer",
           "fused_transformer_layer_bwd", "supports_fused_layer",
           "transformer_layer_bwd_plain", "transformer_layer_plain", "catalog_logsumexp",
           "catalog_logsumexp_fwd", "catalog_logsumexp_dq", "catalog_logsumexp_ditems",
           "catalog_logsumexp_plain", "catalog_logsumexp_dq_plain",
           "catalog_logsumexp_ditems_plain", "KERNELS",
           "reset_launch_counts", "launch_counts"]
