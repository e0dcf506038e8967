"""RecStudio on PyTorch and CUDA.

A port of ``recstudio_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
The module layout mirrors the JAX package so each file has a counterpart
there. This package imports ``torch`` and ``numpy`` only; its CUDA kernels
(``csrc/``) are compiled with ``nvcc`` at first use (``ops/_native.py``).

Implemented so far: SASRec top-k serving (``models/seq/sasrec.py``,
``serving.py``) with the fused transformer-layer and masked-attention
forward kernels.
"""
from .utils import get_model, get_dataset_default_config, seed_everything

__all__ = ["get_model", "get_dataset_default_config", "seed_everything"]
