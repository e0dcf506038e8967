"""RecStudio on PyTorch and CUDA.

A port of ``recstudio_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
The module layout mirrors the JAX package so each file has a counterpart
there. This package imports ``torch`` and ``numpy`` only; its CUDA kernels
(``csrc/``) are compiled with ``nvcc`` at first use (``ops/_native.py``).

Implemented so far: SASRec and BERT4Rec training and serving
(``models/seq/``) on the CUDA kernels of ``csrc/``; NARM, STAMP and
GRU4Rec; BPR (``models/mf/``) with lazy Adam, dense and row-sparse
(``models/optim.py``); MultiDAE and MultiVAE (``models/ae/``); the CTR
rankers DeepFM, FM and LR (``models/fm/`` on ``BaseRanker``); top-k and
CTR serving (``serving.py``); and ``quickstart.run`` with its command
line (``python -m recstudio_torch.quickstart -m BPR -d ml-100k``).
"""
from .utils import get_model, get_dataset_default_config, seed_everything

__all__ = ["get_model", "get_dataset_default_config", "seed_everything"]
