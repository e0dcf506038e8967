"""Negative samplers (``recstudio_tpu/ann``): the uniform proposals so far."""
from .sampler import MaskedUniformSampler, Sampler, UniformSampler

__all__ = ["MaskedUniformSampler", "Sampler", "UniformSampler"]
