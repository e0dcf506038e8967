"""Negative samplers (``recstudio_tpu/ann``): uniform, popularity, MIDX,
cluster and LSH proposals, and a retriever as a proposal."""
from .sampler import (ClusterSamplerPop, ClusterSamplerUniform, LSHSampler,
                      MaskedUniformSampler, MIDXSamplerPop, MIDXSamplerUniform,
                      PopularSamplerModel, RetrieverSampler, Sampler, UniformSampler)

__all__ = ["ClusterSamplerPop", "ClusterSamplerUniform", "LSHSampler", "MaskedUniformSampler",
           "MIDXSamplerPop", "MIDXSamplerUniform", "PopularSamplerModel", "RetrieverSampler",
           "Sampler", "UniformSampler"]
