from .base import BaseGraphRetriever, GraphNet
from .lightgcn import LightGCN
from .ngcf import NGCF
from .simgcl import SimGCL

__all__ = ["BaseGraphRetriever", "GraphNet", "LightGCN", "NGCF", "SimGCL"]
