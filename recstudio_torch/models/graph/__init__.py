from .base import BaseGraphRetriever, GraphNet
from .lightgcn import LightGCN
from .ncl import NCL
from .ngcf import NGCF
from .sgl import SGL
from .simgcl import SimGCL

__all__ = ["BaseGraphRetriever", "GraphNet", "LightGCN", "NCL", "NGCF", "SGL", "SimGCL"]
