from .bpr import BPR
from .cml import CML
from .logisticmf import LogisticMF
from .ncf import NCF
from .pmf import PMF

__all__ = ["BPR", "CML", "LogisticMF", "NCF", "PMF"]
