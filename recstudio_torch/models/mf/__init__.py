from .bpr import BPR
from .cml import CML
from .dssm import DSSM
from .ease import EASE
from .irgan import IRGAN
from .itemknn import ItemKNN
from .logisticmf import LogisticMF
from .ncf import NCF
from .pmf import PMF
from .slim import SLIM
from .wrmf import WRMF

__all__ = ["BPR", "CML", "DSSM", "EASE", "IRGAN", "ItemKNN", "LogisticMF", "NCF", "PMF", "SLIM",
           "WRMF"]
