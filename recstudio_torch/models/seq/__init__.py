from .bert4rec import BERT4Rec
from .dien import DIEN
from .din import DIN
from .gru4rec import GRU4Rec, GRU4RecQueryEncoder
from .narm import NARM, NARMQueryEncoder
from .sasrec import SASRec, SASRecQueryEncoder
from .stamp import STAMP, STAMPQueryEncoder

__all__ = ["BERT4Rec", "DIEN", "DIN", "GRU4Rec", "GRU4RecQueryEncoder", "NARM", "NARMQueryEncoder", "SASRec",
           "SASRecQueryEncoder", "STAMP", "STAMPQueryEncoder"]
