from .bert4rec import BERT4Rec
from .sasrec import SASRec, SASRecQueryEncoder

__all__ = ["BERT4Rec", "SASRec", "SASRecQueryEncoder"]
