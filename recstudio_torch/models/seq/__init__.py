from .sasrec import SASRec, SASRecQueryEncoder

__all__ = ["SASRec", "SASRecQueryEncoder"]
