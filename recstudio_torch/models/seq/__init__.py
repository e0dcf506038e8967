from .bert4rec import BERT4Rec
from .caser import Caser, CaserQueryEncoder
from .cl4srec import CL4SRec
from .coserec import CoSeRec
from .dien import DIEN
from .din import DIN
from .fpmc import FPMC, FPMCQueryEncoder
from .gru4rec import GRU4Rec, GRU4RecQueryEncoder
from .hgn import HGN, HGNQueryEncoder
from .iclrec import ICLRec
from .narm import NARM, NARMQueryEncoder
from .npe import NPE, NPEItemEncoder, NPEQueryEncoder
from .sasrec import SASRec, SASRecQueryEncoder
from .stamp import STAMP, STAMPQueryEncoder
from .transrec import TransRec, TransRecQueryEncoder

__all__ = ["BERT4Rec", "CL4SRec", "Caser", "CaserQueryEncoder", "CoSeRec", "DIEN", "DIN", "FPMC",
           "FPMCQueryEncoder", "GRU4Rec", "GRU4RecQueryEncoder", "HGN", "HGNQueryEncoder",
           "ICLRec", "NARM", "NARMQueryEncoder", "NPE", "NPEItemEncoder", "NPEQueryEncoder",
           "SASRec", "SASRecQueryEncoder", "STAMP", "STAMPQueryEncoder", "TransRec",
           "TransRecQueryEncoder"]
