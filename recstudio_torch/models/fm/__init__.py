from .afm import AFM
from .afn import AFN
from .autoint import AutoInt
from .dcn import DCN
from .dcnv2 import DCNv2
from .deepfm import DeepFM
from .difm import DIFM
from .dlrm import DLRM
from .ffm import FFM
from .fibinet import FiBiNET
from .fm import FM
from .fmfm import FmFM
from .fwfm import FwFM
from .hfm import HFM
from .interhat import InterHAt
from .lr import LR
from .masknet import MaskNet
from .nfm import NFM
from .onn import ONN
from .pnn import PNN
from .widedeep import WideDeep
from .xdeepfm import xDeepFM

__all__ = ["AFM", "AFN", "AutoInt", "DCN", "DCNv2", "DeepFM", "DIFM", "DLRM", "FFM", "FiBiNET", "FM",
           "FmFM", "FwFM", "HFM", "InterHAt", "LR", "MaskNet", "NFM", "ONN", "PNN", "WideDeep",
           "xDeepFM"]
