from .afm import AFM
from .afn import AFN
from .aoanet import AOANet
from .autoint import AutoInt
from .ccpm import CCPM
from .dcn import DCN
from .dcnv2 import DCNv2
from .deepcrossing import DeepCrossing
from .deepfm import DeepFM
from .deepim import DeepIM
from .destine import DESTINE
from .difm import DIFM
from .dlrm import DLRM
from .edcn import EDCN
from .ffm import FFM
from .fgcnn import FGCNN
from .fibinet import FiBiNET
from .fignn import FiGNN
from .finalmlp import FinalMLP
from .flen import FLEN
from .fm import FM
from .fmfm import FmFM
from .fwfm import FwFM
from .hfm import HFM
from .ifm import IFM
from .interhat import InterHAt
from .lorentzfm import LorentzFM
from .lr import LR
from .masknet import MaskNet
from .nfm import NFM
from .onn import ONN
from .pnn import PNN
from .ppnet import PPNet
from .sam import SAM
from .widedeep import WideDeep
from .xdeepfm import xDeepFM

__all__ = ["AFM", "AFN", "AOANet", "AutoInt", "CCPM", "DCN", "DCNv2", "DeepCrossing", "DeepFM",
           "DeepIM", "DESTINE", "DIFM", "DLRM", "EDCN", "FFM", "FGCNN", "FiBiNET", "FiGNN",
           "FinalMLP", "FLEN", "FM", "FmFM", "FwFM", "HFM", "IFM", "InterHAt", "LorentzFM", "LR",
           "MaskNet", "NFM", "ONN", "PNN", "PPNet", "SAM", "WideDeep", "xDeepFM"]
