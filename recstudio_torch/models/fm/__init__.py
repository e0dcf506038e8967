from .autoint import AutoInt
from .dcn import DCN
from .deepfm import DeepFM
from .fm import FM
from .lr import LR
from .nfm import NFM
from .widedeep import WideDeep

__all__ = ["AutoInt", "DCN", "DeepFM", "FM", "LR", "NFM", "WideDeep"]
