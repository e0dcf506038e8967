from .deepfm import DeepFM
from .fm import FM
from .lr import LR

__all__ = ["DeepFM", "FM", "LR"]
