from .aitm import AITM
from .hardshare import HardShare
from .mmoe import MMoE
from .ple import PLE

__all__ = ["AITM", "HardShare", "MMoE", "PLE"]
