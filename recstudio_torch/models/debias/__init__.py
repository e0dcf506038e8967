from .ipsbpr import IPSBPR
from .pda import PDA

__all__ = ["IPSBPR", "PDA"]
