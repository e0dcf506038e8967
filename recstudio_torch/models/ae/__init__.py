from .multidae import MultiDAE
from .multivae import MultiVAE

__all__ = ["MultiDAE", "MultiVAE"]
