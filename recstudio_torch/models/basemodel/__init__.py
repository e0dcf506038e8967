from .baseretriever import BaseRetriever, SharedItemTowerNet
from .recommender import Recommender, batch_to_device

__all__ = ["BaseRetriever", "SharedItemTowerNet", "Recommender", "batch_to_device"]
