from .baseranker import BaseRanker
from .baseretriever import BaseRetriever, SharedItemTowerNet, TwoTowerNet
from .recommender import Recommender, batch_to_device

__all__ = ["BaseRanker", "BaseRetriever", "SharedItemTowerNet", "TwoTowerNet", "Recommender", "batch_to_device"]
