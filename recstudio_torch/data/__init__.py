from .advance_dataset import ALSDataset
from .dataset import SeqDataset, TripletDataset, UserDataset

__all__ = ["ALSDataset", "SeqDataset", "TripletDataset", "UserDataset"]
