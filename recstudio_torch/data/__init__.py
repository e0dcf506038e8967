from .advance_dataset import ALSDataset
from .dataset import FullSeqDataset, SeqDataset, SeqToSeqDataset, TripletDataset, UserDataset

__all__ = ["ALSDataset", "FullSeqDataset", "SeqDataset", "SeqToSeqDataset", "TripletDataset",
           "UserDataset"]
