from .dataset import SeqDataset, TripletDataset, UserDataset

__all__ = ["SeqDataset", "TripletDataset", "UserDataset"]
