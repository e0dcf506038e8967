from .dataset import SeqDataset, TripletDataset

__all__ = ["SeqDataset", "TripletDataset"]
