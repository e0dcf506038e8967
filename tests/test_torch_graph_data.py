"""Dataset-side negatives are refused, not dropped: ``TripletDataset.build``
and ``SeqDataset.build`` raise on a truthy ``neg_count`` or ``sampler``
(the JAX package appends ``neg_count`` rating-0 rows to each batch, which
the port does not), and build as before with the defaults of
``configs/basemodel.json`` (0 and null)."""
import numpy as np
import pytest

from recstudio_torch.data import SeqDataset, TripletDataset
from recstudio_torch.utils import get_model

DATASETS = {"TripletDataset": TripletDataset, "SeqDataset": SeqDataset}


@pytest.mark.parametrize("kwargs", [dict(neg_count=4, sampler="uniform"), dict(neg_count=4),
                                    dict(sampler="uniform")], ids=["both", "neg_count", "sampler"])
@pytest.mark.parametrize("name", list(DATASETS))
def test_dataset_side_negatives_raise(name, kwargs):
    ds = DATASETS[name]("ml-100k")
    with pytest.raises(NotImplementedError, match="dataset-side negatives"):
        ds.build(**kwargs)


@pytest.mark.parametrize("model,name", [("BPR", "TripletDataset"), ("LightGCN", "TripletDataset"),
                                        ("SASRec", "SeqDataset")])
def test_default_data_config_builds(model, name):
    cls, conf = get_model(model)
    assert conf["data"]["neg_count"] == 0 and conf["data"]["sampler"] is None
    assert cls._get_dataset_class() is DATASETS[name]
    np.random.seed(0)
    splits = cls._get_dataset_class()("ml-100k").build(**conf["data"])
    assert len(splits) == 3 and all(len(s.data_index) for s in splits)
    batch = splits[0]._get_pos_batch(np.arange(8))
    assert len(batch[splits[0].fiid]) == 8       # no negative rows appended
