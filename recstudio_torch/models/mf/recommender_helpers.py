"""Shared set-up of the retrievers with no tower (EASE, ItemKNN, SLIM).

Counterpart of ``recstudio_tpu/models/mf/recommender_helpers.py``: the
field bookkeeping of ``Recommender._init_model`` and the catalog sizes,
with no net and no sampler.
"""
from __future__ import annotations


def init_linear_retriever(model, train_data) -> None:
    """``recommender_helpers.py:6-15``."""
    from ..basemodel.recommender import Recommender
    Recommender._init_model(model, train_data)
    model.num_items = train_data.num_items
    model.num_users = train_data.num_users
    model.query_fields = {model.fuid}
    model.item_fields = {model.fiid}
    model.net = None
    model.sampler = None
