"""Online serving: fixed-shape batched top-k inference and CTR scoring.

Counterpart of ``recstudio_tpu/serving.py``: ``Predictor`` serves a
retriever's top-k lists, ``ScorePredictor`` a ranker's probabilities.
Each request is
padded to ``max_batch`` rows so every call runs the same shapes; ``warm()``
runs one dummy request at start-up. The dummy is built from the model's
query fields (zeros ``[max_batch, W]`` for ``in_*`` histories, W the
model's ``history_width``: a sequence model's length, a user model's
widest training history; zero ``seqlen``), so it works for sequence and
user retrievers; the JAX package builds it
from the user id alone (``serving.py:102-108``), which SASRec rejects.

Example::

    from recstudio_torch.serving import Predictor
    pred = Predictor(model, max_batch=128, k=20, train_data=test_split).warm()
    scores, items = pred({"user_id": uids, "in_item_id": hist, "seqlen": lens})

    probs = ScorePredictor(ranker, max_batch=256, train_data=trn).warm(rows)(rows)
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from .models.basemodel.recommender import batch_to_device


class _FixedShapeServer:
    """Pad-to-``max_batch`` and latency accounting, shared by the servers."""

    max_batch: int
    _lat_ms: list

    def _pad(self, batch: Dict[str, np.ndarray]) -> Tuple[Dict[str, np.ndarray], int]:
        n = len(next(iter(batch.values())))
        if n > self.max_batch:
            raise ValueError(f"request batch {n} > max_batch {self.max_batch}"
                             " — split the request")
        out = {}
        for key, value in batch.items():
            value = np.asarray(value)
            out[key] = np.pad(value, [(0, self.max_batch - n)] + [(0, 0)] * (value.ndim - 1))
        return out, n

    def stats(self) -> Dict[str, float]:
        lat = sorted(self._lat_ms) or [0.0]
        return {
            "requests": len(self._lat_ms),
            "p50_ms": lat[len(lat) // 2],
            "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
            "mean_ms": float(np.mean(lat)),
        }


class Predictor(_FixedShapeServer):
    """Fixed-shape batched top-k server for a retriever. Runs on the
    model's device; history masking uses ``train_data.user_hist``."""

    def __init__(self, model, max_batch: int = 32, k: int = 20,
                 train_data=None, exclude_history: bool = True):
        self.model = model
        self.max_batch = int(max_batch)
        self.k = int(k)
        # snapshot item vectors from the current parameters
        model._epoch_refresh(-1)
        hist = getattr(train_data, "user_hist", None) if exclude_history else None
        self._hist = None if hist is None else \
            torch.as_tensor(np.asarray(hist, dtype=np.int32)).to(model.device)
        self._lat_ms = []

    def _dummy(self) -> Dict[str, np.ndarray]:
        out = {}
        for f in sorted(self.model.query_fields):
            # only a history field has a width (the model's, from its dataset)
            shape = ((self.max_batch, self.model.history_width) if f.startswith("in_")
                     else (self.max_batch,))
            out[f] = np.zeros(shape, np.int32)
        return out

    def warm(self) -> "Predictor":
        """Run one dummy request through the serving path (kernels built and
        loaded, caches filled) before the first real one."""
        scores, _ = self._call_padded(self._dummy())
        float(scores.sum().item())   # host read: genuinely complete
        return self

    def _call_padded(self, padded: Dict[str, np.ndarray]):
        fuid = self.model.fuid
        dev = batch_to_device({f: v for f, v in padded.items()
                               if f in self.model.query_fields}, self.model.device)
        user_hist = None
        if self._hist is not None and fuid in dev:
            user_hist = self._hist[dev[fuid].to(torch.long)]
        return self.model.topk(dev, self.k, user_hist)

    def __call__(self, batch: Dict[str, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """Serve one request: ``(scores [n, k], item ids [n, k], 1-based)``."""
        t0 = time.perf_counter()
        padded, n = self._pad(batch)
        scores, items = self._call_padded(padded)
        scores = scores[:n].cpu().numpy()   # the host read is the fence
        items = items[:n].cpu().numpy()
        self._lat_ms.append((time.perf_counter() - t0) * 1e3)
        return scores, items


class ScorePredictor(_FixedShapeServer):
    """Fixed-shape CTR scorer for a fitted ranker (``serving.py:128-167``):
    each feature batch is joined with the user and item features of its
    ids, as the training loader joins them (``train_data``'s
    ``_gather_entity_feats``), padded to ``max_batch`` rows, scored on the
    model's device, and returned as sigmoid probabilities in numpy."""

    def __init__(self, model, max_batch: int = 256, train_data=None):
        from .models.basemodel.baseranker import BaseRanker
        if not isinstance(model, BaseRanker):
            raise NotImplementedError("ScorePredictor serves rankers; scoring a retriever's "
                                      "(user, item) rows is not ported yet (ROADMAP.md queue 1, "
                                      "the ranker items)")
        self.model = model
        self.max_batch = int(max_batch)
        self._feat_join = getattr(train_data, "_gather_entity_feats", None)
        self._lat_ms = []

    def _pad(self, batch: Dict[str, np.ndarray]) -> Tuple[Dict[str, np.ndarray], int]:
        if self._feat_join is not None:
            batch = self._feat_join(dict(batch))
        return super()._pad(batch)

    @torch.no_grad()
    def _run(self, padded: Dict[str, np.ndarray]) -> torch.Tensor:
        self.model.net.eval()
        return self.model.score(batch_to_device(padded, self.model.device))

    def warm(self, example: Dict[str, np.ndarray]) -> "ScorePredictor":
        """Score ``example`` once before the first real request."""
        padded, _ = self._pad(example)
        float(self._run(padded).sum().item())   # host read: genuinely complete
        return self

    def __call__(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        t0 = time.perf_counter()
        padded, n = self._pad(batch)
        out = torch.sigmoid(self._run(padded)[:n]).cpu().numpy()   # the host read is the fence
        self._lat_ms.append((time.perf_counter() - t0) * 1e3)
        return out
