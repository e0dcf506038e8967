"""Online serving: fixed-shape batched top-k inference.

Counterpart of ``recstudio_tpu/serving.py:Predictor``. Each request is
padded to ``max_batch`` rows so every call runs the same shapes; ``warm()``
runs one dummy request at start-up. The dummy is built from the model's
query fields (zeros ``[max_batch, L]`` for ``in_*`` histories, zero
``seqlen``), so it works for sequence retrievers; the JAX package builds it
from the user id alone (``serving.py:102-108``), which SASRec rejects.

Example::

    from recstudio_torch.serving import Predictor
    pred = Predictor(model, max_batch=128, k=20, train_data=test_split).warm()
    scores, items = pred({"user_id": uids, "in_item_id": hist, "seqlen": lens})
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from .models.basemodel.recommender import batch_to_device


class Predictor:
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

    def _dummy(self) -> Dict[str, np.ndarray]:
        out = {}
        for f in sorted(self.model.query_fields):
            # only a sequence field has a length: other query towers have no max_seq_len
            shape = ((self.max_batch, self.model.query_encoder.max_seq_len) if f.startswith("in_")
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

    def stats(self) -> Dict[str, float]:
        lat = sorted(self._lat_ms) or [0.0]
        return {
            "requests": len(self._lat_ms),
            "p50_ms": lat[len(lat) // 2],
            "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
            "mean_ms": float(np.mean(lat)),
        }
