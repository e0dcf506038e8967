"""BaseRanker: pointwise CTR / feature-interaction models.

Counterpart of ``recstudio_tpu/models/basemodel/baseranker.py`` without a
cascaded retriever. A ranker scores one feature row (user, item and
context fields, or the id-less fields of a criteo-layout dataset)
pointwise: ``self.net(batch, rng)`` returns logits ``[B]``, trained with
``BCEWithLogitLoss`` against binarized ratings. Every field of the
dataset is a feature (``_set_data_field``). Evaluation is per row
(``fmeval``): ``logloss``, ``mse``, ``mae`` and ``accuracy`` as masked
per-row sums, and ``auc`` once over the whole split's scores, labels and
weights, all kept on the device (``recommender.py:1159-1188``).

``learner: sparse_adam`` runs the port's dense ``LazyAdam``, whose
trajectory the JAX package's row-sparse CTR step follows; that packed
``[N, 3D]`` step (``_ctr_sparse_grad_step``) is not ported, and
``train.sparse_rows: true``, which asks for it, raises. A retriever or a
two-stage cascade, multitask ratings and the rank metrics a cascade
serves are not ported yet and raise.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ... import eval as eval_mod
from ..loss_func import BCEWithLogitLoss
from .recommender import Recommender, batch_to_device

_QUEUE = "(ROADMAP.md queue 1, the ranker items)"


class BaseRanker(Recommender):
    def __init__(self, config: Dict = None, device="cuda", retriever=None):
        if retriever is not None:
            raise NotImplementedError(f"a ranker with a cascaded retriever (two-stage) is not "
                                      f"ported yet {_QUEUE}")
        super().__init__(config, device)
        tc = self.config["train"]
        if str(tc.get("sparse_rows", "auto")).lower() == "true":
            raise NotImplementedError(
                "train.sparse_rows 'true' asks for the packed row-sparse CTR step, which is not "
                f"ported yet {_QUEUE}; 'auto' or 'false' trains sparse_adam as dense lazy Adam, "
                "the same trajectory")
        self._eval_cache: Dict[Tuple[int, int], Tuple[object, List[Dict[str, torch.Tensor]]]] = {}

    def _set_data_field(self, data) -> None:
        """Every declared field is a feature (``baseranker.py:30-44``)."""
        data.use_field = set(data.field2type.keys())

    def _init_model(self, train_data):
        self._set_data_field(train_data)
        super()._init_model(train_data)
        if isinstance(self.frating, list):
            raise NotImplementedError(f"multitask ratings are not ported yet {_QUEUE}")
        self.net = self._get_score_net(train_data)
        self._eval_cache.clear()

    def _get_score_net(self, train_data) -> torch.nn.Module:
        raise NotImplementedError

    def _get_loss_func(self):
        return BCEWithLogitLoss()

    # ------------------------------------------------------------------
    def score(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Logits ``[B]``; dropout (training mode) draws its seeds from
        ``self.generator``."""
        return self.net(batch, self.generator)

    @torch.no_grad()
    def predict(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """numpy feature batch in, numpy probabilities out
        (``baseranker.py:373-385``)."""
        self.net.eval()
        return torch.sigmoid(self.score(batch_to_device(batch, self.device))).cpu().numpy()

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The pointwise branch of ``baseranker.py:393-422``."""
        return {"pos_score": self.score(batch), "label": batch[self.frating]}

    def training_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        out = self.forward(batch)
        return self.loss_fn(out["label"], out["pos_score"])

    # ------------------------------------------------------------------
    def _eval_batches(self, data) -> List[Dict[str, torch.Tensor]]:
        """A split's padded eval batches, staged on the device once and
        kept for the split's later evaluations (``_eval_scan_parts``)."""
        bs = int(self.config["eval"]["batch_size"])
        key = (id(data), bs)
        if key not in self._eval_cache:
            data.use_field = self.fields
            batches = [batch_to_device(b, self.device) for b in data.eval_loader(bs)]
            self._eval_cache[key] = (data, batches)
        return self._eval_cache[key][1]

    @torch.no_grad()
    def _eval_epoch(self, data, metric_names, cutoffs) -> Dict[str, float]:
        """``_make_eval_step`` and ``_global_metrics`` (``baseranker.py:
        436-520``) over a split: per-row metrics summed over the true rows
        of each batch, ``auc`` over all of the split's rows at once (padded
        rows weigh 0); every number stays on the device until the end."""
        if eval_mod.get_rank_metrics(metric_names):
            raise NotImplementedError("rank metrics of a ranker need a cascaded retriever, "
                                      f"not ported yet {_QUEUE}")
        unknown = [m for m in metric_names if not eval_mod.get_pred_metrics(m)]
        if unknown:
            raise NotImplementedError(f"metrics {unknown} are not ported for a ranker")
        global_names = {m for m, _ in eval_mod.get_global_metrics(metric_names)}
        pred_m = [(m, fn) for m, fn in eval_mod.get_pred_metrics(metric_names)
                  if m not in global_names and m in ("logloss", "accuracy", "mse", "mae")]
        thres = self.config["eval"].get("binarized_prob_thres", 0.5)
        self.net.eval()
        sums: Dict[str, torch.Tensor] = {}
        weight = torch.zeros((), device=self.device)
        glob: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []
        for batch in self._eval_batches(data):
            label = batch[self.frating]
            valid = (torch.arange(label.shape[0], device=self.device) < batch["_size"]).float()
            scores = self.score(batch)
            for name, fn in pred_m:
                if name == "logloss":
                    per = fn(scores, label)
                elif name == "accuracy":
                    per = fn(torch.sigmoid(scores), label, thres)
                else:
                    per = fn(torch.sigmoid(scores), label)
                val = (per * valid).sum()
                sums[name] = sums[name] + val if name in sums else val
            weight = weight + batch["_size"].float()
            if global_names:
                glob.append((scores, label, valid))
        out = {k: float(v) / max(float(weight), 1.0) for k, v in sums.items()}
        if glob:
            scores, labels, weights = (torch.cat(x) for x in zip(*glob))
            for name, fn in eval_mod.get_global_metrics(metric_names):
                out[name] = float(fn(scores, labels, weights))
        return out
