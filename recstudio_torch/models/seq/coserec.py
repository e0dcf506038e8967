"""CoSeRec: contrastive sequential recommendation with robust augmentations.

Counterpart of ``recstudio_tpu/models/seq/coserec.py``: CL4SRec whose two
views are each row's choice among five: insert and substitute (the most
similar item, ``states["top1_sim"]``), crop, mask and reorder; a sequence
no longer than ``augment_threshold`` chooses between the first two. The
similar item is the most co-occurring other item over the training
windows (``_cooccurrence_top1``, numpy on the host, a dense ``[N, N]``
float32 count) until ``augmentation_warm_up_epochs`` training epochs have
run, then, refreshed before each epoch, the item whose normalised
embedding is nearest.
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from ..module.data_augmentation import (Draws, View, crop_map, insert_map, mask_map,
                                        reorder_map, substitute_map)
from .cl4srec import CL4SRec


def view_draws(shape, generator, device) -> Draws:
    """The draws of one ``view_map``: each view's uniforms and a row's two
    choices, among two views and among five."""
    B = shape[0]
    rand = lambda *s: torch.rand(s, generator=generator, device=device)
    return {"insert": rand(*shape), "substitute": rand(*shape), "crop": rand(B),
            "mask": rand(*shape), "reorder": rand(B), "reorder_noise": rand(*shape),
            "short": torch.randint(0, 2, (B,), generator=generator, device=device),
            "long": torch.randint(0, 5, (B,), generator=generator, device=device)}


def view_map(seq: torch.Tensor, seqlen: torch.Tensor, top1: torch.Tensor, draws: Draws,
             insert_rate: float, substitute_rate: float, mask_id: int, threshold: int) -> View:
    """Each row's insert (choice 0), substitute (1), crop (2), mask (3) or
    reorder (4) view; a row no longer than ``threshold`` takes its short
    choice (0 or 1), a longer one its long choice (``coserec.py:75-98``)."""
    views = [insert_map(seq, seqlen, draws["insert"], top1, insert_rate),
             substitute_map(seq, seqlen, draws["substitute"], top1, substitute_rate),
             crop_map(seq, seqlen, draws["crop"]),
             mask_map(seq, seqlen, draws["mask"], mask_id=mask_id),
             reorder_map(seq, seqlen, draws["reorder"], draws["reorder_noise"])]
    choice = torch.where(seqlen > threshold, draws["long"], draws["short"])
    out_seq, out_len = views[0]
    for i in range(1, 5):
        out_seq = torch.where((choice == i)[:, None], views[i][0], out_seq)
        out_len = torch.where(choice == i, views[i][1], out_len)
    return out_seq, out_len


class CoSeRec(CL4SRec):

    def _init_model(self, train_data):
        super()._init_model(train_data)
        t = time.perf_counter()
        self._offline_top1 = torch.as_tensor(self._cooccurrence_top1(train_data)).to(self.device)
        self.cooccurrence_s = time.perf_counter() - t       # host seconds of the offline table

    def _cooccurrence_top1(self, train_data) -> np.ndarray:
        """Each item's most co-occurring other item over the training
        windows' users (``coserec.py:37-56``); ``[PAD]`` is never proposed,
        and an item with no co-occurrence proposes itself."""
        sub = train_data.inter_feat_subset
        users = np.asarray(train_data.inter_feat.get_col(self.fuid))[sub]
        items = np.asarray(train_data.inter_feat.get_col(self.fiid))[sub]
        n = self.num_items
        co = np.zeros((n, n), dtype=np.float32)
        order = np.argsort(users, kind="stable")
        u_s, i_s = users[order], items[order]
        bounds = np.hstack([[0], np.flatnonzero(u_s[1:] != u_s[:-1]) + 1, [len(u_s)]])
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            basket = np.unique(i_s[lo:hi])
            if len(basket) > 1:
                co[np.ix_(basket, basket)] += 1
        np.fill_diagonal(co, 0)
        co[:, 0] = -1
        top1 = co.argmax(axis=1).astype(np.int32)
        top1[0] = 0
        no_co = co.max(axis=1) <= 0
        top1[no_co] = np.arange(n)[no_co]
        return top1

    @torch.no_grad()
    def _online_top1(self) -> torch.Tensor:
        """Each item's nearest other item by the cosine of its encoding,
        ``[PAD]`` mapped to itself (``coserec.py:64-70``)."""
        vec = self._compute_item_vector()                              # [N - 1, D]
        vn = vec * torch.rsqrt((vec * vec).sum(-1, keepdim=True) + 1e-12)
        sim = vn @ vn.t() - 2.0 * torch.eye(vn.shape[0], device=vn.device)
        return torch.cat([torch.zeros(1, dtype=torch.int32, device=vn.device),
                          torch.argmax(sim, dim=1).to(torch.int32) + 1])

    @torch.no_grad()
    def _epoch_refresh(self, nepoch: int):
        """``coserec.py:58-73``: the online table from the epoch after the
        warm-up on, the offline one until then."""
        super()._epoch_refresh(nepoch)
        if nepoch >= int(self.config["model"].get("augmentation_warm_up_epochs", 120)):
            self.states["top1_sim"] = self._online_top1()
        elif "top1_sim" not in self.states:
            self.states["top1_sim"] = self._offline_top1

    def _augment_view(self, seq: torch.Tensor, seqlen: torch.Tensor,
                      top1: torch.Tensor) -> View:
        """One view (``coserec.py:75-98``), the draws from the device
        generator."""
        mc = self.config["model"]
        return view_map(seq, seqlen, top1, view_draws(seq.shape, self.device_generator,
                                                      seq.device),
                        mc.get("insert_rate", 0.4), mc.get("substitute_rate", 0.1),
                        self.mask_id, mc.get("augment_threshold", 4))

    def _views(self, batch: Dict[str, torch.Tensor]) -> Tuple[View, View]:
        if "top1_sim" not in self.states:
            raise RuntimeError("CoSeRec has no similar-item table: a training epoch builds it "
                               "(_epoch_refresh(nepoch >= 0))")
        seq, seqlen, top1 = batch["in_" + self.fiid], batch["seqlen"], self.states["top1_sim"]
        return self._augment_view(seq, seqlen, top1), self._augment_view(seq, seqlen, top1)
