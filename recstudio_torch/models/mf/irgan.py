"""IRGAN: a discriminator and a generator, trained in turns by epoch.

Counterpart of ``recstudio_tpu/models/mf/irgan.py``. The net holds four
tables, ``dis_user_embedding``, ``dis_item_embedding``,
``gen_user_embedding`` and ``gen_item_embedding``, each drawn as
``0.02 N(0, 1)`` from the model's generator with row 0 set to 0 (not the
model's ``init_method``). Two Adam (AdamW with a weight decay)
optimizers, one over the ``dis_`` tables and one over the ``gen_``
tables, take turns: ``every_n_epoch_dis`` epochs of the discriminator,
then ``every_n_epoch_gen`` of the generator; the other player's tables
get no update at all. Each epoch is a host-loader epoch over the
``ALSDataset`` rows (a user and its items ``[B, L]``).

``_gen_sample`` draws from the generator's tempered softmax over the
catalog (a pad column 0 of probability 0) mixed with ``sample_lambda /
num_pos`` at the row's positives (the pad id included, then column 0
zeroed): ``num_neg * L`` draws a row from ``imp + 1e-12``, with the
importance weights ``prob / imp`` and the draws' probabilities. The
discriminator's loss is the masked binary cross-entropy of the positives
(pads at -inf) against the mean of their negatives' scores; the
generator's is the policy gradient of its draws' log probabilities,
rewarded by the frozen discriminator. Evaluation and serving score with
the generator's tables.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...data.advance_dataset import ALSDataset
from ..basemodel.baseretriever import BaseRetriever
from ..basemodel.recommender import Recommender, batch_to_device
from ..init import zero_pad_rows_in_grads
from ..loss_func import softplus
from ..module import Embedding
from ..scorer import InnerProductScorer

TABLES = ("dis_user_embedding", "dis_item_embedding", "gen_user_embedding",
          "gen_item_embedding")


class IRGANNet(nn.Module):
    """The two players' tables."""

    def __init__(self, num_users: int, num_items: int, embed_dim: int):
        super().__init__()
        for name in TABLES:
            self.add_module(name, Embedding(num_users if "user" in name else num_items, embed_dim))


class IRGAN(BaseRetriever):

    @staticmethod
    def _get_dataset_class():
        return ALSDataset

    def _init_model(self, train_data):
        Recommender._init_model(self, train_data)
        self.num_users = train_data.num_users
        self.num_items = train_data.num_items
        self.query_fields = {self.fuid}
        self.item_fields = {self.fiid}
        self.net = IRGANNet(self.num_users, self.num_items, self.embed_dim)
        self.score_func = InnerProductScorer()
        self.sampler = None
        # the host loader's shuffles, seeded as the model is
        self._loader_rng = np.random.default_rng(int(self.config["train"].get("seed") or 0))

    def _get_loss_func(self):
        return None

    def _init_parameter(self, train_data=None):
        """Each table ``0.02 N(0, 1)`` with row 0 set to 0
        (``irgan.py:47-58``), drawn in ``TABLES`` order."""
        with torch.no_grad():
            for name in TABLES:
                w = getattr(self.net, name).weight
                draw = 0.02 * torch.randn(w.shape, generator=self.generator)
                draw[0] = 0.0
                w.copy_(draw)
        self.net.to(self.device).eval()
        self.states.clear()

    def _get_optimizers(self):
        """The discriminator's optimizer, then the generator's, each over
        its own tables (``irgan.py:60-73``)."""
        tc = self.config["train"]
        out = []
        for prefix in ("dis", "gen"):
            wd = float(tc.get(f"weight_decay_{prefix}") or 0.0)
            params = [p for n, p in self.net.named_parameters() if n.startswith(prefix + "_")]
            out.append(self._make_optimizer("adamw" if wd else "adam",
                                            float(tc[f"learning_rate_{prefix}"]), wd, params))
        return out

    def _supports_scan_epoch(self, train_data):
        return False

    def _phase(self, nepoch: int) -> int:
        """0 (the discriminator) or 1 (the generator) at epoch ``nepoch``."""
        tc = self.config["train"]
        cycle = tc["every_n_epoch_gen"] + tc["every_n_epoch_dis"]
        return 0 if (nepoch % cycle) < tc["every_n_epoch_dis"] else 1

    def current_epoch_optimizers(self, nepoch: int):
        return [self._phase(nepoch)]

    # ------------------------------------------------------------------
    def _gen_sample(self, batch: Dict[str, torch.Tensor], num_neg: int, t: float,
                    draws: Optional[torch.Tensor] = None):
        """``(weight, draws, neg_prob)`` (``irgan.py:87-106``), each
        ``[B, num_neg L]``; ``draws`` (catalog ids, 0 the pad) come from the
        device generator unless given. Only ``neg_prob`` carries a gradient,
        to the generator's tables."""
        lam = float(self.config["model"]["sample_lambda"])
        query = self.net.gen_user_embedding(batch[self.fuid])
        logits = self.score_func.catalog(query, self.net.gen_item_embedding.weight[1:]) / t
        prob = F.pad(torch.softmax(logits, dim=-1), (1, 0))             # [B, N]
        pos = batch[self.fiid].long()                                    # [B, L]
        with torch.no_grad():
            num_pos = torch.clamp_min((pos > 0).sum(-1, keepdim=True), 1).to(prob.dtype)
            imp = prob.detach() * (1.0 - lam)
            imp = imp + torch.zeros_like(imp).scatter_add_(1, pos, (lam / num_pos).expand(
                pos.shape).contiguous())
            imp[:, 0] = 0.0
            imp = imp + 1e-12
            if draws is None:
                draws = torch.multinomial(imp, num_neg * pos.shape[-1], replacement=True,
                                          generator=self.device_generator)
            draws = draws.long()
            weight = torch.gather(prob.detach(), 1, draws) / torch.gather(imp, 1, draws)
        neg_prob = torch.gather(prob, 1, draws)
        return weight, draws, neg_prob

    def dis_loss(self, batch: Dict[str, torch.Tensor],
                 draws: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The discriminator's loss (``irgan.py:109-122``)."""
        mc = self.config["model"]
        net = self.net
        query = net.dis_user_embedding(batch[self.fuid])
        pos = batch[self.fiid]
        pos_score = self.score_func(query, net.dis_item_embedding(pos))   # [B, L]
        with torch.no_grad():
            _, neg_ids, _ = self._gen_sample(batch, self.neg_count, mc["T_dis"], draws)
        neg_score = self.score_func(query, net.dis_item_embedding(neg_ids))
        neg_score = neg_score.reshape(*pos_score.shape, -1).mean(-1)
        valid = pos != 0                       # the pads' scores are -inf there
        pos_score = torch.where(valid, pos_score, torch.zeros_like(pos_score))
        per = -F.logsigmoid(pos_score) + softplus(neg_score)
        return torch.where(valid, per, torch.zeros_like(per)).sum() / \
            torch.clamp_min(valid.sum(), 1)

    def gen_terms(self, batch: Dict[str, torch.Tensor],
                  draws: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Each draw's ``log p * reward`` ``[B, n L]``, the reward the frozen
        discriminator's (``irgan.py:124-133``)."""
        mc = self.config["model"]
        weight, neg_ids, neg_prob = self._gen_sample(batch, 2 * self.neg_count, mc["T_gen"],
                                                     draws)
        with torch.no_grad():
            d_query = self.net.dis_user_embedding(batch[self.fuid])
            d_items = self.net.dis_item_embedding(neg_ids)
            reward = 2.0 * (torch.sigmoid(self.score_func(d_query, d_items)) - 0.5) * weight
        return torch.log(neg_prob + 1e-12) * reward

    def gen_loss(self, batch: Dict[str, torch.Tensor],
                 draws: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The generator's policy-gradient loss (``irgan.py:124-134``)."""
        return -torch.sum(torch.mean(self.gen_terms(batch, draws), dim=1))

    def training_step(self, batch: Dict[str, torch.Tensor], phase: int = 0,
                      draws: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.dis_loss(batch, draws) if phase == 0 else self.gen_loss(batch, draws)

    def phase_step(self, batch: Dict[str, torch.Tensor], phase: int,
                   draws: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step of player ``phase``'s optimizer (``irgan.py:142-146``)."""
        opt = self.optimizers[phase]
        self.net.zero_grad(set_to_none=True)
        loss = self.training_step(batch, phase, draws)
        loss.backward()
        zero_pad_rows_in_grads(self.net)
        opt.step()
        return loss.detach()

    def training_epoch(self, nepoch: int) -> float:
        """One host-loader epoch of this epoch's player (``irgan.py:136-155``)."""
        (phase,) = self.current_epoch_optimizers(nepoch)
        bs = int(self.config["train"]["batch_size"])
        total = torch.zeros((), device=self.device)
        nb = 0
        for host in self._train_data.train_loader(bs, True, self._loader_rng):
            total = total + self.phase_step(batch_to_device(host, self.device), phase)
            nb += 1
        return float(total) / max(nb, 1)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _compute_item_vector(self) -> torch.Tensor:
        return self.net.gen_item_embedding.weight[1:]

    @torch.no_grad()
    def topk(self, batch: Dict[str, torch.Tensor], k: int, user_hist=None,
             return_query: bool = False):
        """Scores of the generator's tables (``irgan.py:161-174``)."""
        item_vector = self.states.get("item_vector")
        if item_vector is None:
            item_vector = self._compute_item_vector()
        query = self.net.gen_user_embedding(batch[self.fuid])
        scores = self.score_func.catalog(query, item_vector)
        score_k, topk_items = self._topk_from_scores(scores, k, user_hist)
        if return_query:
            return score_k, topk_items, query
        return score_k, topk_items
