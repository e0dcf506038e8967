"""Recommender: configuration, parameters, and the training engine.

Counterpart of ``recstudio_tpu/models/basemodel/recommender.py``. The model
is an ``nn.Module`` (``self.net``) on ``self.device``. Randomness comes from
two explicit generators seeded with ``train.seed``: ``self.generator`` on
the CPU (parameter initialisation, dropout seeds) and
``self.device_generator`` on the model's device (epoch permutations,
negative samples).

Training (``fit``) runs one device-resident epoch after another
(``_setup_scan_epoch``'s counterpart): the split is staged on the device
once (``device_epoch_arrays`` of ``SeqDataset`` or ``UserDataset``), each
epoch draws one permutation and wraps its tail batch to the epoch's head
(``_steps_per_epoch`` batches), every step gathers its batch on the
device and takes one optimizer step (``_grad_step``), and the epoch's
mean loss is read once, at its end. Evaluation serves each split
through ``topk`` and averages the rank metrics over its true rows.

A net with batch norm (``SimpleBatchNorm``) keeps its population
statistics in buffers, calibrated before each validation and, when a fit
ran none, in ``evaluate`` (``_refresh_net_state``): the first 32
training batches, in order, go through the net in eval mode with no
gradient, the statistics reset first. They are part of ``state_dict``,
so they travel with checkpoints, snapshots and the best epoch's restore.

Learners: ``adam`` (``adamw`` with a weight decay), ``sgd``,
``sparse_adam`` (lazy Adam), and ``adagrad`` and ``rmsprop`` with optax's
formulas (``models/optim.py``). Checkpoints carry the parameters, the
optimizer, both generators and ``states`` (the catalog encoding, a
sampler's index), as the JAX checkpoint carries its ``states``.

Not ported yet: the host-loader epoch (``train.epoch_scan: false``), the
TPU dispatch strategies (``_setup_chunked_epoch``, ``_fit_loop_blocks``),
config overrides passed to ``fit``, learning-rate schedules, orbax
checkpoints and ``load_for_serving`` from a JAX checkpoint.
"""
from __future__ import annotations

import inspect
import itertools
import logging
import os
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ... import eval as eval_mod
from ...utils import get_base_model_config, make_generator, resolve_device, seed_everything
from ...utils.callbacks import EarlyStopping, SaveLastCallback
from ..init import init_parameters, zero_pad_rows_in_grads
from ..module.layers import SimpleBatchNorm
from ..optim import LazyAdam, OptaxAdagrad, OptaxRMSprop

logger = logging.getLogger("recstudio_torch")


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: Union[str, torch.device] = "cuda") -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device`` (``cuda`` unless asked otherwise)."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}


def clip_by_global_norm(params: List[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm``: scale every gradient by
    ``max_norm / norm`` when the global norm exceeds ``max_norm``."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor)


# train.precision values the port honours: it computes in float32 throughout,
# which is what "fp32" asks for and at least what "default" and "bf16_3x"
# (three bf16 passes, float32-like) give on the TPU.
HONOURED_PRECISIONS = ("default", "fp32", "bf16_3x")


def check_train_config(tc: Dict[str, Any]) -> None:
    """Raise on ``train`` keys the port accepts in its config but does not
    honour, instead of ignoring them."""
    precision = str(tc.get("precision", "default")).lower()
    if precision not in HONOURED_PRECISIONS:
        raise NotImplementedError(f"train.precision {tc['precision']!r} is not ported "
                                  f"(the port computes in float32: {HONOURED_PRECISIONS})")
    if str(tc.get("ckpt_backend", "pickle")).lower() != "pickle":
        raise NotImplementedError(f"train.ckpt_backend {tc['ckpt_backend']!r} is not ported "
                                  "(checkpoints are torch.save files)")
    if tc.get("tensorboard_path") is not None:
        raise NotImplementedError("train.tensorboard_path is not ported (no TensorBoard logs)")


class Recommender:
    # ``states`` entries computed from the weights (a graph model adds its
    # propagated users), dropped when a fit moves the weights
    _weight_caches = ("item_vector",)

    def __init__(self, config: Optional[Dict] = None,
                 device: Union[str, torch.device] = "cuda", **kwargs):
        """``kwargs`` give parts instead of the model's own
        (``recommender.py:62``): ``loss``, and for a retriever
        ``item_encoder``, ``query_encoder``, ``scorer`` and ``sampler``."""
        self.config = config if config is not None else get_base_model_config()
        check_train_config(self.config["train"])
        self.device = resolve_device(device)
        seed = self.config["train"].get("seed")
        if seed is not None:
            seed_everything(seed)
        self.generator = make_generator(seed or 0)
        self.device_generator = torch.Generator(device=self.device)
        self.device_generator.manual_seed(int(seed or 0) + 1)
        self.embed_dim = self.config["model"]["embed_dim"]
        self.net: Optional[torch.nn.Module] = None
        self.states: Dict[str, torch.Tensor] = {}
        self.epoch_log: List[Dict[str, float]] = []
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.ckpt_path: Optional[str] = None
        self.callback = None
        self.val_check = False
        self._train_data = None
        self._calib_batches: Optional[List[Dict[str, torch.Tensor]]] = None
        self._kwargs_modules: Dict[str, Any] = kwargs

    @staticmethod
    def _get_dataset_class():
        raise NotImplementedError

    def _get_loss_func(self):
        raise NotImplementedError

    def _init_model(self, train_data):
        self.fields = set(train_data.use_field)
        self.frating = train_data.frating
        self.fuid = train_data.fuid
        self.fiid = train_data.fiid
        self.item_feat = train_data.item_feat
        if self.item_feat is not None:
            self.item_fields = set(self.item_feat.fields).intersection(self.fields)
        else:
            self.item_fields = {self.fiid}
        self.neg_count = self.config["train"].get("negative_count")
        if self._kwargs_modules.get("loss") is not None:
            self.loss_fn = self._kwargs_modules["loss"]
        elif "train_data" in inspect.signature(self._get_loss_func).parameters:
            self.loss_fn = self._get_loss_func(train_data)
        else:
            self.loss_fn = self._get_loss_func()

    def _init_parameter(self, train_data=None):
        """Initialise ``self.net``'s parameters by role (``train.init_method``,
        ``train.init_range``), then place it on the device in eval mode."""
        method = self.config["train"].get("init_method") or "xavier_normal"
        init_range = self.config["train"].get("init_range", 0.02)
        init_parameters(self.net, self.generator, method, init_range)
        self.net.to(self.device).eval()
        self.states.clear()  # cached item vectors belong to the old weights

    def load_state_dict(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Load parameters (e.g. from ``utils.convert.params_from_jax``)."""
        self.net.load_state_dict(state_dict)
        self.net.to(self.device).eval()
        self.states.clear()  # cached item vectors belong to the old weights

    # ------------------------------------------------------------------
    # optimizer and one training step
    # ------------------------------------------------------------------
    def _make_optimizer(self, name: str, lr: float, weight_decay: float = 0.0):
        """``_make_optax`` (``recommender.py:187-225``) in ``torch.optim``,
        with optax's hyperparameters: Adam's eps 1e-8, weight decay
        decoupled (optax.adamw), plain SGD; ``sparse_adam`` is lazy Adam
        (``models/optim.py``), which takes no weight decay there either;
        ``adagrad`` and ``rmsprop`` are optax's (``OptaxAdagrad``,
        ``OptaxRMSprop``), which take none there either. An unknown name
        raises."""
        params = list(self.net.parameters())
        name = (name or "adam").lower()
        if name == "adam" and not weight_decay:
            return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        if name in ("adam", "adamw"):
            wd = weight_decay if name == "adam" else (weight_decay or 0.01)
            return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=wd)
        if name == "sgd":
            return torch.optim.SGD(params, lr=lr)
        if name == "sparse_adam":
            return LazyAdam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        if name == "adagrad":
            return OptaxAdagrad(params, lr=lr)
        if name == "rmsprop":
            return OptaxRMSprop(params, lr=lr)
        raise ValueError(f"unknown learner {name}")

    def _get_optimizer(self) -> torch.optim.Optimizer:
        tc = self.config["train"]
        if tc.get("scheduler"):
            raise NotImplementedError("learning-rate schedules are not ported yet")
        return self._make_optimizer(tc.get("learner", "adam"),
                                    float(tc.get("learning_rate", 1e-3)),
                                    float(tc.get("weight_decay") or 0.0))

    def training_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def _grad_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One optimizer step on ``batch`` (``recommender.py:342-348``):
        loss, gradients, [PAD] rows zeroed, optional global-norm clip,
        update. Returns the loss as a device scalar."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.training_step(batch)
        loss.backward()
        zero_pad_rows_in_grads(self.net)
        clip = self.config["train"].get("grad_clip_norm")
        if clip:
            clip_by_global_norm(list(self.net.parameters()), float(clip))
        self.optimizer.step()
        return loss.detach()

    # ------------------------------------------------------------------
    # device-resident epochs
    # ------------------------------------------------------------------
    def _setup_scan_epoch(self, train_data) -> None:
        """Stage the training split on the device once; each step's batch is
        gathered there (``recommender.py:383-509``)."""
        n = len(train_data.data_index)
        if hasattr(train_data, "device_epoch_arrays"):
            host, self._batch_fn = train_data.device_epoch_arrays()
        else:
            host = train_data._get_pos_batch(np.arange(n))
            self._batch_fn = lambda arrays, sel: {k: v[sel] for k, v in arrays.items()}
        self._epoch_arrays = {k: torch.as_tensor(np.ascontiguousarray(v)).to(self.device)
                              for k, v in host.items()}
        self._epoch_rows = n
        self._steps_per_epoch = max(-(-n // int(self.config["train"]["batch_size"])), 1)

    def _epoch_batches(self):
        """This epoch's batches: one permutation (shuffle on), the tail
        batch wrapped to the epoch's head (``recommender.py:453-457``)."""
        n, bs = self._epoch_rows, int(self.config["train"]["batch_size"])
        nbatch = -(-n // bs)
        if self.config["data"].get("shuffle", True):
            perm = torch.randperm(n, generator=self.device_generator, device=self.device)
        else:
            perm = torch.arange(n, device=self.device)
        if nbatch * bs > n:
            perm = torch.cat([perm, perm[:nbatch * bs - n]])
        for i in range(nbatch):
            yield self._batch_fn(self._epoch_arrays, perm[i * bs:(i + 1) * bs])

    def training_epoch(self, nepoch: int) -> float:
        """One epoch of optimizer steps; the mean loss, read once."""
        self.net.train()
        total = torch.zeros((), device=self.device)
        nbatch = 0
        for batch in self._epoch_batches():
            total = total + self._grad_step(batch)
            nbatch += 1
        self.net.eval()
        return float(total) / max(nbatch, 1)

    # ------------------------------------------------------------------
    # fit / evaluate
    # ------------------------------------------------------------------
    def fit(self, train_data, val_data=None,
            resume_from: Optional[str] = None) -> "Recommender":
        """Train on ``train_data`` for ``train.epochs`` epochs (``recommender.py:
        788-862``), validating on ``val_data`` each ``eval.val_n_epoch``
        epochs with early stopping; a checkpoint is written when the fit
        ends. ``resume_from`` continues a checkpointed fit at its next epoch."""
        if str(self.config["train"].get("epoch_scan", "auto")).lower() == "false":
            raise NotImplementedError("the host-loader epoch is not ported yet")
        self._init_model(train_data)
        self._init_parameter(train_data)
        self.val_check = val_data is not None and bool(self.config["eval"].get("val_metrics"))
        if self.val_check:
            vm = self.config["eval"]["val_metrics"]
            vm = vm[0] if isinstance(vm, list) else vm
            # a rank metric is read at the first cutoff (recommender.py:824-834)
            self.val_metric = f"{vm}@{self._cutoffs()[0]}" if eval_mod.get_rank_metrics(vm) else vm
        self.callback = self._get_callback(train_data.name)
        self._train_data = train_data
        self._calib_batches = None
        self.optimizer = self._get_optimizer()
        self._setup_scan_epoch(train_data)
        start = 0
        if resume_from is not None:
            start = int(self.load_checkpoint(resume_from, restore_optimizer=True)["epoch"]) + 1
            logger.info("resumed from %s at epoch %d", resume_from, start)
        self.fit_loop(val_data, start)
        return self

    def _get_callback(self, dataset_name: str):
        save_dir = self.config["eval"].get("save_path")
        if self.val_check:
            return EarlyStopping(self, self.val_metric, dataset_name, save_dir=save_dir,
                                 patience=self.config["train"].get("early_stop_patience", 10),
                                 mode=self.config["train"].get("early_stop_mode", "max"))
        return SaveLastCallback(self, dataset_name, save_dir=save_dir)

    def fit_loop(self, val_data=None, start_epoch: int = 0) -> None:
        nepoch = start_epoch - 1
        for nepoch in range(start_epoch, self.config["train"]["epochs"]):
            t0 = time.perf_counter()
            self._epoch_refresh(nepoch)
            metrics: Dict[str, float] = {"train_loss": self.training_epoch(nepoch)}
            t1 = time.perf_counter()
            if self.val_check and nepoch % self.config["eval"].get("val_n_epoch", 1) == 0:
                self._refresh_net_state()
                metrics.update(self.validation_epoch(val_data))
            t2 = time.perf_counter()
            self.epoch_log.append({"epoch": nepoch, **metrics, "train_s": t1 - t0,
                                   "eval_s": t2 - t1})
            logger.info("epoch %d %s train %.2fs eval %.2fs", nepoch, metrics, t1 - t0, t2 - t1)
            if self.callback(nepoch, metrics):
                logger.info("early stopped at epoch %d", nepoch)
                break
        for key in self._weight_caches:        # the weights moved: no stale catalog
            self.states.pop(key, None)
        self.ckpt_path = self.callback.save_checkpoint(nepoch)

    def validation_epoch(self, val_data) -> Dict[str, float]:
        return self._eval_epoch(val_data, self.config["eval"]["val_metrics"],
                                self._cutoffs()[:1])

    def _cutoffs(self) -> List[int]:
        c = self.config["eval"].get("cutoff")
        return c if isinstance(c, list) else [c]

    def evaluate(self, test_data, verbose: bool = True) -> Dict[str, float]:
        """Test metrics (``recommender.py:1056-1070``), with the best
        validation epoch's parameters restored when there was one."""
        if self.ckpt_path is not None and getattr(self.callback, "best_params", None) is not None:
            self.restore(self.callback.best_params)
        elif not self.val_check:
            self._refresh_net_state()          # no validation calibrated it
        out = self._eval_epoch(test_data, self.config["eval"]["test_metrics"], self._cutoffs())
        if verbose:
            logger.info("test result %s", out)
        return out

    def _epoch_refresh(self, nepoch: int) -> None:
        pass

    # ------------------------------------------------------------------
    # batch-norm population statistics (recommender.py:300-334)
    # ------------------------------------------------------------------
    def _calibration_forward(self, batch: Dict[str, torch.Tensor]) -> None:
        """One forward pass of the calibration (the ranker's score net)."""
        raise NotImplementedError

    @torch.no_grad()
    def _refresh_net_state(self, max_batches: int = 32) -> None:
        """Calibrate every ``SimpleBatchNorm``: reset its statistics to 0,
        then stream the first ``max_batches`` training batches (unshuffled,
        staged on the device once a fit) through the net in eval mode, each
        layer keeping the cumulative average of its batch means and
        variances. A model with no batch norm, or never given training data
        by ``fit``, is left as it is (evaluation then normalizes with each
        batch's statistics)."""
        bns = [m for m in self.net.modules() if isinstance(m, SimpleBatchNorm)]
        if not bns or self._train_data is None:
            return
        if self._calib_batches is None:
            bs = int(self.config["train"]["batch_size"])
            self._calib_batches = [
                batch_to_device(b, self.device) for b in
                itertools.islice(self._train_data.train_loader(bs, shuffle=False), max_batches)]
        was_training = self.net.training
        self.net.eval()
        for bn in bns:
            bn.mean.zero_()
            bn.var.zero_()
            bn.count.zero_()
            bn.calibrating = True
        try:
            for batch in self._calib_batches:
                self._calibration_forward(batch)
        finally:
            for bn in bns:
                bn.calibrating = False
            self.net.train(was_training)

    def _eval_epoch(self, data, metric_names, cutoffs) -> Dict[str, float]:
        raise NotImplementedError

    # ------------------------------------------------------------------
    # snapshots and checkpoints
    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.net.state_dict().items()}

    def restore(self, snap: Dict[str, torch.Tensor]) -> None:
        self.net.load_state_dict(snap)
        self.states.clear()

    def save_checkpoint(self, path: str, epoch: int = -1, metric: Optional[Dict] = None) -> None:
        """Parameters, ``states``, optimizer state, both generators' states
        and the epoch (``recommender.py:1218-1247``, pickle backend), in
        ``torch.save``'s format. ``states`` keeps its tensors and numbers
        (a retriever's snapshot net, a ``RetrieverSampler``'s state, is
        left out)."""
        payload = {
            "config": self.config, "model": type(self).__name__, "epoch": int(epoch),
            "metric": {k: float(v) for k, v in (metric or {}).items()},
            "params": {k: v.detach().cpu() for k, v in self.net.state_dict().items()},
            "states": _portable(self.states),
            "optimizer": self.optimizer.state_dict() if self.optimizer is not None else None,
            "generator": self.generator.get_state(),
            "device_generator": self.device_generator.get_state(),
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save(payload, path)

    def load_checkpoint(self, path: str, restore_optimizer: bool = False) -> Dict[str, Any]:
        """Load a checkpoint of ``save_checkpoint`` (its ``states`` too); with
        ``restore_optimizer`` also the optimizer and generator states, so a
        fit resumes exactly."""
        payload = torch.load(path, map_location="cpu", weights_only=True)
        self.net.load_state_dict(payload["params"])
        self.states.clear()
        self.states.update(_to_device(payload.get("states") or {}, self.device))
        if restore_optimizer and self.optimizer is not None and payload.get("optimizer"):
            self.optimizer.load_state_dict(payload["optimizer"])
            self.generator.set_state(payload["generator"])
            self.device_generator.set_state(payload["device_generator"])
        return payload


def _portable(tree):
    """``states`` with its tensors on the CPU, keeping only tensors,
    numbers and dicts of them."""
    if isinstance(tree, dict):
        out = {k: _portable(v) for k, v in tree.items()}
        return {k: v for k, v in out.items() if v is not None}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, (int, float)):
        return tree
    return None


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree
