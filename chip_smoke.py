#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``recstudio_torch``) on one NVIDIA GPU.

Run from the root of a checkout with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``recstudio_torch/csrc`` (nvcc, first use),
then:

- phase A: SASRec at the repo's ml-100k config (d 64, F 128, 2 heads,
  2 layers, L 20), seeded numpy weights, ``Predictor(max_batch=128, k=20)``
  over every test user; latency, NDCG@10 and Recall@10 of the served lists,
  and the first 64 served lists held to the JAX package's reference
  (``recstudio_torch/assets/sasrec_ml100k_reference.json``);
- phase B: SASRec at L 200, d 128 on the synthetic ml-1m shape (6040
  users, 3706 items, 1,000,209 interactions, seed 7),
  ``Predictor(max_batch=256, k=20)``; latency, and the kernel path's top-k
  held against the plain path's on the same weights;
- phase C: one ``TransformerLayer`` at L 384 (outside the fused layer's
  gate, so its attention goes to the attention kernel) held against the
  plain layer;
- phase D: SASRec training at L 200, d 128, F 128, 2 heads, 2 layers,
  dropout 0.5, batch 1024 on the synthetic ml-1m shape: 20 timed
  optimizer steps on device-resident batches (each layer through K1 in
  training mode and K2), then one step's loss and gradients on the kernel
  path held against the plain path with the same seeds and batch;
- phase E: ``fit`` SASRec on ml-100k at the repo's config for the epochs
  of the JAX training reference, ``evaluate(test)``, test NDCG@10 held to
  the JAX seeds' band (``recstudio_torch/assets/
  sasrec_ml100k_train_reference.json``), then 8 requests served through
  ``Predictor`` from the trained model, whose lists must give the same
  NDCG@10 as ``evaluate``;
- phase F: BERT4Rec training and serving at the paper's ML-1m settings (L
  200, d 64, F 128, 2 heads, 2 layers, dropout 0.2, mask ratio 0.2, batch
  256) on the synthetic ml-1m shape: 20 timed optimizer steps (K1 and K2
  with no attention mask, the catalog log-partition kernels K7, K8, K9),
  one step's loss and gradients held against the plain path and its loss
  against the materialized path (``train.fused_softmax: false``), then
  every user served through ``Predictor(max_batch=256, k=20)`` with the
  first two requests held to the plain path;
- phase G: ``fit`` BERT4Rec on ml-100k at the repo's config for the epochs
  of its JAX training reference, ``evaluate(test)``, test NDCG@10 held to
  the JAX seeds' band (``recstudio_torch/assets/
  bert4rec_ml100k_train_reference.json``), then 8 served requests whose
  lists must give ``evaluate``'s NDCG@10;
- phase H: long-sequence SASRec at L 1024 (d 128, F 128, 2 heads, 2
  layers, dropout 0, batch 256) on the synthetic ml-1m shape: 20 timed
  optimizer steps whose attention runs the flash kernels K4 (forward), K5
  and K6 (backward), one step's loss and gradients held against the plain
  path (dense ``mha_plain``), then every user served through
  ``Predictor(max_batch=256, k=20)`` (K4 alone) with the first two
  requests held to the plain path;
- phase I: BPR on ml-100k the way users start it,
  ``quickstart.run("BPR", "ml-100k")`` at the repo's config (d 64, ratio
  split, batch 512, adam, early stopping) with the epoch cap of
  ``recstudio_torch/assets/bpr_ml100k_train_reference.json``: test NDCG@5
  held to the JAX seeds' band there; one training step held to the same
  model copied to the CPU (same batch, same negatives); the 8 requests of
  every test user served through ``Predictor``, whose lists must give
  ``evaluate``'s NDCG@5; epoch time, steps per epoch, examples/s, and the
  card's busy share of one profiled epoch (BPR runs no kernel of its own:
  its steps are small PyTorch launches, bound by the host);
- phase J: BPR at the JAX package's scale shape (``scripts/
  scale_bench.py``: the synthetic ml-1m shape, ratio split, batch 8192):
  one warm epoch, then timed epochs under adam, lazy Adam on the dense
  path (``train.sparse_rows: false``) and lazy Adam's row-sparse step;
  one row-sparse step held to one dense lazy-Adam step from the same
  state and negatives, and to a bitwise repeat of itself; a full-catalog
  evaluation of every test user; ``Predictor(max_batch=256, k=20)`` over
  all 6040 users, two requests held to the CPU copy's lists;
- phase K: NARM training and serving on the synthetic ml-1m shape (L 200,
  d 64, GRU hidden 128, one layer, dropout [0.25, 0.5], batch 512, Adam
  1e-3): 20 timed optimizer steps (the GRU through cuDNN in float32, the
  catalog log-partition kernels K7, K8, K9 at 512 query rows), one step's
  loss and gradients held to the plain path (the GRU's time loop,
  materialized scores) from the same generator states, the GRU's forward
  and backward through cuDNN held to its time loop and timed against it,
  then every user served through ``Predictor(max_batch=256, k=20)`` with
  the first two requests held to the plain path;
- phase L: STAMP at the same shape and batch (no dropout, no GRU): the
  same, its plain path the materialized scores, its first two requests
  held to the model copied to the CPU;
- phase M: GRU4Rec at the same shape (dropout 0.3, one uniform negative,
  ``BPRLoss``): 20 timed steps, which launch none of the kernels, and one
  step held to the model copied to the CPU with the same batch, negatives
  and dropout seeds;
- phase N: ``quickstart.run("NARM", "ml-100k")`` and ``("STAMP", ...)`` at
  the repo's config for the epochs of their JAX training references,
  test NDCG@10 held to the JAX seeds' bands (``recstudio_torch/assets/
  narm_ml100k_train_reference.json``, ``stamp_...``), 8 requests served
  whose lists must give ``evaluate``'s NDCG@10;
- phase O: MultiDAE training and serving at the repo's config (d 200,
  encoder [64, 32], decoder [32, 64], relu, dropout 0.5, batch 256, Adam
  1e-2, weight decay 1e-5) on the synthetic ml-1m shape as a
  ``UserDataset`` (one row a user, the training items as the history): 20
  timed steps through the catalog log-partition kernels K7, K8, K9 at 256
  query rows and D 200, one step held to the materialized scores from the
  same generator states, every user served with the first two requests
  held to the model copied to the CPU;
- phase P: MultiVAE there (d 600, encoder [200], decoder [200], tanh,
  batch 500, Adam 1e-3): 20 timed steps, which launch none of the
  kernels (its scores are a plain product at D 600, as in the JAX
  package), one step held to the model copied to the CPU with the same
  eps, dropout seed and the KL weight at its cap, every user served with
  two requests held to the CPU copy;
- phase Q: ``quickstart.run("MultiDAE", "ml-100k")`` and ``("MultiVAE",
  ...)`` at the repo's config (epoch caps 200 and 500, early stopping),
  test NDCG@10 held to the JAX seeds' bands (``recstudio_torch/assets/
  multidae_ml100k_train_reference.json``, ``multivae_...``), every test
  user served, masked by the history window as ``evaluate`` masks, whose
  lists must give ``evaluate``'s NDCG@10;
- phase R: DeepFM at the repo's config (embed_dim 10, MLP [256, 256,
  256], tanh, dropout 0.3) on ``generate_ctr("criteo-1m-shape")`` (1,000,000
  rows, 13 float and 26 token fields; 499,331 table rows, the ids the
  Zipf draws reach of 660,208 vocabulary slots; the JAX
  bench's ``ctr_scale`` setup; its data built by a process of this
  script's own beside the earlier phases), batch 8192, Adam 1e-3: ``fit(train,
  None)`` for one epoch, then four more, the test split evaluated after
  each; the test AUC and logloss after the fifth held to the JAX seeds'
  bands (``recstudio_torch/assets/deepfm_criteo1m_train_reference.json``),
  whose AUC band must clear the untrained AUC by ``AUC_MARGIN``; 20 timed steps, peak memory, an epoch and its busy share, the
  MLP's dropout masks a step; one step held to the model copied to the CPU
  (same batch and dropout seeds) and to a repeat of itself; eval rows/s;
  an epoch under ``sparse_adam`` (the packed row-sparse step); 8 requests of 8192
  rows through ``ScorePredictor`` held to ``predict``. No kernel;
- phase S: ``quickstart.run`` of DeepFM, FM and LR on ml-100k at the
  repo's config (fm family: ``fmeval``, ratings binarized at 3.0; early
  stopping on validation AUC, patience 10) for at most the epochs of
  their references (2, 3 and 10), test AUC held to each model's
  JAX band (``recstudio_torch/assets/{deepfm,fm,lr}_ml100k_train_
  reference.json``), one epoch profiled, every test row served through
  ``ScorePredictor(max_batch=256)``, whose probabilities must be
  ``evaluate``'s. No kernel;
- phase T: LightGCN at the JAX bench's ``graph_scale`` setup
  (``amazon-book-shape``: 52,643 users, 91,599 items, 2,984,108
  interactions, seed 7, built beside the earlier phases; ratio split
  [0.8, 0.1, 0.1]; d 64, 3 layers, batch
  8192, one uniform negative, Adam 1e-3, l2 1e-4) on the ELL route (the
  graph past the dense budget): generation, ETL and graph-build seconds,
  padded ELL slots against edges and the tables' bytes, 20 timed steps,
  peak memory, one step's loss and gradients held to the edge-list route
  and to a bitwise repeat, one layer's forward on the ELL and edge-list
  routes beside ``torch.sparse.mm`` of the same CSR matrix, the busy share
  of ``T_PROFILE_STEPS`` steps of an epoch, every test user evaluated. No
  kernel;
- phase U: ``quickstart.run`` of LightGCN, NGCF and SimGCL (for the
  epochs of their references: 10, 30 and 10) on ml-100k at the repo's
  configs, held to the JAX seeds' bands (``recstudio_torch/assets/
  {lightgcn,ngcf,simgcl}_ml100k_train_reference.json``): LightGCN's and
  NGCF's test NDCG@10, whose bands clear the untrained models' by
  ``NDCG_MARGIN``; SimGCL, which does not learn to rank at its config in
  the JAX package either, its last epoch's training loss (its NDCG@10
  reported beside its band); every test user served, LightGCN's lists
  held to the model copied to the CPU. No kernel;
- phase V: DeepFM at the repo's config through the packed row-sparse
  step (``learner: sparse_adam``, ``sparse_rows: auto``) on
  ``generate_ctr("criteo-10m-hugevocab-shape")`` at 6,000,000 rows (the
  JAX bench's ``ctr_bigvocab_sparse_adam`` at 10,000,000, cut for the time
  limit; its data built by a process of this script's own while the
  earlier phases run), batch 8192: gen and ETL seconds, the table's rows,
  a one-epoch fit and its test AUC, 20 timed steps, the card's busy share
  over 100 profiled steps; one packed step held to one dense lazy-Adam
  step from the same state (parameters and moments), rows no lookup
  touched held unchanged bit for bit, and the step to a bitwise repeat;
  20 steps of the dense ``LazyAdam`` beside. No kernel;
- phase W: AutoInt at its repo config (embed 10, attention 64, 3 layers, 2
  heads, MLP [128, 64], dropout 0.5) on phase R's data, batch 8192: a
  one-epoch fit and its test AUC, the evaluation and ``ScorePredictor``
  through K3 (counted), training through the plain softmax (no launch);
  20 timed steps, one step held to the CPU copy with the same dropout
  seeds, the evaluation's probabilities held to the plain route's;
- phase X: ``quickstart.run`` of WideDeep, DCN, NFM and AutoInt on
  ml-100k at the repo's configs for at most the epochs of their
  references (1 each, DCN's 2; early stopping may end them sooner), test
  AUC held to the JAX seeds' bands (``recstudio_torch/assets/{widedeep,dcn,nfm,
  autoint}_ml100k_train_reference.json``), whose AUC band must clear the
  untrained AUC by ``AUC_MARGIN``; the batch norms calibrated; every test
  row served through ``ScorePredictor`` against ``evaluate`` and
  ``predict``; AutoInt launches K3;
- phase Y: BPR (d 64) on phase T's amazon-book-shape splits with
  ``SampledSoftmaxLoss`` under the ``midx-pop`` proposal (32 clusters a
  half-space, 1,024 buckets, 100 negatives, batch 2048): the refresh's ms
  (catalog encode, two k-means runs, index and CDFs) and its bitwise
  repeat, the state built on the card against a CPU copy from the same
  k-means result, two epochs (step and sample ms, examples/s, peak
  memory), the busy share of 100 profiled steps, the test NDCG@10; then
  each other proposal (``uniform``, ``pop``, ``midx-uni``,
  ``cluster-uni``, ``cluster-pop``, ``lsh``) and mining method (``dns``,
  ``sir``, ``brute``, ``toprand``, ``top&rand``, ``negative_count [200,
  100]``) for ``SAMPLER_MODE_STEPS`` steps; every proposal's 2^20 draws
  for four queries held to its proposal (total variation), its
  ``log_neg_prob`` to ``compute_item_p`` of its draws. No kernel;
- phase Y2: SASRec at phase D's setup (L 200, d 128, batch 256) with
  ``SampledSoftmaxLoss`` under ``midx-uni`` over ``[B, L, D]`` queries (20
  negatives): ``Y2_STEPS`` steps through K1 and K2 with the loss falling,
  the sampler gates, two requests served through K1;
- phase Z: ``quickstart.run`` of PMF, CML, NCF, LogisticMF and BPR under
  ``midx-pop`` on ml-100k, held to the JAX seeds' bands
  (``recstudio_torch/assets/{pmf,cml,ncf,logisticmf,bpr_midx_pop}_
  ml100k_train_reference.json``), every test user served through
  ``Predictor``, whose lists give ``evaluate``'s metrics. No kernel;
- phase AA: DIN and DIEN at their repo configs (d 128; DIN's attention
  MLP [128, 64] and fc MLP [128, 64, 64] with Dice, batch norm, dropout
  0.3; DIEN's GRU and AUGRU hidden 128) on the ml-1m shape as a
  ``SeqDataset`` at L 200, ratings binarized at 3.0, batch 1024: 20 timed
  steps, the busy share of 10, DIEN's AUGRU kernels a step, one step held
  to the CPU copy (same dropout seeds), the batch norms calibrated,
  evaluation rows/s and every test row through ``ScorePredictor`` held to
  ``evaluate``'s probabilities. No kernel;
- phase AB: HardShare, MMoE, PLE and AITM at their repo configs on
  ``kuairand-pure-shape`` (``scripts/multitask_data.py``: the fields of
  kuairand-pure.yaml, the public log's 27,285 users, 7,583 videos and
  1,436,609 rows, a planted signal a task), batch 4096: a one-epoch fit
  and each of the six ratings' test AUC, 20 timed steps, one step held to
  the CPU copy, 8 requests of 4096 rows through ``ScorePredictor`` held
  to ``evaluate``'s; AITM's transfer attention through K3 (counted), held
  to the plain softmax;
- phase AC: the cascade on the ml-1m shape, a SASRec retriever at phase
  B's setup (seeded weights, ``eval.topk`` 100) and DIN at AA's config as
  the ranker (2 retriever-sampled negatives, ``BinaryCrossEntropyLoss``):
  20 timed ranker steps, every user served through ``Predictor(cascade,
  k=20, max_batch=64)`` (K1 in the retriever's query encoding), the first
  two requests held to the retriever's plain layers and the first 16
  users to the CPU copy; p50, the largest latency, peak memory;
- phase AD: ``quickstart.run`` of DIN and DIEN on ml-100k and of the four
  multitask models on ``kuairand-pure-small``, each rating's test AUC
  held to the JAX seeds' band where the band can fail
  (``recstudio_torch/assets/<model>_<dataset>_train_reference.json``,
  ``scripts/torch_seq_mt_seeds.py``); the SASRec -> DIN cascade on
  ml-100k, whose served lists give ``evaluate``'s NDCG@5 and agree with
  the CPU copy's;
- phase AE: the fifteen models of the CTR interaction zoo (InterHAt,
  DIFM, xDeepFM, DCNv2, PNN, DLRM, FwFM, AFM, FFM, FmFM, FiBiNET, MaskNet,
  ONN, HFM, AFN) at their repo configs on phase R's data, batch 8192: for
  each, 20 timed steps (step ms, examples/s, peak memory), one step held
  to the CPU copy in float32 (InterHAt's through K1 and K2; the CPU
  copy's relus taking the card's decisions), one evaluation (AUC,
  rows/s), a ``ScorePredictor`` request of 8192 rows held to ``predict``;
  InterHAt's layer through K1 and K2 (K1 alone in evaluation and serving)
  and DIFM's attention through K3 in evaluation and serving, each
  evaluation held to the plain route; the other thirteen launch nothing;
- phase AF: ``quickstart.run`` of InterHAt, DIFM and xDeepFM on ml-100k at
  the repo's configs for one epoch, test AUC held to the JAX seeds' bands
  (``recstudio_torch/assets/{interhat,difm,xdeepfm}_ml100k_train_
  reference.json``), every test row served through ``ScorePredictor``
  against ``evaluate`` and ``predict``;
- phase AG: the eight sequential retrievers of the zoo (CL4SRec, CoSeRec,
  ICLRec, Caser, FPMC, TransRec, HGN, NPE) at their repo configs on the
  synthetic ml-1m shape at L 200, batch 256 (the contrastive three on its
  ``SeqToSeqDataset`` windows): for each, 20 timed steps from the seed's
  weights (step ms, busy share, peak memory, K1 and K2 launches: three
  encoder passes a step, ICLRec's fourth in evaluation), one step held to
  the plain layers (the contrastive three) or to the CPU copy on
  ``AG_CPU_ROWS`` rows (the five others, which launch no kernel); CoSeRec's
  co-occurrence host seconds and its refresh offline and online, ICLRec's
  refresh (every window encoded, k-means at 256);
- phase AH: ``quickstart.run`` of CL4SRec, ICLRec and CoSeRec on ml-100k
  for the epochs of ``recstudio_torch/assets/{cl4srec,iclrec,coserec}_
  ml100k_train_reference.json`` (``scripts/torch_cl_seeds.py``), test
  NDCG@10 held to the JAX seeds' band, which clears the untrained models'
  NDCG, and every test user served through ``Predictor``, whose lists must
  give ``evaluate``'s NDCG@10;
- phase AI: the rest of the CTR ranker zoo, fourteen models (DeepCrossing,
  IFM, DeepIM, LorentzFM, PPNet, FinalMLP, EDCN, FLEN, SAM, AOANet,
  DESTINE, FiGNN, CCPM, FGCNN) at their repo configs on phase R's data,
  batch 8192, as phase AE runs its fifteen, with the card's busy share of
  five more steps each; FLEN's groups, FinalMLP's streams and PPNet's gate
  fields set from criteo's 13 float and 26 token columns (its defaults
  need user and item tables, which the criteo layout lacks). No kernel;
- phase AJ: ``quickstart.run`` of FinalMLP (its default streams: the user
  and the item features), FiGNN and FGCNN on ml-100k for one epoch, test
  AUC held to the JAX seeds' bands (``recstudio_torch/assets/{finalmlp,
  fignn,fgcnn}_ml100k_train_reference.json``), every test row served
  through ``ScorePredictor`` against ``evaluate`` and ``predict``. No
  kernel;
- phase AK: the rest of the ``mf``, ``debias`` and ``graph`` retrievers at
  their repo configs' widths: EASE, ItemKNN, SLIM, WRMF, IRGAN, DSSM,
  IPSBPR and PDA on the synthetic ml-1m shape (seed 7), SGL and NCL on
  phase T's amazon-book-shape split. The closed-form three: the solve timed
  and held to the same solve on the CPU (SLIM's at ``AK_SLIM_CPU_STEPS``
  ISTA steps; ItemKNN's on the columns with no tie at the ``knn``-th
  similarity); WRMF: a user and an item half-sweep timed, the user sweep
  held to the CPU copy's; IRGAN: 20 steps of each player, one of each held
  to the CPU copy with the same draws; DSSM, IPSBPR, PDA, SGL and NCL: 20
  timed steps, one held to the CPU copy (same batch, negatives, dropout
  seeds and SGL's keep masks) within ``TOL_GRAD`` (the CPU copies compute in
  threads of their own through the rest of AK and AL, which checks them at
  its end); NCL's k-means refresh timed. Each model's peak memory
  and the card's busy share, and one ``Predictor`` request whose lists
  are ``evaluate``'s. No kernel;
- phase AL: ``quickstart.run`` of the ten on ml-100k for the epochs of
  ``recstudio_torch/assets/<model>_ml100k_train_reference.json``
  (``scripts/torch_retriever_seeds.py``; NCL's warm-up cut to 5 epochs as
  there), test NDCG@10 held to the JAX band, which clears the untrained
  model's NDCG@10 (the closed-form three: the JAX value within its stated
  tolerance), every test user served through ``Predictor``, whose lists
  must give ``evaluate``'s NDCG@10. No kernel;
- each kernel against its plain PyTorch version on the phases' shapes,
  with its time, the plain version's, PyTorch's own call where one exists
  (K1's evaluation rows: ``nn.TransformerEncoderLayer`` with the rows'
  masks, held to the plain layer too), and the card's bound for the same
  work.

Launch counts are zeroed before each phase and read after it; a kernel of
a phase that was not launched in it fails the run. Every failure exits
non-zero. The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(REPO, "recstudio_torch", "assets", "sasrec_ml100k_reference.json")
TRAIN_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets",
                               "sasrec_ml100k_train_reference.json")
BERT4REC_TRAIN_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets",
                                        "bert4rec_ml100k_train_reference.json")
BPR_TRAIN_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets",
                                   "bpr_ml100k_train_reference.json")
NARM_TRAIN_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets",
                                    "narm_ml100k_train_reference.json")
STAMP_TRAIN_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets",
                                     "stamp_ml100k_train_reference.json")
MULTIDAE_TRAIN_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets",
                                        "multidae_ml100k_train_reference.json")
MULTIVAE_TRAIN_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets",
                                        "multivae_ml100k_train_reference.json")
CRITEO_TRAIN_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets",
                                      "deepfm_criteo1m_train_reference.json")
ML100K_TRAIN_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets",
                                      "{}_ml100k_train_reference.json")
SAVE_DIR = os.path.join(REPO, "build", "recstudio_torch", "saved")

# H100 SXM peaks (NVIDIA data sheet, dense): float32 outside the tensor
# cores, and HBM3 bandwidth. Both kernels compute in float32 on the SIMT cores.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

TOL_K1 = (1e-4, 1e-4)      # (atol, rtol): float32 sums of <= 1024 terms, then LayerNorm
TOL_K3 = (2e-5, 1e-4)      # float32 sums of <= 512 terms; outputs are averages of v
# K4: float32 sums of <= 2048 terms, outputs averages of v; its row
# statistics (max, sum) to 1e-4
TOL_K4 = (2e-5, 1e-4)
TOL_STATS = (1e-4, 1e-4)
TOL_SCORES = 1e-4          # served scores: dot products of O(1) vectors, d <= 128
# gradients (K2, phase D): float32 sums of up to B L = 204,800 terms in
# another order than cuBLAS's; per tensor, relative to its largest value
TOL_GRAD = (1e-4, 1e-3)    # (atol as a share of max |g|, rtol)
# a gradient that is zero in exact arithmetic, as a share of the largest
TOL_ZERO_GRAD = 1e-6
TOL_LOSS = 1e-5            # phase D loss, relative
TOL_METRIC = 1e-6          # phase E: served NDCG@10 against evaluate()'s
# phase J: one row-sparse lazy-Adam step against the dense step, per
# tensor, relative to its largest magnitude: the two sum a row's duplicate
# lookups in other orders, float32
TOL_LAZY = (1e-6, 1e-5)    # (atol as a share of max |x|, rtol)
# logZ (K7): logsumexp of up to 500,000 float32 terms, each thread summing
# its share in order; values near 10
TOL_LOGZ = (1e-4, 1e-5)
# the GRU layer's outputs through cuDNN against its time loop (phase K):
# float32 sums in another order over 200 steps of |h| < 1; TF32 products
# (10-bit mantissas) miss it by orders of magnitude
TOL_GRU = (2e-5, 1e-4)     # (atol, rtol)
# served CTR probabilities against predict()'s or evaluate()'s: the same
# weights, the MLP's products at another batch size
TOL_PROB = 1e-5
# DIFM's kernel route against its plain route, probabilities: its FM sums
# the pair products of unnormalised float fields (logits up to ~16,000 at
# criteo-1m-shape), so the plain route alone lies up to 3.3e-5 from a
# float64 copy (H100 runs); twice that, rounded up. K3@difm's row holds
# the kernel itself to TOL_K3
TOL_DIFM_PROB = 1e-4
# a relu input the card and the CPU copy may decide apart: within this
# share of its tensor's largest |input| of 0 (float32 sums in two orders)
TOL_RELU_FLIP = 1e-5
# phase R: the JAX seeds' AUC band after its epochs must sit this far above
# the untrained model's AUC, or the gate could not tell a model that learns
AUC_MARGIN = 0.1
# phase U: a JAX NDCG@10 band must clear the untrained model's by this much
NDCG_MARGIN = 0.05
# phase T: one propagation layer against torch.sparse.mm, relative to the
# product's largest magnitude (float32 sums of up to a hub's degree terms)
TOL_LAYER = 1e-5
CLSE_KERNELS = ("catalog_logsumexp_fwd", "catalog_logsumexp_dq", "catalog_logsumexp_ditems")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(tag: str, payload) -> None:
    print(f"{tag} {json.dumps(payload)}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attended_pairs(pad, attn=None, shape=None) -> int:
    """(example, query, key) triples that attention must weigh on these
    masks (``attn`` None: no attention mask; ``pad`` None: no key padding,
    ``shape`` its (B, L)): the allowed keys of each query row, or all Lk
    keys of a row whose keys are all masked (it averages them). Masked-out
    pairs need no work."""
    if pad is None:
        import torch
        pad = torch.zeros(shape, dtype=torch.bool,
                          device=attn.device if attn is not None else "cpu")
    L = pad.shape[1]
    allowed = ~pad[:, None, :].expand(-1, L, -1)         # [B, Lq, Lk]
    if attn is not None:
        allowed = allowed & ~attn[None]
    per_row = allowed.sum(-1)
    return int(per_row.masked_fill(per_row == 0, pad.shape[1]).sum())


def errors(got, want, tol):
    diff = (got - want).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / want.abs().clamp_min(1e-6)).max())
    ok = bool((diff <= tol[0] + tol[1] * want.abs()).all())
    return max_abs, max_rel, ok


def right_padding(rng, B: int, L: int, min_len: int = 1):
    """bool [B, L] key-padding mask of right-padded rows of length >= min_len."""
    import numpy as np
    lens = rng.integers(min_len, L + 1, size=B)
    return np.arange(L)[None, :] >= lens[:, None]


def layer_params(tree_layer, device):
    from recstudio_torch.utils.convert import layer_params_from_jax
    return {name: t.to(device) for name, t in layer_params_from_jax(tree_layer).items()}


def build_model(dataset_name, data_config, embed_dim, seed, device):
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import params_from_jax, random_sasrec_params
    cls, conf = get_model("SASRec")
    conf["model"]["embed_dim"] = embed_dim
    ds = cls._get_dataset_class()(dataset_name, config=data_config)
    trn, _, tst = ds.build(**conf["data"])
    model = cls(conf, device=device)
    model._init_model(trn)
    model._init_parameter(trn)
    mc = conf["model"]
    tree = random_sasrec_params(seed, ds.num_items, embed_dim, ds.max_seq_len,
                                mc["hidden_size"], mc["layer_num"])
    model.load_state_dict(params_from_jax(tree))
    return model, conf, ds, tst, tree


def serve_split(pred, model, split, batch_size):
    """Serve every row of ``split`` in requests of ``batch_size``; returns
    (scores, ids, targets) as numpy over the true rows."""
    import numpy as np
    scores, ids, targets = [], [], []
    for batch in split.eval_loader(batch_size):
        n = int(batch["_size"])
        req = {f: batch[f][:n] for f in sorted(model.query_fields)}
        s, i = pred(req)
        scores.append(s)
        ids.append(i)
        targets.append(batch[model.fiid][:n])
    return np.concatenate(scores), np.concatenate(ids), np.concatenate(targets)


def rank_metrics(ids, targets):
    """NDCG@10 and Recall@10 of served lists against one target a row
    ``[n]`` or several ``[n, T]`` (0 = pad)."""
    import torch
    from recstudio_torch import eval as ev
    ids_t = torch.as_tensor(ids)
    tgt = torch.as_tensor(targets)
    if tgt.dim() == 1:
        tgt = tgt[:, None]
    hit = ev.hit_matrix(ids_t, tgt)
    rating = (tgt > 0).float()
    return {"ndcg@10": float(ev.ndcg(hit, rating, 10).mean()),
            "recall@10": float(ev.recall(hit, rating, 10).mean())}


def request_breakdown(pred, model, batch, p50_ms: float):
    """Device time (CUDA events) of each stage of one full request: copy in,
    query encoding (the transformer layers), catalog scores, history mask +
    top-k; and their sum's share of the request's host-clock p50."""
    import torch
    from recstudio_torch.models.basemodel.recommender import batch_to_device
    padded, _ = pred._pad({f: batch[f] for f in sorted(model.query_fields)})
    dev = batch_to_device(padded, model.device)
    feat = model._get_query_feat(dev)
    user_hist = pred._hist[dev[model.fuid].to(torch.long)]
    items = model.states["item_vector"]
    with torch.no_grad():
        q = model.net.encode_query(feat)
        scores = model.score_func.catalog(q, items)
        out = {"copy_in_ms": time_ms(lambda: batch_to_device(padded, model.device)),
               "encode_ms": time_ms(lambda: model.net.encode_query(feat)),
               "score_ms": time_ms(lambda: model.score_func.catalog(q, items)),
               "mask_topk_ms": time_ms(lambda: model._topk_from_scores(scores, pred.k,
                                                                       user_hist))}
    out["device_share_of_p50"] = sum(out.values()) / p50_ms
    return out


def plain_serving_diffs(pred, model, split, layers, n_requests=2, batch_size=256):
    """Serve the first ``n_requests`` requests of ``split`` on the kernel path
    and on the plain path (``layer.plain``) with the same weights: (rows
    whose lists disagree, rows compared, largest score difference)."""
    import numpy as np
    from recstudio_torch.utils.parity import topk_mismatches
    bad = n_cmp = 0
    max_diff = 0.0
    for batch in itertools.islice(split.eval_loader(batch_size), n_requests):
        req = {f: batch[f] for f in sorted(model.query_fields)}
        s_k, i_k = pred(req)
        for layer in layers:
            layer.plain = True
        s_p, i_p = pred(req)
        for layer in layers:
            layer.plain = False
        bad += topk_mismatches(i_k, s_k, i_p, s_p, TOL_SCORES)
        max_diff = max(max_diff, float(np.abs(s_k - s_p).max()))
        n_cmp += len(i_k)
    return bad, n_cmp, max_diff


def counted(fn):
    """Run ``fn`` with every launch count zeroed first; return (result,
    counts): the kernels', and ``gru_layer_cudnn``, the GRU layers that went
    through cuDNN."""
    import torch
    from recstudio_torch import ops
    from recstudio_torch.models.module.layers import gru_layer
    ops.reset_launch_counts()
    gru_layer.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {**ops.launch_counts(), "gru_layer_cudnn": gru_layer.launches}


# ---------------------------------------------------------------------------
def phase_a(device):
    import numpy as np
    from recstudio_torch.serving import Predictor
    from recstudio_torch.utils.parity import topk_mismatches
    with open(REFERENCE) as f:
        ref = json.load(f)
    model, conf, ds, tst, _ = build_model("ml-100k", None, 64, ref["seed"], device)
    mc = conf["model"]
    shape = dict(embed_dim=model.embed_dim, hidden=mc["hidden_size"], heads=mc["head_num"],
                 layers=mc["layer_num"], act=mc["activation"], eps=mc["layer_norm_eps"],
                 L=ds.max_seq_len, items=ds.num_items)
    check(shape == dict(embed_dim=64, hidden=128, heads=2, layers=2, act="gelu",
                        eps=1e-12, L=20, items=1575), f"phase A config {shape}")
    pred = Predictor(model, max_batch=128, k=20, train_data=tst).warm()
    (scores, ids, targets), counts = counted(lambda: serve_split(pred, model, tst, 128))
    n_ref = len(ref["user_ids"])
    check(np.array_equal(tst.data_index[:n_ref, 0], ref["user_ids"]), "reference users differ")
    bad = topk_mismatches(ids[:n_ref], scores[:n_ref], np.asarray(ref["item_ids"]),
                          np.asarray(ref["scores"]), TOL_SCORES)
    max_diff = float(np.abs(scores[:n_ref] - np.asarray(ref["scores"])).max())
    out = {"phase": "A", "dataset": "ml-100k", "config": shape, "users": len(ids),
           "launches": counts, **pred.stats(), **rank_metrics(ids, targets),
           "breakdown": request_breakdown(pred, model, next(iter(tst.eval_loader(128))),
                                        pred.stats()["p50_ms"]),
           "reference_rows": n_ref, "reference_rows_disagreeing": bad,
           "reference_max_score_diff": max_diff, "tol": TOL_SCORES}
    emit("PHASE", out)
    check(counts["fused_transformer_layer"] > 0, "phase A launched no fused layer")
    check(np.isfinite(scores).all() and scores.shape == (len(tst.data_index), 20),
          "phase A scores")
    check(bad == 0, f"phase A: {bad} of {n_ref} lists disagree with the JAX reference")
    return out


def phase_b(device):
    import numpy as np
    from recstudio_torch.data.synthetic import SHAPES, generate
    from recstudio_torch.serving import Predictor
    t0 = time.perf_counter()
    name, config = generate("ml-1m-shape", *SHAPES["ml-1m-shape"], seed=7)
    config["max_seq_len"] = 200
    model, conf, ds, tst, _ = build_model(name, config, 128, 7, device)
    etl_s = time.perf_counter() - t0
    pred = Predictor(model, max_batch=256, k=20, train_data=tst).warm()
    (scores, ids, targets), counts = counted(lambda: serve_split(pred, model, tst, 256))
    stats = pred.stats()
    # the same weights through the plain path, on the first two requests
    bad, n_cmp, max_diff = plain_serving_diffs(pred, model, tst,
                                               model.query_encoder.transformer.layers)
    out = {"phase": "B", "dataset": name, "users": ds.num_users - 1, "items": ds.num_items - 1,
           "inters": int(ds.num_inters), "L": ds.max_seq_len, "embed_dim": model.embed_dim,
           "etl_s": etl_s, "served": len(ids), "launches": counts, **stats,
           **rank_metrics(ids, targets),
           "breakdown": request_breakdown(pred, model, next(iter(tst.eval_loader(256))),
                                        stats["p50_ms"]),
           "plain_rows": n_cmp, "plain_rows_disagreeing": bad,
           "plain_max_score_diff": max_diff, "tol": TOL_SCORES}
    emit("PHASE", out)
    check(counts["fused_transformer_layer"] > 0, "phase B launched no fused layer")
    check(np.isfinite(scores).all(), "phase B scores not finite")
    check(bad == 0, f"phase B: {bad} of {n_cmp} lists differ between kernel and plain paths")
    return out


def phase_c(device):
    import numpy as np
    import torch
    from recstudio_torch.models.module import TransformerLayer
    from recstudio_torch.utils.convert import random_sasrec_params
    B, L, D, F, H = 64, 384, 128, 128, 2
    tree = random_sasrec_params(11, 2, D, 1, F, 1)
    layer = TransformerLayer(D, H, F, 0.0, "gelu", 1e-12)
    with torch.no_grad():
        for name, value in layer_params(tree["query_encoder"]["transformer"]["layer_0"],
                                        "cpu").items():
            getattr(layer, name).copy_(value)
    layer.to(device).eval()
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(device)
    pad = torch.from_numpy(right_padding(rng, B, L)).to(device)
    causal = torch.triu(torch.ones((L, L), dtype=torch.bool, device=device), 1)
    with torch.no_grad():
        got, counts = counted(lambda: layer(x, pad, causal))
        layer.plain = True
        want = layer(x, pad, causal)
        layer.plain = False
    max_abs, max_rel, ok = errors(got, want, TOL_K1)
    out = {"phase": "C", "shape": dict(B=B, L=L, D=D, F=F, H=H), "launches": counts,
           "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": TOL_K1}
    emit("PHASE", out)
    check(counts["fused_mha"] > 0, "phase C launched no attention kernel")
    check(counts["fused_transformer_layer"] == 0, "phase C went to the fused layer")
    check(ok and torch.isfinite(got).all(), f"phase C layer disagrees with plain: {max_abs}")
    return out


def grad_errors(got, want, zero=()):
    """(max abs error, ok) of gradient tensors by name, each held to
    TOL_GRAD relative to its own largest magnitude. The tensors named in
    ``zero`` have a zero gradient in exact arithmetic (an attention's key
    bias moves every score of a row alike, which the softmax removes):
    both sides' float32 noise there is held under ``TOL_ZERO_GRAD`` of the
    largest gradient of all, not to each other."""
    max_abs, ok = 0.0, True
    largest = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        diff = (got[name] - w).abs()
        max_abs = max(max_abs, float(diff.max()))
        if name in zero:
            ok &= max(float(got[name].abs().max()), float(w.abs().max())) \
                < TOL_ZERO_GRAD * largest
            continue
        ok &= bool((diff <= TOL_GRAD[0] * float(w.abs().max()) + TOL_GRAD[1] * w.abs()).all())
    return max_abs, ok


def training_model(device, model_name, batch_size, L=200, train=None, parts=None,
                   **model_conf):
    """``model_name`` on the synthetic ml-1m shape at ``max_seq_len`` L,
    seed 7, ready for optimizer steps on device-resident batches: (model,
    conf, dataset, test split, dataset name, ETL seconds). ``train``
    overrides ``train`` keys; ``parts`` go to the constructor (``loss=``)."""
    from recstudio_torch.data.synthetic import SHAPES, generate
    from recstudio_torch.utils import get_model
    t0 = time.perf_counter()
    name, config = generate("ml-1m-shape", *SHAPES["ml-1m-shape"], seed=7)
    config["max_seq_len"] = L
    cls, conf = get_model(model_name)
    conf["model"].update(model_conf)
    conf["train"].update(batch_size=batch_size, seed=7, **(train or {}))
    ds = cls._get_dataset_class()(name, config=config)
    trn, _, tst = ds.build(**conf["data"])
    model = cls(conf, device=device, **(parts or {}))
    model._init_model(trn)
    model._init_parameter(trn)
    model.optimizer = model._get_optimizer()
    model._setup_scan_epoch(trn)
    model._train_data = trn                  # the batch norms calibrate on it
    return model, conf, ds, tst, name, time.perf_counter() - t0


def epoch_stream(model):
    """Device-resident batches, one epoch after another (a split of users
    gives fewer batches an epoch than the timed steps take)."""
    while True:
        yield from model._epoch_batches()


def timed_steps(model, batches, n=20, warmup=3):
    """``warmup`` optimizer steps, then ``n`` timed ones (host clock around
    ``_grad_step`` and a synchronize): (the timed batches, sorted step ms,
    losses, launch counts of the timed steps)."""
    import torch
    model.net.train()
    for _ in range(warmup):                             # allocator, first launches
        model._grad_step(next(batches))
    torch.cuda.synchronize()
    steps = [next(batches) for _ in range(n)]

    def run():
        times, losses = [], []
        for batch in steps:
            t = time.perf_counter()
            losses.append(model._grad_step(batch))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return times, torch.stack(losses)

    (times, losses), counts = counted(run)
    return steps, sorted(times), losses, counts


def path_loss_and_grads(model, batch, states, set_path, *path):
    """One training step's loss and gradients from the generator ``states``
    on the path that ``set_path(*path)`` selects."""
    model.generator.set_state(states[0])
    model.device_generator.set_state(states[1])
    set_path(*path)
    model.net.zero_grad(set_to_none=True)
    loss = model.training_step(batch)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone()
                                  for n, p in model.net.named_parameters()}


def steps_and_comparison(model, set_path, *plain_paths):
    """20 timed steps on device-resident batches (their peak memory alone),
    then the last timed batch's loss and gradients on the kernel path
    (``set_path(False)``) and on each of ``plain_paths`` (argument tuples of
    ``set_path``) from the same generator states, with those steps' own
    peak memory. Returns (metrics, losses of the timed steps, their launch
    counts, [(loss, max gradient error, gradients ok) per plain path]);
    the model is left on the kernel path, in eval mode."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    steps, times, losses, counts = timed_steps(model, epoch_stream(model))
    step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    batch = steps[-1]
    states = (model.generator.get_state(), model.device_generator.get_state())
    torch.cuda.reset_peak_memory_stats()
    loss_k, grads_k = path_loss_and_grads(model, batch, states, set_path, False)
    compared = []
    for path in plain_paths:
        loss, grads = path_loss_and_grads(model, batch, states, set_path, *path)
        compared.append((loss, *grad_errors(grads_k, grads)))
        del grads
    compare_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    set_path(False)
    model.net.eval()
    p50 = times[len(times) // 2]
    metrics = {"steps": len(times), "step_ms_p50": p50, "step_ms_max": times[-1],
               "examples_per_s": int(model.config["train"]["batch_size"]) / (p50 / 1e3),
               "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
               "kernel_loss": loss_k, "grad_tol": TOL_GRAD, "loss_tol": TOL_LOSS,
               "peak_mem_gb": step_peak, "compare_peak_mem_gb": compare_peak}
    return metrics, losses, counts, compared


def input_mask_ms(device, B, L, D, p):
    """Time of the step's one plain-PyTorch mask: the embedded sequence's
    dropout (``ops/dropout.keep_scale``)."""
    from recstudio_torch.ops.dropout import SITE_INPUT, keep_scale
    return time_ms(lambda: keep_scale((B, L, D), p, 1, SITE_INPUT, device), iters=5)


def phase_d(device):
    """SASRec training at full width: timed steps, and one step held to the
    plain path."""
    import torch
    model, conf, ds, _, name, etl_s = training_model(device, "SASRec", 1024, embed_dim=128)
    mc = conf["model"]
    shape = dict(B=conf["train"]["batch_size"], L=ds.max_seq_len, D=model.embed_dim,
                 F=mc["hidden_size"],
                 H=mc["head_num"], layers=mc["layer_num"], dropout=mc["dropout_rate"])
    check(shape == dict(B=1024, L=200, D=128, F=128, H=2, layers=2, dropout=0.5),
          f"phase D config {shape}")
    batches = model._epoch_batches()
    _, times, losses, counts = timed_steps(model, batches)

    # one step's loss and gradients, kernel path against plain path
    batch = next(batches)
    layers = model.query_encoder.transformer.layers
    states = (model.generator.get_state(), model.device_generator.get_state())

    def set_path(plain):
        for layer in layers:
            layer.plain = plain

    loss_k, grads_k = path_loss_and_grads(model, batch, states, set_path, False)
    loss_p, grads_p = path_loss_and_grads(model, batch, states, set_path, True)
    set_path(False)
    model.net.eval()
    max_abs, ok = grad_errors(grads_k, grads_p)
    p50 = times[len(times) // 2]
    out = {"phase": "D", "dataset": name, "shape": shape, "etl_s": etl_s, "steps": len(times),
           "launches": counts, "step_ms_p50": p50, "step_ms_max": times[-1],
           "examples_per_s": 1024 / (p50 / 1e3),
           "input_dropout_mask_ms": input_mask_ms(device, 1024, shape["L"], shape["D"], 0.5),
           "loss_first": float(losses[0]),
           "loss_last": float(losses[-1]), "plain_loss": loss_p, "kernel_loss": loss_k,
           "grad_max_abs_err": max_abs, "grad_tol": TOL_GRAD, "loss_tol": TOL_LOSS,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit("PHASE", out)
    check(counts["fused_transformer_layer"] > 0, "phase D launched no fused layer")
    check(counts["fused_transformer_layer_bwd"] > 0, "phase D launched no fused backward")
    check(bool(torch.isfinite(losses).all()), "phase D loss not finite")
    check(abs(loss_k - loss_p) <= TOL_LOSS * abs(loss_p), f"phase D loss {loss_k} vs {loss_p}")
    check(ok, f"phase D gradients disagree with the plain path: {max_abs}")
    return out


TRANSFORMER_KEYS = {"hidden": "hidden_size", "heads": "head_num", "layers": "layer_num"}


def fit_phase(device, tag, model_name, reference, model_keys, expected, kernels,
              quickstart=False, cpu_lists=False, overrides=None, profile=True):
    """fit + evaluate on ml-100k at the repo's config for the reference's
    epochs (through ``quickstart.run`` with ``quickstart``; ``overrides``,
    config groups layered over the repo's config as the reference's runs
    were), test NDCG@10
    held to the JAX seeds' band, then every test user served from the
    trained weights in requests of the eval batch (8 of 128 at ml-100k).
    ``model_keys`` names the ``model`` config keys checked against
    ``expected`` besides the width, L (a sequence model's), batch and
    epochs. With no ``kernels`` named, the phase must launch none. A
    reference with a ``learning_gate`` is held to it: ``ndcg``, the band
    clears the untrained NDCG@10 by ``NDCG_MARGIN``; ``train_loss`` (a JAX
    model that does not learn to rank at its config, whose test NDCG@10 is
    the random-init level and is reported, not gated), the last epoch's
    training loss lies inside the JAX band of it. With
    ``cpu_lists`` every served list is held to the model copied to the CPU
    (ids up to ties, scores within ``TOL_SCORES``). A quick start with
    ``profile`` profiles one more epoch for the card's busy share."""
    import numpy as np
    from recstudio_torch.data import UserDataset
    from recstudio_torch.quickstart import run
    from recstudio_torch.serving import Predictor
    from recstudio_torch.utils import get_model
    with open(reference) as f:
        ref = json.load(f)

    def serve(model, trn, tst):
        # requests of the eval batch, masked as evaluate() masks: the test
        # split's history table, or a user model's history window (its
        # training items: the train split's table)
        size = int(model.config["eval"]["batch_size"])
        hist = trn if isinstance(tst, UserDataset) else tst
        pred = Predictor(model, max_batch=size, k=20, train_data=hist).warm()
        return pred, serve_split(pred, model, tst, size)

    def drive():
        t0 = time.perf_counter()
        if quickstart:
            conf = {"train": {"epochs": ref["epochs"]}, "eval": {"save_path": SAVE_DIR}}
            for group, values in (overrides or {}).items():
                conf.setdefault(group, {}).update(values)
            model, (trn, _, tst), result = run(model_name, "ml-100k", verbose=False,
                                               device=device, model_config=conf)
        else:
            cls, conf = get_model(model_name)
            conf["train"]["epochs"] = ref["epochs"]
            conf["eval"]["save_path"] = SAVE_DIR
            trn, val, tst = cls._get_dataset_class()("ml-100k").build(**conf["data"])
            model = cls(conf, device=device)
            model.fit(trn, val)
            result = model.evaluate(tst, verbose=False)
        run_s = time.perf_counter() - t0
        return (model, trn, tst, result, run_s) + serve(model, trn, tst)

    (model, trn, tst, result, run_s, pred, (scores, ids, targets)), counts = counted(drive)
    users = len(tst.data_index)
    cpu_bad = cpu_rows = None
    if cpu_lists:
        from recstudio_torch.utils.parity import topk_mismatches
        cpu = cpu_copy(model, trn)
        _, (s_c, i_c, _) = serve(cpu, trn, tst)
        cpu_rows, cpu_max_diff = len(i_c), float(np.abs(scores - s_c).max())
        cpu_bad = topk_mismatches(ids, scores, i_c, s_c, TOL_SCORES)
    mc, tc = model.config["model"], model.config["train"]
    shape = dict(embed_dim=model.embed_dim, **{k: mc[v] for k, v in model_keys.items()},
                 batch=tc["batch_size"], epochs=tc["epochs"])
    if hasattr(model, "max_seq_len"):
        shape["L"] = model.max_seq_len
    shape.update({k: tc[k] for k in ("mask_ratio", "weight_decay", "learner", "sampler",
                                     "negative_count") if k in expected})
    check(shape == dict(expected, epochs=ref["epochs"]), f"phase {tag} config {shape}")
    served = rank_metrics(ids, targets)
    lo, hi = ref["ndcg@10_band"]
    out = {"phase": tag, "model": model_name, "dataset": "ml-100k",
           "entry": "quickstart.run" if quickstart else "fit", "config": shape,
           "launches": counts, "run_s": run_s,
           "fit_s": sum(e["train_s"] + e["eval_s"] for e in model.epoch_log),
           "best_epoch": model.callback.best_epoch,
           "epochs": [{k: (round(v, 6) if isinstance(v, float) else v)
                       for k, v in e.items()} for e in model.epoch_log],
           "test_ndcg@10": result["ndcg@10"], "test_recall@10": result["recall@10"],
           "jax_band_ndcg@10": [lo, hi], "jax_runs": ref["runs"],
           "requests": pred.stats()["requests"], "served_ndcg@10": served["ndcg@10"],
           "served_recall@10": served["recall@10"], **{"serve_" + k: v for k, v in
                                                       pred.stats().items()}}
    if "untrained_ndcg@10" in ref:
        out["jax_untrained_ndcg@10"] = ref["untrained_ndcg@10"]
    if "learning_gate" in ref:
        out.update(learning_gate=ref["learning_gate"],
                   ndcg_in_jax_band=lo <= result["ndcg@10"] <= hi,
                   train_loss_last=model.epoch_log[-1]["train_loss"],
                   jax_band_train_loss_last=ref["train_loss_last_band"])
    if cpu_lists:
        out.update(cpu_rows=cpu_rows, cpu_rows_disagreeing=cpu_bad,
                   cpu_max_score_diff=cpu_max_diff, cpu_tol=TOL_SCORES)
    if quickstart and profile:  # the card's busy share of one more epoch, profiled
        train_s = sorted(e["train_s"] for e in model.epoch_log)
        epoch_s = train_s[len(train_s) // 2]
        model._epoch_refresh(0)         # what the epoch reads (a sampler's index)
        host_ms, busy_ms = busy_share(lambda: model.training_epoch(0))
        # a closed-form, ALS or host-loader model stages no device epoch
        rows = getattr(model, "_epoch_rows", None)
        steps = None if rows is None else -(-rows // tc["batch_size"])
        out.update(epoch_s_p50=epoch_s, steps_per_epoch=steps,
                   step_ms_p50=None if steps is None else epoch_s / steps * 1e3,
                   profiled_epoch_host_ms=host_ms, profiled_epoch_busy_ms=busy_ms,
                   busy_share_of_epoch=None if busy_ms is None else busy_ms / (epoch_s * 1e3))
    emit("PHASE", out)
    for name in kernels:
        check(counts[name] > 0, f"phase {tag} launched no {name}")
    if not kernels:
        check(not any(counts.values()), f"phase {tag} launched a kernel: {counts}")
    check(all(np.isfinite(e["train_loss"]) for e in model.epoch_log), f"phase {tag} loss")
    if ref.get("learning_gate") != "train_loss":
        check(lo <= result["ndcg@10"] <= hi,
              f"phase {tag} test NDCG@10 {result['ndcg@10']} outside the JAX band [{lo}, {hi}]")
    if ref.get("learning_gate") == "ndcg":
        check(lo - ref["untrained_ndcg@10"] >= NDCG_MARGIN,
              f"phase {tag} {model_name}: the JAX band does not clear the untrained NDCG@10")
    elif ref.get("learning_gate") == "train_loss":
        # the JAX model does not learn to rank at this config: its test
        # NDCG@10 is the random-init level (reported beside the band above);
        # the training loss shows that the port trains as the JAX model does
        l_lo, l_hi = ref["train_loss_last_band"]
        check(l_lo <= out["train_loss_last"] <= l_hi,
              f"phase {tag} {model_name}: last training loss {out['train_loss_last']} outside "
              f"the JAX band [{l_lo}, {l_hi}]")
    if cpu_lists:
        check(cpu_rows == users and cpu_bad == 0,
              f"phase {tag}: {cpu_bad} of {cpu_rows} lists differ from the CPU copy's")
    requests = -(-users // pred.max_batch)
    check(pred.stats()["requests"] == requests,
          f"phase {tag} served {pred.stats()['requests']} requests, not {requests}")
    check(abs(served["ndcg@10"] - result["ndcg@10"]) <= TOL_METRIC and
          abs(served["recall@10"] - result["recall@10"]) <= TOL_METRIC,
          f"phase {tag}: served lists do not come from the evaluated (trained) weights")
    return out


def phase_e(device):
    """SASRec: fit + evaluate on ml-100k at the repo's config, then serve."""
    return fit_phase(device, "E", "SASRec", TRAIN_REFERENCE,
                     dict(TRANSFORMER_KEYS, dropout="dropout_rate"),
                     dict(embed_dim=64, hidden=128, heads=2, layers=2, dropout=0.5, L=20,
                          batch=512), ["fused_transformer_layer_bwd"])


def phase_f(device):
    """BERT4Rec training and serving at full width: timed steps, one step
    held to the plain path and to the materialized path, every user served."""
    import numpy as np
    import torch
    from recstudio_torch.serving import Predictor
    model, conf, ds, tst, name, etl_s = training_model(device, "BERT4Rec", 256)
    mc, tc = conf["model"], conf["train"]
    shape = dict(B=tc["batch_size"], L=ds.max_seq_len, D=model.embed_dim, F=mc["hidden_size"],
                 H=mc["head_num"], layers=mc["layer_num"], dropout=mc["dropout"],
                 mask_ratio=tc["mask_ratio"], items=ds.num_items - 1)
    check(shape == dict(B=256, L=200, D=64, F=128, H=2, layers=2, dropout=0.2, mask_ratio=0.2,
                        items=3706), f"phase F config {shape}")
    check(model._use_fused_softmax(), "phase F does not take the fused softmax step")
    layers = model.query_encoder.transformer.layers

    def set_path(plain, fused="auto"):
        for layer in layers:
            layer.plain = plain
        model.config["train"]["fused_softmax"] = fused

    # one step's loss and gradients on the kernel path, held to the plain
    # path (plain layers, materialized scores with their autograd backward)
    # and to the kernel layers with materialized scores
    metrics, losses, train_counts, ((loss_p, max_abs, ok), (loss_m, _, _)) = \
        steps_and_comparison(model, set_path, (True, "false"), (False, "false"))
    loss_k = metrics["kernel_loss"]

    pred = Predictor(model, max_batch=256, k=20, train_data=tst).warm()
    (scores, ids, targets), serve_counts = counted(lambda: serve_split(pred, model, tst, 256))
    stats = pred.stats()
    bad, n_cmp, max_diff = plain_serving_diffs(pred, model, tst, layers)
    counts = {k: train_counts[k] + serve_counts[k] for k in train_counts}
    out = {"phase": "F", "model": "BERT4Rec", "dataset": name, "shape": shape, "etl_s": etl_s,
           "launches": counts, "train_launches": train_counts, **metrics,
           "input_dropout_mask_ms": input_mask_ms(device, shape["B"], shape["L"], shape["D"],
                                                  shape["dropout"]),
           "plain_loss": loss_p, "materialized_loss": loss_m, "grad_max_abs_err": max_abs,
           "served": len(ids), **{"serve_" + k: v for k, v in stats.items()},
           **rank_metrics(ids, targets), "plain_rows": n_cmp, "plain_rows_disagreeing": bad,
           "plain_max_score_diff": max_diff, "tol": TOL_SCORES}
    emit("PHASE", out)
    for kernel in ("fused_transformer_layer", "fused_transformer_layer_bwd",
                   "catalog_logsumexp_fwd", "catalog_logsumexp_dq", "catalog_logsumexp_ditems"):
        check(train_counts[kernel] > 0, f"phase F training launched no {kernel}")
    check(serve_counts["fused_transformer_layer"] > 0, "phase F serving launched no fused layer")
    check(bool(torch.isfinite(losses).all()), "phase F loss not finite")
    check(abs(loss_k - loss_p) <= TOL_LOSS * abs(loss_p), f"phase F loss {loss_k} vs {loss_p}")
    check(abs(loss_k - loss_m) <= TOL_LOSS * abs(loss_m),
          f"phase F loss {loss_k} vs the materialized path's {loss_m}")
    check(ok, f"phase F gradients disagree with the plain path: {max_abs}")
    check(np.isfinite(scores).all() and scores.shape == (len(tst.data_index), 20),
          "phase F scores")
    check(bad == 0, f"phase F: {bad} of {n_cmp} lists differ between kernel and plain paths")
    return out


def phase_g(device):
    """BERT4Rec: fit + evaluate on ml-100k at the repo's config, then serve."""
    return fit_phase(device, "G", "BERT4Rec", BERT4REC_TRAIN_REFERENCE,
                     dict(TRANSFORMER_KEYS, dropout="dropout"),
                     dict(embed_dim=64, hidden=128, heads=2, layers=2, dropout=0.2, L=20,
                          batch=512, mask_ratio=0.2, weight_decay=1e-5),
                     ["fused_transformer_layer", "fused_transformer_layer_bwd",
                      "catalog_logsumexp_fwd", "catalog_logsumexp_dq",
                      "catalog_logsumexp_ditems"])


def phase_h(device):
    """Long-sequence SASRec (L 1024, dropout 0): timed training steps whose
    attention runs K4, K5 and K6; one step held to the plain path; every
    user served through K4, two requests held to the plain path."""
    import numpy as np
    import torch
    from recstudio_torch.serving import Predictor
    model, conf, ds, tst, name, etl_s = training_model(device, "SASRec", 256, L=1024,
                                                       embed_dim=128, dropout_rate=0.0)
    mc = conf["model"]
    shape = dict(B=conf["train"]["batch_size"], L=ds.max_seq_len, D=model.embed_dim,
                 F=mc["hidden_size"], H=mc["head_num"], layers=mc["layer_num"],
                 act=mc["activation"], eps=mc["layer_norm_eps"], dropout=mc["dropout_rate"],
                 items=ds.num_items - 1)
    check(shape == dict(B=256, L=1024, D=128, F=128, H=2, layers=2, act="gelu", eps=1e-12,
                        dropout=0.0, items=3706), f"phase H config {shape}")
    layers = model.query_encoder.transformer.layers

    def set_path(plain):
        for layer in layers:
            layer.plain = plain

    # one step's loss and gradients, kernel path against plain path
    metrics, losses, train_counts, ((loss_p, max_abs, ok),) = \
        steps_and_comparison(model, set_path, (True,))
    loss_k = metrics["kernel_loss"]

    pred = Predictor(model, max_batch=256, k=20, train_data=tst).warm()
    (scores, ids, targets), serve_counts = counted(lambda: serve_split(pred, model, tst, 256))
    stats = pred.stats()
    bad, n_cmp, max_diff = plain_serving_diffs(pred, model, tst, layers)
    counts = {k: train_counts[k] + serve_counts[k] for k in train_counts}
    out = {"phase": "H", "model": "SASRec", "dataset": name, "shape": shape, "etl_s": etl_s,
           "launches": counts, "train_launches": train_counts, "serve_launches": serve_counts,
           **metrics, "plain_loss": loss_p, "grad_max_abs_err": max_abs,
           "served": len(ids), **{"serve_" + k: v for k, v in stats.items()},
           **rank_metrics(ids, targets), "plain_rows": n_cmp, "plain_rows_disagreeing": bad,
           "plain_max_score_diff": max_diff, "tol": TOL_SCORES}
    emit("PHASE", out)
    for kernel in ("flash_mha_fwd", "flash_mha_bwd_dq", "flash_mha_bwd_dkv"):
        check(train_counts[kernel] > 0, f"phase H training launched no {kernel}")
    check(serve_counts["flash_mha_fwd"] > 0, "phase H serving launched no flash_mha_fwd")
    for kernel in ("fused_transformer_layer", "fused_mha"):
        check(counts[kernel] == 0, f"phase H launched {kernel} at L 1024")
    check(bool(torch.isfinite(losses).all()), "phase H loss not finite")
    check(abs(loss_k - loss_p) <= TOL_LOSS * abs(loss_p), f"phase H loss {loss_k} vs {loss_p}")
    check(ok, f"phase H gradients disagree with the plain path: {max_abs}")
    check(np.isfinite(scores).all() and scores.shape == (len(tst.data_index), 20),
          "phase H scores")
    check(bad == 0, f"phase H: {bad} of {n_cmp} lists differ between kernel and plain paths")
    return out


def busy_share(fn):
    """Run ``fn`` under ``torch.profiler``: (host ms, the card's busy ms,
    the union of its kernel and copy intervals). Busy ms is None when the
    profiler records no device activity. The intervals are read from the
    profiler's raw events (ns; ``kineto_results``, which torch 2.11 keeps
    and which is not public API): building its Python event tree takes
    about a minute for an epoch of a few hundred thousand events. A torch
    without them fails the run rather than measure another way."""
    import torch
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3
    raw = getattr(prof.profiler, "kineto_results", None)
    check(raw is not None and hasattr(raw, "events"),
          f"torch {torch.__version__}'s profiler keeps no raw kineto results: busy_share "
          "reads them (torch 2.11 does)")
    spans = sorted((e.start_ns(), e.end_ns()) for e in raw.events()
                   if e.device_type() == DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    return host_ms, (busy / 1e6 if spans else None)


def multi_target_ndcg(ids, targets, k):
    """NDCG@k of served lists against multi-target rows ``[n, T]`` (0 = pad)."""
    import torch
    from recstudio_torch import eval as ev
    tgt = torch.as_tensor(targets)
    return float(ev.ndcg(ev.hit_matrix(torch.as_tensor(ids), tgt), (tgt > 0).float(), k).mean())


def cpu_copy(model, train_split):
    """The same model on the CPU, holding the card's weights."""
    cpu = type(model)(model.config, device="cpu")
    cpu._init_model(train_split)
    cpu.load_state_dict({k: v.cpu() for k, v in model.net.state_dict().items()})
    return cpu


def step_on(model, batch, neg, **kwargs):
    """One training step's loss and gradients with the negatives ``neg``
    (``kwargs`` go to ``training_step``)."""
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    import torch
    zeros = torch.zeros(neg.shape, device=neg.device)
    model.sampling = lambda *a, **k: (None, neg, zeros)
    try:
        model.net.train()
        model.net.zero_grad(set_to_none=True)
        loss = model.training_step(batch, **kwargs)
        loss.backward()
        zero_pad_rows_in_grads(model.net)
    finally:
        del model.sampling
        model.net.eval()
    return float(loss.detach()), {n: p.grad.detach().clone()
                                  for n, p in model.net.named_parameters()}


def phase_i(device):
    """BPR: quickstart.run on ml-100k at the repo's config, test NDCG@5 held
    to the JAX band, one step held to the CPU copy, 8 requests served."""
    import numpy as np
    import torch
    from recstudio_torch.quickstart import run
    from recstudio_torch.serving import Predictor
    with open(BPR_TRAIN_REFERENCE) as f:
        ref = json.load(f)
    overrides = {"train": {"epochs": ref["epochs"]}, "eval": {"save_path": SAVE_DIR}}

    def drive():
        t0 = time.perf_counter()
        model, splits, result = run("BPR", "ml-100k", model_config=overrides, verbose=False,
                                    device=device)
        run_s = time.perf_counter() - t0
        pred = Predictor(model, max_batch=128, k=20, train_data=splits[2]).warm()
        return model, splits, result, run_s, pred, serve_split(pred, model, splits[2], 128)

    (model, (trn, val, tst), result, run_s, pred, (scores, ids, targets)), counts = \
        counted(drive)
    tc, mc = model.config["train"], model.config["model"]
    shape = dict(embed_dim=model.embed_dim, batch=tc["batch_size"], learner=tc["learner"],
                 negatives=tc["negative_count"], split=model.config["data"]["split_ratio"],
                 eval_batch=model.config["eval"]["batch_size"], epochs=tc["epochs"],
                 users=trn.num_users - 1, items=trn.num_items - 1)
    check(shape == dict(embed_dim=64, batch=512, learner="adam", negatives=1,
                        split=[0.8, 0.1, 0.1], eval_batch=20, epochs=ref["epochs"],
                        users=943, items=1574), f"phase I config {shape}")
    steps = -(-len(trn.data_index) // tc["batch_size"])
    train_s = sorted(e["train_s"] for e in model.epoch_log)
    epoch_s = train_s[len(train_s) // 2]
    # the card's busy share of one more epoch, profiled
    host_ms, busy_ms = busy_share(lambda: model.training_epoch(0))

    # one step on the card held to the same model on the CPU
    batch = next(model._epoch_batches())
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    neg = torch.randint(1, trn.num_items, (tc["batch_size"], 1), generator=gen, device=device)
    loss_k, grads_k = step_on(model, batch, neg)
    cpu = cpu_copy(model, trn)
    loss_c, grads_c = step_on(cpu, {k: v.cpu() for k, v in batch.items()}, neg.cpu())
    max_abs, ok = grad_errors({k: v.cpu() for k, v in grads_k.items()}, grads_c)

    served = multi_target_ndcg(ids, targets, 5)
    lo, hi = ref["ndcg@5_band"]
    out = {"phase": "I", "model": "BPR", "dataset": "ml-100k", "entry": "quickstart.run",
           "config": shape, "launches": counts, "run_s": run_s,
           "epochs_run": len(model.epoch_log), "best_epoch": model.callback.best_epoch,
           "steps_per_epoch": steps, "epoch_s_p50": epoch_s,
           "step_ms_p50": epoch_s / steps * 1e3,
           "examples_per_s": steps * tc["batch_size"] / epoch_s,
           "fit_s": sum(e["train_s"] + e["eval_s"] for e in model.epoch_log),
           "profiled_epoch_host_ms": host_ms, "profiled_epoch_busy_ms": busy_ms,
           "busy_share_of_epoch": None if busy_ms is None else busy_ms / (epoch_s * 1e3),
           "test_ndcg@5": result["ndcg@5"], "test_recall@5": result["recall@5"],
           "test_ndcg@20": result["ndcg@20"], "jax_band_ndcg@5": [lo, hi],
           "jax_runs": ref["runs"], "cpu_loss": loss_c, "card_loss": loss_k,
           "grad_max_abs_err": max_abs, "grad_tol": TOL_GRAD, "loss_tol": TOL_LOSS,
           "requests": pred.stats()["requests"], "served_ndcg@5": served,
           **{"serve_" + k: v for k, v in pred.stats().items()}}
    emit("PHASE", out)
    check(all(np.isfinite(e["train_loss"]) for e in model.epoch_log), "phase I loss")
    check(lo <= result["ndcg@5"] <= hi,
          f"phase I test NDCG@5 {result['ndcg@5']} outside the JAX band [{lo}, {hi}]")
    check(abs(loss_k - loss_c) <= TOL_LOSS * abs(loss_c), f"phase I loss {loss_k} vs {loss_c}")
    check(ok, f"phase I gradients disagree with the CPU copy's: {max_abs}")
    check(pred.stats()["requests"] == 8, "phase I served other than 8 requests")
    check(np.isfinite(scores).all() and scores.shape == (len(tst.data_index), 20),
          "phase I scores")
    check(abs(served - result["ndcg@5"]) <= TOL_METRIC,
          "phase I: served lists do not come from the evaluated (trained) weights")
    return out


def lazy_state(model):
    """Parameters, lazy-Adam moments and step count, cloned."""
    opt = model.optimizer
    out = {}
    for n, p in model.net.named_parameters():
        mu, nu = opt.moments(p)
        out[n], out[n + ".mu"], out[n + ".nu"] = p.detach().clone(), mu.clone(), nu.clone()
    return out, opt.param_groups[0]["count"]


def set_lazy_state(model, state):
    import torch
    tensors, count = state
    with torch.no_grad():
        for n, p in model.net.named_parameters():
            mu, nu = model.optimizer.moments(p)
            p.copy_(tensors[n])
            mu.copy_(tensors[n + ".mu"])
            nu.copy_(tensors[n + ".nu"])
    for group in model.optimizer.param_groups:
        group["count"] = count


def phase_j(device):
    """BPR at the scale shape: timed epochs under adam, dense lazy Adam and
    the row-sparse step; one row-sparse step held to the dense step and to
    itself; full-catalog evaluation; every user served."""
    import numpy as np
    import torch
    from recstudio_torch.data.synthetic import SHAPES, generate
    from recstudio_torch.serving import Predictor
    from recstudio_torch.utils import get_model, seed_everything
    from recstudio_torch.utils.parity import topk_mismatches
    t0 = time.perf_counter()
    name, config = generate("ml-1m-shape", *SHAPES["ml-1m-shape"], seed=7)
    cls, conf = get_model("BPR")
    seed_everything(2022)
    ds = cls._get_dataset_class()(name, config=config)
    trn, val, tst = ds.build(**conf["data"])
    etl_s = time.perf_counter() - t0
    conf["train"].update(batch_size=8192)
    conf["eval"].update(batch_size=512, cutoff=[20], test_metrics=["ndcg", "recall"],
                        topk=100, save_path=SAVE_DIR)
    n = len(trn.data_index)
    steps = -(-n // 8192)
    check((ds.num_users - 1, ds.num_items - 1, ds.num_inters) == (6040, 3706, 1_000_209),
          f"phase J dataset {ds.num_users - 1} x {ds.num_items - 1} x {ds.num_inters}")

    def build(learner, sparse_rows):
        c = json.loads(json.dumps(conf))
        c["train"].update(learner=learner, sparse_rows=sparse_rows)
        m = cls(c, device=device)
        m._init_model(trn)
        m._init_parameter(trn)
        m.optimizer = m._get_optimizer()
        m._setup_scan_epoch(trn)
        return m

    modes, models, counts = {}, {}, None
    for mode, learner, sparse_rows in (("adam", "adam", "auto"),
                                       ("lazy_dense", "sparse_adam", "false"),
                                       ("lazy_rows", "sparse_adam", "auto")):
        model = build(learner, sparse_rows)
        check(model._sparse_rows_enabled() == (mode == "lazy_rows"),
              f"phase J {mode}: row-sparse gate")

        def epochs(model=model):
            model.training_epoch(0)                         # warm
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses = [model.training_epoch(e) for e in range(3)]
            return (time.perf_counter() - t) / 3, losses

        (epoch_s, losses), c = counted(epochs)
        counts = c if counts is None else {k: counts[k] + c[k] for k in counts}
        host_ms, busy_ms = busy_share(lambda: model.training_epoch(0))
        modes[mode] = {"epoch_s": epoch_s, "examples_per_s": n / epoch_s,
                       "step_ms": epoch_s / steps * 1e3, "losses": losses,
                       "profiled_epoch_host_ms": host_ms, "profiled_epoch_busy_ms": busy_ms,
                       "busy_share_of_epoch": None if busy_ms is None
                       else busy_ms / (epoch_s * 1e3)}
        check(all(np.isfinite(losses)), f"phase J {mode} loss not finite")
        models[mode] = model

    # one row-sparse step against one dense lazy-Adam step from the same
    # parameters, moments, count and generator states (so the same negatives)
    model = models["lazy_rows"]
    batch = next(model._epoch_batches())
    state = lazy_state(model)
    gens = model.device_generator.get_state()
    after = {}
    for tag, flag in (("rows", True), ("dense", False), ("rows_again", True)):
        set_lazy_state(model, state)
        model.device_generator.set_state(gens)
        model._sparse_rows_flag = flag
        model._grad_step(batch)
        after[tag] = lazy_state(model)[0]
    model._sparse_rows_flag = True
    max_abs, ok = 0.0, True
    for key, want in after["dense"].items():
        diff = (after["rows"][key] - want).abs()
        max_abs = max(max_abs, float(diff.max()))
        ok &= bool((diff <= TOL_LAZY[0] * float(want.abs().max())
                    + TOL_LAZY[1] * want.abs()).all())
    bitwise = all(torch.equal(after["rows"][k], after["rows_again"][k]) for k in after["rows"])
    touched = int((after["rows"]["item_encoder.weight"] != state[0]["item_encoder.weight"])
                  .any(-1).sum())

    # full-catalog evaluation of every test user (adam's weights)
    model = models["adam"]
    model._eval_epoch(tst, ["ndcg", "recall"], [20])       # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    ev = model._eval_epoch(tst, ["ndcg", "recall"], [20])
    eval_s = time.perf_counter() - t

    pred = Predictor(model, max_batch=256, k=20, train_data=tst).warm()
    users = np.arange(1, ds.num_users, dtype=np.int32)
    served = [pred({"user_id": users[i:i + 256]}) for i in range(0, len(users), 256)]
    stats = pred.stats()
    cpu = cpu_copy(model, trn)
    cpu_pred = Predictor(cpu, max_batch=256, k=20, train_data=tst)
    bad = n_cmp = 0
    max_diff = 0.0
    for i, (s_k, i_k) in enumerate(served[:2]):
        s_c, i_c = cpu_pred({"user_id": users[i * 256:(i + 1) * 256]})
        bad += topk_mismatches(i_k, s_k, i_c, s_c, TOL_SCORES)
        max_diff = max(max_diff, float(np.abs(s_k - s_c).max()))
        n_cmp += len(i_k)
    scores = np.concatenate([s for s, _ in served])
    out = {"phase": "J", "model": "BPR", "dataset": name, "users": ds.num_users - 1,
           "items": ds.num_items - 1, "inters": int(ds.num_inters), "train_rows": n,
           "batch": 8192, "steps_per_epoch": steps, "etl_s": etl_s, "launches": counts,
           "modes": modes, "lazy_step_max_abs_err": max_abs, "lazy_tol": TOL_LAZY,
           "lazy_step_bitwise_repeat": bitwise, "lazy_step_item_rows_touched": touched,
           "eval_users": len(tst.data_index), "eval_s": eval_s,
           "eval_queries_per_s": len(tst.data_index) / eval_s, **ev,
           "served_users": len(scores), **{"serve_" + k: v for k, v in stats.items()},
           "serve_max_ms": max(pred._lat_ms), "cpu_rows": n_cmp, "cpu_rows_disagreeing": bad,
           "cpu_max_score_diff": max_diff, "tol": TOL_SCORES}
    emit("PHASE", out)
    check(ok, f"phase J: the row-sparse step disagrees with the dense lazy step: {max_abs}")
    check(bitwise, "phase J: the row-sparse step does not repeat bit for bit")
    check(touched > 0, "phase J: the row-sparse step moved no item row")
    check(np.isfinite(ev["ndcg@20"]) and np.isfinite(ev["recall@20"]), "phase J eval")
    check(np.isfinite(scores).all() and scores.shape == (len(users), 20), "phase J scores")
    check(bad == 0, f"phase J: {bad} of {n_cmp} lists differ from the CPU copy's")
    return out


def gru_versus_plain(device, gru, B, L, D, seed=2032):
    """The first layer of ``gru`` (a ``GRULayer``) forward and backward
    through cuDNN (``gru_layer``) against its time loop (``gru_layer_plain``)
    at ``[B, L, D]``: the output's and every gradient's largest error, both
    times, and, for contrast, the largest output error of cuDNN with TF32
    allowed (the ``nn.GRU``'s own forward under PyTorch's default cuDNN
    setting)."""
    import numpy as np
    import torch
    from recstudio_torch.models.module.layers import gru_layer, gru_layer_plain
    rnn = gru.layers[0]
    w = list(rnn.all_weights[0])
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(device)
    x.requires_grad_()
    cot = torch.from_numpy(rng.normal(size=(B, L, rnn.hidden_size)).astype(np.float32)).to(device)

    def run(fn):
        out = fn(x, *w)
        return [out, *torch.autograd.grad(out, [x, *w], cot)]

    got, want = run(gru_layer), run(gru_layer_plain)
    torch.cuda.synchronize()
    max_abs, max_rel, ok = errors(got[0].detach(), want[0].detach(), TOL_GRU)
    grad_abs, grad_ok = grad_errors(dict(enumerate(got[1:])), dict(enumerate(want[1:])))
    c = torch.backends.cudnn
    with torch.no_grad(), c.flags(enabled=True, benchmark=c.benchmark,
                                  deterministic=c.deterministic, allow_tf32=True):
        tf32 = rnn(x)[0]
    return {"shape": dict(B=B, L=L, D=D, H=rnn.hidden_size), "max_abs_err": max_abs,
            "max_rel_err": max_rel, "grad_max_abs_err": grad_abs, "tol": TOL_GRU,
            "grad_tol": TOL_GRAD, "ok": ok and grad_ok,
            "tf32_allowed_max_abs_err": float((tf32 - want[0]).abs().max()),
            "fwd_bwd_ms": time_ms(lambda: run(gru_layer), iters=10),
            "plain_fwd_bwd_ms": time_ms(lambda: run(gru_layer_plain), iters=3, warmup=1),
            "fwd_ms": time_ms(lambda: gru_layer(x.detach(), *w), iters=10),
            "plain_fwd_ms": time_ms(lambda: gru_layer_plain(x.detach(), *w), iters=3,
                                    warmup=1)}


def served_diffs(pred_a, pred_b, split, fields, n_requests=2, batch_size=256):
    """The first ``n_requests`` requests of ``split`` through two predictors:
    (rows whose lists disagree, rows compared, largest score difference)."""
    import numpy as np
    from recstudio_torch.utils.parity import topk_mismatches
    bad = n_cmp = 0
    max_diff = 0.0
    for batch in itertools.islice(split.eval_loader(batch_size), n_requests):
        req = {f: batch[f] for f in fields}
        (s_a, i_a), (s_b, i_b) = pred_a(req), pred_b(req)
        bad += topk_mismatches(i_a, s_a, i_b, s_b, TOL_SCORES)
        max_diff = max(max_diff, float(np.abs(s_a - s_b).max()))
        n_cmp += len(i_a)
    return bad, n_cmp, max_diff


# the model config keys a catalog-softmax phase reports and checks
CATALOG_MODEL_KEYS = ("hidden_size", "layer_num", "dropout_rate", "dropout", "encoder_dims",
                      "decoder_dims", "activation")


def catalog_softmax_phase(device, tag, model_name, expected, batch_size=512):
    """NARM, STAMP or MultiDAE training and serving at full width on the
    synthetic ml-1m shape: 20 timed steps through ``_fused_softmax_step``
    (K7, K8, K9 at one query row a sequence or a user), one step held to
    the plain path (the GRU's time loop where there is a GRU, materialized
    scores), every user served, the first two requests held to the plain
    path (NARM) or to the model copied to the CPU (STAMP and MultiDAE, whose
    serving runs no kernel and no GRU). A user model (MultiDAE) reports its
    history width W, and the bytes of the ``[B, W, D]`` rows its history
    bag sums (``F.embedding_bag`` reads them without storing them)."""
    import numpy as np
    import torch
    from recstudio_torch.serving import Predictor
    model, conf, ds, tst, name, etl_s = training_model(device, model_name, batch_size)
    mc, tc = conf["model"], conf["train"]
    width = dict(L=ds.max_seq_len) if hasattr(ds, "max_seq_len") else \
        dict(W=model.history_width)
    shape = dict(B=tc["batch_size"], **width, D=model.embed_dim,
                 items=ds.num_items - 1, lr=tc["learning_rate"], learner=tc["learner"],
                 **{k: mc[k] for k in CATALOG_MODEL_KEYS if k in mc})
    if tc.get("weight_decay"):
        shape["weight_decay"] = tc["weight_decay"]
    check({k: v for k, v in shape.items() if k != "W"} == expected,
          f"phase {tag} config {shape}")
    check(model._use_fused_softmax(), f"phase {tag} does not take the fused softmax step")
    gru = getattr(model.query_encoder, "gru", None)

    def set_path(plain, fused="auto"):
        if gru is not None:
            gru.plain = plain
        model.config["train"]["fused_softmax"] = fused

    metrics, losses, train_counts, ((loss_p, max_abs, ok),) = \
        steps_and_comparison(model, set_path, (True, "false"))
    loss_k = metrics["kernel_loss"]

    pred = Predictor(model, max_batch=256, k=20, train_data=tst).warm()
    (scores, ids, targets), serve_counts = counted(lambda: serve_split(pred, model, tst, 256))
    stats = pred.stats()
    fields = sorted(model.query_fields)
    if gru is not None:
        bad, n_cmp, max_diff = plain_serving_diffs(pred, model, tst, [gru])
        held_to = "plain path (the GRU's time loop)"
    else:
        cpu_pred = Predictor(cpu_copy(model, tst), max_batch=256, k=20, train_data=tst)
        bad, n_cmp, max_diff = served_diffs(pred, cpu_pred, tst, fields)
        held_to = "the model copied to the CPU"
    counts = {k: train_counts[k] + serve_counts[k] for k in train_counts}
    out = {"phase": tag, "model": model_name, "dataset": name, "shape": shape, "etl_s": etl_s,
           **({"bag_bytes": 4 * shape["B"] * shape["W"] * shape["D"]} if "W" in shape else {}),
           "launches": counts, "train_launches": train_counts, "serve_launches": serve_counts,
           **metrics, "plain_loss": loss_p, "grad_max_abs_err": max_abs,
           "served": len(ids), **{"serve_" + k: v for k, v in stats.items()},
           **rank_metrics(ids, targets), "served_held_to": held_to, "held_rows": n_cmp,
           "held_rows_disagreeing": bad, "held_max_score_diff": max_diff, "tol": TOL_SCORES}
    if gru is not None:
        out["gru"] = gru_versus_plain(device, gru, shape["B"], shape["L"], shape["D"])
        out["input_dropout_mask_ms"] = input_mask_ms(device, shape["B"], shape["L"], shape["D"],
                                                     mc["dropout_rate"][0])
    emit("PHASE", out)
    for kernel in CLSE_KERNELS:
        check(train_counts[kernel] > 0, f"phase {tag} training launched no {kernel}")
    if gru is not None:
        check(train_counts["gru_layer_cudnn"] > 0, f"phase {tag} ran no GRU through cuDNN")
        check(serve_counts["gru_layer_cudnn"] > 0, f"phase {tag} served no GRU through cuDNN")
        check(out["gru"]["ok"], f"phase {tag}: the cuDNN GRU disagrees with its time loop: "
                                f"{out['gru']['max_abs_err']}, {out['gru']['grad_max_abs_err']}")
    check(bool(torch.isfinite(losses).all()), f"phase {tag} loss not finite")
    check(abs(loss_k - loss_p) <= TOL_LOSS * abs(loss_p),
          f"phase {tag} loss {loss_k} vs {loss_p}")
    check(ok, f"phase {tag} gradients disagree with the plain path: {max_abs}")
    check(np.isfinite(scores).all() and scores.shape == (len(tst.data_index), 20),
          f"phase {tag} scores")
    check(bad == 0, f"phase {tag}: {bad} of {n_cmp} lists differ from the {held_to}'s")
    return out


def phase_k(device):
    """NARM at full width: the GRU through cuDNN, K7-K9 at 512 rows."""
    return catalog_softmax_phase(device, "K", "NARM", dict(
        B=512, L=200, D=64, items=3706, lr=1e-3, learner="adam", hidden_size=128, layer_num=1,
        dropout_rate=[0.25, 0.5]))


def phase_l(device):
    """STAMP at full width: K7-K9 at 512 rows."""
    return catalog_softmax_phase(device, "L", "STAMP", dict(
        B=512, L=200, D=64, items=3706, lr=1e-3, learner="adam"))


def phase_m(device):
    """GRU4Rec at full width: timed steps (the GRU through cuDNN, no kernel
    of the port), one step held to the model copied to the CPU."""
    import torch
    model, conf, ds, tst, name, etl_s = training_model(device, "GRU4Rec", 512)
    mc, tc = conf["model"], conf["train"]
    shape = dict(B=tc["batch_size"], L=ds.max_seq_len, D=model.embed_dim,
                 hidden_size=mc["hidden_size"], layer_num=mc["layer_num"],
                 dropout_rate=mc["dropout_rate"], negatives=tc["negative_count"],
                 items=ds.num_items - 1)
    check(shape == dict(B=512, L=200, D=64, hidden_size=128, layer_num=1, dropout_rate=0.3,
                        negatives=1, items=3706), f"phase M config {shape}")
    check(not model._use_fused_softmax(), "phase M takes the softmax step")
    torch.cuda.reset_peak_memory_stats()
    steps, times, losses, counts = timed_steps(model, model._epoch_batches())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # one step on the card held to the same model on the CPU: same batch,
    # negatives and dropout seeds (the masks are a function of the seed)
    batch = steps[-1]
    gen = torch.Generator(device=device)
    gen.manual_seed(12)
    neg = torch.randint(1, ds.num_items, (tc["batch_size"], 1), generator=gen, device=device)
    state = model.generator.get_state()
    loss_k, grads_k = step_on(model, batch, neg)
    cpu = cpu_copy(model, tst)
    cpu.generator.set_state(state)
    loss_c, grads_c = step_on(cpu, {k: v.cpu() for k, v in batch.items()}, neg.cpu())
    max_abs, ok = grad_errors({k: v.cpu() for k, v in grads_k.items()}, grads_c)
    p50 = times[len(times) // 2]
    out = {"phase": "M", "model": "GRU4Rec", "dataset": name, "shape": shape, "etl_s": etl_s,
           "launches": counts, "steps": len(times), "step_ms_p50": p50,
           "step_ms_max": times[-1], "examples_per_s": tc["batch_size"] / (p50 / 1e3),
           "input_dropout_mask_ms": input_mask_ms(device, shape["B"], shape["L"], shape["D"],
                                                  shape["dropout_rate"]),
           "loss_first": float(losses[0]), "loss_last": float(losses[-1]), "peak_mem_gb": peak,
           "card_loss": loss_k, "cpu_loss": loss_c, "grad_max_abs_err": max_abs,
           "grad_tol": TOL_GRAD, "loss_tol": TOL_LOSS}
    emit("PHASE", out)
    check(counts["gru_layer_cudnn"] > 0, "phase M ran no GRU through cuDNN")
    check(all(v == 0 for k, v in counts.items() if k != "gru_layer_cudnn"),
          f"phase M launched a kernel: {counts}")
    check(bool(torch.isfinite(losses).all()), "phase M loss not finite")
    check(abs(loss_k - loss_c) <= TOL_LOSS * abs(loss_c), f"phase M loss {loss_k} vs {loss_c}")
    check(ok, f"phase M gradients disagree with the CPU copy's: {max_abs}")
    return out


def phase_n(device):
    """NARM and STAMP the way users start them, ``quickstart.run`` on
    ml-100k, held to their JAX bands."""
    return [fit_phase(device, "N", "NARM", NARM_TRAIN_REFERENCE,
                      {"hidden": "hidden_size", "layers": "layer_num",
                       "dropout": "dropout_rate"},
                      dict(embed_dim=64, hidden=128, layers=1, dropout=[0.25, 0.5], L=20,
                           batch=512), CLSE_KERNELS + ("gru_layer_cudnn",), quickstart=True),
            fit_phase(device, "N", "STAMP", STAMP_TRAIN_REFERENCE, {},
                      dict(embed_dim=64, L=20, batch=512), CLSE_KERNELS, quickstart=True)]


def phase_o(device):
    """MultiDAE at full width: K7-K9 at 256 user rows, D 200."""
    return catalog_softmax_phase(device, "O", "MultiDAE", dict(
        B=256, D=200, items=3706, lr=1e-2, learner="adam", weight_decay=1e-5, dropout=0.5,
        encoder_dims=[64, 32], decoder_dims=[32, 64], activation="relu"), batch_size=256)


def vae_step(model, batch, eps):
    """One MultiVAE training step's loss and gradients with ``eps``."""
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    model.net.train()
    model.net.zero_grad(set_to_none=True)
    loss = model.training_step(batch, eps=eps)
    loss.backward()
    zero_pad_rows_in_grads(model.net)
    model.net.eval()
    return float(loss.detach()), {n: p.grad.detach().clone()
                                  for n, p in model.net.named_parameters()}


def phase_p(device):
    """MultiVAE at full width: timed steps (materialized scores, no kernel
    of the port), one step held to the model copied to the CPU with the same
    eps, dropout seed and anneal at its cap, every user served."""
    import numpy as np
    import torch
    from recstudio_torch.serving import Predictor
    model, conf, ds, tst, name, etl_s = training_model(device, "MultiVAE", 500)
    mc, tc = conf["model"], conf["train"]
    shape = dict(B=tc["batch_size"], W=model.history_width, D=model.embed_dim,
                 items=ds.num_items - 1, lr=tc["learning_rate"], learner=tc["learner"],
                 weight_decay=tc["weight_decay"],
                 **{k: mc[k] for k in CATALOG_MODEL_KEYS if k in mc})
    check({k: v for k, v in shape.items() if k != "W"} == dict(
        B=500, D=600, items=3706, lr=1e-3, learner="adam", weight_decay=1e-5, dropout_rate=0.5,
        encoder_dims=[200], decoder_dims=[200], activation="tanh"), f"phase P config {shape}")
    torch.cuda.reset_peak_memory_stats()
    steps, times, losses, counts = timed_steps(model, epoch_stream(model))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # one step on the card held to the same model on the CPU: same batch,
    # eps and dropout seed (the mask is a function of the seed), the KL
    # term at its largest weight
    batch = steps[-1]
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    eps = torch.randn((tc["batch_size"], mc["encoder_dims"][-1]), generator=gen, device=device)
    state = model.generator.get_state()
    model.states["anneal"] = float(tc["anneal_max"])
    loss_k, grads_k = vae_step(model, batch, eps)
    cpu = cpu_copy(model, tst)
    cpu.generator.set_state(state)
    cpu.states["anneal"] = float(tc["anneal_max"])
    loss_c, grads_c = vae_step(cpu, {k: v.cpu() for k, v in batch.items()}, eps.cpu())
    max_abs, ok = grad_errors({k: v.cpu() for k, v in grads_k.items()}, grads_c)

    pred = Predictor(model, max_batch=256, k=20, train_data=tst).warm()
    (scores, ids, targets), serve_counts = counted(lambda: serve_split(pred, model, tst, 256))
    stats = pred.stats()
    cpu_pred = Predictor(cpu, max_batch=256, k=20, train_data=tst)
    bad, n_cmp, max_diff = served_diffs(pred, cpu_pred, tst, sorted(model.query_fields))
    p50 = times[len(times) // 2]
    out = {"phase": "P", "model": "MultiVAE", "dataset": name, "shape": shape, "etl_s": etl_s,
           "bag_bytes": 4 * shape["B"] * shape["W"] * shape["D"],
           "launches": {k: counts[k] + serve_counts[k] for k in counts},
           "train_launches": counts, "serve_launches": serve_counts, "steps": len(times),
           "step_ms_p50": p50, "step_ms_max": times[-1],
           "examples_per_s": tc["batch_size"] / (p50 / 1e3), "loss_first": float(losses[0]),
           "loss_last": float(losses[-1]), "peak_mem_gb": peak, "anneal": tc["anneal_max"],
           "card_loss": loss_k, "cpu_loss": loss_c, "grad_max_abs_err": max_abs,
           "grad_tol": TOL_GRAD, "loss_tol": TOL_LOSS, "served": len(ids),
           **{"serve_" + k: v for k, v in stats.items()}, **rank_metrics(ids, targets),
           "served_held_to": "the model copied to the CPU", "held_rows": n_cmp,
           "held_rows_disagreeing": bad, "held_max_score_diff": max_diff, "tol": TOL_SCORES}
    emit("PHASE", out)
    check(not any(out["launches"].values()), f"phase P launched a kernel: {out['launches']}")
    check(bool(torch.isfinite(losses).all()), "phase P loss not finite")
    check(abs(loss_k - loss_c) <= TOL_LOSS * abs(loss_c), f"phase P loss {loss_k} vs {loss_c}")
    check(ok, f"phase P gradients disagree with the CPU copy's: {max_abs}")
    check(np.isfinite(scores).all() and scores.shape == (len(tst.data_index), 20),
          "phase P scores")
    check(bad == 0, f"phase P: {bad} of {n_cmp} lists differ from the CPU copy's")
    return out


def phase_q(device):
    """MultiDAE and MultiVAE the way users start them, ``quickstart.run`` on
    ml-100k, held to their JAX bands."""
    keys = {"encoder_dims": "encoder_dims", "decoder_dims": "decoder_dims",
            "activation": "activation"}
    return [fit_phase(device, "Q", "MultiDAE", MULTIDAE_TRAIN_REFERENCE,
                      dict(keys, dropout="dropout"),
                      dict(embed_dim=200, encoder_dims=[64, 32], decoder_dims=[32, 64],
                           activation="relu", dropout=0.5, batch=256, weight_decay=1e-5),
                      CLSE_KERNELS, quickstart=True),
            fit_phase(device, "Q", "MultiVAE", MULTIVAE_TRAIN_REFERENCE,
                      dict(keys, dropout="dropout_rate"),
                      dict(embed_dim=600, encoder_dims=[200], decoder_dims=[200],
                           activation="tanh", dropout=0.5, batch=500, weight_decay=1e-5),
                      (), quickstart=True)]


# ---------------------------------------------------------------------------
def ranker_step(model, batch, gen_state):
    """One training step's loss and gradients from the dropout generator
    state ``gen_state``: the same seeds, so the same masks, on any device."""
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    model.generator.set_state(gen_state)
    model.net.train()
    model.net.zero_grad(set_to_none=True)
    loss = model.training_step(batch)
    loss.backward()
    zero_pad_rows_in_grads(model.net)
    model.net.eval()
    return float(loss.detach()), {n: p.grad.detach().clone()
                                  for n, p in model.net.named_parameters()}


def eval_probs(model, split):
    """``evaluate``'s scores of a split (its staged eval batches), as
    probabilities, true rows only: an array, or ``{rating: array}`` for a
    multitask ranker."""
    import numpy as np
    import torch
    out = []
    with torch.no_grad():
        for b in model._eval_batches(split):
            s, n = model.score(b), int(b["_size"])
            out.append({r: torch.sigmoid(v)[:n].cpu().numpy() for r, v in s.items()}
                       if isinstance(s, dict) else torch.sigmoid(s)[:n].cpu().numpy())
    if isinstance(out[0], dict):
        return {r: np.concatenate([o[r] for o in out]) for r in out[0]}
    return np.concatenate(out)


_CRITEO = {}


def criteo_setup(prepared=None):
    """Phase R's data and DeepFM config (the JAX bench's ``ctr_scale``):
    ``(reference, dataset, (train, val, test), DeepFM class, config, gen s,
    ETL s)``; set up once a process from ``prepared`` (``start_data("R")``,
    given by phase R; phase W trains AutoInt on it), a fresh copy of the
    config each call."""
    if "setup" not in _CRITEO:
        check(prepared is not None, "phase W trains on phase R's data: run phase R first")
        _CRITEO["setup"] = _criteo_setup(prepared)
    ref, ds, splits, cls, conf, gen_s, etl_s = _CRITEO["setup"]
    return ref, ds, splits, cls, json.loads(json.dumps(conf)), gen_s, etl_s


def ctr_dataset(shape_name, rows):
    """``generate_ctr(shape_name)`` at ``rows`` (seed 11, the shape's
    vocabularies) built as the JAX bench builds it (``fmeval``, entry split
    [0.8, 0.1, 0.1] after ``np.random.seed(11)``): ``(dataset, splits, gen
    s, ETL s)``."""
    import numpy as np
    from recstudio_torch.data import TripletDataset
    from recstudio_torch.data.synthetic import ctr_shape_vocabs, generate_ctr
    t0 = time.perf_counter()
    name, config = generate_ctr(shape_name, rows, seed=11, vocabs=ctr_shape_vocabs(shape_name))
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.random.seed(11)
    ds = TripletDataset(name, config=config)
    splits = ds.build(fmeval=True, split_mode="entry", split_ratio=[0.8, 0.1, 0.1])
    etl_s = time.perf_counter() - t0
    check(ds.num_inters == rows and len(ds.field2type) == 40 and ds.fuid is None,
          f"{shape_name} dataset {ds.num_inters} rows, {len(ds.field2type)} fields")
    return ds, splits, gen_s, etl_s


def criteo_rows() -> int:
    with open(CRITEO_TRAIN_REFERENCE) as f:
        return int(json.load(f)["rows"])


def _criteo_setup(prepared):
    from recstudio_torch.utils import get_model
    with open(CRITEO_TRAIN_REFERENCE) as f:
        ref = json.load(f)
    ds, splits, gen_s, etl_s, _ = load_data(prepared)
    B = ref["batch_size"]
    cls, conf = get_model("DeepFM")
    conf["train"].update(epochs=1, batch_size=B, learner="adam", learning_rate=1e-3,
                         seed=2022)
    conf["eval"].update(batch_size=B, val_metrics=["auc"], test_metrics=["auc", "logloss"],
                        save_path=SAVE_DIR)
    return ref, ds, splits, cls, conf, gen_s, etl_s


def phase_r(device, prepared):
    """DeepFM at criteo-1m-shape (the JAX bench's ``ctr_scale``): a one-epoch
    fit and four more epochs, the test AUC and logloss after the fifth held
    to the JAX bands, 20 timed steps, one step held to the CPU copy, the
    epoch's busy share, dropout masks, a sparse_adam epoch (the packed
    row-sparse step), and ``ScorePredictor`` at 8192 rows a request."""
    import numpy as np
    import torch
    from recstudio_torch.ops.dropout import SITE_HIDDEN, keep_scale
    from recstudio_torch.serving import ScorePredictor
    ref, ds, (trn, val, tst), cls, conf, gen_s, etl_s = criteo_setup(prepared)
    name, rows, B = ds.name, ref["rows"], ref["batch_size"]
    emb_rows = sum(ds.num_values(f) for f, t in ds.field2type.items() if t == "token")

    def drive():
        model = cls(conf, device=device)
        t = time.perf_counter()
        model.fit(trn, None)
        fit_s = time.perf_counter() - t
        log = [{"epochs": 1, **model.evaluate(tst, verbose=False)}]
        for n in range(1, ref["epochs"]):
            model.training_epoch(n)
            log.append({"epochs": n + 1, **model.evaluate(tst, verbose=False)})
        return model, fit_s, log

    (model, fit_s, test_log), counts = counted(drive)
    result = test_log[-1]
    mc = model.config["model"]
    shape = dict(embed_dim=model.embed_dim, mlp=mc["mlp_layer"], activation=mc["activation"],
                 dropout=mc["dropout"], fields=len(model.net.embedding.field_specs), batch=B)
    check(shape == dict(embed_dim=10, mlp=[256, 256, 256], activation="tanh", dropout=0.3,
                        fields=39, batch=8192), f"phase R config {shape}")
    n = len(trn.data_index)
    steps = -(-n // B)

    # 20 timed steps on device-resident batches, peak memory
    batches = list(itertools.islice(model._epoch_batches(), 23))
    torch.cuda.reset_peak_memory_stats(device)
    model.net.train()
    step_ms = []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model._grad_step(batch)
        torch.cuda.synchronize()
        if i >= 3:
            step_ms.append((time.perf_counter() - t) * 1e3)
    model.net.eval()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    step_p50 = sorted(step_ms)[len(step_ms) // 2]

    # an epoch, then the same epoch profiled
    torch.cuda.synchronize()
    t = time.perf_counter()
    model.training_epoch(1)
    epoch_s = time.perf_counter() - t
    host_ms, busy_ms = busy_share(lambda: model.training_epoch(2))

    # the MLP's dropout masks of one step: one before each of its 4 layers
    widths = [model.net.mlp.dense_0.in_features] + list(mc["mlp_layer"])
    mask_ms = time_ms(lambda: [keep_scale((B, w), mc["dropout"], 12345, SITE_HIDDEN, device)
                               for w in widths])

    # one step on the card held to the CPU copy (same batch, same dropout
    # seeds), and repeated on the card
    batch = batches[0]
    gen = model.generator.get_state()
    loss_k, grads_k = ranker_step(model, batch, gen)
    loss_k2, grads_k2 = ranker_step(model, batch, gen)
    bitwise = loss_k == loss_k2 and all(torch.equal(grads_k[k], grads_k2[k]) for k in grads_k)
    cpu = cpu_copy(model, trn)
    loss_c, grads_c = ranker_step(cpu, {k: v.cpu() for k, v in batch.items()}, gen)
    max_abs, ok = grad_errors({k: v.cpu() for k, v in grads_k.items()}, grads_c)
    del cpu

    # evaluation rate (the split's batches are staged)
    model._eval_epoch(tst, ["auc", "logloss"], [None])
    torch.cuda.synchronize()
    t = time.perf_counter()
    model._eval_epoch(tst, ["auc", "logloss"], [None])
    eval_s = time.perf_counter() - t

    # sparse_adam (the packed row-sparse step): fit's epoch warms it; a timed
    # one, a profiled one
    lconf = json.loads(json.dumps(conf))
    lconf["train"]["learner"] = "sparse_adam"
    lazy = cls(lconf, device=device).fit(trn, None)
    lazy_loss = lazy.epoch_log[0]["train_loss"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    lazy.training_epoch(1)
    lazy_epoch_s = time.perf_counter() - t
    lazy_host_ms, lazy_busy_ms = busy_share(lambda: lazy.training_epoch(2))
    lazy_opt = type(lazy.optimizer).__name__
    lazy_packed = lazy._ctr_sparse_enabled()
    del lazy

    # ScorePredictor at 8192 rows a request, held to predict()
    pred = ScorePredictor(model, max_batch=B, train_data=trn)
    fields = [f for f in tst.inter_feat.fields if f != model.frating]
    starts = range(0, min(8 * B, len(tst.data_index)), B)
    requests = [{f: tst.inter_feat.get_col(f)[tst.data_index[i:i + B]] for f in fields}
                for i in starts]
    pred.warm(requests[0])
    served = [pred(r) for r in requests]
    want = [model.predict(tst._get_pos_batch(np.arange(i, i + len(r)))) for i, r in zip(
        starts, served)]
    serve_diff = max(float(np.abs(a - b).max()) for a, b in zip(served, want))

    lo, hi = ref["auc_band"]
    llo, lhi = ref["logloss_band"]
    out = {"phase": "R", "model": "DeepFM", "dataset": name, "rows": rows,
           "train_rows": n, "test_rows": len(tst.data_index), "config": shape,
           "emb_rows": emb_rows,
           "launches": counts, "gen_s": gen_s, "etl_s": etl_s, "fit_s": fit_s,
           "fit_epoch_s": model.epoch_log[0]["train_s"], "steps_per_epoch": steps,
           "step_ms_p50": step_p50, "step_ms_min": min(step_ms),
           "examples_per_s": B / step_p50 * 1e3, "peak_mem_gb": peak_gb,
           "epoch_s": epoch_s, "epoch_examples_per_s": n / epoch_s,
           "profiled_epoch_host_ms": host_ms, "profiled_epoch_busy_ms": busy_ms,
           "busy_share_of_epoch": None if busy_ms is None else busy_ms / (epoch_s * 1e3),
           "dropout_mask_ms_per_step": mask_ms,
           "dropout_mask_elements_per_step": B * sum(widths),
           "dropout_mask_share_of_step": mask_ms / step_p50,
           "one_epoch_test_auc": test_log[0]["auc"],
           "one_epoch_test_logloss": test_log[0]["logloss"], "band_epochs": ref["epochs"],
           "test_auc": result["auc"], "test_logloss": result["logloss"], "test_log": test_log,
           "jax_band_auc": [lo, hi], "jax_band_logloss": [llo, lhi],
           "jax_untrained_auc": ref["untrained_auc"],
           "jax_runs": [{k: r[k] for k in ("seed", "auc", "logloss", "untrained_auc")}
                        for r in ref["runs"]], "eval_s": eval_s,
           "eval_rows_per_s": len(tst.data_index) / eval_s,
           "cpu_loss": loss_c, "card_loss": loss_k, "grad_max_abs_err": max_abs,
           "grad_tol": TOL_GRAD, "loss_tol": TOL_LOSS, "step_bitwise_repeat": bitwise,
           "sparse_adam": {"optimizer": lazy_opt, "packed_step": lazy_packed,
                           "first_epoch_loss": lazy_loss,
                           "epoch_s": lazy_epoch_s, "profiled_epoch_host_ms": lazy_host_ms,
                           "profiled_epoch_busy_ms": lazy_busy_ms,
                           "busy_share_of_epoch": None if lazy_busy_ms is None
                           else lazy_busy_ms / (lazy_epoch_s * 1e3)},
           "serve_max_abs_diff_vs_predict": serve_diff,
           **{"serve_" + k: v for k, v in pred.stats().items()}}
    emit("PHASE", out)
    check(not any(counts.values()), f"phase R launched a kernel: {counts}")
    check(np.isfinite(model.epoch_log[0]["train_loss"]) and np.isfinite(lazy_loss),
          "phase R loss not finite")
    check(lo > ref["untrained_auc"] + AUC_MARGIN,
          f"phase R: the JAX band [{lo}, {hi}] does not clear the untrained AUC "
          f"{ref['untrained_auc']} by {AUC_MARGIN}")
    check(lo <= result["auc"] <= hi,
          f"phase R test AUC {result['auc']} outside the JAX band [{lo}, {hi}]")
    check(llo <= result["logloss"] <= lhi,
          f"phase R test logloss {result['logloss']} outside the JAX band [{llo}, {lhi}]")
    check(abs(loss_k - loss_c) <= TOL_LOSS * abs(loss_c), f"phase R loss {loss_k} vs {loss_c}")
    check(ok, f"phase R gradients disagree with the CPU copy's: {max_abs}")
    check(lazy_opt == "LazyAdam" and lazy_packed,
          f"phase R sparse_adam ran {lazy_opt}, packed step {lazy_packed}")
    check(serve_diff <= TOL_PROB, f"phase R ScorePredictor differs from predict by {serve_diff}")
    check(pred.stats()["requests"] == len(starts) == min(8, -(-len(tst.data_index) // B)),
          "phase R served other than 8 requests")
    return out


def ranker_fit_phase(device, tag, model_name, expected, kernels=(), profile=True):
    """A ranker the way users start it, ``quickstart.run(model_name,
    "ml-100k")`` at the repo's config for at most its reference's epochs
    (early stopping may end it sooner), test AUC held to
    its JAX band (which must clear the untrained AUC by ``AUC_MARGIN``),
    one epoch profiled (``profile``), every test row served through
    ``ScorePredictor(max_batch=256)``, whose probabilities must be
    ``evaluate``'s and ``predict``'s. Its batch norms must be calibrated
    (count > 0). It launches ``kernels`` and no other."""
    import numpy as np
    from recstudio_torch import eval as ev
    from recstudio_torch.models.module.layers import SimpleBatchNorm
    from recstudio_torch.quickstart import run
    from recstudio_torch.serving import ScorePredictor
    import torch
    with open(ML100K_TRAIN_REFERENCE.format(model_name.lower())) as f:
        ref = json.load(f)

    def drive():
        t0 = time.perf_counter()
        model, (trn, _, tst), result = run(
            model_name, "ml-100k", verbose=False, device=device,
            model_config={"train": {"epochs": ref["epochs"]}, "eval": {"save_path": SAVE_DIR}})
        run_s = time.perf_counter() - t0
        size = 256
        fields = ("user_id", "item_id", "timestamp")
        rows = tst.data_index
        pred = ScorePredictor(model, max_batch=size, train_data=trn)
        requests = [{f: tst.inter_feat.get_col(f)[rows[i:i + size]] for f in fields}
                    for i in range(0, len(rows), size)]
        pred.warm(requests[0])
        probs = np.concatenate([pred(r) for r in requests])
        return model, trn, tst, result, run_s, pred, probs

    (model, trn, tst, result, run_s, pred, probs), counts = counted(drive)
    mc, tc = model.config["model"], model.config["train"]
    shape = dict(embed_dim=model.embed_dim, **{k: mc[k] for k in expected if k != "embed_dim"},
                 batch=tc["batch_size"], epochs=tc["epochs"],
                 patience=tc["early_stop_patience"], fmeval=trn.fmeval)
    check(shape == dict(expected, batch=512, epochs=ref["epochs"],
                        patience=ref["early_stop_patience"], fmeval=True),
          f"phase {tag} {model_name} config {shape}")
    want = eval_probs(model, tst)
    served_diff = float(np.abs(probs - want).max())
    tst.use_field = model.fields
    predicted = np.concatenate([model.predict(tst._get_pos_batch(np.arange(
        i, min(i + 4096, len(tst.data_index))))) for i in range(0, len(tst.data_index), 4096)])
    predict_diff = float(np.abs(probs - predicted).max())
    served_auc = float(ev.auc(torch.from_numpy(probs),
                              torch.from_numpy(tst.inter_feat.get_col("rating")[
                                  tst.data_index])))
    bn_counts = [float(m.count) for m in model.net.modules() if isinstance(m, SimpleBatchNorm)]
    train_s = sorted(e["train_s"] for e in model.epoch_log)
    epoch_s = train_s[len(train_s) // 2]
    host_ms, busy_ms = busy_share(lambda: model.training_epoch(0)) if profile else (None, None)
    steps = -(-model._epoch_rows // tc["batch_size"])
    lo, hi = ref["auc_band"]
    out = {"phase": tag, "model": model_name, "dataset": "ml-100k",
           "entry": "quickstart.run", "config": shape, "launches": counts,
           "run_s": run_s, "epochs_run": len(model.epoch_log),
           "best_epoch": model.callback.best_epoch,
           "fit_s": sum(e["train_s"] + e["eval_s"] for e in model.epoch_log),
           "epoch_s_p50": epoch_s, "steps_per_epoch": steps,
           "step_ms_p50": epoch_s / steps * 1e3,
           "eval_s_p50": sorted(e["eval_s"] for e in model.epoch_log)[
               len(model.epoch_log) // 2],
           "profiled_epoch_host_ms": host_ms, "profiled_epoch_busy_ms": busy_ms,
           "busy_share_of_epoch": None if busy_ms is None else busy_ms / (epoch_s * 1e3),
           "test_auc": result["auc"], "test_logloss": result["logloss"],
           "jax_band_auc": [lo, hi], "jax_untrained_auc": ref["untrained_auc"],
           "jax_runs": ref["runs"], "bn_counts": bn_counts, "served_rows": len(probs),
           "served_auc": served_auc, "served_max_abs_diff_vs_evaluate": served_diff,
           "served_max_abs_diff_vs_predict": predict_diff,
           **{"serve_" + k: v for k, v in pred.stats().items()}}
    emit("PHASE", out)
    others = {k: v for k, v in counts.items() if k not in kernels and v}
    check(not others, f"phase {tag} {model_name} launched {others}")
    check(all(counts[k] > 0 for k in kernels), f"phase {tag} {model_name}: {counts}")
    check(all(np.isfinite(e["train_loss"]) for e in model.epoch_log),
          f"phase {tag} {model_name} loss")
    check(lo > ref["untrained_auc"] + AUC_MARGIN,
          f"phase {tag} {model_name}: the JAX band [{lo}, {hi}] does not clear the untrained "
          f"AUC {ref['untrained_auc']} by {AUC_MARGIN}")
    check(lo <= result["auc"] <= hi, f"phase {tag} {model_name} test AUC {result['auc']} "
                                     f"outside the JAX band [{lo}, {hi}]")
    check(all(c > 0 for c in bn_counts), f"phase {tag} {model_name} BN counts {bn_counts}")
    check(len(probs) == len(tst.data_index) and max(served_diff, predict_diff) <= TOL_PROB,
          f"phase {tag} {model_name}: served probabilities differ from evaluate's by "
          f"{served_diff}, from predict's by {predict_diff}")
    return out


def phase_s(device):
    """DeepFM, FM and LR the way users start them (``ranker_fit_phase``).
    No kernel."""
    return [ranker_fit_phase(device, "S", name, expected) for name, expected in (
        ("DeepFM", dict(embed_dim=10, mlp_layer=[256, 256, 256], dropout=0.3)),
        ("FM", dict(embed_dim=10)), ("LR", dict(embed_dim=1)))]


# ---------------------------------------------------------------------------
# phase T's amazon-book-shape dataset and splits, which phase Y trains on
_AMAZON = {}
# phase T's steps profiled for the card's busy share (of an epoch's 293)
T_PROFILE_STEPS = 100


def amazon_dataset():
    """Phase T's data: ``generate("amazon-book-shape")`` (seed 7) built as
    LightGCN's dataset after ``seed_everything(2022)``: ``(dataset, (train,
    test), gen s, ETL s)``."""
    from recstudio_torch.data.synthetic import SHAPES, generate
    from recstudio_torch.utils import get_model, seed_everything
    t0 = time.perf_counter()
    name, config = generate("amazon-book-shape", *SHAPES["amazon-book-shape"], seed=7)
    gen_s = time.perf_counter() - t0
    cls, conf = get_model("LightGCN")
    seed_everything(2022)
    t0 = time.perf_counter()
    ds = cls._get_dataset_class()(name, config=config)
    trn, _, tst = ds.build(**conf["data"])
    return ds, (trn, tst), gen_s, time.perf_counter() - t0


def phase_t(device, prepared):
    """LightGCN at amazon-book-shape on the ELL route (the JAX bench's
    ``graph_scale``): graph build, 20 timed steps, one step held to the
    edge-list route and to a bitwise repeat, one layer's forward against
    ``torch.sparse.mm`` of the same CSR matrix, the busy share of
    ``T_PROFILE_STEPS`` steps, every test user evaluated. Its data comes
    from ``prepared`` (``start_data("T")``'s process)."""
    import numpy as np
    import torch
    from recstudio_torch.utils import get_model
    ds, (trn, tst), gen_s, etl_s, _ = load_data(prepared)
    name = ds.name
    cls, conf = get_model("LightGCN")
    _AMAZON.update(name=name, ds=ds, splits=(trn, tst), etl_s=etl_s)   # phase Y's too
    # 6 of the shape's 91,599 item ids are never drawn (seed 7)
    check((ds.num_users - 1, ds.num_items - 1, ds.num_inters) == (52643, 91593, 2_984_108),
          f"phase T dataset {ds.num_users - 1} x {ds.num_items - 1} x {ds.num_inters}")
    conf["train"].update(batch_size=8192)
    conf["eval"].update(batch_size=512, cutoff=[20], test_metrics=["ndcg", "recall"],
                        topk=100, save_path=SAVE_DIR)
    mc, tc = conf["model"], conf["train"]
    shape = dict(embed_dim=conf["model"]["embed_dim"], n_layers=mc["n_layers"],
                 l2=mc["l2_reg_weight"], batch=tc["batch_size"], lr=tc["learning_rate"],
                 learner=tc["learner"], negatives=tc["negative_count"],
                 split=conf["data"]["split_ratio"])
    check(shape == dict(embed_dim=64, n_layers=3, l2=1e-4, batch=8192, lr=1e-3,
                        learner="adam", negatives=1, split=[0.8, 0.1, 0.1]),
          f"phase T config {shape}")
    model = cls(conf, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model._init_model(trn)
    model._init_parameter(trn)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    check(model._prop_m is None and model._adj is None and model._ell is not None
          and model._sym_spmm is not None, "phase T: the graph did not take the ELL route")
    ell = model.ell_stats()
    model.optimizer = model._get_optimizer()
    model._setup_scan_epoch(trn)
    n_rows = model._epoch_rows
    steps_per_epoch = -(-n_rows // tc["batch_size"])

    torch.cuda.reset_peak_memory_stats()
    steps, times, losses, counts = timed_steps(model, epoch_stream(model))
    step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # one step on the ELL route, again, and on the edge-list route, from the
    # same parameters and generator states (so the same negatives)
    sym = model._sym_spmm

    def set_path(edges):
        model._sym_spmm = None if edges else sym

    batch = steps[-1]
    states = (model.generator.get_state(), model.device_generator.get_state())
    torch.cuda.reset_peak_memory_stats()
    loss_e, grads_e = path_loss_and_grads(model, batch, states, set_path, False)
    ell_step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss_r, grads_r = path_loss_and_grads(model, batch, states, set_path, False)
    loss_l, grads_l = path_loss_and_grads(model, batch, states, set_path, True)
    set_path(False)
    model.net.eval()
    bitwise = loss_e == loss_r and all(torch.equal(grads_e[k], grads_r[k]) for k in grads_e)
    grad_err, grads_ok = grad_errors(grads_e, grads_l)
    del grads_e, grads_r, grads_l

    # one propagation layer's forward: ELL, the edge list, torch.sparse.mm
    # of the same matrix in CSR (the yardstick; not used on the path)
    gen = torch.Generator(device=device)
    gen.manual_seed(2035)
    emb = torch.randn(model._num_nodes, 64, generator=gen, device=device)
    src = model._edges[0]
    crow = torch.cat([model._deg_in.new_zeros(1), torch.cumsum(model._deg_in, 0)])
    csr = torch.sparse_csr_tensor(crow, src.long(), model._edge_w,
                                  (model._num_nodes, model._num_nodes))
    with torch.no_grad():
        ref = torch.sparse.mm(csr, emb)
        layer_scale = float(ref.abs().max())
        layer_err = float((model._ell_apply(emb) - ref).abs().max())
        edge_err = float((model._edge_apply(emb) - ref).abs().max())
        del ref
        ell_ms = time_ms(lambda: model._ell_apply(emb))
        edge_ms = time_ms(lambda: model._edge_apply(emb))
        sparse_ms = time_ms(lambda: torch.sparse.mm(csr, emb))
    del emb, csr, crow

    # T_PROFILE_STEPS steps of an epoch under the profiler (the whole epoch,
    # 293 steps, was cut for the script's time limit, as a second one was
    # before it)
    model.net.train()
    window = list(itertools.islice(model._epoch_batches(), T_PROFILE_STEPS))
    window_losses = []
    host_ms, busy_ms = busy_share(lambda: window_losses.extend(model._grad_step(b)
                                                               for b in window))
    model.net.eval()
    del window
    model._eval_epoch(tst, ["ndcg", "recall"], [20])          # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    ev = model._eval_epoch(tst, ["ndcg", "recall"], [20])
    eval_s = time.perf_counter() - t
    p50 = times[len(times) // 2]
    out = {"phase": "T", "model": "LightGCN", "dataset": name, "users": ds.num_users - 1,
           "items": ds.num_items - 1, "inters": int(ds.num_inters), "train_rows": n_rows,
           "config": shape, "gen_s": gen_s, "etl_s": etl_s, "graph_build_s": graph_s,
           "nodes": model._num_nodes, "route": "ell", "ell": ell,
           "ell_slots_per_edge": ell["slots"] / ell["edges"], "launches": counts,
           "steps": len(times), "step_ms_p50": p50, "step_ms_max": times[-1],
           "examples_per_s": tc["batch_size"] / (p50 / 1e3), "loss_first": float(losses[0]),
           "loss_last": float(losses[-1]), "peak_mem_gb": step_peak,
           "ell_step_peak_mem_gb": ell_step_peak, "ell_loss": loss_e, "edge_list_loss": loss_l,
           "grad_max_abs_err": grad_err, "grad_tol": TOL_GRAD, "loss_tol": TOL_LOSS,
           "step_bitwise_repeat": bitwise, "layer_fwd_ms": {"ell": ell_ms, "edge_list": edge_ms,
                                                            "torch_sparse_mm_csr": sparse_ms},
           "layer_max_abs_err_vs_sparse_mm": {"ell": layer_err, "edge_list": edge_err},
           "layer_max_abs": layer_scale, "layer_tol": TOL_LAYER,
           "steps_per_epoch": steps_per_epoch, "profiled_steps": T_PROFILE_STEPS,
           "profiled_steps_host_ms": host_ms, "profiled_steps_busy_ms": busy_ms,
           "busy_share_of_steps": None if busy_ms is None else busy_ms / host_ms,
           "eval_users": len(tst.data_index), "eval_s": eval_s,
           "eval_queries_per_s": len(tst.data_index) / eval_s, **ev}
    emit("PHASE", out)
    check(not any(counts.values()), f"phase T launched a kernel: {counts}")
    check(all(np.isfinite(float(x)) for x in [*losses, *window_losses]), "phase T loss")
    check(abs(loss_e - loss_l) <= TOL_LOSS * abs(loss_l),
          f"phase T: ELL loss {loss_e} vs edge-list {loss_l}")
    check(grads_ok, f"phase T: ELL gradients disagree with the edge list's: {grad_err}")
    check(bitwise, "phase T: the ELL step does not repeat bit for bit")
    check(max(layer_err, edge_err) <= TOL_LAYER * layer_scale,
          f"phase T: a layer disagrees with torch.sparse.mm: {layer_err}, {edge_err}")
    check(np.isfinite(ev["ndcg@20"]) and np.isfinite(ev["recall@20"]), "phase T eval")
    return out


def phase_u(device):
    """LightGCN, NGCF and SimGCL the way users start them, ``quickstart.run``
    on ml-100k at the repo's configs for the epochs of their references,
    held to their JAX bands;
    LightGCN's served lists held to the CPU copy's."""
    graph = {"LightGCN": (dict(n_layers="n_layers", l2="l2_reg_weight",
                               prop_dtype="prop_dtype"),
                          dict(embed_dim=64, n_layers=3, l2=1e-4, prop_dtype="fp32", batch=512)),
             "NGCF": (dict(layer_size="layer_size", mess_dropout="mess_dropout",
                           l2="l2_reg_weight"),
                      dict(embed_dim=64, layer_size=[64] * 4, mess_dropout=[0.1] * 3, l2=1e-5,
                           batch=2048)),
             "SimGCL": (dict(n_layers="n_layers", eps="eps", cl_weight="cl_weight",
                             temperature="temperature", cl_neg_type="cl_neg_type",
                             l2="l2_reg_weight"),
                        dict(embed_dim=64, n_layers=3, eps=0.1, cl_weight=0.5, temperature=0.2,
                             cl_neg_type="all", l2=1e-4, batch=2048))}
    return [fit_phase(device, "U", name, ML100K_TRAIN_REFERENCE.format(name.lower()), keys,
                      expected, (), quickstart=True, cpu_lists=name == "LightGCN")
            for name, (keys, expected) in graph.items()]


# phase V: the JAX bench's ctr_bigvocab_sparse_adam (bench.py:307-327), its
# rows cut from 10,000,000 to 6,000,000, then 5,200,000, for the script's
# time limit, the vocabularies kept; the table (the ids the Zipf draws
# reach, 21.8 M rows at 10,000,000, 15.4 M at 6,000,000) must keep more than
# V_MIN_TABLE_ROWS rows
V_SHAPE = "criteo-10m-hugevocab-shape"
V_ROWS = 5_200_000
V_MIN_TABLE_ROWS = 13_000_000
# the epoch's steps run under the profiler for the card's busy share
V_PROFILE_STEPS = 100
# one packed step against one dense lazy-Adam step (tests/test_sparse_rows.py)
TOL_PACKED = (2e-4, 1e-6)  # (rtol, atol)


def net_state(model):
    """Copies of a model's parameters, buffers and optimizer state."""
    import copy
    return ({k: v.detach().clone() for k, v in model.net.state_dict().items()},
            copy.deepcopy(model.optimizer.state_dict()))


def set_net_state(model, state):
    """Load ``net_state``'s copies (the optimizer takes its state tensors as
    they are, so it is given copies of them, and ``state`` stays as saved)."""
    import copy
    sd, opt = state
    model.net.load_state_dict(sd)
    model.optimizer.load_state_dict(copy.deepcopy(opt))


def dense_copy(model, trn, state):
    """The port's DeepFM with ``sparse_rows: false`` (dense ``LazyAdam``)
    holding the packed model's ``state``: the tables' first D columns, their
    moments from the packed columns, the dense leaves' moments and the
    step count from its optimizer."""
    import torch
    conf = json.loads(json.dumps(model.config))
    conf["train"]["sparse_rows"] = "false"
    dense = type(model)(conf, device=model.device)
    dense._init_model(trn)
    dense._init_parameter(trn)
    sd, opt = state
    tables = {k: m.embed_dim for k, m in packed_table_names(model).items()}
    dense.net.load_state_dict({k: v[:, :tables[k]] if k in tables else v
                               for k, v in sd.items()})
    dense.optimizer = dense._get_optimizer()
    names = [n for n, _ in model.net.named_parameters()]
    moments = {names[i]: st for i, st in opt["state"].items()}
    with torch.no_grad():
        for name, p in dense.net.named_parameters():
            mu, nu = dense.optimizer.moments(p)
            if name in tables:
                d = tables[name]
                mu.copy_(sd[name][:, d:2 * d])
                nu.copy_(sd[name][:, 2 * d:])
            elif name in moments:
                mu.copy_(moments[name]["mu"])
                nu.copy_(moments[name]["nu"])
    dense.optimizer.param_groups[0]["count"] = opt["param_groups"][0]["count"]
    return dense


def packed_table_names(model):
    """``{state_dict name of a packed table: its Embeddings module}``."""
    return {f"{prefix}.token_embedding.weight": m for prefix, m in model.net.named_modules()
            if m in model._packed_embeddings()}


def packed_versus_dense(model, dense, state, after, tables):
    """Largest errors of the packed step's ``after`` state against the dense
    step's: parameters, and each table's mu and nu columns against the
    dense moments; and whether all lie within ``TOL_PACKED``."""
    import torch
    rtol, atol = TOL_PACKED
    errs, ok = {}, True
    params = dict(dense.net.named_parameters())
    for name, want in dense.net.state_dict().items():
        got = after[name]
        pairs = [("params", got, want)]
        if name in tables:
            d = tables[name].embed_dim
            mu, nu = dense.optimizer.moments(params[name])
            pairs = [("params", got[:, :d], want), ("mu", got[:, d:2 * d], mu),
                     ("nu", got[:, 2 * d:], nu)]
        for tag, g, w in pairs:
            diff = (g - w).abs()
            errs[f"{name}:{tag}"] = float(diff.max())
            ok &= bool((diff <= atol + rtol * w.abs()).all())
    return errs, ok


def phase_v(device, prepared):
    """DeepFM at criteo-10m-hugevocab-shape through the packed row-sparse
    step (the JAX bench's ``ctr_bigvocab_sparse_adam``): gen and ETL
    seconds (in ``start_data("V")``'s process), the
    table's rows, one epoch by ``fit`` and its test AUC, 20 timed steps,
    the card's busy share over ``V_PROFILE_STEPS`` profiled steps; one packed step held to one
    dense lazy-Adam step from the same state, to a bitwise repeat, and
    rows no lookup touched to be unchanged bit for bit; 20 steps of the
    dense ``LazyAdam`` on the same batches for comparison."""
    import numpy as np
    import torch
    from recstudio_torch.data.synthetic import ctr_shape_vocabs
    from recstudio_torch.utils import get_model
    rows = V_ROWS
    ds, (trn, val, tst), gen_s, etl_s, wait_s = load_data(prepared)
    check(ds.num_inters == rows, f"phase V dataset {ds.num_inters} rows, not {rows}")
    vocab_rows = sum(ds.num_values(f) for f, t in ds.field2type.items() if t == "token")
    B = 8192
    cls, conf = get_model("DeepFM")
    conf["train"].update(epochs=1, batch_size=B, learner="sparse_adam", sparse_rows="auto",
                         learning_rate=1e-3, seed=2022)
    conf["eval"].update(batch_size=B, val_metrics=["auc"], test_metrics=["auc", "logloss"],
                        save_path=SAVE_DIR)

    def drive():
        model = cls(conf, device=device)
        t = time.perf_counter()
        model.fit(trn, None)
        fit_s = time.perf_counter() - t
        return model, fit_s, model.evaluate(tst, verbose=False)

    (model, fit_s, result), counts = counted(drive)
    if model.ckpt_path and os.path.isfile(model.ckpt_path):
        os.remove(model.ckpt_path)          # a few GB of packed table
    engaged = model._ctr_sparse_enabled()
    tables = packed_table_names(model)
    mc = model.config["model"]
    shape = dict(embed_dim=model.embed_dim, mlp=mc["mlp_layer"], activation=mc["activation"],
                 dropout=mc["dropout"], fields=len(model.net.embedding.field_specs), batch=B)
    check(shape == dict(embed_dim=10, mlp=[256, 256, 256], activation="tanh", dropout=0.3,
                        fields=39, batch=8192), f"phase V config {shape}")
    check(vocab_rows > V_MIN_TABLE_ROWS,
          f"phase V table {vocab_rows} rows, not past {V_MIN_TABLE_ROWS}")
    check(engaged and sorted(tables) == ["embedding.token_embedding.weight",
                                         "linear.embedding.token_embedding.weight"],
          f"phase V: the packed step did not engage ({sorted(tables)})")
    table = model.net.embedding.token_embedding.weight
    n = len(trn.data_index)

    # 20 timed steps on device-resident batches, peak memory
    batches = list(itertools.islice(epoch_stream(model), 23))

    def timed(m):
        torch.cuda.reset_peak_memory_stats(device)
        m.net.train()
        ms = []
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            t = time.perf_counter()
            m._grad_step(batch)
            torch.cuda.synchronize()
            if i >= 3:
                ms.append((time.perf_counter() - t) * 1e3)
        m.net.eval()
        return sorted(ms)[len(ms) // 2], min(ms), torch.cuda.max_memory_allocated(device) / 1e9

    step_p50, step_min, peak_gb = timed(model)

    # fit's epoch, and the first V_PROFILE_STEPS steps of the next profiled
    # for the card's busy time (a whole epoch under the profiler took 42 s
    # at 10,000,000 rows)
    epoch_s = model.epoch_log[0]["train_s"]
    steps = -(-n // B)

    def profiled_steps():
        model.net.train()
        for batch in itertools.islice(model._epoch_batches(), V_PROFILE_STEPS):
            model._grad_step(batch)
        model.net.eval()

    host_ms, busy_ms = busy_share(profiled_steps)
    busy_share_of_steps = None if busy_ms is None else \
        busy_ms / (V_PROFILE_STEPS * epoch_s / steps * 1e3)

    # one packed step from a saved state, twice: a bitwise repeat, and rows
    # no lookup of the batch touched unchanged bit for bit
    batch = batches[0]
    gen = model.generator.get_state()
    state = net_state(model)
    model.generator.set_state(gen)
    model.net.train()
    loss_a = float(model._grad_step(batch))
    after = {k: v.detach().clone() for k, v in model.net.state_dict().items()}
    set_net_state(model, state)
    model.generator.set_state(gen)
    loss_b = float(model._grad_step(batch))
    model.net.eval()
    bitwise = loss_a == loss_b and all(torch.equal(after[k], v)
                                       for k, v in model.net.state_dict().items())
    untouched_ok, touched_rows = True, {}
    for name, m in tables.items():
        touched = torch.zeros(after[name].shape[0], dtype=torch.bool, device=device)
        ids = torch.stack([batch[f] for _, f in m.token], -1).long() + m.offsets
        touched[ids.reshape(-1)] = True
        touched_rows[name] = int(touched.sum())
        untouched_ok &= torch.equal(after[name][~touched], state[0][name][~touched])

    # the same step on the dense LazyAdam from the same state
    dense = dense_copy(model, trn, state)
    check(not dense._ctr_sparse_enabled() and table.shape[1] == 3 * model.embed_dim,
          "phase V: the dense copy is packed")
    dense.generator.set_state(gen)
    dense.net.train()
    loss_d = float(dense._grad_step(batch))
    dense.net.eval()
    errs, same = packed_versus_dense(model, dense, state, after, tables)
    del state, after
    dense_p50, dense_min, dense_peak = timed(dense)
    del dense
    torch.cuda.empty_cache()

    out = {"phase": "V", "model": "DeepFM", "dataset": ds.name, "rows": rows,
           "train_rows": n, "test_rows": len(tst.data_index), "config": shape,
           "learner": "sparse_adam", "sparse_rows": "auto", "packed_step": engaged,
           "vocab_slots": sum(ctr_shape_vocabs(V_SHAPE)), "table_rows": vocab_rows, "table_shape": list(table.shape),
           "table_gb": table.numel() * 4 / 1e9, "launches": counts, "gen_s": gen_s,
           "etl_s": etl_s, "data_wait_s": wait_s, "fit_s": fit_s,
           "steps_per_epoch": steps, "step_ms_p50": step_p50, "step_ms_min": step_min,
           "examples_per_s": B / step_p50 * 1e3, "peak_mem_gb": peak_gb,
           "epoch_s": epoch_s, "epoch_examples_per_s": n / epoch_s,
           "profiled_steps": V_PROFILE_STEPS, "profiled_steps_host_ms": host_ms,
           "profiled_steps_busy_ms": busy_ms, "busy_share_of_epoch": busy_share_of_steps,
           "test_auc": result["auc"], "test_logloss": result["logloss"],
           "packed_vs_dense": {"loss_packed": loss_a, "loss_dense": loss_d,
                               "max_abs_err": max(errs.values()), "tol": TOL_PACKED,
                               "ok": same, "errors": errs},
           "untouched_rows_bitwise": untouched_ok, "touched_rows": touched_rows,
           "step_bitwise_repeat": bitwise,
           "dense_lazy_adam": {"step_ms_p50": dense_p50, "step_ms_min": dense_min,
                               "examples_per_s": B / dense_p50 * 1e3,
                               "peak_mem_gb": dense_peak}}
    emit("PHASE", out)
    check(not any(counts.values()), f"phase V launched a kernel: {counts}")
    check(np.isfinite(model.epoch_log[0]["train_loss"]) and 0 < result["auc"] < 1,
          f"phase V loss {model.epoch_log[0]['train_loss']}, AUC {result['auc']}")
    check(same, f"phase V: the packed step differs from dense lazy Adam's: {errs}")
    check(untouched_ok, "phase V: the packed step moved rows no lookup touched")
    check(bitwise, "phase V: the packed step does not repeat bit for bit")
    return out


# rows of W's CPU-copy step: the batch's 8,192 until the script's time
# limit cut them to AE's 1,024 (the CPU's plain attention masks)
W_CPU_ROWS = 1024


def phase_w(device):
    """AutoInt at its repo config on phase R's data (criteo-1m-shape), batch
    8192: a one-epoch fit and its test AUC (the evaluation through K3), 20
    timed steps (dropout 0.5 in training: the plain softmax, no kernel),
    one step held to the CPU copy (``W_CPU_ROWS`` rows) with the same
    dropout seeds, the evaluation's probabilities held to the plain-attention route on the
    same weights, eval rows/s, and ``ScorePredictor`` at 8192 rows a
    request held to ``predict``."""
    import numpy as np
    import torch
    from recstudio_torch.models.module.layers import MultiHeadAttention
    from recstudio_torch.serving import ScorePredictor
    from recstudio_torch.utils import get_model
    ref, ds, (trn, val, tst), _, _, gen_s, etl_s = criteo_setup()
    B = ref["batch_size"]
    cls, conf = get_model("AutoInt")
    conf["train"].update(epochs=1, batch_size=B, learner="adam", learning_rate=1e-3,
                         seed=2022)
    conf["eval"].update(batch_size=B, val_metrics=["auc"], test_metrics=["auc", "logloss"],
                        save_path=SAVE_DIR)

    def drive():
        model = cls(conf, device=device)
        t = time.perf_counter()
        model.fit(trn, None)
        fit_s = time.perf_counter() - t
        return model, fit_s, model.evaluate(tst, verbose=False)

    (model, fit_s, result), counts = counted(drive)
    mc = model.config["model"]
    shape = dict(embed_dim=model.embed_dim, **{k: mc[k] for k in (
        "attention_dim", "num_attention_layers", "n_head", "mlp_layer", "activation",
        "dropout", "wide", "deep", "residual_project", "layer_norm")},
        fields=len(model.net.embedding.field_specs), batch=B)
    check(shape == dict(embed_dim=10, attention_dim=64, num_attention_layers=3, n_head=2,
                        mlp_layer=[128, 64], activation="relu", dropout=0.5, wide=True,
                        deep=True, residual_project=True, layer_norm=False, fields=39,
                        batch=8192), f"phase W config {shape}")
    n = len(trn.data_index)
    batches = list(itertools.islice(epoch_stream(model), 23))
    torch.cuda.reset_peak_memory_stats(device)
    model.net.train()
    step_ms = []
    _, train_counts = counted(lambda: model._grad_step(batches[0]))
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model._grad_step(batch)
        torch.cuda.synchronize()
        if i >= 3:
            step_ms.append((time.perf_counter() - t) * 1e3)
    model.net.eval()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    step_p50 = sorted(step_ms)[len(step_ms) // 2]

    # one step on the card held to the CPU copy (the first W_CPU_ROWS rows of
    # a batch, the same dropout seeds)
    batch = {k: v[:W_CPU_ROWS] for k, v in batches[0].items()}
    gen = model.generator.get_state()
    loss_k, grads_k = ranker_step(model, batch, gen)
    cpu = cpu_copy(model, trn)
    loss_c, grads_c = ranker_step(cpu, {k: v.cpu() for k, v in batch.items()}, gen)
    key_biases = [k for k in grads_c if k.endswith(".attn.k_proj.bias")]
    grads_k = {k: v.cpu() for k, v in grads_k.items()}
    max_abs, ok = grad_errors(grads_k, grads_c, key_biases)
    # each tensor's largest error over its tolerance (1 at the tolerance)
    grad_err_over_tol = {k: float(((grads_k[k] - w).abs() / (
        TOL_GRAD[0] * float(w.abs().max()) + TOL_GRAD[1] * w.abs() + 1e-30)).max())
        for k, w in grads_c.items()}
    del cpu

    # the evaluation's probabilities through K3, and through the plain softmax
    attn = [m for m in model.net.modules() if isinstance(m, MultiHeadAttention)]
    probs_k, eval_counts = counted(lambda: eval_probs(model, tst))
    for m in attn:
        m.plain = True
    probs_p = eval_probs(model, tst)
    for m in attn:
        m.plain = False
    k3_diff = float(np.abs(probs_k - probs_p).max())
    model._eval_epoch(tst, ["auc", "logloss"], [None])
    torch.cuda.synchronize()
    t = time.perf_counter()
    model._eval_epoch(tst, ["auc", "logloss"], [None])
    eval_s = time.perf_counter() - t

    # ScorePredictor at 8192 rows a request, held to predict()
    pred = ScorePredictor(model, max_batch=B, train_data=trn)
    fields = [f for f in tst.inter_feat.fields if f != model.frating]
    starts = range(0, min(8 * B, len(tst.data_index)), B)
    requests = [{f: tst.inter_feat.get_col(f)[tst.data_index[i:i + B]] for f in fields}
                for i in starts]
    pred.warm(requests[0])
    served, serve_counts = counted(lambda: [pred(r) for r in requests])
    want = [model.predict(tst._get_pos_batch(np.arange(i, i + len(r)))) for i, r in zip(
        starts, served)]
    serve_diff = max(float(np.abs(a - b).max()) for a, b in zip(served, want))
    L = len(model.net.embedding.field_specs)
    tile = 32
    out = {"phase": "W", "model": "AutoInt", "dataset": ds.name, "rows": ref["rows"],
           "train_rows": n, "test_rows": len(tst.data_index), "config": shape,
           "launches": counts, "training_step_launches": train_counts,
           "eval_launches": eval_counts, "serve_launches": serve_counts,
           "fit_s": fit_s, "fit_epoch_s": model.epoch_log[0]["train_s"],
           "steps_per_epoch": -(-n // B), "step_ms_p50": step_p50, "step_ms_min": min(step_ms),
           "examples_per_s": B / step_p50 * 1e3, "peak_mem_gb": peak_gb,
           "test_auc": result["auc"], "test_logloss": result["logloss"],
           "eval_s": eval_s, "eval_rows_per_s": len(tst.data_index) / eval_s,
           "cpu_rows": W_CPU_ROWS, "cpu_loss": loss_c, "card_loss": loss_k,
           "grad_max_abs_err": max_abs, "grad_tol": TOL_GRAD, "loss_tol": TOL_LOSS,
           "zero_gradients": key_biases,
           "grad_err_over_tol": grad_err_over_tol,
           "zero_gradient_tol": TOL_ZERO_GRAD,
           "k3_vs_plain_route_max_abs_diff": k3_diff, "prob_tol": TOL_PROB,
           "k3_real_pair_share_of_tiles": L * L / (-(-L // tile) * tile) ** 2,
           "serve_max_abs_diff_vs_predict": serve_diff,
           **{"serve_" + k: v for k, v in pred.stats().items()}}
    emit("PHASE", out)
    others = {k: v for k, v in counts.items() if k != "fused_mha" and v}
    check(not others, f"phase W launched {others}")
    check(counts["fused_mha"] > 0 and eval_counts["fused_mha"] > 0
          and serve_counts["fused_mha"] > 0 and not any(train_counts.values()),
          f"phase W: K3 launches fit/evaluate {counts}, eval {eval_counts}, serving "
          f"{serve_counts}, a training step {train_counts}")
    check(np.isfinite(model.epoch_log[0]["train_loss"]) and 0 < result["auc"] < 1,
          f"phase W loss {model.epoch_log[0]['train_loss']}, AUC {result['auc']}")
    check(abs(loss_k - loss_c) <= TOL_LOSS * abs(loss_c), f"phase W loss {loss_k} vs {loss_c}")
    check(ok, f"phase W gradients disagree with the CPU copy's: {max_abs}")
    check(k3_diff <= TOL_PROB, f"phase W: K3's probabilities differ from the plain route's "
                               f"by {k3_diff}")
    check(serve_diff <= TOL_PROB, f"phase W ScorePredictor differs from predict by {serve_diff}")
    return out


def phase_x(device):
    """WideDeep, DCN, NFM and AutoInt the way users start them
    (``ranker_fit_phase``): batch norms calibrated, AutoInt's validation,
    evaluation and serving through K3."""
    return [ranker_fit_phase(device, "X", name, expected,
                             ("fused_mha",) if name == "AutoInt" else (), profile=False)
            for name, expected in (
                ("WideDeep", dict(embed_dim=10, mlp_layer=[256, 256, 256], activation="relu",
                                  dropout=0.3, batch_norm=True)),
                ("DCN", dict(embed_dim=10, mlp_layer=[256, 256, 256], num_layers=6,
                             activation="relu", dropout=0.5, batch_norm=True)),
                ("NFM", dict(embed_dim=10, mlp_layer=[128, 128, 128], activation="sigmoid",
                             dropout=0.3, batch_norm=True)),
                ("AutoInt", dict(embed_dim=10, attention_dim=64, num_attention_layers=3,
                                 n_head=2, mlp_layer=[128, 64], dropout=0.5)))]


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# phases Y, Y2, Z: the sampler layer
# ---------------------------------------------------------------------------
# the proposals and mining methods of train.sampler and train.sampling_method
# that phase Y runs for SAMPLER_MODE_STEPS steps each beside its midx-pop fit
PROPOSALS = ("uniform", "pop", "midx-uni", "cluster-uni", "cluster-pop", "lsh")
MINING = ("dns", "sir", "brute", "toprand", "top&rand")
SAMPLER_MODE_STEPS = 50
# phase Y2's timed SASRec steps (the loss must fall from the first 50 to the last 50)
Y2_STEPS = 300
# draws a sampler makes for one fixed batch of queries in its distribution gate
SAMPLER_DRAWS = 2 ** 20
# the gate: total variation of the draws' frequencies from the proposal (over
# buckets, or items grouped by id where the support is large) at most twice
# its expected value under the proposal itself plus this slack
TV_SLACK = 0.005
# id groups of the item-level gates on a large support
ID_GROUPS = 1024
# log_neg_prob against compute_item_p of the draws: the same float32 dot
# products of O(1) vectors, taken by a product and by an einsum
TOL_ITEM_P = 1e-4
# a sampler state built on the card against its CPU copy from the same
# k-means result: floats (rtol, atol), the bucket weights being sums of up
# to ~3,300 float32 weights (a cluster's items) that the two devices add in
# other orders, n eps at most 2e-4; the in-bucket CDF cp, running sums of
# up to a bucket's weights over their total
TOL_STATE = (2e-4, 1e-6)
TOL_CP = 2e-3


def tv_and_noise(counts, probs):
    """Total variation of ``counts``' frequencies from ``probs`` and its
    expected value when the draws follow ``probs`` (numpy float64)."""
    import numpy as np
    n = counts.sum()
    tv = 0.5 * float(np.abs(counts / n - probs).sum())
    noise = 0.5 * float(np.sum(np.sqrt(2.0 * probs * (1.0 - probs) / (np.pi * n))))
    return tv, noise


def proposal_groups(sampler, state, queries, num_items):
    """The sampler's proposal for each of ``queries`` [Q, D], from its
    definition in float64 (not the sampler's code): ``(group of each item
    id [num_items], the mean over the queries of the proposal over the
    groups, name of the level)``. MIDX: its K^2 buckets; cluster: its K
    clusters; popularity, uniform and LSH: items grouped by id range."""
    import torch
    from recstudio_torch.ann import sampler as S
    q = queries.double()
    ids = torch.arange(num_items, device=q.device)
    by_id = torch.clamp_max(ids * ID_GROUPS // num_items, ID_GROUPS - 1)

    def grouped(p_items):                      # [Q, num_items] -> [ID_GROUPS]
        out = torch.zeros(ID_GROUPS, dtype=torch.float64, device=q.device)
        return out.index_add(0, by_id, p_items.mean(0))

    if isinstance(sampler, S.MIDXSamplerUniform) and not isinstance(
            sampler, S.ClusterSamplerUniform):
        K = sampler.K
        half = q.shape[-1] // 2
        r0s = torch.softmax(q[:, :half] @ state["c0"].double().t(), -1)
        r1s = torch.softmax(q[:, half:] @ state["c1"].double().t(), -1)
        wkk = state["wkk"].double()
        s0 = (r1s @ wkk.t()) * r0s + 1e-12
        s1 = wkk[None] * r1s[:, None, :] + 1e-12
        p = (s0 / s0.sum(-1, keepdim=True))[:, :, None] * s1 / s1.sum(-1, keepdim=True)
        group = (state["cd0"] - 1) * K + state["cd1"] - 1
        return group, p.reshape(len(q), -1).mean(0), "bucket"
    if isinstance(sampler, S.ClusterSamplerUniform):
        p = torch.softmax(q @ state["c"].double().t(), -1)
        return state["cd"] - 1, p.mean(0), "cluster"
    if isinstance(sampler, S.PopularSamplerModel):
        return by_id, grouped(state["pop_prob"].double()[None]), "item_id_group"
    if isinstance(sampler, S.LSHSampler):
        code_q = sampler._hash(queries)                                   # [Q, L]
        code_i = sampler._hash(state["item_embs"])                        # [N - 1, L]
        share = (code_i[None] == code_q[:, None]).sum(-1).double()        # [Q, N - 1]
        share = torch.cat([share.new_zeros(len(q), 1), share], 1)
        return by_id, grouped(share / share.sum(-1, keepdim=True)), "item_id_group"
    p = torch.full((1, num_items), 1.0 / (num_items - 1), dtype=torch.float64, device=q.device)
    p[:, 0] = 0.0
    return by_id, grouped(p), "item_id_group"


def sampler_gates(model, queries, tag):
    """The sampler's gates for one fixed batch of ``queries`` [Q, D]:
    ``SAMPLER_DRAWS`` draws against its proposal (and, for MIDX, the items
    of its likeliest bucket against the in-bucket law), and its
    ``log_neg_prob`` against ``compute_item_p`` of the draws. Returns the
    report; fails the run on a gate."""
    import torch
    from recstudio_torch.ann import sampler as S
    sampler, state = model.sampler, model.states.get("sampler")
    n = model.num_items
    per_query = SAMPLER_DRAWS // len(queries)
    gen = torch.Generator(device=queries.device)
    gen.manual_seed(2040)
    with torch.no_grad():
        _, neg, lnp = sampler(queries, per_query, gen, state=state)
        group, probs, level = proposal_groups(sampler, state, queries, n)
        drawn = group[neg.reshape(-1)]
        counts = torch.bincount(drawn, minlength=len(probs)).double()
        tv, noise = tv_and_noise(counts.cpu().numpy(), probs.cpu().numpy())
        out = {"sampler": type(sampler).__name__, "draws": int(neg.numel()), "level": level,
               "cells": len(probs), "tv": tv, "tv_expected_noise": noise,
               "tv_bound": 2 * noise + TV_SLACK}
        check(tv <= 2 * noise + TV_SLACK,
              f"phase {tag} {out['sampler']}: draws off the proposal, TV {tv} (noise {noise})")
        if isinstance(sampler, S.MIDXSamplerUniform) and level == "bucket":
            top = int(torch.argmax(probs))
            members = state["indices"][state["indptr"][top]:state["indptr"][top + 1]] + 1
            w = state["p"][members].double() if "p" in state else \
                torch.ones(len(members), dtype=torch.float64, device=members.device)
            inside = neg.reshape(-1)[drawn == top]
            c = (inside[:, None] == members[None, :]).sum(0).double()
            itv, inoise = tv_and_noise(c.cpu().numpy(), (w / w.sum()).cpu().numpy())
            out.update(in_bucket_items=len(members), in_bucket_draws=int(inside.numel()),
                       in_bucket_tv=itv, in_bucket_tv_bound=2 * inoise + TV_SLACK)
            check(itv <= 2 * inoise + TV_SLACK,
                  f"phase {tag} {out['sampler']}: in-bucket draws off, TV {itv} ({inoise})")
        if not isinstance(sampler, (S.LSHSampler, S.UniformSampler)):
            q = sampler._queries(queries) if hasattr(sampler, "_queries") else queries
            want = sampler.compute_item_p(q, neg, state)
            diff = (lnp - want).abs()
            bad = int((diff > TOL_ITEM_P * torch.clamp_min(want.abs(), 1.0)).sum())
            out.update(log_prob_max_abs_diff=float(diff.max()), log_prob_mismatches=bad,
                       log_prob_tol=TOL_ITEM_P)
            check(bad == 0, f"phase {tag} {out['sampler']}: {bad} log_neg_prob differ from "
                            "compute_item_p of the draws")
    return out


def state_cpu_copy(model, tag):
    """The card's sampler state against a CPU copy built from the same
    k-means result: integer arrays bit for bit, floats to ``TOL_STATE``
    (``cp`` to ``TOL_CP``)."""
    import torch
    from recstudio_torch.ann import sampler as S
    sampler, state = model.sampler, model.states["sampler"]
    x = model.states["item_vector"].cpu()
    cpu = {k: v.cpu() for k, v in state.items()}
    if isinstance(sampler, S.ClusterSamplerUniform):
        copy = sampler.build_state(x, cpu["c"], cpu["cd"][1:] - 1)
    else:
        copy = sampler.build_state(x, cpu["c0"], cpu["cd0"][1:] - 1, cpu["c1"], cpu["cd1"][1:] - 1)
    worst, ok = {}, sorted(copy) == sorted(cpu)
    for key, want in copy.items():
        got = cpu[key]
        if not torch.is_floating_point(want):
            same = torch.equal(got, want)
            worst[key] = 0.0 if same else float((got - want).abs().max())
            ok &= same
            continue
        worst[key] = float((got - want).abs().max())
        if key == "cp":
            ok &= worst[key] <= TOL_CP
        else:
            ok &= bool(torch.allclose(got, want, rtol=TOL_STATE[0], atol=TOL_STATE[1]))
    check(ok, f"phase {tag}: the card's sampler state differs from the CPU copy's: {worst}")
    return {"max_abs_diff": worst, "tol": TOL_STATE, "cp_tol": TOL_CP}


def refresh_repeats(model):
    """``_epoch_refresh(0)`` twice from the same generator state: whether
    every state tensor repeats bit for bit, and the second's ms."""
    import torch
    gen = model.device_generator.get_state()
    model._epoch_refresh(0)
    first = {k: v.clone() for k, v in model.states["sampler"].items()}
    first["item_vector"] = model.states["item_vector"].clone()
    model.device_generator.set_state(gen)
    torch.cuda.synchronize()
    t = time.perf_counter()
    model._epoch_refresh(0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    again = dict(model.states["sampler"], item_vector=model.states["item_vector"])
    return all(torch.equal(first[k], again[k]) for k in first) and sorted(first) == \
        sorted(again), ms


def sample_ms(model, batch):
    """Card time of one batch's ``sampling`` (the train config's method),
    its query encoded in eval mode."""
    import torch
    tc = model.config["train"]
    was = model.net.training
    model.net.eval()
    with torch.no_grad():
        q = model.net.encode_query(model._get_query_feat(batch))
    model.net.train(was)
    return time_ms(lambda: model.sampling(batch, model.neg_count, q,
                                          method=tc.get("sampling_method", "none"),
                                          excluding_hist=tc.get("excluding_hist", False)),
                   iters=10)


def phase_y(device):
    """BPR at amazon-book-shape with ``SampledSoftmaxLoss`` under the
    ``midx-pop`` proposal (32 clusters a half-space, 100 negatives, batch
    2048): two epochs, each after the sampler's refresh, and the test
    NDCG@10; then each other proposal and mining method for
    ``SAMPLER_MODE_STEPS`` steps; the sampler gates."""
    import numpy as np
    import torch
    from recstudio_torch.data.synthetic import SHAPES, generate
    from recstudio_torch.models.loss_func import SampledSoftmaxLoss
    from recstudio_torch.ops.kmeans import kmeans
    from recstudio_torch.utils import get_model, seed_everything
    cls, conf = get_model("BPR")
    t0 = time.perf_counter()
    name, config = generate("amazon-book-shape", *SHAPES["amazon-book-shape"], seed=7)
    if _AMAZON.get("name") == name:                   # phase T's splits (same data config)
        ds, (trn, tst) = _AMAZON["ds"], _AMAZON["splits"]
    else:
        seed_everything(2022)
        ds = cls._get_dataset_class()(name, config=config)
        trn, _, tst = ds.build(**conf["data"])
    etl_s = time.perf_counter() - t0
    conf["train"].update(batch_size=2048, sampler="midx-pop", sampler_num_clusters=32,
                         negative_count=100, epochs=2)
    conf["eval"].update(batch_size=512, cutoff=[10], test_metrics=["ndcg", "recall"],
                        topk=100, save_path=SAVE_DIR)
    tc = conf["train"]
    model = cls(conf, device=device, loss=SampledSoftmaxLoss())
    model._init_model(trn)
    model._init_parameter(trn)
    model.optimizer = model._get_optimizer()
    model._setup_scan_epoch(trn)
    shape = dict(embed_dim=model.embed_dim, batch=tc["batch_size"], lr=tc["learning_rate"],
                 learner=tc["learner"], sampler=tc["sampler"],
                 clusters=tc["sampler_num_clusters"], negatives=tc["negative_count"],
                 loss=type(model.loss_fn).__name__, users=ds.num_users - 1,
                 items=ds.num_items - 1, inters=int(ds.num_inters))
    check(shape == dict(embed_dim=64, batch=2048, lr=1e-3, learner="adam", sampler="midx-pop",
                        clusters=32, negatives=100, loss="SampledSoftmaxLoss", users=52643,
                        items=91593, inters=2_984_108), f"phase Y config {shape}")
    steps_per_epoch = -(-model._epoch_rows // tc["batch_size"])

    # the refresh: the catalog encode, two k-means runs, the index and CDFs
    model._epoch_refresh(0)                               # warm
    bitwise, refresh_ms = refresh_repeats(model)
    half = model.states["item_vector"][:, :32].contiguous()
    kmeans_ms = time_ms(lambda: kmeans(half, 32, 30, model.device_generator), iters=3, warmup=1)
    state_y = state_cpu_copy(model, "Y")

    def fit_two_epochs():
        epochs = []
        for ep in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            model._epoch_refresh(ep)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss = model.training_epoch(ep)
            torch.cuda.synchronize()
            epochs.append({"epoch": ep, "refresh_ms": (t1 - t) * 1e3,
                           "train_s": time.perf_counter() - t1, "train_loss": loss})
        return epochs

    torch.cuda.reset_peak_memory_stats()
    epochs, fit_counts = counted(fit_two_epochs)
    fit_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.synchronize()
    t = time.perf_counter()
    ev = model._eval_epoch(tst, ["ndcg", "recall"], [10])
    eval_s = time.perf_counter() - t
    model._epoch_refresh(2)
    batches = [b for b, _ in zip(epoch_stream(model), range(100))]
    host_ms, busy_ms = busy_share(lambda: [model._grad_step(b) for b in batches])
    base_sample_ms = sample_ms(model, batches[0])
    gates = [sampler_gates(model, model.net.encode_query(batches[0][model.fuid][:4]).detach(),
                           "Y")]

    # each other proposal and mining method, SAMPLER_MODE_STEPS steps each
    modes = []
    for mode in PROPOSALS + MINING:
        if mode in PROPOSALS:
            tc.update(sampler=mode, sampling_method="none", negative_count=100)
        else:
            tc.update(sampler="midx-pop", sampling_method=mode, negative_count=[200, 100])
        model.neg_count = tc["negative_count"]
        model.sampler = model._get_sampler(trn)
        model.states.pop("sampler", None)
        model._epoch_refresh(3)
        torch.cuda.reset_peak_memory_stats()
        _, times, losses, counts = timed_steps(model, epoch_stream(model),
                                               n=SAMPLER_MODE_STEPS)
        row = {"mode": mode, "sampler": type(model.sampler).__name__,
               "sampling_method": tc["sampling_method"], "negatives": tc["negative_count"],
               "sample_ms": sample_ms(model, batches[0]), "step_ms_p50": times[len(times) // 2],
               "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
               "losses_finite": bool(torch.isfinite(losses).all()),
               "launches": sum(counts.values()),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        if mode in PROPOSALS:
            row["gate"] = sampler_gates(
                model, model.net.encode_query(batches[0][model.fuid][:4]).detach(), "Y")
        if mode in ("cluster-pop",):
            row["state_vs_cpu"] = state_cpu_copy(model, "Y")
        modes.append(row)
        emit("SAMPLER_MODE", {"phase": "Y", **row})
    model.states.clear()
    train_s = [e["train_s"] for e in epochs]
    step_ms = sum(train_s) / (2 * steps_per_epoch) * 1e3
    out = {"phase": "Y", "model": "BPR", "dataset": name, "config": shape, "etl_s": etl_s,
           "train_rows": model._epoch_rows, "steps_per_epoch": steps_per_epoch,
           "refresh_ms": refresh_ms, "kmeans_ms_one_run": kmeans_ms,
           "refresh_bitwise_repeat": bitwise, "state_vs_cpu": state_y, "epochs": epochs,
           "launches": fit_counts, "step_ms_mean": step_ms, "sample_ms": base_sample_ms,
           "examples_per_s": tc["batch_size"] / (step_ms / 1e3), "peak_mem_gb": fit_peak,
           "profiled_steps": len(batches), "profiled_host_ms": host_ms,
           "profiled_busy_ms": busy_ms,
           "busy_share": None if busy_ms is None else busy_ms / host_ms,
           "eval_users": len(tst.data_index), "eval_s": eval_s, **ev,
           "gates": gates, "modes": modes}
    emit("PHASE", out)
    check(bitwise, "phase Y: the sampler refresh does not repeat bit for bit")
    check(not any(fit_counts.values()), f"phase Y launched a kernel: {fit_counts}")
    check(all(np.isfinite(e["train_loss"]) for e in epochs), "phase Y loss")
    check(all(m["losses_finite"] for m in modes),
          f"phase Y: a mode's loss is not finite: {[m['mode'] for m in modes]}")
    check(not any(m["launches"] for m in modes), "phase Y: a mode launched a kernel")
    check(np.isfinite(ev["ndcg@10"]) and ev["ndcg@10"] > 0, f"phase Y test NDCG@10 {ev}")
    return out


def phase_y2(device):
    """SASRec at phase D's ml-1m-shape setup (hidden 128, 2 layers, 2 heads,
    dropout 0.5, L 200) with ``SampledSoftmaxLoss`` under the ``midx-uni``
    proposal over ``[B, L, D]`` queries (32 clusters, 20 negatives, batch
    256): ``Y2_STEPS`` steps through K1 and K2, the loss falling; the
    sampler gates; requests served through K1."""
    import torch
    from recstudio_torch.models.loss_func import SampledSoftmaxLoss
    from recstudio_torch.serving import Predictor
    model, conf, ds, tst, name, etl_s = training_model(
        device, "SASRec", 256, embed_dim=128,
        train=dict(sampler="midx-uni", sampler_num_clusters=32, negative_count=20),
        parts=dict(loss=SampledSoftmaxLoss()))
    mc, tc = conf["model"], conf["train"]
    shape = dict(B=tc["batch_size"], L=ds.max_seq_len, D=model.embed_dim, F=mc["hidden_size"],
                 H=mc["head_num"], layers=mc["layer_num"], dropout=mc["dropout_rate"],
                 sampler=tc["sampler"], clusters=tc["sampler_num_clusters"],
                 negatives=tc["negative_count"], loss=type(model.loss_fn).__name__)
    check(shape == dict(B=256, L=200, D=128, F=128, H=2, layers=2, dropout=0.5,
                        sampler="midx-uni", clusters=32, negatives=20,
                        loss="SampledSoftmaxLoss"), f"phase Y2 config {shape}")
    model._epoch_refresh(0)
    bitwise, refresh_ms = refresh_repeats(model)
    state_y2 = state_cpu_copy(model, "Y2")
    torch.cuda.reset_peak_memory_stats()
    steps, times, losses, counts = timed_steps(model, epoch_stream(model), n=Y2_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    first, last = float(losses[:50].mean()), float(losses[-50:].mean())
    batch = steps[-1]
    model.net.eval()
    s_ms = sample_ms(model, batch)
    # four position queries [L, D] of the last batch's first sequence, as
    # training encodes them (the per-position queries the sampler draws for)
    model.net.train()
    with torch.no_grad():
        q = model.net.encode_query(model._get_query_feat(batch), model.generator)
    model.net.eval()
    gates = [sampler_gates(model, q[0][batch[model.fiid][0] > 0][:4].contiguous(), "Y2")]
    model.states.pop("item_vector", None)

    def serve():
        pred = Predictor(model, max_batch=256, k=20, train_data=tst).warm()
        reqs = list(itertools.islice(tst.eval_loader(256), 2))
        for b in reqs:
            pred({f: b[f][:int(b["_size"])] for f in sorted(model.query_fields)})
        return pred

    pred, serve_counts = counted(serve)
    out = {"phase": "Y2", "model": "SASRec", "dataset": name, "config": shape, "etl_s": etl_s,
           "refresh_ms": refresh_ms, "refresh_bitwise_repeat": bitwise,
           "state_vs_cpu": state_y2, "steps": len(times), "launches": counts,
           "step_ms_p50": times[len(times) // 2], "step_ms_max": times[-1],
           "sample_ms": s_ms, "examples_per_s": 256 / (times[len(times) // 2] / 1e3),
           "loss_first_50_mean": first, "loss_last_50_mean": last, "peak_mem_gb": peak,
           "gates": gates, "serve_launches": serve_counts,
           **{"serve_" + k: v for k, v in pred.stats().items()}}
    emit("PHASE", out)
    check(bitwise, "phase Y2: the sampler refresh does not repeat bit for bit")
    check(counts["fused_transformer_layer"] > 0 and counts["fused_transformer_layer_bwd"] > 0,
          f"phase Y2 launched no K1 or no K2 in training: {counts}")
    check(serve_counts["fused_transformer_layer"] > 0, f"phase Y2 served without K1: "
                                                       f"{serve_counts}")
    check(bool(torch.isfinite(losses).all()), "phase Y2 loss not finite")
    check(last < first, f"phase Y2: the loss did not fall ({first} -> {last})")
    return out


def phase_z(device):
    """PMF, CML, NCF (fusion), LogisticMF and BPR under ``midx-pop`` the way
    users start them (``quickstart.run`` on ml-100k at the repo's configs,
    for the epochs of their JAX references), each held to its JAX seeds'
    band (``recstudio_torch/assets/{pmf,cml,ncf,logisticmf,bpr_midx_pop}_
    ml100k_train_reference.json``, written by ``scripts/torch_mf_seeds.py``)
    and every test user served through ``Predictor``, whose lists give
    ``evaluate``'s metrics."""
    runs = (
        ("PMF", "pmf", {}, dict(embed_dim=64, batch=512, learner="adam")),
        ("CML", "cml", dict(margin="margin"), dict(embed_dim=64, margin=1, batch=512,
                                                   negative_count=5)),
        ("NCF", "ncf", dict(score_mode="score_mode", mlp="mlp_hidden_size"),
         dict(embed_dim=64, score_mode="fusion", mlp=[128, 64], batch=512, negative_count=1)),
        ("LogisticMF", "logisticmf", {}, dict(embed_dim=64, batch=512, learner="adagrad",
                                              negative_count=10)),
        ("BPR", "bpr_midx_pop", {}, dict(embed_dim=64, batch=512, sampler="midx-pop",
                                         negative_count=1)))
    out = []
    for model_name, ref_name, keys, expected in runs:
        with open(ML100K_TRAIN_REFERENCE.format(ref_name)) as f:
            overrides = json.load(f).get("overrides") or None
        out.append(fit_phase(device, "Z", model_name, ML100K_TRAIN_REFERENCE.format(ref_name),
                             keys, expected, (), quickstart=True, overrides=overrides))
    return out


# ---------------------------------------------------------------------------
# phases AA-AD: the sequence-aware, multitask and two-stage rankers
# ---------------------------------------------------------------------------
SEQ_MT_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets", "{}_{}_train_reference.json")
SYNTH_DIR = os.path.join(REPO, "build", "recstudio_torch", "synthetic")
# phase AB's data: the public KuaiRand-Pure log's counts (scripts/multitask_data.py);
# phase AD's multitask runs: the small file of the JAX bands
MT_SHAPE, MT_SMALL, MT_SEED = "kuairand-pure-shape", "kuairand-pure-small", 7
MT_BATCH = 4096
# phase AB's optimizer steps before the test AUCs (the timed 20 among
# them): the plain dropout masks of a dozen 2,752-wide expert inputs make a
# step 50-250 ms, so a whole epoch (268 steps) does not fit the limit; the
# CPU copy's step takes the first rows of a batch
AB_STEPS = 30
AB_CPU_ROWS = 1024
# phase AA: rows of the batch whose step is held to the CPU copy (DIEN's
# AUGRU loop over L 200 on the CPU)
AA_CPU_ROWS = 256
# phase AC: users a served request. A candidate row of DIN's activation unit
# is [L, 4d] floats (200 x 512 x 4 bytes = 410 kB), 100 candidates a user:
# 41 MB a user for the unit's input alone, about 2.6 GB a request
AC_MAX_BATCH = 64
AC_CPU_ROWS = 16


def kuairand(name):
    """``scripts/multitask_data.write_kuairand(name)`` (seed ``MT_SEED``,
    under ``build/``): ``(dataset name, data config)``."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from multitask_data import write_kuairand
    return write_kuairand(name, SYNTH_DIR, seed=MT_SEED)


def mt_dataset():
    """Phase AB's data: ``kuairand(MT_SHAPE)`` built as a ``TripletDataset``
    with the multitask family's split (``np.random.seed(MT_SEED)`` first):
    ``(dataset, splits, gen s, ETL s)``."""
    import numpy as np
    from recstudio_torch.data import TripletDataset
    from recstudio_torch.utils import get_model
    t0 = time.perf_counter()
    dname, config = kuairand(MT_SHAPE)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.random.seed(MT_SEED)
    ds = TripletDataset(dname, config=config)
    splits = ds.build(**get_model("MMoE")[1]["data"])
    return ds, splits, gen_s, time.perf_counter() - t0


def device_kernels(fn) -> int:
    """Kernels the card ran for ``fn`` (``torch.profiler``'s raw events,
    copies and fills left out)."""
    import torch
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    raw = prof.profiler.kineto_results
    return sum(1 for e in raw.events() if e.device_type() == DeviceType.CUDA
               and not e.name().startswith(("Memcpy", "Memset")))


def relu_inputs(card=None):
    """A ``TorchFunctionMode`` that keeps the input of every relu of a step
    (``.inputs``: {shape: [CPU tensors in call order]}). Given the mode of
    the card's step (``card``), each relu of the CPU copy's step takes the
    card's decision for the same call (the n-th of its shape): where both
    inputs lie within rounding of 0 they can fall on either side on the two
    devices, and one flipped unit moves its weight row's gradient by the
    whole of its row's term. ``relu_flips`` holds what that hid."""
    import torch
    from torch.overrides import TorchFunctionMode
    relus = {torch.relu, torch.nn.functional.relu, torch.Tensor.relu}

    class ReluInputs(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.inputs = {}

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func not in relus:
                return func(*args, **kwargs)
            x = args[0]
            seen = self.inputs.setdefault(tuple(x.shape), [])
            seen.append(x.detach().cpu())
            theirs = None if card is None else card.inputs.get(tuple(x.shape), [])
            if not theirs or len(seen) > len(theirs):   # a relu the card ran inside a kernel
                return func(*args, **kwargs)
            return x * (theirs[len(seen) - 1] > 0).to(x.device, x.dtype)

    return ReluInputs()


def relu_flips(card, cpu):
    """(units whose relu the two devices decided apart, the largest |input|
    among them over its tensor's largest)."""
    import torch
    n, worst = 0, 0.0
    for shape, mine in cpu.inputs.items():
        for c, p in zip(card.inputs.get(shape, []), mine):
            flip = (c > 0) != (p > 0)
            if bool(flip.any()):
                n += int(flip.sum())
                scale = max(float(c.abs().max()), float(p.abs().max()))
                worst = max(worst, float(torch.maximum(c[flip].abs(), p[flip].abs()).max())
                            / scale)
    return n, worst


def card_vs_cpu_step(model, cpu, batch, zero=(), relus=None):
    """One training step on the card and on its CPU copy from the same
    dropout generator state: (card loss, CPU loss, max gradient error,
    gradients ok, the three tensors with the largest error over their
    tolerance). With ``relus`` (a dict), the CPU copy's relus take the
    card's decisions (``relu_inputs``), and ``relus`` gets the count of
    units decided apart and the largest of their inputs (``relu_flips``)."""
    import contextlib
    gen = model.generator.get_state()
    card = relu_inputs() if relus is not None else contextlib.nullcontext()
    with card:
        loss_k, grads_k = ranker_step(model, batch, gen)
    mine = relu_inputs(card) if relus is not None else contextlib.nullcontext()
    with mine:
        loss_c, grads_c = ranker_step(cpu, {k: v.cpu() for k, v in batch.items()}, gen)
    if relus is not None:
        relus["flipped_units"], relus["flipped_largest_input"] = relu_flips(card, mine)
    grads_k = {k: v.cpu() for k, v in grads_k.items()}
    max_abs, ok = grad_errors(grads_k, grads_c, zero)
    over = sorted((float(((grads_k[k] - w).abs() / (
        TOL_GRAD[0] * float(w.abs().max()) + TOL_GRAD[1] * w.abs() + 1e-30)).max()), k)
        for k, w in grads_c.items() if k not in zero)[-3:]
    return (loss_k, loss_c, max_abs, ok and abs(loss_k - loss_c) <= TOL_LOSS * abs(loss_c),
            {k: v for v, k in over})


def max_prob_diff(a, b):
    import numpy as np
    if isinstance(a, dict):
        return max(float(np.abs(a[r] - b[r]).max()) for r in a)
    return float(np.abs(a - b).max())


def seq_ranker_phase(device, name, expected):
    """``name`` (DIN or DIEN) at its repo config on the ml-1m shape as a
    ``SeqDataset`` at L 200 (ratings binarized at 3.0), batch 1024: 20
    timed steps, the busy share of 10, one step held to the CPU copy,
    DIEN's gated GRU kernels a step, the batch norms calibrated, evaluation
    rows/s, every test row through ``ScorePredictor(max_batch=256)`` held
    to ``evaluate``'s probabilities."""
    import numpy as np
    import torch
    from recstudio_torch.serving import ScorePredictor
    model, conf, ds, tst, dname, etl_s = training_model(device, name, 1024)
    model.config["eval"]["batch_size"] = 256     # the config's 32: one AUGRU loop a 32 rows
    mc = conf["model"]
    shape = dict(embed_dim=model.embed_dim, **{k: mc[k] for k in expected if k != "embed_dim"},
                 L=ds.max_seq_len, batch=conf["train"]["batch_size"])
    check(shape == dict(expected, L=200, batch=1024), f"phase AA {name} config {shape}")
    torch.cuda.reset_peak_memory_stats(device)
    steps, times, losses, counts = timed_steps(model, epoch_stream(model))
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    n_prof = 10 if name == "DIN" else 3              # DIEN: 10,000 launches a step
    host_ms, busy_ms = busy_share(lambda: [model._grad_step(b) for b in steps[:n_prof]])
    step_kernels = device_kernels(lambda: model._grad_step(steps[0]))
    gru = {}
    if name == "DIEN":
        H = mc["hidden_size"]
        x = torch.randn(1024, 200, H, device=device, requires_grad=True)
        att = torch.rand(1024, 200, device=device, requires_grad=True)

        def augru():
            out, last = model.net.evolution(x, att)
            (out.sum() + last.sum()).backward()
        gru = {"augru_kernels_a_step": device_kernels(augru),
               "augru_fwd_bwd_ms": time_ms(augru, iters=5, warmup=1),
               "augru_fwd_ms": time_ms(lambda: model.net.evolution(x.detach(), att.detach()),
                                       iters=5, warmup=1)}
        del x, att
    model.net.eval()
    cpu = cpu_copy(model, tst)
    zero = [f"dense_mlp.dense_{i}.bias" for i in range(len(mc["fc_mlp"]))] \
        if mc.get("batch_norm") else []
    loss_k, loss_c, grad_err, step_ok, over = card_vs_cpu_step(
        model, cpu, {k: v[:AA_CPU_ROWS] for k, v in steps[-1].items()}, zero)
    del cpu
    model._refresh_net_state()
    metrics = ["auc", "logloss"]
    result = model._eval_epoch(tst, metrics, [None])
    torch.cuda.synchronize()
    t = time.perf_counter()
    model._eval_epoch(tst, metrics, [None])
    eval_s = time.perf_counter() - t
    want = eval_probs(model, tst)
    pred = ScorePredictor(model, max_batch=256, train_data=model._train_data)
    fields = ("user_id", "item_id", "in_item_id", "seqlen")
    requests = [{f: b[f][:int(b["_size"])] for f in fields} for b in tst.eval_loader(256)]
    pred.warm(requests[0])
    served, serve_counts = counted(lambda: np.concatenate([pred(r) for r in requests]))
    served_diff = max_prob_diff(served, want)
    p50 = times[len(times) // 2]
    out = {"phase": "AA", "model": name, "dataset": dname, "etl_s": etl_s, "config": shape,
           "launches": counts, "serve_launches": serve_counts, "steps": len(times),
           "step_ms_p50": p50, "step_ms_max": times[-1], "examples_per_s": 1024 / p50 * 1e3,
           "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
           "peak_mem_gb": peak_gb, "profiled_steps": n_prof, "profiled_host_ms": host_ms,
           "profiled_busy_ms": busy_ms,
           "busy_share": None if busy_ms is None else busy_ms / host_ms,
           "kernels_a_step": step_kernels, **gru, "cpu_rows": AA_CPU_ROWS,
           "card_loss": loss_k, "cpu_loss": loss_c,
           "grad_max_abs_err": grad_err, "grad_err_over_tol_largest": over,
           "grad_tol": TOL_GRAD, "loss_tol": TOL_LOSS,
           "zero_gradients": zero, "bn_counts": [float(m.count) for m in model.net.modules()
                                                 if hasattr(m, "calibrating")],
           "test_rows": len(tst.data_index), "test_auc_after_steps": result["auc"],
           "eval_batch": 256, "eval_s": eval_s, "eval_rows_per_s": len(tst.data_index) / eval_s,
           "served_rows": len(served), "served_max_abs_diff_vs_evaluate": served_diff,
           **{"serve_" + k: v for k, v in pred.stats().items()}}
    emit("PHASE", out)
    gru_ok = (counts["gru_layer_cudnn"] > 0 and serve_counts["gru_layer_cudnn"] > 0) \
        if name == "DIEN" else True                  # DIEN's extractor: cuDNN
    check(gru_ok and not any(v for k, v in {**counts, **serve_counts}.items()
                             if k != "gru_layer_cudnn"),
          f"phase AA {name} launched {counts} {serve_counts}")
    check(bool(torch.isfinite(losses).all()), f"phase AA {name} losses")
    check(step_ok, f"phase AA {name}: the step disagrees with the CPU copy's: loss {loss_k} "
                   f"vs {loss_c}, gradients {grad_err}")
    check(len(served) == len(tst.data_index) and served_diff <= TOL_PROB,
          f"phase AA {name}: served probabilities differ from evaluate's by {served_diff}")
    return out


def phase_aa(device):
    """DIN and DIEN at their repo configs (``seq_ranker_phase``). No kernel:
    the JAX package's are MLPs, a GRU scan and gathers."""
    return [seq_ranker_phase(device, "DIN", dict(
                embed_dim=128, attention_mlp=[128, 64], fc_mlp=[128, 64, 64],
                activation="dice", batch_norm=True, dropout=0.3)),
            seq_ranker_phase(device, "DIEN", dict(
                embed_dim=128, hidden_size=128, fc_mlp=[128, 64, 64], activation="sigmoid",
                dropout=0.3))]


def phase_ab(device, prepared):
    """HardShare, MMoE, PLE and AITM at their repo configs on
    ``kuairand-pure-shape`` (27,285 users, 7,583 videos, 1,436,609 rows; the
    fields of kuairand-pure.yaml, six ``is_*`` ratings), batch 4096:
    ``AB_STEPS`` optimizer steps (20 of them timed) and each rating's test
    AUC after them, one step held to the CPU copy, 8 requests of 4096 rows
    through ``ScorePredictor`` held to ``evaluate``'s probabilities;
    AITM's transfer attention through K3 in evaluation and serving, held
    to the plain softmax."""
    import numpy as np
    import torch
    from recstudio_torch.models.module.layers import MultiHeadAttention
    from recstudio_torch.serving import ScorePredictor
    from recstudio_torch.utils import get_model
    ds, (trn, _, tst), gen_s, etl_s, wait_s = load_data(prepared)
    dname = ds.name
    check((ds.num_users - 1, ds.num_items - 1) == (27285, 7583) and len(ds.frating) == 6,
          f"phase AB data: {ds.num_users - 1} users, {ds.num_items - 1} videos")
    out = []
    for name in ("HardShare", "MMoE", "PLE", "AITM"):
        cls, conf = get_model(name)
        conf["train"].update(batch_size=MT_BATCH, seed=2022)
        conf["eval"].update(batch_size=MT_BATCH, save_path=SAVE_DIR)
        t = time.perf_counter()
        model = cls(conf, device=device)
        model._init_model(trn)
        model._init_parameter(trn)
        model.optimizer = model._get_optimizer()
        model._setup_scan_epoch(trn)
        stage_s = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats(device)
        steps, times, losses, counts = timed_steps(model, epoch_stream(model))
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        model.net.train()
        batches = itertools.islice(epoch_stream(model), AB_STEPS - 23)
        _, more_counts = counted(lambda: [model._grad_step(b) for b in batches])
        model.net.eval()
        step_p50 = times[len(times) // 2]
        result, eval_counts = counted(lambda: model._eval_epoch(
            tst, ["auc", "logloss"], [None]))
        cpu = cpu_copy(model, trn)
        zero = [f"att_{r}.k_proj.bias" for r in model.frating[1:]] if name == "AITM" else []
        loss_k, loss_c, grad_err, step_ok, over = card_vs_cpu_step(
            model, cpu, {k: v[:AB_CPU_ROWS] for k, v in steps[-1].items()}, zero)
        del cpu
        probs = eval_probs(model, tst)
        attn = [m for m in model.net.modules() if isinstance(m, MultiHeadAttention)]
        for m in attn:
            m.plain = True
        plain_diff = max_prob_diff(probs, eval_probs(model, tst))
        for m in attn:
            m.plain = False
        pred = ScorePredictor(model, max_batch=MT_BATCH, train_data=trn)
        fields = [f for f in tst.inter_feat.fields if f not in model.frating]
        requests = [{f: tst.inter_feat.get_col(f)[tst.data_index[i:i + MT_BATCH]]
                     for f in fields} for i in range(0, 8 * MT_BATCH, MT_BATCH)]
        pred.warm(requests[0])
        served, serve_counts = counted(lambda: [pred(r) for r in requests])
        served = {r: np.concatenate([s[r] for s in served]) for r in model.frating}
        served_diff = max_prob_diff(served, {r: p[:8 * MT_BATCH] for r, p in probs.items()})
        aucs = {r: result[f"{r}_auc"] for r in model.frating}
        ph = {"phase": "AB", "model": name, "dataset": dname, "gen_s": gen_s, "etl_s": etl_s,
              "data_wait_s": wait_s,
              "rows": int(ds.num_inters), "train_rows": len(trn.data_index),
              "test_rows": len(tst.data_index), "fields": len(model.fields) - 6,
              "config": {k: v for k, v in model.config["model"].items()},
              "batch": MT_BATCH, "stage_s": stage_s, "launches": counts,
              "later_steps_launches": more_counts, "eval_launches": eval_counts,
              "serve_launches": serve_counts, "steps": AB_STEPS, "timed_steps": len(times),
              "steps_per_epoch": -(-len(trn.data_index) // MT_BATCH),
              "step_ms_p50": step_p50, "step_ms_max": times[-1],
              "examples_per_s": MT_BATCH / step_p50 * 1e3,
              "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
              "peak_mem_gb": peak_gb, "test_auc": aucs,
              "test_logloss": {r: result[f"{r}_logloss"] for r in model.frating},
              "cpu_rows": AB_CPU_ROWS, "card_loss": loss_k, "cpu_loss": loss_c,
              "grad_max_abs_err": grad_err, "grad_err_over_tol_largest": over,
              "zero_gradients": zero, "k3_vs_plain_route_max_abs_diff": plain_diff,
              "served_max_abs_diff_vs_evaluate": served_diff,
              **{"serve_" + k: v for k, v in pred.stats().items()}}
        emit("PHASE", ph)
        out.append(ph)
        kernels = ("fused_mha",) if name == "AITM" else ()
        check(not {k: v for k, v in counts.items() if k not in kernels and v},
              f"phase AB {name} launched {counts}")
        if name == "AITM":
            check(eval_counts["fused_mha"] > 0 and serve_counts["fused_mha"] > 0,
                  f"phase AB AITM: K3 launches evaluation {eval_counts}, serving {serve_counts}")
        check(bool(torch.isfinite(losses).all()) and all(0.5 < a < 1 for a in aucs.values()),
              f"phase AB {name} losses {losses}, AUCs {aucs}")
        check(step_ok, f"phase AB {name}: the step disagrees with the CPU copy's: loss "
                       f"{loss_k} vs {loss_c}, gradients {grad_err}")
        check(plain_diff <= TOL_PROB, f"phase AB {name}: K3's probabilities differ from the "
                                      f"plain route's by {plain_diff}")
        check(served_diff <= TOL_PROB, f"phase AB {name}: served probabilities differ from "
                                       f"evaluate's by {served_diff}")
        del model, steps
    return out


def cascade_cpu_copy(ranker, train_split):
    """A cascade on the CPU holding the card's weights: the retriever and
    the ranker copied."""
    retr = ranker.retriever
    cpu_retr = type(retr)(retr.config, device="cpu")
    cpu_retr._init_model(train_split)
    cpu_retr.load_state_dict({k: v.cpu() for k, v in retr.net.state_dict().items()})
    cpu = type(ranker)(ranker.config, device="cpu", retriever=cpu_retr, loss=ranker.loss_fn)
    cpu._init_model(train_split)
    cpu.load_state_dict({k: v.cpu() for k, v in ranker.net.state_dict().items()})
    return cpu


def cascade_checks(ranker, pred, tst, requests, n_plain=2):
    """The first ``n_plain`` requests served again with the frozen
    retriever's layers on their plain path, and the first ``AC_CPU_ROWS``
    users of the first through the CPU copy: (rows compared and
    disagreeing, largest score difference) of each."""
    import numpy as np
    import torch
    from recstudio_torch.utils.parity import topk_mismatches
    layers = [m for m in ranker.states["retriever"]["net"].modules() if hasattr(m, "plain")]
    bad = n_cmp = 0
    max_diff = 0.0
    for req in requests[:n_plain]:
        s_k, i_k = pred(req)
        for m in layers:
            m.plain = True
        s_p, i_p = pred(req)
        for m in layers:
            m.plain = False
        bad += topk_mismatches(i_k, s_k, i_p, s_p, TOL_SCORES)
        max_diff = max(max_diff, float(np.abs(s_k - s_p).max()))
        n_cmp += len(i_k)
    cpu = cascade_cpu_copy(ranker, ranker._train_data)
    req = {k: v[:AC_CPU_ROWS] for k, v in requests[0].items()}
    s_k, i_k = pred(req)
    hist = torch.from_numpy(np.asarray(tst.user_hist, np.int32)[req[ranker.fuid]])
    s_c, i_c = cpu.topk({k: torch.from_numpy(np.asarray(v)) for k, v in req.items()},
                        pred.k, hist)
    cpu_bad = topk_mismatches(i_k, s_k, i_c.numpy(), s_c.numpy(), TOL_SCORES)
    cpu_diff = float(np.abs(s_k - s_c.numpy()).max())
    return {"plain_rows": n_cmp, "plain_rows_disagreeing": bad,
            "plain_max_score_diff": max_diff, "cpu_rows": len(i_k),
            "cpu_rows_disagreeing": cpu_bad, "cpu_max_score_diff": cpu_diff,
            "tol": TOL_SCORES}


def serve_requests(pred, tst, batch_size):
    """Every test user's request (its ``pred._fields``) in requests of
    ``batch_size``, and each request's targets."""
    reqs, targets = [], []
    for b in tst.eval_loader(batch_size):
        n = int(b["_size"])
        reqs.append({f: b[f][:n] for f in sorted(pred._fields)})
        targets.append(b["item_id"][:n])
    return reqs, targets


def phase_ac(device):
    """The cascade on the ml-1m shape: a SASRec retriever at phase B's setup
    (L 200, d 128, 2 layers, seeded weights, ``eval.topk`` 100) and DIN at
    its repo config as the ranker (``BinaryCrossEntropyLoss``, 2
    retriever-sampled negatives): 20 timed ranker steps, then every user
    served through ``Predictor(cascade, k=20, max_batch=AC_MAX_BATCH)``
    (K1 in the retriever's query encoding), the first two requests held
    to the retriever on its plain layers, the first ``AC_CPU_ROWS`` users
    to the CPU copy."""
    import numpy as np
    import torch
    from recstudio_torch.data import SeqDataset
    from recstudio_torch.data.synthetic import SHAPES, generate
    from recstudio_torch.models.loss_func import BinaryCrossEntropyLoss
    from recstudio_torch.serving import Predictor
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import params_from_jax, random_sasrec_params
    t0 = time.perf_counter()
    dname, config = generate("ml-1m-shape", *SHAPES["ml-1m-shape"], seed=7)
    config["max_seq_len"] = 200
    din_cls, din_conf = get_model("DIN")
    din_conf["data"].update(binarized_rating_thres=0.0)       # every interaction a positive
    din_conf["train"].update(batch_size=1024, negative_count=2, seed=7)
    din_conf["eval"].update(topk=20, cutoff=[20], save_path=SAVE_DIR)
    ds = SeqDataset(dname, config=config)
    trn, _, tst = ds.build(**din_conf["data"])
    etl_s = time.perf_counter() - t0
    sas_cls, sas_conf = get_model("SASRec")
    sas_conf["model"]["embed_dim"] = 128
    sas_conf["eval"]["topk"] = 100
    retr = sas_cls(sas_conf, device=device)
    retr._init_model(trn)
    retr._init_parameter(trn)
    mc = sas_conf["model"]
    retr.load_state_dict(params_from_jax(random_sasrec_params(
        7, ds.num_items, 128, 200, mc["hidden_size"], mc["layer_num"])))
    model = din_cls(din_conf, device=device, retriever=retr, loss=BinaryCrossEntropyLoss())
    model._init_model(trn)
    model._init_parameter(trn)
    model.optimizer = model._get_optimizer()
    model._setup_scan_epoch(trn)
    model._train_data = trn
    model._epoch_refresh(0)
    torch.cuda.reset_peak_memory_stats(device)
    steps, times, losses, train_counts = timed_steps(model, epoch_stream(model))
    train_peak = torch.cuda.max_memory_allocated(device) / 1e9
    model.net.eval()
    model._refresh_net_state()
    pred = Predictor(model, max_batch=AC_MAX_BATCH, k=20, train_data=tst).warm()
    requests, targets = serve_requests(pred, tst, AC_MAX_BATCH)
    torch.cuda.reset_peak_memory_stats(device)
    served, serve_counts = counted(lambda: [pred(r) for r in requests])
    serve_peak = torch.cuda.max_memory_allocated(device) / 1e9
    ids = np.concatenate([i for _, i in served])
    scores = np.concatenate([s for s, _ in served])
    held = cascade_checks(model, pred, tst, requests)
    stats = pred.stats()
    p50 = times[len(times) // 2]
    out = {"phase": "AC", "model": "SASRec->DIN", "dataset": dname, "etl_s": etl_s,
           "retriever": {"embed_dim": 128, "layers": mc["layer_num"], "L": 200,
                         "eval_topk": 100, "weights": "random_sasrec_params(7)"},
           "ranker": {k: din_conf["model"][k] for k in ("embed_dim", "attention_mlp",
                                                       "fc_mlp", "activation", "batch_norm",
                                                       "dropout")},
           "negatives": 2, "batch": 1024, "launches": train_counts,
           "serve_launches": serve_counts, "steps": len(times), "step_ms_p50": p50,
           "step_ms_max": times[-1], "examples_per_s": 1024 / p50 * 1e3,
           "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
           "train_peak_mem_gb": train_peak, "max_batch": AC_MAX_BATCH,
           "candidates_a_user": 100, "served": len(ids), "serve_peak_mem_gb": serve_peak,
           **{"serve_" + k: v for k, v in stats.items()},
           "serve_max_ms": max(pred._lat_ms), **rank_metrics(ids, np.concatenate(targets)),
           **held}
    emit("PHASE", out)
    check(serve_counts["fused_transformer_layer"] > 0 and train_counts[
        "fused_transformer_layer"] > 0, f"phase AC: K1 launches {train_counts} {serve_counts}")
    check(bool(torch.isfinite(losses).all()) and np.isfinite(scores).all()
          and ids.shape == (len(tst.data_index), 20) and (ids > 0).all(),
          "phase AC losses or served lists")
    check(held["plain_rows_disagreeing"] == 0 and held["cpu_rows_disagreeing"] == 0,
          f"phase AC: served lists differ from the plain path's or the CPU copy's: {held}")
    return out


def seq_mt_band_fit(device, name, dataset, data_config):
    """``quickstart.run(name, dataset)`` at the repo's config for its JAX
    reference's epochs: each rating's test AUC held to its band where the
    band can fail (it clears the untrained AUC by ``AUC_MARGIN`` and lies
    inside (0, 1)); the others reported. The batch norms calibrated."""
    from recstudio_torch.quickstart import run
    with open(SEQ_MT_REFERENCE.format(name.lower(), dataset)) as f:
        ref = json.load(f)

    def drive():
        t0 = time.perf_counter()
        model, splits, result = run(name, dataset, data_config=data_config, verbose=False,
                                    device=device,
                                    model_config={"train": {"epochs": ref["epochs"]},
                                                  "eval": {"save_path": SAVE_DIR}})
        return model, splits, result, time.perf_counter() - t0

    (model, _, result, run_s), counts = counted(drive)
    gated, reported = {}, {}
    for key, (lo, hi) in ref["auc_band"].items():
        can_fail = lo > ref["untrained_auc"][key] + AUC_MARGIN and 0 < lo and hi < 1
        (gated if can_fail else reported)[key] = [lo, hi]
    bn_counts = [float(m.count) for m in model.net.modules() if hasattr(m, "calibrating")]
    out = {"phase": "AD", "model": name, "dataset": dataset, "entry": "quickstart.run",
           "launches": counts, "run_s": run_s, "epochs_run": len(model.epoch_log),
           "best_epoch": model.callback.best_epoch,
           "epoch_s_p50": sorted(e["train_s"] for e in model.epoch_log)[
               len(model.epoch_log) // 2],
           "test": result, "jax_bands_gated": gated, "jax_bands_reported": reported,
           "jax_untrained_auc": ref["untrained_auc"], "jax_runs": len(ref["runs"]),
           "bn_counts": bn_counts}
    emit("PHASE", out)
    kernels = {"AITM": ("fused_mha",), "DIEN": ("gru_layer_cudnn",)}.get(name, ())
    check(not {k: v for k, v in counts.items() if k not in kernels and v},
          f"phase AD {name} launched {counts}")
    check(all(counts[k] > 0 for k in kernels), f"phase AD {name}: {counts}")
    check(gated, f"phase AD {name}: no band of {ref['auc_band']} can fail")
    check(all(c > 0 for c in bn_counts), f"phase AD {name} BN counts {bn_counts}")
    for key, (lo, hi) in gated.items():
        check(lo <= result[key] <= hi, f"phase AD {name} test {key} {result[key]} outside "
                                       f"the JAX band [{lo}, {hi}]")
    return out


def phase_ad(device):
    """``quickstart.run`` of DIN and DIEN on ml-100k and of HardShare, MMoE,
    PLE and AITM on the small planted-signal file, held to the JAX seeds'
    bands (``recstudio_torch/assets/<model>_<dataset>_train_reference.json``,
    ``scripts/torch_seq_mt_seeds.py``); then the SASRec -> DIN cascade on
    ml-100k, built as ``tests/test_two_stage.py`` builds BPR -> FM: its
    test NDCG@5 equal to the NDCG@5 of its served lists, the first request
    held to the CPU copy."""
    out = [seq_mt_band_fit(device, name, "ml-100k", None) for name in ("DIN", "DIEN")]
    dname, config = kuairand(MT_SMALL)
    out += [seq_mt_band_fit(device, name, dname, config)
            for name in ("HardShare", "MMoE", "PLE", "AITM")]
    return out + [cascade_fit(device)]


def cascade_fit(device):
    """The SASRec -> DIN cascade on ml-100k (``tests/test_two_stage.py``'s
    way: the retriever fitted first, then the ranker with ``retriever=`` and
    ``loss=``): every test user served at ``evaluate``'s batch size, whose
    lists must give ``evaluate``'s NDCG@5, the first request held to the
    CPU copy. K1 in the retriever's query encoding."""
    import numpy as np
    import torch
    from recstudio_torch.data import SeqDataset
    from recstudio_torch.models.loss_func import BinaryCrossEntropyLoss
    from recstudio_torch.serving import Predictor
    from recstudio_torch.utils import get_model, seed_everything
    from recstudio_torch.utils.parity import topk_mismatches

    def drive():
        seed_everything(2022)
        t0 = time.perf_counter()
        din_cls, din_conf = get_model("DIN")
        din_conf["data"].update(binarized_rating_thres=0.0)
        din_conf["train"].update(epochs=1, negative_count=2)
        din_conf["eval"].update(topk=20, cutoff=[5], val_metrics=["ndcg"],
                                test_metrics=["ndcg", "recall"], save_path=SAVE_DIR)
        ds = SeqDataset("ml-100k", config={"low_rating_thres": 0.0})
        trn, val, tst = ds.build(**din_conf["data"])
        sas_cls, sas_conf = get_model("SASRec")
        sas_conf["train"]["epochs"] = 1
        sas_conf["eval"].update(topk=100, save_path=SAVE_DIR)
        retr = sas_cls(sas_conf, device=device)
        retr.fit(trn, None)
        model = din_cls(din_conf, device=device, retriever=retr, loss=BinaryCrossEntropyLoss())
        model.fit(trn, val)
        result = model.evaluate(tst, verbose=False)
        run_s = time.perf_counter() - t0
        bs = int(din_conf["eval"]["batch_size"])             # evaluate's shapes
        pred = Predictor(model, max_batch=bs, k=20, train_data=tst).warm()
        requests, targets = serve_requests(pred, tst, bs)
        served = [pred(r) for r in requests]
        return model, tst, result, run_s, pred, requests, targets, served

    (model, tst, result, run_s, pred, requests, targets, served), counts = counted(drive)
    ids = np.concatenate([i for _, i in served])
    tgt = torch.as_tensor(np.concatenate(targets))[:, None]
    from recstudio_torch import eval as ev
    hit = ev.hit_matrix(torch.as_tensor(ids), tgt)
    served_ndcg = float(ev.ndcg(hit, (tgt > 0).float(), 5).mean())
    cpu = cascade_cpu_copy(model, model._train_data)
    req = requests[0]
    hist = torch.from_numpy(np.asarray(tst.user_hist, np.int32)[req["user_id"]])
    s_c, i_c = cpu.topk({k: torch.from_numpy(np.asarray(v)) for k, v in req.items()}, 20, hist)
    s_k, i_k = served[0]
    cpu_bad = topk_mismatches(i_k, s_k, i_c.numpy(), s_c.numpy(), TOL_SCORES)
    out = {"phase": "AD", "model": "SASRec->DIN", "dataset": "ml-100k",
           "entry": "fit(retriever), then the ranker with retriever= and loss=",
           "launches": counts, "run_s": run_s, "epochs_run": len(model.epoch_log),
           "test": result, "served_users": len(ids), "served_ndcg@5": served_ndcg,
           "cpu_rows": len(i_k), "cpu_rows_disagreeing": cpu_bad,
           "cpu_max_score_diff": float(np.abs(s_k - s_c.numpy()).max()),
           **{"serve_" + k: v for k, v in pred.stats().items()}}
    emit("PHASE", out)
    check(counts["fused_transformer_layer"] > 0, f"phase AD cascade: {counts}")
    check(len(ids) == len(tst.data_index) and abs(served_ndcg - result["ndcg@5"]) <= TOL_METRIC,
          f"phase AD cascade: served NDCG@5 {served_ndcg} vs evaluate's {result['ndcg@5']}")
    check(cpu_bad == 0, f"phase AD cascade: {cpu_bad} lists differ from the CPU copy's")
    return out


# ---------------------------------------------------------------------------
# phases AE and AF: the CTR interaction zoo, InterHAt and DIFM
# ---------------------------------------------------------------------------
# each model's repo config, as phase AE checks it (criteo-1m-shape, batch 8192)
AE_MODELS = {
    "InterHAt": dict(embed_dim=16, n_head=2, feedforward_dim=64, order=3, aggregation_dim=32,
                     mlp_layer=[128, 64], dropout=0.3),
    "DIFM": dict(embed_dim=10, mlp_layer=[256, 256], n_head=2, dropout=0.3),
    "xDeepFM": dict(embed_dim=10, cin_layer_size=[100, 100, 100], mlp_layer=[128, 128, 128],
                    direct=False, dropout=0.2),
    "DCNv2": dict(embed_dim=10, combination="parallel", low_rank=None, num_layers=3,
                  mlp_layer=[256, 256, 256], dropout=0.5, batch_norm=True),
    "PNN": dict(embed_dim=10, product_type="inner", mlp_layer=[128, 64], dropout=0.5),
    "DLRM": dict(embed_dim=10, op="sum", top_mlp_layer=[128, 128],
                 bottom_mlp_layer=[128, 128], top_dropout=0.5, bottom_dropout=0.5),
    "FwFM": dict(embed_dim=10, linear_type="filv"),
    "AFM": dict(embed_dim=10, attention_dim=4, dropout=0.5),
    "FFM": dict(embed_dim=10),
    "FmFM": dict(embed_dim=10),
    "FiBiNET": dict(embed_dim=10, reduction_ratio=3, bilinear_type="interaction",
                    mlp_layer=[128, 32], dropout=0.5, shared_bilinear=True),
    "MaskNet": dict(embed_dim=10, parallel=False, num_blocks=3, block_dim=50,
                    mlp_layer=[512, 128], dropout=0.5),
    "ONN": dict(embed_dim=10, mlp_layer=[128, 64], dropout=0.2, batch_norm=True),
    "HFM": dict(embed_dim=10, op="circular_correlation", deep=True, mlp_layer=[256, 256, 256],
                dropout=0.3),
    "AFN": dict(embed_dim=10, log_hidden_size=128, mlp_layer=[128, 128], ensemble=True,
                ensemble_mlp_layer=[256, 64], dropout=0.5, ensemble_dropout=0.5),
}
# the kernels each model launches in phase AE (the rest launch none)
AE_KERNELS = {"InterHAt": ("fused_transformer_layer", "fused_transformer_layer_bwd"),
              "DIFM": ("fused_mha",)}
# rows of the step held to the CPU copy (the plain Philox masks of a whole
# 8192-row step on the host's cores would take most of the phase's time)
AE_CPU_ROWS = 1024


def ae_zero_gradients(name, model):
    """Gradients that are zero in exact arithmetic: a Linear's bias that
    feeds a batch norm in training mode, an attention's key bias; DESTINE's
    unary logits' bias (a softmax over the fields) and its queries' and
    keys' (the whitening over the fields). FLEN's first-order bias is not
    one here: dropout scales it row by row before its batch norm."""
    from recstudio_torch.models.module.layers import MLPModule, SimpleBatchNorm
    zero = [f"{mname}.dense_{i}.bias" for mname, m in model.net.named_modules()
            if isinstance(m, MLPModule) for i in range(m.n_layers)
            if isinstance(getattr(m, f"bn_{i}", None), SimpleBatchNorm)
            and getattr(m, f"dense_{i}").bias is not None]
    if name == "DIFM":
        zero.append("vector_fen.attn.k_proj.bias")
    if name == "DESTINE":
        zero += [f"attn_{i}.{leaf}.bias" for i in range(model.net.n_layers)
                 for leaf in ("unary", "Wq", "Wk")]
    return zero


def zoo_step(device, name, trn, tst, B, staged, tag="AE", expected=None, over=None,
             busy_steps=0):
    """One model of phase AE (or ``tag``): its repo config (``over``
    applied; ``expected`` is what it must be, ``AE_MODELS[name]`` by
    default) on criteo-1m-shape at batch ``B``, initialised from its seed;
    20 timed steps, the card's busy share of ``busy_steps`` more, one step
    held to the CPU copy (its relus taking the card's decisions,
    ``relu_inputs``), one evaluation, ``ScorePredictor`` at ``B`` rows held
    to ``predict``; InterHAt's and DIFM's evaluation held to the plain
    route."""
    import numpy as np
    import torch
    from recstudio_torch.models.module import TransformerLayer
    from recstudio_torch.models.module.layers import MultiHeadAttention
    from recstudio_torch.serving import ScorePredictor
    from recstudio_torch.utils import get_model
    expected = AE_MODELS[name] if expected is None else expected
    cls, conf = get_model(name)
    conf["model"].update(over or {})
    conf["train"].update(epochs=1, batch_size=B, seed=2022)
    conf["eval"].update(batch_size=B, val_metrics=["auc"], test_metrics=["auc", "logloss"],
                        save_path=SAVE_DIR)
    t = t_model = time.perf_counter()
    model = cls(conf, device=device)
    model._init_model(trn)
    model._init_parameter(trn)
    model.optimizer = model._get_optimizer()
    if not staged:                           # the training split, staged once for all
        model._setup_scan_epoch(trn)
        staged.update(arrays=model._epoch_arrays, fn=model._batch_fn, rows=model._epoch_rows)
    model._epoch_arrays, model._batch_fn = staged["arrays"], staged["fn"]
    model._epoch_rows = staged["rows"]
    model._train_data = trn                  # the batch norms calibrate on it
    init_s = time.perf_counter() - t
    mc = model.config["model"]
    shape = {k: (model.embed_dim if k == "embed_dim" else mc.get(k)) for k in expected}
    fields = len(model.fields) - 1
    check(shape == expected and fields == 39 and B == 8192,
          f"phase {tag} {name} config {shape}, {fields} fields, batch {B}")
    torch.cuda.reset_peak_memory_stats(device)
    steps, times, losses, counts = timed_steps(model, epoch_stream(model))
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    p50 = times[len(times) // 2]
    busy = {}
    if busy_steps:                           # the card's busy share of a few more steps
        host_ms, busy_ms = busy_share(lambda: [model._grad_step(b)
                                               for b in steps[:busy_steps]])
        check(busy_ms is not None, f"phase {tag} {name}: the profiler saw no device activity")
        busy = {"busy_steps": busy_steps, "busy_host_ms": host_ms, "busy_ms": busy_ms,
                "busy_share": busy_ms / host_ms}
    _, step_counts = counted(lambda: model._grad_step(steps[0]))
    model.net.eval()

    zero = ae_zero_gradients(name, model)
    rows = {k: v[:AE_CPU_ROWS] for k, v in steps[-1].items()}
    t = time.perf_counter()
    cpu, relus = cpu_copy(model, trn), {}
    loss_k, loss_c, grad_err, step_ok, over = card_vs_cpu_step(model, cpu, rows, zero, relus)
    del cpu
    cpu_step_s = time.perf_counter() - t

    result, eval_counts = counted(lambda: model.evaluate(tst, verbose=False))
    torch.cuda.synchronize()
    t = time.perf_counter()
    model._eval_epoch(tst, ["auc", "logloss"], [None])
    eval_s = time.perf_counter() - t
    plain = [m for m in model.net.modules()
             if isinstance(m, (TransformerLayer, MultiHeadAttention))]
    route_diff = None
    route_tol = TOL_DIFM_PROB if name == "DIFM" else TOL_PROB
    if plain:                                # the kernel route, then the plain route
        routes = []
        for flag in (False, True):
            for m in plain:
                m.plain = flag
            routes.append(eval_probs(model, tst))
        for m in plain:
            m.plain = False
        route_diff = max_prob_diff(*routes)

    pred = ScorePredictor(model, max_batch=B, train_data=trn)
    cols = [f for f in tst.inter_feat.fields if f != model.frating]
    request = {f: tst.inter_feat.get_col(f)[tst.data_index[:B]] for f in cols}
    pred.warm(request)
    served, serve_counts = counted(lambda: pred(request))
    tst.use_field = model.fields
    serve_diff = float(np.abs(served - model.predict(tst._get_pos_batch(np.arange(B)))).max())
    launched = {k: counts[k] + step_counts[k] + eval_counts[k] + serve_counts[k] for k in counts}
    ph = {"phase": tag, "model": name, "config": shape, "fields": fields, "batch": B,
          "init_s": init_s, "launches": launched, "timed_steps_launches": counts,
          "training_step_launches": step_counts,
          "eval_launches": eval_counts, "serve_launches": serve_counts,
          "step_ms_p50": p50, "step_ms_min": times[0], "step_ms_max": times[-1],
          "examples_per_s": B / p50 * 1e3, "peak_mem_gb": peak_gb, **busy,
          "params_m": sum(p.numel() for p in model.net.parameters()) / 1e6,
          "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
          "cpu_rows": AE_CPU_ROWS, "card_loss": loss_k, "cpu_loss": loss_c,
          "grad_max_abs_err": grad_err, "grad_err_over_tol_largest": over,
          "grad_tol": TOL_GRAD, "loss_tol": TOL_LOSS, "zero_gradients": zero,
          "test_auc_after_steps": result["auc"], "test_logloss": result["logloss"],
          "eval_s": eval_s, "eval_rows_per_s": len(tst.data_index) / eval_s,
          "route_diff": route_diff,
          "route_tol": route_tol, "relu_flip_tol": TOL_RELU_FLIP, **relus,
          "cpu_step_s": cpu_step_s, "model_s": time.perf_counter() - t_model,
          "serve_max_abs_diff_vs_predict": serve_diff,
          **{"serve_" + k: v for k, v in pred.stats().items()}}
    emit("PHASE", ph)
    kernels = AE_KERNELS.get(name, ())
    check(not {k: v for k, v in launched.items() if k not in kernels and v},
          f"phase {tag} {name} launched {counts} {eval_counts} {serve_counts}")
    if name == "InterHAt":
        check(counts["fused_transformer_layer"] > 0 and counts["fused_transformer_layer_bwd"] > 0
              and eval_counts["fused_transformer_layer"] > 0
              and serve_counts["fused_transformer_layer"] > 0
              and not eval_counts["fused_transformer_layer_bwd"],
              f"phase AE InterHAt: K1/K2 launches {counts}, {eval_counts}, {serve_counts}")
    if name == "DIFM":
        check(not counts["fused_mha"] and eval_counts["fused_mha"] > 0
              and serve_counts["fused_mha"] > 0,
              f"phase AE DIFM: K3 launches {counts}, {eval_counts}, {serve_counts}")
    check(bool(torch.isfinite(losses).all()) and 0 < result["auc"] < 1,
          f"phase {tag} {name} losses {losses}, AUC {result['auc']}")
    check(step_ok, f"phase {tag} {name}: the step disagrees with the CPU copy's: loss {loss_k} "
                   f"vs {loss_c}, gradients {grad_err} {over}")
    check(relus["flipped_largest_input"] <= TOL_RELU_FLIP,
          f"phase {tag} {name}: card and CPU copy decide relus apart away from 0: {relus}")
    check(route_diff is None or route_diff <= route_tol,
          f"phase {tag} {name}: the kernel route's scores differ from the plain route's by "
          f"{route_diff}")
    check(serve_diff <= TOL_PROB, f"phase {tag} {name}: ScorePredictor differs from predict by "
                                  f"{serve_diff}")
    return ph


def phase_ae(device):
    """The fifteen models of the zoo at their repo configs on phase R's data
    (criteo-1m-shape, 39 fields), batch 8192 (``zoo_step``): InterHAt
    through K1 and K2 (K1 alone in evaluation and serving), DIFM's
    evaluation and serving through K3, the others through no kernel."""
    ref, ds, (trn, _, tst), _, _, _, _ = criteo_setup()
    staged = {}
    return [zoo_step(device, name, trn, tst, ref["batch_size"], staged) for name in AE_MODELS]


def phase_af(device):
    """InterHAt, DIFM and xDeepFM the way users start them
    (``ranker_fit_phase``, one epoch each): InterHAt's training
    through K1 and K2, its validation, evaluation and serving through K1;
    DIFM's validation, evaluation and serving through K3."""
    kernels = {"InterHAt": ("fused_transformer_layer", "fused_transformer_layer_bwd"),
               "DIFM": ("fused_mha",), "xDeepFM": ()}
    keys = {"InterHAt": ("embed_dim", "n_head", "feedforward_dim", "order", "dropout"),
            "DIFM": ("embed_dim", "mlp_layer", "n_head", "dropout"),
            "xDeepFM": ("embed_dim", "cin_layer_size", "direct", "dropout")}
    return [ranker_fit_phase(device, "AF", name, {k: AE_MODELS[name][k] for k in keys[name]},
                             kernels[name], profile=False) for name in kernels]


# ---------------------------------------------------------------------------
# phases AI and AJ: the rest of the CTR ranker zoo
# ---------------------------------------------------------------------------
# criteo-1m-shape's columns: 13 float fields and 26 token fields, no user or
# item id and no feature table. FLEN's, FinalMLP's and PPNet's default groups
# (the interaction, user and item tables' fields; the user and item
# features or ids) are then single or empty, which the JAX package and the
# port refuse to build; phase AI sets them from the columns
CRITEO_FLOATS = [f"I{i}" for i in range(1, 14)]
CRITEO_TOKENS = [f"C{i}" for i in range(1, 27)]
AI_GROUPS = {"FLEN": {"fields": [CRITEO_FLOATS, CRITEO_TOKENS]},
             "FinalMLP": {"fields1": CRITEO_FLOATS, "fields2": CRITEO_TOKENS},
             "PPNet": {"gate_fields": CRITEO_TOKENS}}
# each model's repo config (with AI_GROUPS), as phase AI checks it
AI_MODELS = {
    "DeepCrossing": dict(embed_dim=10, hidden_dims=[64, 64, 64], dropout=0.5),
    "IFM": dict(embed_dim=10, mlp_layer=[256, 256, 256], dropout=0.5, batch_norm=False),
    "DeepIM": dict(embed_dim=10, order=3, mlp_layer=[256, 256], dropout=0.3),
    "LorentzFM": dict(embed_dim=10),
    "PPNet": dict(embed_dim=10, mlp_layer=[256, 128], gate_hidden_dim=64, dropout=0.3,
                  **AI_GROUPS["PPNet"]),
    "FinalMLP": dict(embed_dim=10, mlp_layer1=[256, 256], mlp_layer2=[256, 256], dropout1=0.3,
                     dropout2=0.3, fs_mlp_layer=[128], n_head=2, **AI_GROUPS["FinalMLP"]),
    "EDCN": dict(embed_dim=10, num_layers=3, bridge_type="hadamard_product", dropout=0.3),
    "FLEN": dict(embed_dim=10, mlp_layer=[128, 64], dropout=0.3, **AI_GROUPS["FLEN"]),
    "SAM": dict(embed_dim=10, interaction_type="sam2e", aggregation="concat", dropout=0.0),
    "AOANet": dict(embed_dim=10, num_interaction_layers=2, num_subspaces=4,
                   mlp_layer=[128, 64], dropout=0.3),
    "DESTINE": dict(embed_dim=10, attention_dim=32, num_attention_layers=3, n_head=2,
                    mlp_layer=[128, 64], dropout=0.3),
    "FiGNN": dict(embed_dim=10, num_layers=2),
    "CCPM": dict(embed_dim=10, channels=[3, 3], heights=[6, 5], mlp_layer=[256], dropout=0.5),
    "FGCNN": dict(embed_dim=10, channels=[6, 8], heights=[7, 7], pooling_sizes=[2, 2],
                  recombine_channels=[3, 3], mlp_layer=[128, 64], dropout=0.3),
}
AI_BUSY_STEPS = 5


def phase_ai(device):
    """The fourteen models at their repo configs on phase R's data
    (criteo-1m-shape, 39 fields), batch 8192, through ``zoo_step`` with
    five more steps profiled for the card's busy share; FLEN's, FinalMLP's
    and PPNet's field groups set from criteo's columns (``AI_GROUPS``). No
    kernel is launched: the JAX models reach no Pallas kernel."""
    ref, ds, (trn, _, tst), _, _, _, _ = criteo_setup()
    staged = {}
    return [zoo_step(device, name, trn, tst, ref["batch_size"], staged, "AI", expected,
                     AI_GROUPS.get(name), AI_BUSY_STEPS) for name, expected in AI_MODELS.items()]


def phase_aj(device):
    """FinalMLP (its default streams: ml-100k's user and item features),
    FiGNN and FGCNN the way users start them (``ranker_fit_phase``, one
    epoch each), test AUC held to the six-seed JAX bands, every test row
    served; no kernel."""
    expected = {"FinalMLP": dict(embed_dim=10, mlp_layer1=[256, 256], mlp_layer2=[256, 256],
                                 n_head=2, fields1=None, fields2=None),
                "FiGNN": AI_MODELS["FiGNN"],
                "FGCNN": {k: AI_MODELS["FGCNN"][k] for k in
                          ("embed_dim", "channels", "heights", "pooling_sizes",
                           "recombine_channels")}}
    return [ranker_fit_phase(device, "AJ", name, config, profile=False)
            for name, config in expected.items()]


AG_MODELS = {"CL4SRec": dict(hidden_size=64, layer_num=1, head_num=2, dropout_rate=0.5,
                             layer_norm_eps=1e-12),
             "CoSeRec": dict(hidden_size=64, layer_num=1, head_num=2, dropout_rate=0.5,
                             layer_norm_eps=1e-12),
             "ICLRec": dict(hidden_size=64, layer_num=1, head_num=2, dropout_rate=0.5,
                            layer_norm_eps=1e-5, num_intent_clusters=256),
             "Caser": dict(n_v=8, n_h=16, dropout=0.4), "FPMC": {}, "TransRec": {},
             "HGN": dict(pooling_type="mean"), "NPE": dict(dropout_rate=0.3)}
AG_CL = ("CL4SRec", "CoSeRec", "ICLRec")
AG_BATCH, AG_L = 256, 200
# rows of the CPU copy's step (Caser's 200 convolutions take ~0.7 s a row
# on the card machine's CPU)
AG_CPU_ROWS = dict(Caser=4, FPMC=64, TransRec=64, HGN=64, NPE=64)
# steps profiled for the card's busy share
AG_BUSY_STEPS = 5
CL_KERNELS = ("fused_transformer_layer", "fused_transformer_layer_bwd")


def seq_card_vs_cpu(model, cpu, batch, neg, **kwargs):
    """One training step on the card and on its CPU copy with the negatives
    ``neg`` and the same dropout seeds: (card loss, CPU loss, max gradient
    error, loss and gradients ok). ``kwargs`` go to both ``training_step``
    calls, their tensors moved to the CPU for the copy's."""
    gen = model.generator.get_state()
    loss_k, grads_k = step_on(model, batch, neg, **kwargs)
    cpu.generator.set_state(gen)
    loss_c, grads_c = step_on(cpu, {k: v.cpu() for k, v in batch.items()}, neg.cpu(),
                              **_to_cpu(kwargs))
    max_abs, ok = grad_errors({k: v.cpu() for k, v in grads_k.items()}, grads_c)
    return loss_k, loss_c, max_abs, ok and abs(loss_k - loss_c) <= TOL_LOSS * abs(loss_c)


def _to_cpu(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def ag_step(device, name, cls, conf, trn, etl_s):
    """One model of phase AG on the ml-1m shape's split ``trn``: its refresh,
    20 timed steps, the busy share of ``AG_BUSY_STEPS``, and one step held
    to the plain layers or to the CPU copy."""
    import numpy as np
    import torch
    t = time.perf_counter()
    model = cls(conf, device=device)
    model._init_model(trn)
    model._init_parameter(trn)
    model.optimizer = model._get_optimizer()
    model._setup_scan_epoch(trn)
    init_s = time.perf_counter() - t
    mc, tc = model.config["model"], model.config["train"]
    shape = {k: mc[k] for k in AG_MODELS[name]}
    check(shape == AG_MODELS[name] and model.embed_dim == 64 and model.max_seq_len == AG_L
          and tc["batch_size"] == AG_BATCH, f"phase AG {name} config {shape}")
    out = {"phase": "AG", "model": name, "config": dict(shape, embed_dim=64, L=AG_L,
                                                         batch=AG_BATCH),
           "dataset": type(trn).__name__, "train_rows": len(trn.data_index), "etl_s": etl_s,
           "init_s": init_s}
    refresh, refresh_counts = {}, {}
    if name == "CoSeRec":
        out["cooccurrence_s"] = model.cooccurrence_s
        warm_up = mc["augmentation_warm_up_epochs"]
        for tag, warm in (("offline", warm_up), ("online", 0)):
            mc["augmentation_warm_up_epochs"] = warm
            model.states.pop("top1_sim", None)
            torch.cuda.synchronize()
            t = time.perf_counter()
            model._epoch_refresh(0)
            torch.cuda.synchronize()
            refresh[tag] = (time.perf_counter() - t, model.states["top1_sim"].clone())
        mc["augmentation_warm_up_epochs"] = warm_up
        out["refresh_offline_s"], out["refresh_online_s"] = refresh["offline"][0], \
            refresh["online"][0]
        out["online_neighbours_changed"] = float(
            (refresh["offline"][1] != refresh["online"][1]).float().mean())
        check(torch.equal(refresh["offline"][1], model._offline_top1)
              and refresh["online"][1].shape == model._offline_top1.shape
              and out["online_neighbours_changed"] > 0, "phase AG CoSeRec refresh")
    else:
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, refresh_counts = counted(lambda: model._epoch_refresh(0))
        out["refresh_s"] = time.perf_counter() - t
        if name == "ICLRec":
            centres = model.states["intent_centroids"]
            out["refresh_launches"] = refresh_counts
            check(tuple(centres.shape) == (256, 64) and bool(torch.isfinite(centres).all())
                  and refresh_counts["fused_transformer_layer"] > 0
                  and not refresh_counts["fused_transformer_layer_bwd"],
                  f"phase AG ICLRec refresh: {tuple(centres.shape)}, {refresh_counts}")
    if name in AG_CL:
        layers = model.query_encoder.transformer.layers

        def set_path(plain):
            for layer in layers:
                layer.plain = plain
        metrics, losses, counts, ((loss_p, max_abs, ok),) = steps_and_comparison(
            model, set_path, (True,))
        out.update(metrics, plain_loss=loss_p, grad_max_abs_err=max_abs, compare="plain layers")
        ok &= abs(metrics["kernel_loss"] - loss_p) <= TOL_LOSS * abs(loss_p)
    else:
        torch.cuda.reset_peak_memory_stats()
        steps, times, losses, counts = timed_steps(model, epoch_stream(model))
        p50 = times[len(times) // 2]
        out.update(steps=len(times), step_ms_p50=p50, step_ms_max=times[-1],
                   examples_per_s=AG_BATCH / (p50 / 1e3), loss_first=float(losses[0]),
                   loss_last=float(losses[-1]),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
        n_rows = AG_CPU_ROWS[name]
        rows = {k: v[:n_rows] for k, v in steps[-1].items()}
        neg = torch.from_numpy(np.random.default_rng(2035).integers(
            1, trn.num_items, size=(n_rows, 1))).to(device)
        t = time.perf_counter()
        cpu = cpu_copy(model, trn)
        loss_k, loss_c, max_abs, ok = seq_card_vs_cpu(model, cpu, rows, neg)
        del cpu
        out.update(compare="CPU copy", cpu_rows=n_rows, card_loss=loss_k, cpu_loss=loss_c,
                   grad_max_abs_err=max_abs, cpu_step_s=time.perf_counter() - t,
                   grad_tol=TOL_GRAD, loss_tol=TOL_LOSS)
    batches = itertools.islice(epoch_stream(model), AG_BUSY_STEPS)
    model.net.train()
    host_ms, busy_ms = busy_share(lambda: [model._grad_step(b) for b in batches])
    model.net.eval()
    out.update(launches={k: v + refresh_counts.get(k, 0) for k, v in counts.items()},
               timed_steps_launches=counts, busy_steps=AG_BUSY_STEPS, busy_host_ms=host_ms,
               busy_ms=busy_ms, busy_share=None if busy_ms is None else busy_ms / host_ms)
    emit("PHASE", out)
    check(bool(torch.isfinite(losses).all()), f"phase AG {name} losses {losses}")
    check(ok, f"phase AG {name}: the step disagrees with its {out['compare']}: "
              f"{out.get('kernel_loss', out.get('card_loss'))}, gradients {max_abs}")
    if name in AG_CL:                # three encoder passes a step; ICLRec's fourth, evaluating
        passes = 4 if name == "ICLRec" else 3
        check(counts["fused_transformer_layer"] == passes * out["steps"]
              and counts["fused_transformer_layer_bwd"] == 3 * out["steps"],
              f"phase AG {name}: K1, K2 launches {counts} in {out['steps']} steps")
        check(not any(v for k, v in counts.items() if k not in CL_KERNELS),
              f"phase AG {name} launched {counts}")
    else:
        check(not any(counts.values()), f"phase AG {name} launched a kernel: {counts}")
    return out



def phase_ag(device):
    """The eight sequential retrievers of the zoo at full width on the ml-1m
    shape at L 200 (``ag_step``), the split built once for each dataset
    class."""
    from recstudio_torch.data.synthetic import SHAPES, generate
    from recstudio_torch.utils import get_model
    name, config = generate("ml-1m-shape", *SHAPES["ml-1m-shape"], seed=7)
    config["max_seq_len"] = AG_L
    splits, out = {}, []
    for model_name in AG_MODELS:
        cls, conf = get_model(model_name)
        conf["train"].update(batch_size=AG_BATCH, seed=7)
        ds_cls = cls._get_dataset_class()
        if ds_cls not in splits:
            t = time.perf_counter()
            trn = ds_cls(name, config=config).build(**conf["data"])[0]
            splits[ds_cls] = (trn, time.perf_counter() - t)
        out.append(ag_step(device, model_name, cls, conf, *splits[ds_cls]))
    return out


def phase_ah(device):
    """CL4SRec, ICLRec and CoSeRec the way users start them (``fit_phase``
    through ``quickstart.run``): training through K1 and K2, evaluation and
    serving through K1; test NDCG@10 in the JAX band, which clears chance."""
    out = []
    for name in ("CL4SRec", "ICLRec", "CoSeRec"):
        path = os.path.join(REPO, "recstudio_torch", "assets",
                            f"{name.lower()}_ml100k_train_reference.json")
        with open(path) as f:
            ref = json.load(f)
        check(ref["ndcg@10_band"][0] > ref["untrained_ndcg@10"],
              f"phase AH {name}: the JAX band does not clear the untrained NDCG@10")
        out.append(fit_phase(device, "AH", name, path,
                             dict(TRANSFORMER_KEYS, dropout="dropout_rate"),
                             dict(embed_dim=64, hidden=64, heads=2, layers=1, dropout=0.5, L=20,
                                  batch=256), CL_KERNELS, quickstart=True))
    return out


# ---------------------------------------------------------------------------
# phases AK and AL: the rest of the mf, debias and graph retrievers
# ---------------------------------------------------------------------------
# each model's repo config, checked before it runs (its widths)
AK_CONFIG = {"EASE": {"train": {"lambda": 250}},
             "ItemKNN": {"train": {"knn": 100, "similarity": "cosine"}},
             "SLIM": {"train": {"alpha": 1, "l1_ratio": 0.1, "max_iter": 200,
                                "positive_only": True}},
             "WRMF": {"model": {"embed_dim": 64}, "train": {"alpha": 1, "lambda": 0.5}},
             "IRGAN": {"model": {"embed_dim": 64, "T_dis": 0.2, "T_gen": 1, "sample_lambda": 0.2},
                       "train": {"batch_size": 16, "negative_count": 1}},
             "DSSM": {"model": {"embed_dim": 64, "mlp_layer": [128, 128, 128],
                                "activation": "tanh", "dropout": 0.3},
                      "train": {"batch_size": 512, "negative_count": 1}},
             "IPSBPR": {"model": {"embed_dim": 64, "ips_gamma": 0.5, "ips_clip": 100.0},
                        "train": {"batch_size": 512, "negative_count": 1}},
             "PDA": {"model": {"embed_dim": 64, "pda_gamma": 0.1},
                     "train": {"batch_size": 512, "negative_count": 1}},
             "SGL": {"model": {"embed_dim": 64, "n_layers": 3, "aug_type": "ED", "ssl_ratio": 0.1,
                               "ssl_reg": 0.1, "temperature": 0.2},
                     "train": {"batch_size": 2048, "negative_count": 1}},
             "NCL": {"model": {"embed_dim": 64, "n_layers": 3, "hyper_layers": 1,
                               "num_clusters": 10, "temperature": 0.05},
                     "train": {"batch_size": 2048, "negative_count": 1}}}
AK_CLOSED_FORM = ("EASE", "ItemKNN", "SLIM")
AK_STEP_MODELS = ("DSSM", "IPSBPR", "PDA")
AK_GRAPH = ("SGL", "NCL")
AK_BUSY_STEPS = 5
# SLIM's CPU copy takes this many ISTA steps (200 on the CPU would take
# minutes); the card takes the same for the comparison
AK_SLIM_CPU_STEPS = 10
# the closed forms on the card against the CPU's, as a share of max |B|:
# float32 Gram products of 6,040-long columns and EASE's inverse of a
# 3,706-wide matrix, summed in other orders
TOL_SOLVE = 2e-3
# ItemKNN's columns compared: those whose knn-th and knn + 1-th cosine
# similarities (at most 1, float32 errors near 1e-7) differ by more than this
TOL_TIE = 1e-5
# a WRMF half-sweep against the CPU copy's: (atol as a share of max |x|,
# rtol), batched float32 solves of 64-wide systems
TOL_ALS = (1e-4, 1e-3)


def background(work):
    """Start ``work()`` in a thread of its own: a ``wait()`` that joins it
    and returns its result, or raises what it raised. The CPU copies of
    phase AK compute there while the card goes on."""
    import threading
    box = {}

    def run():
        try:
            box["out"] = work()
        except Exception as e:               # raised again by wait()
            box["error"] = e

    thread = threading.Thread(target=run)
    thread.start()

    def wait():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["out"]

    return wait


def ak_model(device, name, trn, optimizers=True):
    """``name`` at its repo config (seed 7) on ``trn``, its config checked:
    (model, init s)."""
    import torch
    from recstudio_torch.utils import get_model
    cls, conf = get_model(name)
    got = {g: {k: conf[g][k] for k in keys} for g, keys in AK_CONFIG[name].items()}
    check(got == AK_CONFIG[name], f"phase AK {name} config {got}")
    conf["train"]["seed"] = 7
    conf["eval"]["save_path"] = SAVE_DIR
    torch.cuda.synchronize()
    t = time.perf_counter()
    model = cls(conf, device=device)
    model._init_model(trn)
    model._init_parameter(trn)
    if optimizers:
        model.optimizers = model._get_optimizers()
        model.optimizer = model.optimizers[0]
    torch.cuda.synchronize()
    return model, time.perf_counter() - t


def ak_request(model, tst):
    """One ``Predictor`` request of the eval batch's rows, held to the lists
    ``evaluate``'s step gives the same rows (``topk`` with the batch's
    history): ``(rows, equal)``."""
    import numpy as np
    from recstudio_torch.models.basemodel.recommender import batch_to_device
    from recstudio_torch.serving import Predictor
    size = int(model.config["eval"]["batch_size"])
    tst.use_field = model.fields
    batch = next(iter(tst.eval_loader(size)))
    n = int(batch["_size"])
    pred = Predictor(model, max_batch=size, k=20, train_data=tst).warm()
    _, ids = pred({f: batch[f][:n] for f in sorted(model.query_fields)})
    dev = batch_to_device(batch, model.device)
    _, want = model.topk(dev, 20, dev.get("user_hist"))
    return n, bool(np.array_equal(ids, want[:n].cpu().numpy()))


def held(got, want, tol):
    """(max abs error, ok): ``got`` within ``tol`` (atol as a share of max
    |want|, rtol) of ``want``."""
    diff = (got - want).abs()
    ok = bool((diff <= tol[0] * float(want.abs().max()) + tol[1] * want.abs()).all())
    return float(diff.max()), ok


def untied_columns(R, knn):
    """Columns of ItemKNN's cosine similarity (float64 on the CPU) whose
    ``knn``-th and ``knn + 1``-th values differ by more than ``TOL_TIE``:
    there the card and the CPU keep the same entries."""
    import torch
    R = R.double()
    G = R.t() @ R
    G.fill_diagonal_(0.0)
    norm = torch.sqrt((R * R).sum(0))
    S = G / (norm[:, None] * norm[None, :] + 1e-6)
    top = torch.topk(S, knn + 1, dim=0).values
    return torch.nonzero(top[knn - 1] - top[knn] > TOL_TIE).flatten()


def ak_closed_form(device, name, trn, tst):
    """EASE, ItemKNN or SLIM: the solve timed, its peak memory and busy
    share, ``B`` held to the CPU's solve (computed in the background), the
    test metrics and a request. Returns ``finish()``, which waits for the
    CPU's solve, emits the phase line, checks and returns it."""
    import copy
    import torch
    model, init_s = ak_model(device, name, trn, optimizers=False)
    t = time.perf_counter()
    model.trainloaders = model._get_train_loaders(trn)
    R = model._interaction_matrix()
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    _, counts = counted(lambda: model.training_epoch(0))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # SLIM's 200-product solve once, warm from the epoch above
    solve_ms = time_ms(lambda: model.solve(R), *((1, 0) if name == "SLIM" else (3, 1)))
    host_ms, busy_ms = busy_share(lambda: model.training_epoch(0))
    cpu = type(model)(copy.deepcopy(model.config), device="cpu")
    cpu._init_model(trn)
    tc = model.config["train"]
    if name == "SLIM":                          # both sides at AK_SLIM_CPU_STEPS
        tc["max_iter"] = cpu.config["train"]["max_iter"] = AK_SLIM_CPU_STEPS
        card = model.solve(R).cpu()
        tc["max_iter"] = 200
    else:
        card = model.states["B"].cpu()
    R_cpu = R.cpu()

    def cpu_side():
        t0 = time.perf_counter()
        want = cpu.solve(R_cpu)
        want = want[0] if name == "EASE" else want
        cpu_s = time.perf_counter() - t0
        cols = untied_columns(R_cpu, tc["knn"]) if name == "ItemKNN" \
            else torch.arange(card.shape[1])
        return {"cpu_solve_s": cpu_s, "cpu_columns_compared": int(len(cols)),
                "b_max_err_share": float((card - want)[:, cols].abs().max())
                / float(want.abs().max())}

    wait = background(cpu_side)
    ev = model._eval_epoch(tst, ["ndcg", "recall"], [10])
    rows, equal = ak_request(model, tst)
    out = {"phase": "AK", "model": name, "dataset": "ml-1m-shape", "users": trn.num_users - 1,
           "items": trn.num_items - 1, "train_rows": len(trn.data_index),
           "config": AK_CONFIG[name], "init_s": init_s, "stage_s": stage_s,
           "launches": counts, "solve_ms": solve_ms, "peak_mem_gb": peak,
           "busy_host_ms": host_ms, "busy_ms": busy_ms,
           "busy_share": None if busy_ms is None else busy_ms / host_ms,
           "cpu_steps": AK_SLIM_CPU_STEPS if name == "SLIM" else None,
           "solve_tol": TOL_SOLVE, "request_rows": rows, "request_equals_evaluate": equal, **ev}
    del model, R

    def finish():
        out.update(wait())
        emit("PHASE", out)
        check(not any(counts.values()), f"phase AK {name} launched a kernel: {counts}")
        check(out["cpu_columns_compared"] >= card.shape[1] // 2,
              f"phase AK {name}: {out['cpu_columns_compared']} columns compared")
        check(out["b_max_err_share"] <= TOL_SOLVE,
              f"phase AK {name}: B differs from the CPU's by {out['b_max_err_share']} of its max")
        check(equal, f"phase AK {name}: the served lists differ from evaluate's")
        return out

    return finish


def ak_wrmf(device, trn, tst):
    """WRMF: a user and an item half-sweep timed with their peak memory, the
    user sweep held to the CPU copy's (swept in the background), the busy
    share of one more sweep. Returns ``finish()``, as ``ak_closed_form``."""
    import torch
    model, init_s = ak_model(device, "WRMF", trn, optimizers=False)
    t = time.perf_counter()
    model.trainloaders = model._get_train_loaders(trn)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t
    cpu = cpu_copy(model, trn)
    sweeps, launches = [], {}
    for epoch in (0, 1):
        data = model.trainloaders[epoch]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, counts = counted(lambda: model.training_epoch(epoch))
        first_s = time.perf_counter() - t
        sweeps.append({"view": "users" if epoch == 0 else "items",
                       "rows": int(data["keys"].shape[0]), "width": int(data["vals"].shape[1]),
                       "first_s": first_s,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
        launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
        if epoch == 0:                   # held to the CPU copy's first user sweep below
            first_users = model.net.query_encoder.weight.detach().cpu().clone()
    for epoch in (0, 1):                 # a second pair, the libraries warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.training_epoch(epoch)
        torch.cuda.synchronize()
        sweeps[epoch]["s"] = time.perf_counter() - t
    def cpu_side():          # the copy's first user sweep, from the card's initial weights
        t0 = time.perf_counter()
        cpu.trainloaders = cpu._get_train_loaders(trn)
        cpu.training_epoch(0)
        err, ok = held(first_users, cpu.net.query_encoder.weight.detach(), TOL_ALS)
        return {"cpu_sweep_s": time.perf_counter() - t0, "user_table_max_abs_err": err}, ok

    wait = background(cpu_side)
    host_ms, busy_ms = busy_share(lambda: model.training_epoch(0))
    ev = model._eval_epoch(tst, ["ndcg", "recall"], [10])
    rows, equal = ak_request(model, tst)
    out = {"phase": "AK", "model": "WRMF", "dataset": "ml-1m-shape",
           "config": AK_CONFIG["WRMF"], "init_s": init_s, "stage_s": stage_s,
           "launches": launches, "sweeps": sweeps,
           "peak_mem_gb": max(s["peak_mem_gb"] for s in sweeps), "als_tol": TOL_ALS,
           "busy_host_ms": host_ms, "busy_ms": busy_ms,
           "busy_share": None if busy_ms is None else busy_ms / host_ms,
           "request_rows": rows, "request_equals_evaluate": equal, **ev}
    del model

    def finish():
        res, ok = wait()
        out.update(res)
        emit("PHASE", out)
        check(not any(launches.values()), f"phase AK WRMF launched a kernel: {launches}")
        check(ok, "phase AK WRMF: the user sweep differs from the CPU copy's by "
                  f"{out['user_table_max_abs_err']}")
        check(equal, "phase AK WRMF: the served lists differ from evaluate's")
        return out

    return finish


def _all_grads(model):
    import torch
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone()
            for n, p in model.net.named_parameters()}


def ak_irgan(device, trn, tst):
    """IRGAN: 20 host-loader steps of each player timed (copy in, step,
    synchronize), one step of each held to the CPU copy with the same
    draws, the busy share of five discriminator steps."""
    import numpy as np
    import torch
    from recstudio_torch.models.basemodel.recommender import batch_to_device
    model, init_s = ak_model(device, "IRGAN", trn)
    bs = int(model.config["train"]["batch_size"])
    loader = trn.train_loader(bs, True, np.random.default_rng(7))
    host = [b for b, _ in zip(itertools.cycle(loader), range(23))]
    cpu = cpu_copy(model, trn)              # takes the card's weights before each comparison
    mc = model.config["model"]
    compared, timed, launches = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    for phase in (0, 1):
        batch = batch_to_device(host[0], device)
        n, t = (model.neg_count, mc["T_dis"]) if phase == 0 else \
            (2 * model.neg_count, mc["T_gen"])
        with torch.no_grad():
            _, draws, _ = model._gen_sample(batch, n, t)
        model.net.zero_grad(set_to_none=True)
        loss_k = model.training_step(batch, phase, draws)
        loss_k.backward()
        cpu.load_state_dict({k: v.cpu() for k, v in model.net.state_dict().items()})
        cpu.net.zero_grad(set_to_none=True)
        loss_c = cpu.training_step(_to_cpu(batch), phase, draws.cpu())
        loss_c.backward()
        err, ok = grad_errors({k: v.cpu() for k, v in _all_grads(model).items()},
                              _all_grads(cpu))
        loss_k, loss_c = loss_k.item(), loss_c.item()
        # the generator's loss sums terms of both signs, so its float32 error
        # scales with the terms' sizes, not with the sum's
        scale = abs(loss_c) if phase == 0 else \
            float(cpu.gen_terms(_to_cpu(batch), draws.cpu()).abs().mean(1).sum())
        ok &= abs(loss_k - loss_c) <= TOL_LOSS * scale
        compared[phase] = {"card_loss": loss_k, "cpu_loss": loss_c, "loss_scale": scale,
                           "grad_max_abs_err": err, "ok": ok}
        model.net.zero_grad(set_to_none=True)
        model.net.train()
        for b in host[:3]:
            model.phase_step(batch_to_device(b, device), phase)
        torch.cuda.synchronize()

        def run():
            times = []
            for b in host[3:]:
                t0 = time.perf_counter()
                model.phase_step(batch_to_device(b, device), phase)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return sorted(times)
        times, counts = counted(run)
        launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
        timed["dis" if phase == 0 else "gen"] = {"steps": len(times),
                                                 "step_ms_p50": times[len(times) // 2],
                                                 "step_ms_max": times[-1]}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    host_ms, busy_ms = busy_share(lambda: [model.phase_step(batch_to_device(b, device), 0)
                                           for b in host[:AK_BUSY_STEPS]])
    model.net.eval()
    ev = model._eval_epoch(tst, ["ndcg", "recall"], [10])
    rows, equal = ak_request(model, tst)
    out = {"phase": "AK", "model": "IRGAN", "dataset": "ml-1m-shape",
           "config": AK_CONFIG["IRGAN"], "init_s": init_s, "launches": launches,
           "width": int(host[0][model.fiid].shape[1]), "timed": timed, "peak_mem_gb": peak,
           "cpu_compare": {("dis" if k == 0 else "gen"): v for k, v in compared.items()},
           "grad_tol": TOL_GRAD, "loss_tol": TOL_LOSS, "busy_steps": AK_BUSY_STEPS,
           "busy_host_ms": host_ms, "busy_ms": busy_ms,
           "busy_share": None if busy_ms is None else busy_ms / host_ms,
           "request_rows": rows, "request_equals_evaluate": equal, **ev}
    emit("PHASE", out)
    check(not any(launches.values()), f"phase AK IRGAN launched a kernel: {launches}")
    check(all(c["ok"] for c in compared.values()),
          f"phase AK IRGAN: a step differs from the CPU copy's: {compared}")
    check(equal, "phase AK IRGAN: the served lists differ from evaluate's")
    return out


def ak_steps(device, name, trn, tst, dataset, background_step=False):
    """DSSM, IPSBPR, PDA, SGL or NCL: its refresh (NCL's k-means) timed, 20
    timed steps, one held to the CPU copy within ``TOL_GRAD`` (the same
    rows, negatives, dropout seeds, SGL's keep masks, NCL's centroids),
    the busy share of five steps, a request. Returns ``finish()``, which
    waits for the CPU copy's step, emits the phase line, checks and returns
    it; with ``background_step`` the caller goes on with the card while the
    CPU step runs (the amazon-book-shape copies' steps take tens of seconds
    on the host)."""
    import numpy as np
    import torch
    model, init_s = ak_model(device, name, trn)
    model._setup_scan_epoch(trn)
    model._train_data = trn
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, refresh_counts = counted(lambda: model._epoch_refresh(0))
    refresh_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    steps, times, losses, counts = timed_steps(model, epoch_stream(model))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    batch = steps[-1]
    neg = torch.from_numpy(np.random.default_rng(2036).integers(
        1, trn.num_items, size=(batch[model.fiid].shape[0], model.neg_count))).to(device)
    t = time.perf_counter()
    cpu = cpu_copy(model, trn)
    cpu.states.update(_to_cpu(model.states))
    copy_s = time.perf_counter() - t
    kwargs = {"keep": [model.keep_masks(), model.keep_masks()]} if name == "SGL" else {}
    gen = model.generator.get_state()
    loss_k, grads_k = step_on(model, batch, neg, **kwargs)
    grads_k = {k: v.cpu() for k, v in grads_k.items()}
    def cpu_side():          # the same step on the CPU copy, from the same dropout seeds
        t0 = time.perf_counter()
        cpu.generator.set_state(gen)
        loss_c, grads_c = step_on(cpu, _to_cpu(batch), neg.cpu(), **_to_cpu(kwargs))
        max_abs, ok = grad_errors(grads_k, grads_c)
        return {"cpu_loss": loss_c, "grad_max_abs_err": max_abs,
                "cpu_step_s": time.perf_counter() - t0}, \
            ok and abs(loss_k - loss_c) <= TOL_LOSS * abs(loss_c)

    wait = background(cpu_side)
    if not background_step:
        wait()
    batches = itertools.islice(epoch_stream(model), AK_BUSY_STEPS)
    model.net.train()
    host_ms, busy_ms = busy_share(lambda: [model._grad_step(b) for b in batches])
    model.net.eval()
    rows, equal = ak_request(model, tst)
    p50 = times[len(times) // 2]
    bs = int(model.config["train"]["batch_size"])
    out = {"phase": "AK", "model": name, "dataset": dataset, "users": trn.num_users - 1,
           "items": trn.num_items - 1, "train_rows": model._epoch_rows,
           "config": AK_CONFIG[name], "init_s": init_s, "refresh_s": refresh_s,
           "launches": {k: v + refresh_counts.get(k, 0) for k, v in counts.items()},
           "steps": len(times), "step_ms_p50": p50, "step_ms_max": times[-1],
           "examples_per_s": bs / (p50 / 1e3), "loss_first": float(losses[0]),
           "loss_last": float(losses[-1]), "peak_mem_gb": peak, "card_loss": loss_k,
           "grad_tol": TOL_GRAD, "loss_tol": TOL_LOSS, "cpu_copy_s": copy_s,
           "cpu_step_in_background": background_step, "busy_steps": AK_BUSY_STEPS,
           "busy_host_ms": host_ms, "busy_ms": busy_ms,
           "busy_share": None if busy_ms is None else busy_ms / host_ms,
           "request_rows": rows, "request_equals_evaluate": equal}
    if name == "NCL":
        out["centroids"] = list(model.states["user_centroids"].shape)
    del model

    def finish():
        res, ok = wait()
        out.update(res)
        emit("PHASE", out)
        check(not any(out["launches"].values()), f"phase AK {name} launched a kernel: {counts}")
        check(bool(torch.isfinite(losses).all()), f"phase AK {name} losses {losses}")
        check(ok, f"phase AK {name}: the step differs from the CPU copy's: {loss_k} vs "
                  f"{out['cpu_loss']}, gradients {out['grad_max_abs_err']}")
        check(equal, f"phase AK {name}: the served lists differ from evaluate's")
        return out

    return finish


# phase AK's CPU copies still computing when AK returned with ``defer``:
# their ``finish`` closures, which phase AL calls at its end
_AK_PENDING = []


def phase_ak(device, defer=False):
    """The ten at full width (``AK_CONFIG``): SGL and NCL on phase T's
    amazon-book-shape split (built here when T has not run), their CPU
    copies' steps in the background while the eight others run on the
    synthetic ml-1m shape (seed 7, each dataset class's split built once).
    The closed forms' and WRMF's CPU copies compute in the background too.
    With ``defer`` the CPU work still running goes on through phase AL,
    which checks it and returns its phase lines first."""
    from recstudio_torch.data.synthetic import SHAPES, generate
    from recstudio_torch.utils import get_model, seed_everything
    if "splits" not in _AMAZON:
        ds, (trn, tst), _, _ = amazon_dataset()
        _AMAZON.update(name=ds.name, ds=ds, splits=(trn, tst))
    trn, tst = _AMAZON["splits"]
    pending = [ak_steps(device, model_name, trn, tst, "amazon-book-shape",
                        background_step=True) for model_name in AK_GRAPH]
    name, config = generate("ml-1m-shape", *SHAPES["ml-1m-shape"], seed=7)
    splits, out = {}, []
    for model_name in ("EASE", "ItemKNN", "SLIM", "WRMF", "IRGAN", "DSSM", "IPSBPR", "PDA"):
        cls, conf = get_model(model_name)
        ds_cls = cls._get_dataset_class()
        if ds_cls not in splits:
            seed_everything(7)
            trn, _, tst = ds_cls(name, config=config).build(**conf["data"])
            splits[ds_cls] = (trn, tst)
        trn, tst = splits[ds_cls]
        if model_name in AK_CLOSED_FORM:
            pending.append(ak_closed_form(device, model_name, trn, tst))
        elif model_name == "WRMF":
            pending.append(ak_wrmf(device, trn, tst))
        elif model_name == "IRGAN":
            out.append(ak_irgan(device, trn, tst))
        else:
            out.append(ak_steps(device, model_name, trn, tst, "ml-1m-shape")())
    if defer:
        _AK_PENDING.extend(pending)
        return out
    return out + [finish() for finish in pending]


AL_EXPECTED = {"EASE": ({}, dict(embed_dim=64, batch=512)),
               "ItemKNN": ({}, dict(embed_dim=64, batch=512)),
               "SLIM": ({}, dict(embed_dim=64, batch=512)),
               "WRMF": ({}, dict(embed_dim=64, batch=100)),
               "IRGAN": (dict(T_dis="T_dis", T_gen="T_gen"),
                         dict(embed_dim=64, T_dis=0.2, T_gen=1, batch=16, negative_count=1)),
               "DSSM": (dict(mlp="mlp_layer", dropout="dropout"),
                        dict(embed_dim=64, mlp=[128, 128, 128], dropout=0.3, batch=512,
                             negative_count=1)),
               "IPSBPR": (dict(gamma="ips_gamma"), dict(embed_dim=64, gamma=0.5, batch=512,
                                                        negative_count=1)),
               "PDA": (dict(gamma="pda_gamma"), dict(embed_dim=64, gamma=0.1, batch=512,
                                                     negative_count=1)),
               "SGL": (dict(n_layers="n_layers", aug="aug_type"),
                       dict(embed_dim=64, n_layers=3, aug="ED", batch=2048, negative_count=1)),
               "NCL": (dict(n_layers="n_layers", clusters="num_clusters"),
                       dict(embed_dim=64, n_layers=3, clusters=10, batch=2048,
                            negative_count=1))}


def phase_al(device):
    """The ten the way users start them (``fit_phase`` through
    ``quickstart.run`` on ml-100k), held to the bands of
    ``scripts/torch_retriever_seeds.py``, each band clearing the untrained
    model's NDCG@10; no profiled epoch (AK gives their busy shares). AK's
    deferred CPU steps are waited for and checked at its end."""
    out = []
    for name, (keys, expected) in AL_EXPECTED.items():
        reference = ML100K_TRAIN_REFERENCE.format(name.lower())
        with open(reference) as f:
            ref = json.load(f)
        check(ref["untrained_ndcg@10"] is None or
              ref["ndcg@10_band"][0] > ref["untrained_ndcg@10"],
              f"phase AL {name}: the JAX band does not clear the untrained NDCG@10")
        out.append(fit_phase(device, "AL", name, reference, keys, expected, (),
                             quickstart=True, overrides=ref.get("overrides") or None,
                             profile=False))
    held = [finish() for finish in _AK_PENDING]       # AK's deferred CPU steps
    _AK_PENDING.clear()
    return held + out


def causal_mask(L, device, causal=True):
    """The causal attention mask (True = disallow), or None (bidirectional)."""
    import torch
    return torch.triu(torch.ones((L, L), dtype=torch.bool, device=device), 1) if causal else None


def k1_versus_plain(device, B, L, D, F, H, causal=True, padded=True, act="gelu", eps=1e-12):
    """K1 in eval mode against the plain layer, with a bitwise repeat and
    the output tile of each of its four products (sized to the card);
    ``padded`` False: no key padding mask (InterHAt's fields)."""
    import numpy as np
    import torch
    from recstudio_torch.ops.transformer_layer import (forward_tiles, fused_transformer_layer,
                                                       transformer_layer_plain)
    from recstudio_torch.utils.convert import random_sasrec_params
    rng = np.random.default_rng(B + L)
    tree = random_sasrec_params(B + L, 2, D, 1, F, 1)
    params = layer_params(tree["query_encoder"]["transformer"]["layer_0"], device)
    x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(device)
    pad = torch.from_numpy(right_padding(rng, B, L)).to(device) if padded else None
    attn = causal_mask(L, device, causal)
    kern = lambda: fused_transformer_layer(x, params, pad, attn, H, 0.0, act, eps, False)
    plain = lambda: transformer_layer_plain(x, params, pad, attn, H, act, eps)
    lib_layer, lib_name = library_layer(params, D, H, F, eps, act, device)
    lib = lambda: lib_layer(x, src_mask=attn, src_key_padding_mask=pad)
    with torch.no_grad():
        got, want = kern(), plain()
        bitwise = torch.equal(got, kern())
        torch.cuda.synchronize()
        max_abs, max_rel, ok = errors(got, want, TOL_K1)
        ms, plain_ms = time_ms(kern), time_ms(plain)
        # the same function in one PyTorch call
        lib_abs, _, lib_ok = errors(lib(), want, TOL_K1)
        library_ms = time_ms(lib)
    flops = 2 * B * L * D * (3 * D + D + 2 * F) + 4 * attended_pairs(pad, attn, (B, L)) * D
    nbytes = 4 * (2 * B * L * D + 4 * D * D + 2 * D * F + 9 * D + F + (B * L if padded else 0)
                  + (L * L if causal else 0))
    b_ms, by = bound(flops, nbytes)
    return {"shape": dict(B=B, L=L, D=D, F=F, H=H, causal=causal, key_padding=padded,
                          activation=act), "max_abs_err": max_abs,
            "max_rel_err": max_rel, "tol": TOL_K1, "ok": ok and bitwise and lib_ok,
            "bitwise_repeatable": bitwise, "tiles": forward_tiles(B, L, D, F, False, device),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "gflop": flops / 1e9, "library_ms": library_ms, "library": lib_name,
            "library_max_abs_err": lib_abs}


def library_layer(params, D, H, F, eps, act, device):
    """``nn.TransformerEncoderLayer`` holding the layer's ``params``, in
    eval mode, and its description: one call (under ``no_grad``) computes
    K1's post-LN layer, the causal mask as ``src_mask`` and the right
    padding as ``src_key_padding_mask``. K1's gelu is the tanh form, a
    callable here, which takes the module off its fused fast path (relu
    with no mask keeps it)."""
    import functools
    import torch
    import torch.nn.functional as F_
    activation = "relu" if act == "relu" else functools.partial(F_.gelu, approximate="tanh")
    layer = torch.nn.TransformerEncoderLayer(D, H, F, dropout=0.0, activation=activation,
                                             layer_norm_eps=eps, batch_first=True,
                                             norm_first=False, device=device).eval()
    layer.load_state_dict({
        "self_attn." + n if n.startswith("in_proj") else
        "self_attn.out_proj." + n[len("out_proj_"):] if n.startswith("out_proj") else
        n.replace("_", ".", 1): v for n, v in params.items()})
    name = "nn.TransformerEncoderLayer, eval, " + (
        "relu (its fused fast path where no mask is given)" if act == "relu" else
        "tanh gelu as a callable (not the fused fast path)")
    return layer, name


def k3_versus_plain(device, B, H, L, Dh, causal=True):
    """K3 through ``fused_mha`` against mha_plain with right padding,
    example 0 fully masked, and the causal mask (or none); with the kernel's
    time alone on masks made once (``kernel_only_ms``: ``fused_mha`` makes
    them from the boolean masks on every call), and the share of (query
    tile, key tile) pairs it computes and of query tiles that make the extra
    pass for rows with no allowed key (``mha_tiles``, the kernel's skip
    rule)."""
    import numpy as np
    import torch
    from recstudio_torch.ops.attention import (MHA_TILE, additive_masks, fused_mha, mha_fwd,
                                               mha_plain, mha_tiles)
    rng = np.random.default_rng(B + L + 1)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, L, Dh)).astype(np.float32)).to(device)
               for _ in range(3))
    pad_np = right_padding(rng, B, L)
    pad_np[0] = True                   # one example whose keys are all masked
    pad = torch.from_numpy(pad_np).to(device)
    attn = causal_mask(L, device, causal)
    pad_add, attn_add = additive_masks(pad, attn)
    mask = sdpa_mask(pad_add, attn_add)
    kern = lambda: fused_mha(q, k, v, pad, attn)
    kern_only = lambda: mha_fwd(q, k, v, pad_add, attn_add)
    plain = lambda: mha_plain(q, k, v, pad_add, attn_add)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    with torch.no_grad():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        max_abs, max_rel, ok = errors(got, want, TOL_K3)
        masked_row_ok = bool(torch.allclose(got[0], v[0].mean(dim=1, keepdim=True).expand_as(
            got[0]), atol=TOL_K3[0], rtol=TOL_K3[1]))
        bitwise = torch.equal(got, kern()) and torch.equal(got, kern_only())
        ms, kernel_ms = time_ms(kern), time_ms(kern_only)
        plain_ms, library_ms = time_ms(plain), time_ms(lib)
    tiles, extra = mha_tiles(pad, attn, L, L, *MHA_TILE)
    flops = 4 * H * attended_pairs(pad, attn) * Dh
    nbytes = 4 * (4 * B * H * L * Dh + B * L + (L * L if causal else 0))
    b_ms, by = bound(flops, nbytes)
    return {"shape": dict(B=B, H=H, L=L, Dh=Dh, causal=causal), "max_abs_err": max_abs,
            "max_rel_err": max_rel, "tol": TOL_K3, "ok": ok and masked_row_ok and bitwise,
            "all_masked_row_uniform": masked_row_ok, "bitwise_repeatable": bitwise,
            "tile": list(MHA_TILE), "tiles_computed_share": float(tiles.float().mean()),
            "extra_pass_share": float(extra.float().mean()), "ms": ms,
            "kernel_only_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": by, "gflop": flops / 1e9}


def k3_unmasked_versus_plain(device, B, H, L, Dh):
    """K3 through ``fused_mha`` with no mask at all (AutoInt's attention over
    the fields) against mha_plain, with a bitwise repeat, beside SDPA; the
    share of the ``MHA_TILE`` tiles' score pairs that are real (L pads to
    whole tiles)."""
    import numpy as np
    import torch
    from recstudio_torch.ops.attention import MHA_TILE, fused_mha, mha_plain
    rng = np.random.default_rng(B + L + 2)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, L, Dh)).astype(np.float32)).to(device)
               for _ in range(3))
    kern = lambda: fused_mha(q, k, v)
    plain = lambda: mha_plain(q, k, v)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)
    with torch.no_grad():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        max_abs, max_rel, ok = errors(got, want, TOL_K3)
        bitwise = torch.equal(got, kern())
        ms, plain_ms, library_ms = time_ms(kern), time_ms(plain), time_ms(lib)
    flops = 4 * B * H * L * L * Dh
    nbytes = 4 * 4 * B * H * L * Dh
    b_ms, by = bound(flops, nbytes)
    padded = (-(-L // MHA_TILE[0]) * MHA_TILE[0]) * (-(-L // MHA_TILE[1]) * MHA_TILE[1])
    return {"shape": dict(B=B, H=H, L=L, Dh=Dh, causal=False, key_padding=False),
            "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": TOL_K3,
            "ok": ok and bitwise, "bitwise_repeatable": bitwise, "tile": list(MHA_TILE),
            "real_pair_share_of_tiles": L * L / padded, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": by, "gflop": flops / 1e9}


def layer_inputs(device, B, L, D, F, seed, causal=True, padded=True):
    """Seeded layer weights, x, an output gradient g, right padding (None
    unless ``padded``) and the attention mask (None unless ``causal``)."""
    import numpy as np
    import torch
    from recstudio_torch.utils.convert import random_sasrec_params
    rng = np.random.default_rng(seed)
    tree = random_sasrec_params(seed, 2, D, 1, F, 1)
    params = layer_params(tree["query_encoder"]["transformer"]["layer_0"], device)
    x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(device)
    pad = torch.from_numpy(right_padding(rng, B, L)).to(device) if padded else None
    return params, x, g, pad, causal_mask(L, device, causal)


def k1_train_versus_plain(device, B, L, D, F, H, p=0.5, seed=2026, causal=True, padded=True,
                          act="gelu", eps=1e-12):
    """K1 in training mode (dropout on) against the plain forward with the
    same masks, with a bitwise repeat of the output and of every residual
    K2 reads."""
    import torch
    from recstudio_torch.ops.transformer_layer import (forward_tiles, training_residuals,
                                                       transformer_layer_plain)
    params, x, _, pad, attn = layer_inputs(device, B, L, D, F, B + L + 2, causal, padded)
    call = lambda: training_residuals(x, params, pad, attn, H, p, act, eps, seed)
    kern = lambda: call()[0]
    plain = lambda: transformer_layer_plain(x, params, pad, attn, H, act, eps, p, seed, True)
    with torch.no_grad():
        (got, res), want = call(), plain()
        got2, res2 = call()
        bitwise = torch.equal(got, got2) and all(torch.equal(res[k], res2[k]) for k in res)
        del res, res2, got2
        torch.cuda.synchronize()
        max_abs, max_rel, ok = errors(got, want, TOL_K1)
        ms, plain_ms = time_ms(kern), time_ms(plain, iters=5)
    M = B * L
    flops = 2 * M * D * (3 * D + D + 2 * F) + 4 * attended_pairs(pad, attn, (B, L)) * D
    weights = 4 * D * D + 2 * D * F + 9 * D + F
    # x, weights, masks in; out and the residuals of K2 out
    nbytes = 4 * (M * D + weights + (B * L if padded else 0) + (L * L if causal else 0) + M * D
                  + M * (3 * D + 4 * D + 2 * F + 2) + B * H * L * 2)
    b_ms, by = bound(flops, nbytes)
    return {"shape": dict(B=B, L=L, D=D, F=F, H=H, dropout=p, causal=causal,
                          key_padding=padded, activation=act),
            "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": TOL_K1,
            "ok": ok and bitwise, "bitwise_repeatable": bitwise,
            "tiles": forward_tiles(B, L, D, F, True, device), "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": by, "gflop": flops / 1e9}


def k2_versus_plain(device, B, L, D, F, H, p=0.5, seed=2027, causal=True, padded=True,
                    act="gelu", eps=1e-12):
    """K2 (dropout on) against autograd through the plain forward with the
    same masks; the plain time is the autograd backward alone. Reports the
    share of its attention steps' tile pairs (``K2_ATTN_TILE``) K2 computes
    (``mha_tiles``: those holding an allowed pair, and every pair of a query
    tile that holds a row with no allowed key) and each weight gradient's
    row ranges (S, rows), sized to the card."""
    import torch
    from recstudio_torch.ops.attention import mha_tiles
    from recstudio_torch.ops.transformer_layer import (K2_ATTN_TILE, PARAM_NAMES,
                                                       fused_transformer_layer_bwd,
                                                       training_residuals,
                                                       transformer_layer_plain,
                                                       weight_grad_splits)
    params, x, g, pad, attn = layer_inputs(device, B, L, D, F, B + L + 3, causal, padded)
    _, res = training_residuals(x, params, pad, attn, H, p, act, eps, seed)
    kern = lambda: fused_transformer_layer_bwd(g, x, params, pad, attn, H, p, act, eps, seed,
                                               res)
    dx, grads = kern()
    dx2, grads2 = kern()
    torch.cuda.synchronize()
    bitwise = torch.equal(dx, dx2) and all(torch.equal(grads[n], grads2[n]) for n in PARAM_NAMES)
    xs = x.detach().requires_grad_()
    ps = {n: params[n].detach().requires_grad_() for n in PARAM_NAMES}
    out = transformer_layer_plain(xs, ps, pad, attn, H, act, eps, p, seed, True)
    inputs = [xs, *(ps[n] for n in PARAM_NAMES)]
    plain = lambda: torch.autograd.grad(out, inputs, g, retain_graph=True)
    want = plain()
    max_abs, ok = grad_errors({"x": dx, **grads}, {"x": want[0], **dict(zip(PARAM_NAMES,
                                                                            want[1:]))})
    ms, plain_ms = time_ms(kern), time_ms(plain, iters=5)
    M = B * L
    flops = 2 * 2 * M * D * (3 * D + D + 2 * F) + 8 * attended_pairs(pad, attn, (B, L)) * D
    weights = 4 * D * D + 2 * D * F + 9 * D + F
    # x, masks, weights, the residuals and g in; dx and the twelve gradients out
    nbytes = 4 * (M * D + (B * L if padded else 0) + (L * L if causal else 0) + weights
                  + M * (3 * D + 4 * D + 2 * F + 2) + B * H * L * 2 + M * D + M * D + weights)
    b_ms, by = bound(flops, nbytes)
    tiles, empty = mha_tiles(pad, attn, L, L, *K2_ATTN_TILE)
    return {"shape": dict(B=B, L=L, D=D, F=F, H=H, dropout=p, causal=causal,
                          key_padding=padded, activation=act),
            "max_abs_err": max_abs,
            "tol": TOL_GRAD, "ok": ok and bitwise, "bitwise_repeatable": bitwise, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms, "bound_by": by,
            "gflop": flops / 1e9, "tile": list(K2_ATTN_TILE),
            "tiles_computed_share": float((tiles | empty[:, :, None]).float().mean()),
            "weight_grad_splits": weight_grad_splits(B, L, D, F, device)}


def clse_inputs(device, M, N, D, seed, g_share=0.2):
    """Query rows and a catalog at the scale of a trained model's, and the
    cotangent of a batch: nonzero (1 / count) on a share ``g_share`` of the
    rows (a fifth: BERT4Rec's masked positions; 1: NARM's and STAMP's one
    row a sequence), zero on the rest."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(M, D)).astype(np.float32)
    items = rng.normal(0.0, 0.3, size=(N, D)).astype(np.float32)
    keep = rng.random(M) < g_share
    g = np.where(keep, 1.0 / max(int(keep.sum()), 1), 0.0).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (q, items, g))


def clse_versus_plain(device, M, N, D, seed=2028, g_share=0.2):
    """K7, K8 and K9 against their plain versions at one shape: rows for
    each, repeated bit for bit, with the ranges of each kernel's plan, the
    blocks of its grid and the card's resident blocks the plan was cut
    for. The plain versions are
    cuBLAS float32 (TF32 off) and ``torch.logsumexp``. K8's library time is
    float32 ``scaled_dot_product_attention`` of the query rows over the
    catalog as keys and values, ``softmax(q items^T) items``: all of K8's
    arithmetic but the scale by g. No single PyTorch call computes logZ
    alone (K7) or ``P^T (g o q)`` alone (K9)."""
    import torch
    from recstudio_torch.ops.softmax_z import (DITEMS_PLAN, DQ_PLAN, FWD_PLAN,
                                               catalog_logsumexp_ditems,
                                               catalog_logsumexp_ditems_plain,
                                               catalog_logsumexp_dq, catalog_logsumexp_dq_plain,
                                               catalog_logsumexp_fwd, catalog_logsumexp_plain,
                                               resident, splits)
    q, items, g = clse_inputs(device, M, N, D, seed, g_share)
    shape = dict(M=M, N=N, D=D, g_share=g_share)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q[None, None], items[None, None], items[None, None], scale=1.0)
    libraries = {"K8": sdpa, "K9": None}
    rows = {}
    with torch.no_grad():
        logz, again = catalog_logsumexp_fwd(q, items), catalog_logsumexp_fwd(q, items)
        want = catalog_logsumexp_plain(q, items)
        torch.cuda.synchronize()
        max_abs, max_rel, ok = errors(logz, want, TOL_LOGZ)
        bitwise = torch.equal(logz, again)
        b_ms, by = bound(2 * M * N * D, 4 * (M * D + N * D + M))
        rows["K7"] = {"shape": shape, "max_abs_err": max_abs, "max_rel_err": max_rel,
                      "tol": TOL_LOGZ,
                      "ok": ok and bitwise and bool(torch.isfinite(logz).all()),
                      "bitwise_repeatable": bitwise,
                      "ms": time_ms(lambda: catalog_logsumexp_fwd(q, items)),
                      "plain_ms": time_ms(lambda: catalog_logsumexp_plain(q, items)),
                      "library_ms": None, "bound_ms": b_ms, "bound_by": by,
                      "gflop": 2 * M * N * D / 1e9}
        for tag, kern, plain, nbytes in (
                ("K8", catalog_logsumexp_dq, catalog_logsumexp_dq_plain,
                 4 * (2 * M * D + N * D + 2 * M)),
                ("K9", catalog_logsumexp_ditems, catalog_logsumexp_ditems_plain,
                 4 * (M * D + 2 * N * D + 2 * M))):
            got, again = kern(q, items, logz, g), kern(q, items, logz, g)
            want = plain(q, items, logz, g)
            torch.cuda.synchronize()
            max_abs, ok = grad_errors({"grad": got}, {"grad": want})
            bitwise = torch.equal(got, again)
            b_ms, by = bound(4 * M * N * D, nbytes)
            rows[tag] = {"shape": shape, "max_abs_err": max_abs, "tol": TOL_GRAD,
                         "ok": ok and bitwise, "bitwise_repeatable": bitwise,
                         "ms": time_ms(lambda: kern(q, items, logz, g)),
                         "plain_ms": time_ms(lambda: plain(q, items, logz, g)),
                         "library_ms": time_ms(libraries[tag]) if libraries[tag] else None,
                         "bound_ms": b_ms, "bound_by": by,
                         "gflop": 4 * M * N * D / 1e9}
    # each grid: tiles of 64 of the axis a block owns (K9: items, else query
    # rows) times the ranges of its plan (sized to the card)
    for tag, kind, outer in (("K7", FWD_PLAN, M), ("K8", DQ_PLAN, M), ("K9", DITEMS_PLAN, N)):
        rows[tag]["splits"] = splits(M, N, D, kind)
        rows[tag]["grid_blocks"] = -(-outer // 64) * rows[tag]["splits"]
        rows[tag]["resident_blocks"] = resident(D, kind)
    return rows


def flash_inputs(device, B, H, L, Dh, causal, all_masked, seed):
    """q, k, v, an output gradient g [B, H, L, Dh], right padding (example 0
    fully masked if asked), the causal mask or None, and the additive masks."""
    import numpy as np
    import torch
    from recstudio_torch.ops.attention import additive_masks
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(B, H, L, Dh)).astype(np.float32)).to(device)
                  for _ in range(4))
    pad_np = right_padding(rng, B, L)
    if all_masked:
        pad_np[0] = True
    pad = torch.from_numpy(pad_np).to(device)
    attn = causal_mask(L, device, causal)
    return q, k, v, g, pad, attn, additive_masks(pad, attn)


def sdpa_mask(pad_add, attn_add):
    """The combined, clamped additive mask that SDPA takes: [B, 1, Lq, Lk],
    or [B, 1, 1, Lk] with no attention mask."""
    import torch
    mask = pad_add[:, None, None, :]
    if attn_add is not None:
        mask = attn_add[None, None] + mask
    return mask.clamp_min(torch.finfo(torch.float32).min)


def flash_bound(B, H, L, Dh, pairs, causal, ops_per_pair, tensors, row_floats):
    """The card's least time for a flash kernel: ``ops_per_pair`` Dh
    operations for each attended pair of each head, against each input read
    once and each output written once: ``tensors`` [B, H, L, Dh] tensors,
    ``row_floats`` floats of each query row (statistics, delta) and the
    masks. Returns ((ms, bound by), operations)."""
    flops = ops_per_pair * Dh * H * pairs
    nbytes = 4 * (B * H * L * (Dh * tensors + row_floats) + B * L + (L * L if causal else 0))
    return bound(flops, nbytes), flops


def k4_versus_plain(device, B, H, L, Dh, causal=True, all_masked=True, seed=2029):
    """K4 against its plain version (out and the row statistics), repeated
    bit for bit; with ``all_masked`` example 0 must come out as the average
    of its L values with statistics exactly (finfo.min, L). Reports the
    share of (query tile, key tile) pairs of ``FLASH_TILE`` K4 computes or
    passes over again: those holding an allowed pair (``mha_tiles``, the
    kernel's skip rule), and every pair of a query tile that holds a row with
    no allowed key (its one more pass over all L values), and the share of
    such query tiles. Library time: float32 SDPA with the combined clamped
    mask."""
    import torch
    from recstudio_torch.ops.attention import (FLASH_TILE, flash_mha_fwd, flash_mha_plain,
                                               mha_tiles)
    q, k, v, _, pad, attn, (pad_add, attn_add) = flash_inputs(device, B, H, L, Dh, causal,
                                                              all_masked, seed)
    kern = lambda: flash_mha_fwd(q, k, v, pad_add, attn_add)
    plain = lambda: flash_mha_plain(q, k, v, pad_add, attn_add)
    mask = sdpa_mask(pad_add, attn_add)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    with torch.no_grad():
        (got, stats), (want, want_stats) = kern(), plain()
        again, again_stats = kern()
        torch.cuda.synchronize()
        max_abs, max_rel, ok = errors(got, want, TOL_K4)
        _, _, stats_ok = errors(stats, want_stats, TOL_STATS)
        bitwise = torch.equal(got, again) and torch.equal(stats, again_stats)
        masked_ok = not all_masked or (bool(torch.allclose(
            got[0], v[0].mean(dim=1, keepdim=True).expand_as(got[0]), atol=TOL_K4[0],
            rtol=TOL_K4[1])) and bool((stats[0, ..., 0] == torch.finfo(torch.float32).min).all())
            and bool((stats[0, ..., 1] == L).all()))
        del want, want_stats, again, again_stats
        ms, plain_ms, library_ms = time_ms(kern), time_ms(plain, iters=5), time_ms(lib, iters=5)
    pairs = attended_pairs(pad, attn)
    tiles, empty = mha_tiles(pad, attn, L, L, *FLASH_TILE)
    # q, k, v in, out out; stats (max, sum) out
    (b_ms, by), flops = flash_bound(B, H, L, Dh, pairs, causal, 4, 4, 2)
    return {"shape": dict(B=B, H=H, L=L, Dh=Dh, causal=causal, all_masked_example=all_masked),
            "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": TOL_K4,
            "ok": ok and stats_ok and masked_ok and bitwise, "stats_ok": stats_ok,
            "all_masked_row_uniform": masked_ok, "bitwise_repeatable": bitwise,
            "tile": list(FLASH_TILE),
            "tiles_computed_share": float((tiles | empty[:, :, None]).float().mean()),
            "extra_pass_share": float(empty.float().mean()), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": by, "gflop": flops / 1e9}


def k5_k6_versus_plain(device, B, H, L, Dh, causal=True, all_masked=False, seed=2030):
    """K5 and K6 on K4's out and statistics, held to their explicit plain
    versions and to autograd of ``mha_plain`` (TOL_GRAD relative to each
    tensor's largest value), each repeated bit for bit. Library time for
    both: SDPA's backward, one call that computes dq, dk and dv together.
    Each row reports the share of (query tile, key tile) pairs of
    ``FLASH_TILE`` the kernels compute: those holding an allowed pair, and
    every pair of a query tile that holds a row with no allowed key."""
    import torch
    from recstudio_torch.ops.attention import (FLASH_TILE, flash_mha_bwd_dkv,
                                               flash_mha_bwd_dkv_plain, flash_mha_bwd_dq,
                                               flash_mha_bwd_dq_plain, flash_mha_fwd, mha_plain,
                                               mha_tiles)
    q, k, v, g, pad, attn, (pad_add, attn_add) = flash_inputs(device, B, H, L, Dh, causal,
                                                              all_masked, seed)
    masks = (pad_add, attn_add)
    with torch.no_grad():
        out, stats = flash_mha_fwd(q, k, v, *masks)
    k5 = lambda: flash_mha_bwd_dq(q, k, v, *masks, out, stats, g)
    (dq, delta), (dq2, delta2) = k5(), k5()
    k6 = lambda: flash_mha_bwd_dkv(q, k, v, *masks, stats, g, delta)
    (dk, dv), (dk2, dv2) = k6(), k6()
    torch.cuda.synchronize()
    p5 = lambda: flash_mha_bwd_dq_plain(q, k, v, *masks, out, stats, g)
    p6 = lambda: flash_mha_bwd_dkv_plain(q, k, v, *masks, stats, g, delta)
    want_dq = p5()[0]
    want_dk, want_dv = p6()
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    auto = torch.autograd.grad(mha_plain(qs, ks, vs, *masks), (qs, ks, vs), g)
    err5, ok5 = grad_errors({"dq": dq}, {"dq": want_dq})
    err6, ok6 = grad_errors({"dk": dk, "dv": dv}, {"dk": want_dk, "dv": want_dv})
    aerr5, aok5 = grad_errors({"dq": dq}, {"dq": auto[0]})
    aerr6, aok6 = grad_errors({"dk": dk, "dv": dv}, {"dk": auto[1], "dv": auto[2]})
    bit5 = torch.equal(dq, dq2) and torch.equal(delta, delta2)
    bit6 = torch.equal(dk, dk2) and torch.equal(dv, dv2)
    del want_dq, want_dk, want_dv, auto, dq2, dk2, dv2
    mask = sdpa_mask(pad_add, attn_add)
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    lib = lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), g, retain_graph=True)
    ms5, ms6 = time_ms(k5), time_ms(k6)
    plain5, plain6, library_ms = time_ms(p5, iters=5), time_ms(p6, iters=5), time_ms(lib, iters=5)
    pairs = attended_pairs(pad, attn)
    tiles, empty = mha_tiles(pad, attn, L, L, *FLASH_TILE)
    share = float((tiles | empty[:, :, None]).float().mean())
    shape = dict(B=B, H=H, L=L, Dh=Dh, causal=causal, all_masked_example=all_masked)
    # K5 reads q, k, v, dO, out and stats, writes dq and delta; K6 reads q,
    # k, v, dO, stats and delta, writes dk and dv
    (b5, by5), f5 = flash_bound(B, H, L, Dh, pairs, causal, 6, 6, 3)
    (b6, by6), f6 = flash_bound(B, H, L, Dh, pairs, causal, 8, 6, 3)
    row = lambda err, ok, aerr, aok, bit, ms, plain_ms, b_ms, by, flops: {
        "shape": shape, "max_abs_err": max(err, aerr), "plain_max_abs_err": err,
        "autograd_max_abs_err": aerr, "tol": TOL_GRAD, "ok": ok and aok and bit,
        "bitwise_repeatable": bit, "tile": list(FLASH_TILE), "tiles_computed_share": share,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library": "SDPA backward (dq, dk, dv together)", "bound_ms": b_ms, "bound_by": by,
        "gflop": flops / 1e9}
    return (row(err5, ok5, aerr5, aok5, bit5, ms5, plain5, b5, by5, f5),
            row(err6, ok6, aerr6, aok6, bit6, ms6, plain6, b6, by6, f6))


# ---------------------------------------------------------------------------
# the data of phases V, R, T and AB: host work (minutes at 10,000,000 rows),
# each built by a process of its own while the card's earlier phases run
# ---------------------------------------------------------------------------
PHASE_DATA = {"V": lambda: ctr_dataset(V_SHAPE, V_ROWS),
              "R": lambda: ctr_dataset("criteo-1m-shape", criteo_rows()),
              "T": amazon_dataset, "AB": mt_dataset}


def start_data(phase):
    """Build ``PHASE_DATA[phase]()`` in a process of its own: ``(process,
    pickle path)``."""
    path = os.path.join(REPO, "build", "recstudio_torch", f"{phase}-data.pkl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--data", phase, path],
                            cwd=REPO)
    return proc, path


def write_data(phase, path):
    """``--data``: pickle ``PHASE_DATA[phase]()`` (``(dataset, splits, gen
    s, ETL s)``) to ``path``, at a low priority beside the phases that run
    meanwhile."""
    import pickle
    os.nice(10)
    sys.path.insert(0, REPO)
    data = PHASE_DATA[phase]()
    with open(path + ".part", "wb") as f:
        pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(path + ".part", path)


def load_data(prepared):
    """Wait for ``start_data``'s process and load its dataset: ``(dataset,
    splits, gen s, ETL s, s waited)``."""
    import pickle
    proc, path = prepared
    t0 = time.perf_counter()
    rc = proc.wait()
    wait_s = time.perf_counter() - t0
    check(rc == 0 and os.path.isfile(path), f"the data process for {path} failed ({rc})")
    with open(path, "rb") as f:
        ds, splits, gen_s, etl_s = pickle.load(f)
    os.remove(path)
    return ds, splits, gen_s, etl_s, wait_s


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from recstudio_torch.ops import _native
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    gpu = gpu_line()
    print(f"GPU {gpu}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)

    prepared = {phase: start_data(phase) for phase in PHASE_DATA}
    try:
        return _main(device, prepared)
    finally:
        for proc, pkl in prepared.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            for path in (pkl, pkl + ".part"):
                if os.path.isfile(path):
                    os.remove(path)


def _main(device, prepared) -> int:
    import torch
    from recstudio_torch.ops import _native
    gpu = gpu_line()
    lib = _native.load()
    ptxas = [ln.strip() for ln in lib.ptxas_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("BUILD", {"seconds": lib.build_seconds, "library": os.path.relpath(lib.path, REPO)})
    for ln in ptxas:
        print(f"PTXAS {ln}", flush=True)

    phases = []
    for fn in (phase_a, phase_b, phase_c, phase_d, phase_e, phase_f, phase_g, phase_h,
               phase_i, phase_j, phase_k, phase_l, phase_m, phase_n, phase_o, phase_p,
               phase_q, lambda d: phase_r(d, prepared["R"]), phase_s,
               lambda d: phase_t(d, prepared["T"]), phase_u, phase_w, phase_x, phase_y,
               phase_y2, phase_z, phase_aa, lambda d: phase_ab(d, prepared["AB"]), phase_ac,
               phase_ad, phase_ae, phase_af, phase_ag, phase_ah, phase_ai, phase_aj,
               lambda d: phase_ak(d, defer=True), phase_al,
               lambda d: phase_v(d, prepared["V"])):
        t = time.perf_counter()
        out = fn(device)
        phases += out if isinstance(out, list) else [out]
        print(f"LAP {phases[-1]['phase']} {time.perf_counter() - t:.1f} s", flush=True)

    k1_a = k1_versus_plain(device, 128, 20, 64, 128, 2)
    k1_b = k1_versus_plain(device, 256, 200, 128, 128, 2)
    k3_b = k3_versus_plain(device, 256, 2, 200, 64)
    k3_c = k3_versus_plain(device, 64, 2, 384, 64)
    # BERT4Rec's attention through K1 at F: no attention mask, right padding
    k3_f = k3_versus_plain(device, 256, 2, 200, 32, causal=False)
    # AutoInt's attention over criteo's 39 fields at W's batch: no mask, Dh 32
    k3_autoint = k3_unmasked_versus_plain(device, 8192, 2, 39, 32)
    # AITM's transfer attention over [info, tower] at AB's evaluation batch
    k3_aitm = k3_unmasked_versus_plain(device, MT_BATCH, 1, 2, 64)
    k1_d = k1_train_versus_plain(device, 1024, 200, 128, 128, 2)
    k2_d = k2_versus_plain(device, 1024, 200, 128, 128, 2)
    # phase F's shapes: BERT4Rec layers (no attention mask, dropout 0.2), and
    # the log-partition over B L = 51,200 rows and 3,706 items; then 512 rows
    # against a catalog of 500,000
    k1_f = k1_versus_plain(device, 256, 200, 64, 128, 2, causal=False)
    k1t_f = k1_train_versus_plain(device, 256, 200, 64, 128, 2, p=0.2, causal=False)
    k2_f = k2_versus_plain(device, 256, 200, 64, 128, 2, p=0.2, causal=False)
    clse_f = clse_versus_plain(device, 256 * 200, 3706, 64)
    clse_cat = clse_versus_plain(device, 512, 500_000, 64)
    # phases K and L: one query row a sequence, 512 rows by 3,706 items, every
    # row with a gradient
    clse_k = clse_versus_plain(device, 512, 3706, 64, seed=2033, g_share=1.0)
    # phase O: MultiDAE's one row a user, 256 rows by 3,706 items at D 200
    # (the kernels' DK = 16 instantiation), every row with a gradient
    clse_o = clse_versus_plain(device, 256, 3706, 200, seed=2034, g_share=1.0)
    rows = [("K1@A", k1_a), ("K1@B", k1_b), ("K3@B", k3_b), ("K3@C", k3_c),
            ("K3@F", k3_f), ("K3@autoint", k3_autoint), ("K3@aitm", k3_aitm),
            ("K1train@D", k1_d), ("K2@D", k2_d), ("K1@F", k1_f), ("K1train@F", k1t_f),
            ("K2@F", k2_f)]
    # phase AE's InterHAt (its layer over criteo's 39 fields: d 16, Dh 8, F 64,
    # relu, neither mask; dropout 0.3 in training) and DIFM (Dh 5, no mask)
    rows += [("K1@interhat", k1_versus_plain(device, 8192, 39, 16, 64, 2, causal=False,
                                             padded=False, act="relu", eps=1e-5)),
             ("K1train@interhat", k1_train_versus_plain(device, 8192, 39, 16, 64, 2, p=0.3,
                                                        causal=False, padded=False,
                                                        act="relu", eps=1e-5)),
             ("K2@interhat", k2_versus_plain(device, 8192, 39, 16, 64, 2, p=0.3, causal=False,
                                             padded=False, act="relu", eps=1e-5)),
             ("K3@difm", k3_unmasked_versus_plain(device, 8192, 2, 39, 5))]
    # phase AG's contrastive layer (d 64, F 64, causal, right padding; dropout
    # 0.5 in training) and ICLRec's intent encode (evaluation, LayerNorm eps 1e-5)
    rows += [("K1train@cl4srec", k1_train_versus_plain(device, AG_BATCH, AG_L, 64, 64, 2)),
             ("K2@cl4srec", k2_versus_plain(device, AG_BATCH, AG_L, 64, 64, 2)),
             ("K1@iclrec", k1_versus_plain(device, AG_BATCH, AG_L, 64, 64, 2, eps=1e-5))]
    rows += [(f"{k}@F", clse_f[k]) for k in ("K7", "K8", "K9")]
    rows += [(f"{k}@cat500k", clse_cat[k]) for k in ("K7", "K8", "K9")]
    rows += [(f"{k}@K", clse_k[k]) for k in ("K7", "K8", "K9")]
    rows += [(f"{k}@O", clse_o[k]) for k in ("K7", "K8", "K9")]
    # phase H's attention (B 256, L 1024, Dh 64, causal, example 0 fully
    # masked in K4's row), BERT4Rec's route at L 2048 (no attention mask),
    # and an Lk that is a multiple of no tile
    k4_h = k4_versus_plain(device, 256, 2, 1024, 64)
    k4_bidir = k4_versus_plain(device, 64, 2, 2048, 64, causal=False)
    k4_odd = k4_versus_plain(device, 64, 2, 600, 32)
    k5_h, k6_h = k5_k6_versus_plain(device, 256, 2, 1024, 64)
    k5_m, k6_m = k5_k6_versus_plain(device, 16, 2, 1024, 64, all_masked=True)
    rows += [("K4@H", k4_h), ("K4@bidir", k4_bidir), ("K4@odd", k4_odd), ("K5@H", k5_h),
             ("K6@H", k6_h), ("K5@masked", k5_m), ("K6@masked", k6_m)]
    for name, res in rows:
        emit("KERNEL_VS_PLAIN", {"kernel": name, "gpu": gpu, **res})
        check(res["ok"], f"{name} disagrees with its plain version: {res['max_abs_err']}")

    def launches(name):
        return sum(p["launches"][name] for p in phases)

    row = lambda res: {k: res[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}
    kernels = [
        {"name": "fused_transformer_layer", "route": "cuda",
         "source": "recstudio_torch/csrc/transformer_layer.cu",
         "replaces": "recstudio_tpu/ops/transformer_layer.py:267",
         "launches": launches("fused_transformer_layer"), **row(k1_b)},
        {"name": "fused_mha", "route": "cuda", "source": "recstudio_torch/csrc/attention.cu",
         "replaces": "recstudio_tpu/ops/attention.py:71",
         "launches": launches("fused_mha"),
         "launches_by_phase": {p["phase"] + ("" if "model" not in p else f":{p['model']}"):
                               p["launches"]["fused_mha"] for p in phases
                               if p["launches"].get("fused_mha")}, **row(k3_c)},
        {"name": "fused_transformer_layer_bwd", "route": "cuda",
         "source": "recstudio_torch/csrc/transformer_layer_bwd.cu",
         "replaces": "recstudio_tpu/ops/transformer_layer.py:292",
         "launches": launches("fused_transformer_layer_bwd"), **row(k2_d)},
    ]
    for name, kid, line in (("catalog_logsumexp_fwd", "K7", 53),
                            ("catalog_logsumexp_dq", "K8", 115),
                            ("catalog_logsumexp_ditems", "K9", 135)):
        kernels.append({"name": name, "route": "cuda",
                        "source": "recstudio_torch/csrc/softmax_z.cu",
                        "replaces": f"recstudio_tpu/ops/softmax_z.py:{line}",
                        "launches": launches(name), **row(clse_f[kid])})
    for name, kid, line, res in (("flash_mha_fwd", "K4", 133, k4_h),
                                 ("flash_mha_bwd_dq", "K5", 220, k5_h),
                                 ("flash_mha_bwd_dkv", "K6", 246, k6_h)):
        kernels.append({"name": name, "route": "cuda",
                        "source": "recstudio_torch/csrc/flash_attention.cu",
                        "replaces": f"recstudio_tpu/ops/attention.py:{line}",
                        "launches": launches(name), **row(res)})
    for kern in kernels:
        check(kern["launches"] > 0, f"{kern['name']} was never launched")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"GPU {gpu_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--data"]:         # start_data's process
        write_data(sys.argv[2], sys.argv[3])
        sys.exit(0)
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
