#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Every phase is fatal: any failure raises, the script exits non-zero and prints
no result line.

1. device  -- the card's name and power limit, as nvidia-smi gives them;
2. build   -- nvcc builds every kernel source in ``csrc/``, one process each,
   all started together;
3. kernels -- each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it: integer-valued inputs must agree exactly
   (ties included), normal inputs within a stated tolerance. Times of the
   kernel, its plain version and one PyTorch library call, beside the card's
   bound (for the kernels that multiply on the tensor cores in 3xTF32, the
   top-k matmul, the two attention pools' forwards, the float32 DIN head's
   forward, the products of its backward that run there
   (din_bwd_tensor_products) and the AFM backward's z and W dz, three TF32
   products at the tensor cores' rate; the pools' and the float32 head's rows
   also carry the CUDA-core bound as ``cuda_core_bound_ms``). The two pools, the
   AFM backward, the float32 DIN head, both ways, and the fused trainers must
   repeat bit for bit. The AFM pool is also checked
   at widths past the preset's (AFM_WIDE), the fused MF trainer at factors of
   MF_WIDE_DIM, the fused MF trainer (both dtypes) and the compact LR trainer
   also on their batch shuffled and with skewed ids (TRAINER_ROWS). The lookup pair (gather_rows, onehot_grad) is also checked at the
   other main paths' shapes (DIN's history batch and full-history target tile,
   LR's bias tables); its rows and the top-k rows of at most 32 users (a
   served batch, a single-user request) carry ``host_us``, the host's time per
   launcher call, and ``library_host_us``, the same for the library call; where
   a call is host-bound, kernel and library are timed in turns. The DIN head
   is checked in float32 and in bfloat16, both also at ragged widths
   (DIN_RAGGED) at the train batch's row count, in float32 also at the
   longest history the kernels take (DIN_LONG_ROWS rows at L 64), the
   backward in both dtypes and the bf16 forward also at the widest fc the
   kernels take (DIN_WIDE_FC); the backward in both dtypes also timed with
   the forward's pooled rows handed to it (``kernel_ms_pooled_given``, as
   training runs it), whose gradients must be the recomputing call's bit for
   bit; the bf16
   backward held against its plain version and the float64 sums
   (check_din_bf16_bwd, a limit in proportion to the relu inputs near a kink,
   and a fixed excess over the plain version's rows off the float64 sums);
   the bf16 forward at the train batch on the inputs of each of
   DIN_BF16_FWD_SEEDS. DIN's full-history catalog scorer
   (``din_full_history``: the ragged attention kernel, then the float32 head's
   fc head) at the din-refresh cell's shapes: the fixture's complete histories
   of every user against every item, held against its plain version (the
   bucketed, masked scorer) and timed beside it, its bound from the products
   it needs (``ops/din_full_history.py::products_needed``: the first
   attention layer once per item; 3xTF32, three TF32 products each), no
   library call computing it;
4. train   -- the MF training path (slice 2) through the entry points a user
   calls: ``run_experiment(PRESETS["mf"])`` for 20 epochs at full width on a
   synthetic ml-100k-format dataset, then ``MatrixFactorization.fast_fit`` on
   the same batch. The loss must fall, the history keys are the full set, the
   launch counts show every lookup went through the gather kernels, and the
   losses match the same run on the CPU (plain versions) and the fused trainer;
5. serve   -- ``cli/serve.py::build_server`` trains MF and serves it over
   HTTP on the card; each answer is held against the plain top-k of the
   trained factors;
6. slice   -- the MF serving path of slice 1 (a seeded random model) over
   HTTP, through both top-k kernels;
7. lr      -- the feature family's LR (slice 3): ``run_experiment(PRESETS["lr"])``
   for 20 epochs at full width, then ``LogisticRegression.fast_fit`` in both
   modes on the same batch; the losses match the same run on the CPU and the
   Trainer's, and the loss falls;
8. afm     -- ``run_experiment(PRESETS["afm"])`` at full width (embedding 128,
   attention 64) for AFM_EPOCHS epochs. The CPU reference is slow at this
   width (about 65 GFLOP an epoch and 390 GFLOP for the catalog in its plain
   path), so the card's history is held against a CPU ``Trainer.fit`` over
   the same batches, and its catalog scores against the CPU's for one tile of
   64 users under the same trained weights;
9. serve_lr, serve_afm -- ``cli/serve.py::build_server`` trains each and
   serves it over HTTP: LR through its rank-2 factors (``topk_serve_matmul``
   at D = 2), AFM through its masked catalog scores and the plain top-k,
   then a second ``Recommender`` with ``use_pallas="fused"`` over the same
   model and mask, whose ``topk_scores`` lists must be the plain stable
   top-k's (``run_serve_model``, as for every non-factored model);
10. din     -- ``run_experiment(PRESETS["din"])`` at full width (embedding 64,
   attention (128, 64, 1), fc (256, 128, 1), history 10) for DIN_EPOCHS epochs
   with window serving: training and evaluation through the fused DIN head
   kernels, the catalog through the DIN attention-pool kernel, one launch a
   16-user tile. Held against a CPU ``Trainer.fit`` over the same batches and
   the CPU's window scores of one tile under the same trained weights;
11. din_bf16 -- DIN as ``bench.py`` trains it, ``compute_dtype="bfloat16"`` and
   ``indirect_hist=True``, for DIN_BF16_EPOCHS epochs through ``run_experiment``:
   the DIN head kernels' bf16 path, held against a CPU ``Trainer.fit`` in bf16;
12. serve_din -- ``cli/serve.py::build_server --model din``: the preset's
   full-history serving (trained through the DIN head kernels, scored through
   the full-history kernel and its fc head, a pair of launches for each chunk
   of users, in the ranking evaluation and in the server's refresh), answers held against the stable top-k of the
   served scores, and the full-history scores of a few users (the longest
   history among them) against the CPU's;
13. din_depth -- DIN with an attention net of one hidden layer, which
   ``ops/din_head.py::kernel_route`` refuses: ``run_experiment`` for
   DIN_DEPTH_EPOCHS epochs with window serving through the composition
   (``attention_pool`` + ``mlp``), with no DIN kernel launch, against the
   CPU's history;
14. deepfm  -- ``run_experiment(PRESETS["deepfm"])`` at full width (embedding
   128, tower (512, 256, 128, 1)) for DEEPFM_EPOCHS epochs, every id and bias
   lookup through the gather kernel pair (four a forward), held as afm is;
15. serve_deepfm -- ``cli/serve.py::build_server --model deepfm``, served and
   held as serve_afm is;
16. feature_zoo -- WideDeep, NFM, PNN, DCN (the deepcross preset),
   DeepCrossing and FFM, each through ``run_experiment`` at its preset's
   full width for ZOO_EPOCHS epochs, held as afm is, with each model's
   lookups a forward (LOOKUPS) counted exactly;
17. dien    -- ``run_experiment(PRESETS["dien"])`` at the preset's width
   (embedding 16, attention (64, 32, 1), fc (128, 64, 1)) for DIEN_EPOCHS
   epochs with window serving, then the full-history catalog of every user
   on the card: every lookup through the gather pair, no DIN head or pool
   launch (DIEN's attention, GRU and MLPs are plain torch). Held against a
   CPU ``Trainer.fit``, the window catalog against the CPU's tile by tile,
   the full-history catalog against the CPU's on one user of each length
   bucket and the longest history;
18. dien_bf16_aux -- DIEN in bf16 with ``indirect_hist``, then with AUGRU and
   the auxiliary loss in float32, DIEN_SECOND_EPOCHS epochs each, against the
   CPU;
19. neuralcf -- ``run_experiment(PRESETS["neuralcf"])`` at full width (mf_dim
   256, layers (512, 256, 128, 64, 32)) in float32, then in bf16, four
   lookups a forward, against the CPU, and one catalog tile;
20. autorec, i_autorec -- U- and I-AutoRec (hidden 256, 150 global
   negatives): the masked loss and the whole catalog against the CPU's, no
   kernel launch;
21. serve_pair_matrix -- ``build_server --model neuralcf`` and ``--model
   autorec``, served and held as serve_afm is (``run_serve_model``);
22. minibatch -- ``run_experiment`` in minibatch mode (``train/minibatch.py``):
   DeepFM at the preset's width and MF at D 64, MODE_EPOCHS epochs of
   MINIBATCH_BATCH rows (the order drawn on the host), then the ranking eval;
   held against the same trainer called on the CPU (losses within
   MODE_LOSS_RTOL, every parameter and optimizer-state tensor within
   STATE_RTOL), lookups counted exactly;
23. stream -- ``fit_stream`` on MF and ``fit_stream_sparse`` on DeepFM, the
   host arrays through the pinned, side-stream prefetch (``data/stream.py``),
   held the same way;
24. sparse -- ``run_experiment`` in sparse mode (``train/sparse_trainer.py``):
   MF and DeepFM with lazy Adam, MF with row-wise AdaGrad; the table rows
   through the gather kernel, no ``onehot_grad``; held the same way, and every
   table row the CPU run never touched keeps its bits, in the table and in
   its row-optimizer state; then both row optimizers on DeepFM's first
   item-id batch, row V - 1 in the first step only: it, and every row no step
   touches, keeps its bits;
25. checkpoint_serve -- AutoRec trained, checkpointed (``runtime/checkpoint.py``)
   and resumed, against the uninterrupted run; MF and DeepFM served by
   ``build_server --checkpoint`` over HTTP, their lists against an in-memory
   ``Recommender``'s (DeepFM's also a fused one's, ``topk_scores``); launches
   counted exactly;
26. cf -- UserCF and ItemCF on the synthetic ``ua`` fold, GDCF on ``u1``
   (``cf/``), every top-k through ``topk_scores``; the lists against the
   stable top-k of the card's own scores, Recall / Precision / F1 and GDCF's
   losses against the CPU's;
27. cli_run -- ``cli/run.py --model dien --epochs CLI_EPOCHS --json``,
   ``cli/run.py --model mf --train-mode sparse --epochs CLI_EPOCHS --json``
   and ``cli/cf.py usercf --json`` on the card, their JSON lines parsed, their
   launches counted;
28. mesh_nccl -- one rank over NCCL on the card (``runtime/distributed.py::
   initialize``, ``make_mesh(1, 1)``): the collectives on CUDA tensors give
   their input back bit for bit, and one epoch of MF through
   ``run_experiment(mesh_shape=(1, 1))`` equals the run without a mesh bit
   for bit in the train split's pre-update forward, and after the backward
   (whose ``onehot_grad`` atomics vary the last bits run to run) within
   MESH_LOSS_RTOL and MESH_PARAM_RTOL, its launches equal;
29. mesh -- ranks spawned on the one card (``runtime/distributed.py::spawn``,
   a deadline a spawn) over Gloo, because NCCL refuses two ranks on one GPU:
   the runs of MESH_RUNS on 2 ranks and of MESH_RUNS_4 on 4 (MF and DeepFM
   at the presets' widths, fullbatch on (1, 2) under psum and scatter, (2, 1)
   and (2, 2); sparse MF on (1, 2)), each rank's losses within
   MESH_LOSS_RTOL and params within MESH_PARAM_RTOL of the same run on one
   rank on the card, every rank's launches of the four lookup and top-k
   kernels counted exactly; the runs that keep their tables sharded then
   serve the top MESH_TOPK of every user through ``ShardedRecommender``,
   the lists equal to the dense ``Recommender``'s over the same params. One
   JSON line a run: wall, ``train_time_s``, the bytes each rank moved
   through Gloo (all staged through the host), the launches;
30. scaling_model -- ``runtime/scaling_model.py::program_costs`` of one
   DeepFM fullbatch step at the preset's width, ``predict_weak_scaling`` at
   1, 2, 4 and 8 cards, the measured step beside it, the card's name and
   power limit;
31. native -- ``data/native.py`` builds the C++ parser with ``c++`` and
   loads the fixture's files to the NumPy path's arrays; the native parser
   must have run.

The lookup pair's rows also cover the feature presets' widths (DeepFM's
train-batch ids into user and item tables of D 128 and D 256, PNN's), DIEN's
history and indirect rows (D 16, float32 and bf16), NeuralCF's tables
(D 256) and the minibatch modes' first batch (DeepFM's 8,192 ids into its
D 128 tables, MF's into its D 64 user table) and the mesh phase's EP blocks
(MF's and DeepFM's tables, block 2 of 2, on clamped ids with the cotangent of
the ids the block does not own zeroed); the ``topk_scores`` rows also
classic CF's top 20 of 943 x 1682 and UserCF's 10 neighbours of 943 x 943;
both top-k kernels' rows also the EP blocks' (every user over block 2 of 2
of the items with its seen mask, a block of 4 with vocab-pad columns, the
merge of two blocks' candidates).

Phases 4-31 are the main paths: each sets the launch counts to 0 just before
it and reads them just after (the mesh phase on each rank, around each run). The last line of stdout is
``{"ok": true, "device": {...}}``; the line before it is the card's name and
power limit, and the line before that the ``kernels`` line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deeplearningrecommendationsystem_tpu_torch.cf import (
    cf_eval,
    gdcf_train,
    item_cf_recommend,
    item_cf_scores,
    load_base_test,
    user_cf_recommend,
    user_cf_scores,
)
from deeplearningrecommendationsystem_tpu_torch.cli import serve as serve_cli
from deeplearningrecommendationsystem_tpu_torch.configs import PRESETS
from deeplearningrecommendationsystem_tpu_torch.data import MovieLens100K, write_ml100k_format
from deeplearningrecommendationsystem_tpu_torch.data.stream import tree_map
from deeplearningrecommendationsystem_tpu_torch.experiments import (
    build_model,
    matrix_batches,
    run_experiment,
    split_batches,
)
from deeplearningrecommendationsystem_tpu_torch.models import MatrixFactorization, ServingContext
from deeplearningrecommendationsystem_tpu_torch.models.base import catalog_scores_from_pairs
from deeplearningrecommendationsystem_tpu_torch.ops import afm_attention as afm
from deeplearningrecommendationsystem_tpu_torch.ops import din_attention as dinatt
from deeplearningrecommendationsystem_tpu_torch.ops import din_full_history as dfh
from deeplearningrecommendationsystem_tpu_torch.ops import din_head as dh
from deeplearningrecommendationsystem_tpu_torch.ops import gather as gat
from deeplearningrecommendationsystem_tpu_torch.ops import lr_epoch as lre
from deeplearningrecommendationsystem_tpu_torch.ops import mf_epoch as mfe
from deeplearningrecommendationsystem_tpu_torch.ops import serving_topk as topk
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import afm_attention as cuda_afm
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import build
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import din_attention as cuda_dinatt
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import din_full_history as cuda_dfh
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import din_head as cuda_dh
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import gather as cuda_gather
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import lr_epoch as cuda_lre
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import mf_epoch as cuda_mfe
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import serving_topk as cuda_topk
from deeplearningrecommendationsystem_tpu_torch.ops.attention import attention_pool
from deeplearningrecommendationsystem_tpu_torch.ops.interactions import pairwise_products
from deeplearningrecommendationsystem_tpu_torch.ops.linear import mlp, mlp_init
from deeplearningrecommendationsystem_tpu_torch.parallel.embedding import padded_height
from deeplearningrecommendationsystem_tpu_torch.parallel.serving import _seen_block
from deeplearningrecommendationsystem_tpu_torch.runtime.checkpoint import CheckpointManager
from deeplearningrecommendationsystem_tpu_torch.server import RecommenderServer
from deeplearningrecommendationsystem_tpu_torch.serving import Recommender
from deeplearningrecommendationsystem_tpu_torch.train import (
    LazyAdamState,
    RowwiseAdagradState,
    TrainConfig,
    Trainer,
    fit_minibatch,
    fit_minibatch_sparse,
    fit_stream,
    fit_stream_sparse,
    sparse_table_update,
)
from deeplearningrecommendationsystem_tpu_torch.train.minibatch import epoch_order

DEVICE = torch.device("cuda")
NEG_INF = topk.NEG_INF
# H100 SXM data sheet (dense, no sparsity): float32 outside the tensor cores and
# HBM3 bandwidth. The bound of a kernel is the larger of its operations over the
# first and its bytes (each input read once, each output written once) over the
# second.
PEAK_F32_FLOP_S = 67e12
PEAK_TF32_FLOP_S = 495e12  # the tensor cores' dense TF32 rate
PEAK_BF16_FLOP_S = 989e12  # the tensor cores' dense bf16 rate (float32 accumulation)
PEAK_BYTES_S = 3.35e12
# Top-k values within RTOL of the row's largest |score| count as equal (float32
# sums in another order than cuBLAS); integer-valued inputs must agree exactly.
RTOL = 1e-4
# mf_fullbatch_train against its plain version, over MF_CHECK_EPOCHS epochs:
# (loss rtol, table atol). float32: sums in another order, carried through
# Adam's normalised steps; bfloat16: a gradient row may round to the other
# bf16 neighbour.
MF_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 2e-3)}
MF_CHECK_EPOCHS = 5
# the training path on the card against the same run on the CPU (plain
# versions), and against fast_fit: losses rtol, rank AUCs atol
TRAIN_LOSS_RTOL, TRAIN_AUC_ATOL = 1e-4, 1e-3
TRAIN_EPOCHS = 20
EMBEDDING_DIM = 64
MF_WIDE_DIM = 256  # the fused MF trainer also at factors past 128 (8 columns a lane)
# The fused trainers also on their train batch with its rows in another order
# ("shuffled": a random permutation) and with skewed ids ("skewed": a fifth of
# the rows moved to one user and another fifth to one item, and 1 row in 1,000
# given an id outside the table), drawn from a generator of their own
# (TRAINER_ROWS_SEED) so that the other rows keep their inputs
TRAINER_ROWS, TRAINER_ROWS_SEED = ("shuffled", "skewed"), 3
SEEN_DENSITY = 100_000 / (943 * 1682)  # ml-100k: every rating is a seen item
# (users, items, dim, k): all users of the MF preset, one batched request of
# the slice below, the single-user request of every serve phase, and the JAX
# package's large-catalog serving shape
KERNEL_SHAPES = [(943, 1682, EMBEDDING_DIM, 50), (32, 1682, EMBEDDING_DIM, 50),
                 (1, 1682, EMBEDDING_DIM, 10), (2048, 131072, EMBEDDING_DIM, 50)]
HOST_TIMED_USERS = 32  # top-k rows of at most this many users also carry host_us
LR_SERVING_SHAPE = (943, 1682, 2, 50)  # LR's rank-2 serving factors, all users
# the fused LR trainers against their plain versions over LR_CHECK_EPOCHS
# epochs: (loss rtol, weight atol), float32 sums in another order (block
# partials, shared atomics) carried through Adam's normalised steps at lr 0.05
LR_TOL = (1e-5, 1e-4)
LR_CHECK_EPOCHS = 5
# the AFM pool kernels against their plain versions: largest error within
# this share of the tensor's largest |value| (float32 sums over D, over the 15
# pairs and, for dW, db and dh, over all rows, in another order)
AFM_FWD_RTOL, AFM_BWD_RTOL = 1e-5, 1e-4
AFM_EPOCHS = 3  # the CPU reference's plain path is slow at full width
# (D, A) past the preset's, at AFM_WIDE_ROWS rows: the weights too wide to sit
# in shared memory beside a tile (read from device memory), A past 128, and D
# past one patch of the backward's dW rows
AFM_WIDE, AFM_WIDE_ROWS = ((128, 128), (256, 64), (64, 256), (256, 256)), 8_192
CATALOG_TILE = 64  # users per tile of catalog_scores_from_features
# DeepFM and the other feature models at their presets' full widths: epochs of
# each run (the CPU reference's plain path is slow at full width: about 0.3
# TFLOP an epoch for DeepFM, 0.9 for DCN, whose three 641 x 641 crosses make
# it the widest), and the id lookups a forward: the two id tables and the two
# bias tables of a linear part (PNN, DCN and DeepCrossing have none; FFM looks
# up both domains of each id table)
DEEPFM_EPOCHS, ZOO_EPOCHS = 3, 2
ZOO = ("widedeep", "nfm", "pnn", "deepcross", "deepcrossing", "ffm")
# NeuralCF looks up its four tables a forward (GMF and MLP, user and item);
# AutoRec looks nothing up
LOOKUPS = {"afm": 4, "deepfm": 4, "widedeep": 4, "nfm": 4, "pnn": 2, "deepcross": 2,
           "deepcrossing": 2, "ffm": 6, "neuralcf": 4, "autorec": 0}
# the card's catalog tile against the CPU's under the same weights: largest
# error within this share of the largest |logit| (float32 products summed in
# another order, cuBLAS against the CPU's)
FEATURE_TILE_RTOL = 1e-5
FEATURE_ROWS_SEED = 4  # the lookup pair's rows at the feature presets' widths draw from their own generator
EP_ROWS_SEED = 7  # ... and the lookup pair's and top-k rows at the mesh phase's EP blocks
PAIR_SEQ_ROWS_SEED = 5  # ... and at DIEN's and NeuralCF's
FULL_HISTORY_ROWS_SEED = 8  # ... and DIN's full-history scorer's weights
# the DIN head and pool kernels against their plain versions: largest error
# within this share of the tensor's largest |value| (float32 sums over D, the
# widths, the L positions and, for the weight gradients, all rows, in another
# order). The backward is held so on the rows none of whose relu inputs lies
# within DIN_KINK of its layer's largest |value| from 0: at such a kink the
# mask, so the row's gradient, may flip between any two float32 orders of
# summation, and at the train batch a few rows sit there. d b3 is 0 in exact
# arithmetic and held to DIN_DB3_ATOL of sum |g|.
DIN_FWD_RTOL, DIN_BWD_RTOL, DIN_DB3_ATOL, DIN_KINK = 1e-5, 1e-4, 1e-6, 1e-6
# The head's bf16 path against its bf16 plain version. Both round the same
# operands to bf16 and sum in float32, but a sum in another order can put a
# value that is then rounded on the other bf16 neighbour. Forward: at most
# DIN_BF16_LOGITS_OFF of the bf16 logits may differ at all, each within
# DIN_BF16_FWD_ULPS bf16 ulps of its own plain value past DIN_BF16_FWD_ATOL of
# the largest |logit|, and the kernel's logits may lie no farther past that
# slack from the head's logits with every sum in float64 (the same operands
# rounded, din_head_fwd_exact) than the plain version's do. Measured at the
# train batch on an H100 over seeds 0-39 (tools/probe_din_bf16_fwd_seeds.py):
# 19-46 logits differ, up to 1.29 ulps past the slack (seeds 17 and 31), where
# the plain version lies 1.29 and 1.22 ulps past it from the float64 sums and
# the kernel 0.64 and 0.65; on every seed the kernel lies no farther from them
# than the plain version. Two float32 orders of summation followed by the same
# bf16 roundings put a logit two ulps apart, so the limit is two ulps, the
# smallest whole number that every seed meets.
# Backward: a flip can put a relu input on the other side of 0 and flip a row's
# d hist and d target. At most one row in 1 / DIN_BF16_OFF_SHARE of the relu
# inputs that lie within DIN_BF16_KINK of their layer's largest |value| from 0
# (``kink_distance``'s measure, on the rows checked) may be off by more than
# DIN_BF16_BWD_RTOL of the tensor's largest |value|, each with a relu input
# within DIN_BF16_KINK; and the kernel may be off the gradients with every sum
# in float64 (the same operands rounded, din_head_bwd_exact) in at most
# DIN_BF16_EXACT_EXCESS more rows than the plain version is. Measured on an
# H100 over seeds 0-39 of the kernel before its sums changed order
# (tools/probe_din_bf16_bwd_seeds.py): at the train batch 0-6 rows off among
# 180k-202k such inputs, at fc (2048, 2048) 0-1 on 4,096 rows (20k-22k inputs)
# and 1-9 on 20,000 rows (104k-119k), at most 8.3e-5 of them; kernel and plain
# version each off the float64 gradients in 1-36 rows at a kink, the kernel in
# at most 2, 1 and 3 more than the plain version at those three shapes, so the
# excess allowed is 3. Which of the two lies nearer the float64 gradients on a
# flipped row is a coin toss (the kernel farther on 10-18 of the 40 seeds), so
# those distances are reported, not held. Without the rows off every gradient
# lies within DIN_BF16_BWD_RTOL of its tensor's largest |value| (observed at
# most 2.4e-4). The same values through the plain head in float32 throughout
# (no operand rounded) must fail both checks (observed: 21,400 logits differ;
# each rounded gradient 2.6e-3 to 0.17 off), so they tell rounding where the
# head rounds from not rounding.
DIN_BF16_LOGITS_OFF, DIN_BF16_FWD_ATOL, DIN_BF16_FWD_ULPS = 64, 2.0 ** -10, 2
DIN_BF16_OFF_SHARE, DIN_BF16_BWD_RTOL, DIN_BF16_KINK = 1e-4, 1e-3, 2e-4
DIN_BF16_EXACT_EXCESS = 3
# the gradients that the rounding moves (d b3 is 0 in exact arithmetic, d c3 the
# sum of g, d c2 a masked product of g alone)
DIN_BF16_ROUNDED = ("hist", "target", "wh", "wt", "b1", "w2", "b2", "w3", "u1p", "u1t", "c1",
                    "u2", "u3")
# (L, D, A, F) of the bf16 head rows at ragged widths: none of D, A or F a
# multiple of 8 or 16, so the tensor-core products' fragments end inside a width
# (zero fill past K and N); taken at the train batch's row count, where the
# bf16 limits' counts were set
DIN_RAGGED = (7, 8, (12, 8, 1), (20, 12, 1))
# The bf16 head forward's check runs on the train batch's inputs drawn by a
# generator of each of these seeds
DIN_BF16_FWD_SEEDS = (0, 1, 2, 3, 4)
DIN_LONG_ROWS = 16_384  # rows of the float32 head's rows at the longest history the kernels take
# The head's backward at the widest fc the kernels take, both dtypes, and the
# bf16 forward there (its tensor-core attention unit: no pooled rows kept), on
# rows of a generator of their own; both backwards take the split there, the fc
# head's backward in din_head_bwd_fc_stream_kernel (din_head_bwd_fc_head_kernel's
# tile of two full-width regions does not fit)
DIN_WIDE_FC, DIN_WIDE_FC_ROWS = (2048, 2048, 1), 4_096
DIN_EPOCHS = 3  # the CPU reference's plain path is slow at full width
DIN_BF16_EPOCHS = 2  # DIN under bf16 compute: fewer epochs, for the run's time
HISTORY_TILE = 16  # users per tile of catalog_scores_from_history
DIN_ATTENTION, DIN_FC = (128, 64, 1), (256, 128, 1)  # models/din.py's defaults, the preset's
# The lookup pair (gather_rows, onehot_grad) and the serving top-k pair: where
# the kernel takes under LOOKUP_INTERLEAVE_MS a call is bound by the host, whose
# speed drifts within a run, so kernel and library are timed in turns (kernel,
# library, library, kernel, ...), LOOKUP_RUNS runs each of LOOKUP_BUDGET_MS, and
# each reports its median. host_us and library_host_us: the host clock over
# HOST_CALLS calls of the launcher and of the library call, no synchronise, per
# call.
LOOKUP_INTERLEAVE_MS, LOOKUP_RUNS, LOOKUP_BUDGET_MS = 0.1, 5, 20.0
HOST_CALLS = 1_000
DIN_TARGET_TILE = 512  # serve_din's smallest target tile: 2 users x 256 catalog items
# DIEN (embedding 16, attention (64, 32, 1), fc (128, 64, 1)), NeuralCF (mf_dim
# 256, layers (512, 256, 128, 64, 32)) and AutoRec (hidden 256) at their
# presets' widths: epochs of each run (the CPU references' plain paths, and
# DIEN's GRU, a Python loop of about 12 launches a step, set them)
DIEN_EPOCHS, DIEN_SECOND_EPOCHS, NEURALCF_EPOCHS, NEURALCF_BF16_EPOCHS = 3, 2, 3, 2
AUTOREC_EPOCHS, CLI_EPOCHS = 3, 2
DIEN_WINDOW_TILE = 8  # users per tile of DIEN's window scorer (models/dien.py)
DIEN_AUX_WEIGHT = 0.5
# catalog_scores_full_history's buckets, item chunk and activation budget
# (models/base.py), from which its launches are counted
FULL_HISTORY_BUCKETS, FULL_HISTORY_CHUNK, FULL_HISTORY_BUDGET = (
    (32, 64, 128, 256, 512, 1024), 256, 32 * 1024 * 1024)
# The bf16 runs (DIEN with indirect_hist, NeuralCF) are held to the float32
# limits (TRAIN_LOSS_RTOL, TRAIN_AUC_ATOL): cuBLAS and the CPU both sum a bf16
# product in float32 and round it once, and on an H100 the two runs' losses
# came out within 1.2e-7 (DIEN) and 2.4e-7 (NeuralCF) of each other, their
# AUCs within 1.2e-6 (PERF.md §6, DIEN and NeuralCF).
# The minibatch, stream and sparse modes (train/minibatch.py,
# train/sparse_trainer.py) at the presets' widths: MODE_EPOCHS epochs of
# MINIBATCH_BATCH rows (ExperimentConfig's batch_size), each held against the
# same call on the CPU with the same batches in the same order: losses within
# MODE_LOSS_RTOL (float32 sums in another order, carried through some 20-50
# Adam steps). Every tensor of the trained state (the params, the dense Adam's
# moments and steps, the sparse tables' lazy-Adam moments and step or AdaGrad
# accumulators) within STATE_RTOL of the CPU's, relative to that tensor's
# largest magnitude on the CPU: on one H100 the worst came out 4.5e-6 (sparse
# DeepFM's item table), the minibatch runs (whose onehot_grad adds with
# atomics) 2.5e-6 at most. The lookup pair's rows at these batches, and the
# row optimizers' padding check (SENTINEL_STEPS steps of SENTINEL_LR), draw
# from a generator of their own (MINIBATCH_ROWS_SEED).
MINIBATCH_BATCH, MODE_EPOCHS, MODE_LOSS_RTOL, MINIBATCH_ROWS_SEED = 8192, 2, 1e-6, 6
STATE_RTOL, SENTINEL_STEPS, SENTINEL_LR = 2e-5, 3, 1e-2
# checkpoint_serve: epochs before and after the checkpoint, and the resumed
# run's params against the uninterrupted run's. onehot_grad adds a table
# row's gradients with atomics, in another order each run, so two MF runs of
# the same thing differ: 7.9e-7 apart after two full-batch epochs, the resumed
# one 5.5e-7 (measured on one H100), at the limit's edge. The resume is
# checked on AutoRec, which looks nothing up and repeats its bits.
CHECKPOINT_EPOCHS, RESUME_ATOL = 2, 1e-6
# classic CF (the reference scripts' settings): UserCF / ItemCF neighbours and
# list length, GDCF iterations and cutoff; Recall / Precision / F1 against the
# CPU's within CF_METRIC_ATOL: a near tie that the card's and the CPU's float32
# sums order differently moves one item of one list, 1 / (943 x 10) of ua's
# recall; ItemCF came out 5.3e-4 (five such items) off, UserCF 1.1e-4, GDCF
# 0 (measured on one H100; both sides deterministic, so a run repeats them)
CF_NEIGHBOURS, CF_TOP_N, CF_GDCF_ITERATIONS, CF_GDCF_K, CF_METRIC_ATOL = 10, 20, 10, 50, 1e-3
CSRC = "deeplearningrecommendationsystem_tpu_torch/csrc"
PALLAS = "deeplearningrecommendationsystem_tpu/ops/pallas"
KERNELS = {
    "topk_serve_matmul": {"route": "cuda", "source": f"{CSRC}/serving_topk.cu",
                          "replaces": f"{PALLAS}/serving_topk.py:137"},
    "topk_scores": {"route": "cuda", "source": f"{CSRC}/serving_topk.cu",
                    "replaces": f"{PALLAS}/serving_topk.py:236"},
    "gather_rows": {"route": "cuda", "source": f"{CSRC}/gather.cu",
                    "replaces": f"{PALLAS}/gather.py:69 and {PALLAS}/gather_mm.py:71"},
    "onehot_grad": {"route": "cuda", "source": f"{CSRC}/gather.cu",
                    "replaces": f"{PALLAS}/onehot_grad.py:70"},
    "mf_fullbatch_train": {"route": "cuda", "source": f"{CSRC}/mf_epoch.cu",
                           "replaces": f"{PALLAS}/mf_epoch.py:141"},
    "lr_fullbatch_train": {"route": "cuda", "source": f"{CSRC}/lr_epoch.cu",
                           "replaces": f"{PALLAS}/lr_epoch.py:90"},
    "lr_fullbatch_train_compact": {"route": "cuda", "source": f"{CSRC}/lr_epoch.cu",
                                   "replaces": f"{PALLAS}/lr_epoch.py:272"},
    "afm_attention_pool": {"route": "cuda", "source": f"{CSRC}/afm_attention.cu",
                           "replaces": f"{PALLAS}/afm_attention.py:57"},
    "afm_attention_pool_bwd": {"route": "cuda", "source": f"{CSRC}/afm_attention.cu",
                               "replaces": f"{PALLAS}/afm_attention.py:175 (backward _pool_bwd)"},
    "din_head_fused": {"route": "cuda", "source": f"{CSRC}/din_head.cu",
                       "replaces": f"{PALLAS}/din_head.py:346 (forward, pallas_call :267)"},
    "din_head_fused_bwd": {"route": "cuda", "source": f"{CSRC}/din_head.cu",
                           "replaces": f"{PALLAS}/din_head.py:346 (backward, pallas_call :300)"},
    "din_attention_pool": {"route": "cuda", "source": f"{CSRC}/din_attention.cu",
                           "replaces": f"{PALLAS}/din_attention.py:82"},
    "din_full_history": {"route": "cuda", "source": f"{CSRC}/din_full_history.cu",
                         "replaces": "none: the JAX package scores full histories through XLA "
                                     "(models/base.py::catalog_scores_full_history)"},
}
# kernel launches of one call of the DIN head's launchers at the preset's widths,
# by dtype: the float32 forward is the attention stage and the fc head, the
# bf16 forward din_fwd_kernel; the backward in either dtype under autograd (the
# forward's pooled rows handed to it) the fc head's backward, the attention
# unit's, the fc weight gradients and the slots' sum
DIN_HEAD_LAUNCHES = {"din_head_fused": {"float32": 2, "bfloat16": 1},
                     "din_head_fused_bwd": {"float32": 4, "bfloat16": 4}}
LAUNCHERS = {"topk_serve_matmul": cuda_topk.topk_serve_matmul,
             "topk_scores": cuda_topk.topk_scores,
             "gather_rows": cuda_gather.gather_rows,
             "onehot_grad": cuda_gather.onehot_grad,
             "mf_fullbatch_train": cuda_mfe.mf_fullbatch_train,
             "lr_fullbatch_train": cuda_lre.lr_fullbatch_train,
             "lr_fullbatch_train_compact": cuda_lre.lr_fullbatch_train_compact,
             "afm_attention_pool": cuda_afm.afm_attention_pool,
             "afm_attention_pool_bwd": cuda_afm.afm_attention_pool_bwd,
             "din_head_fused": cuda_dh.din_head_fused,
             "din_head_fused_bwd": cuda_dh.din_head_fused_bwd,
             "din_attention_pool": cuda_dinatt.din_attention_pool,
             "din_full_history": cuda_dfh.din_full_history_scores}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def launches() -> dict:
    """Every launcher's count; the DIN head's also by its inputs' dtype, as
    "din_head_fused:float32" and so on."""
    counts = {name: fn.launches for name, fn in LAUNCHERS.items()}
    for name in DIN_HEAD_LAUNCHES:
        counts.update({f"{name}:{dt}": n for dt, n in LAUNCHERS[name].launches_by_dtype.items()})
    return counts


def reset_launches() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0
    cuda_dh.reset_launches()


def din_head_counts(fwd: dict, bwd: dict) -> dict:
    """The DIN head's launch counts, in all and by dtype, for ``fwd`` and ``bwd``
    calls by dtype ({"float32": n, "bfloat16": m})."""
    counts = {}
    for name, calls in (("din_head_fused", fwd), ("din_head_fused_bwd", bwd)):
        per = {dt: calls.get(dt, 0) * DIN_HEAD_LAUNCHES[name][dt] for dt in ("float32", "bfloat16")}
        counts.update({name: sum(per.values()), **{f"{name}:{dt}": n for dt, n in per.items()}})
    return counts


# ---------------------------------------------------------------- phase 1

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi listed no card")
    return out[0]


# ---------------------------------------------------------------- phase 3

def time_ms(fn, budget_ms: float = 150.0) -> float:
    """Device time of one call of ``fn``: CUDA events around a run of calls,
    after a warm-up; the number of calls fills about ``budget_ms``."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = int(min(200, max(3, budget_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_of(flops: float, nbytes: float, tf32_flops: float = 0.0, bf16_flops: float = 0.0):
    """(bound_ms, bound_by) for this work on the card's peaks: float32 operations
    on the CUDA cores, TF32 and bf16 ones on the tensor cores (which run beside
    the CUDA cores: the larger time counts), against the bytes."""
    t_ops = max(flops / PEAK_F32_FLOP_S, tf32_flops / PEAK_TF32_FLOP_S,
                bf16_flops / PEAK_BF16_FLOP_S) * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def topk_bound(name: str, U: int, I: int, D: int, k: int):
    out_bytes = U * k * (4 + 4)
    if name == "topk_serve_matmul":
        # the 3xTF32 products (3 x 2 U I D on the tensor cores) and one float32
        # compare per score; P, Q, seen (1 byte), outputs
        return bound_of(U * I, U * D * 4 + I * D * 4 + U * I + out_bytes, 3 * 2 * U * I * D)
    return bound_of(U * I, U * I * 4 + U * I + out_bytes)  # one compare per score


def check_exact(name, got, want) -> None:
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        bad = (got[1] != want[1]).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: kernel != plain version on integer inputs at {bad}")


def scale(scores: torch.Tensor) -> torch.Tensor:
    """[U, 1]: each row's largest |score| over its unmasked items, at least 1."""
    live = scores.masked_fill(scores <= NEG_INF / 2, 0.0)
    return live.abs().amax(dim=-1, keepdim=True).clamp_min(1.0)


def check_close(name, got, want_ext, scores) -> float:
    """Kernel (values, ids) against the plain version's top k + 1 ``want_ext``
    on the masked ``scores``: values within the tolerance; ids equal wherever
    both neighbouring values differ by more than it; every id carries its own
    score and no id repeats. Returns the largest absolute value error."""
    gv, gi = got
    k = gv.shape[1]
    wv, wi = want_ext[0][:, :k], want_ext[1][:, :k]
    tol = RTOL * scale(scores)
    err = (gv - wv).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"{name}: values differ by up to {err.max().item()}")
    ext = want_ext[0]
    gap_prev = torch.cat([torch.full_like(ext[:, :1], float("inf")), ext[:, :-1] - ext[:, 1:]], 1)
    gap_next = torch.cat([ext[:, :-1] - ext[:, 1:], torch.full_like(ext[:, :1], float("inf"))], 1)
    clear = ((gap_prev > tol) & (gap_next > tol))[:, :k]
    if not torch.equal(gi[clear], wi[clear]):
        raise AssertionError(f"{name}: ids differ where the values are apart")
    own = torch.gather(scores, 1, gi.long())
    if not bool(((own - gv).abs() <= tol).all()):
        raise AssertionError(f"{name}: an id does not carry its own score")
    srt = gi.sort(dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        raise AssertionError(f"{name}: an id repeats in a row")
    return float(err.max().item())


def fewer_than_k(seen: torch.Tensor) -> torch.Tensor:
    """User 0 keeps three unseen items, fewer than any k checked here."""
    I = seen.shape[1]
    seen[0] = True
    seen[0, [5, I // 2, I - 1]] = False
    return seen


def check_topk(name: str, U: int, I: int, D: int, k: int, gen: torch.Generator,
               seen: torch.Tensor | None = None, label: str | None = None) -> dict:
    """The kernel against its plain version on a random seen mask whose user 0
    keeps fewer than k unseen items, or on ``seen`` as the main path gives it
    (an EP block's, int8, its vocab-pad columns set)."""
    dev = DEVICE
    given = seen is not None
    if not given:
        seen = fewer_than_k(torch.rand((U, I), generator=gen, device=dev) < SEEN_DENSITY)
    mask = seen != 0
    kernel, plain = getattr(topk, name), getattr(topk, f"{name}_plain")
    if name == "topk_serve_matmul":
        p_int = torch.randint(-3, 4, (U, D), generator=gen, device=dev).float()
        q_int = torch.randint(-3, 4, (I, D), generator=gen, device=dev).float()
        P = torch.randn((U, D), generator=gen, device=dev)
        Q = torch.randn((I, D), generator=gen, device=dev)
        int_args, args = (p_int, q_int, seen), (P, Q, seen)
        masked = torch.where(mask, NEG_INF, P @ Q.T)

        def library():
            return torch.topk(torch.where(mask, NEG_INF, torch.matmul(P, Q.T)), k)
    else:
        s_int = torch.randint(-20, 21, (U, I), generator=gen, device=dev).float()
        S = torch.randn((U, I), generator=gen, device=dev)
        int_args, args = (s_int, seen), (S, seen)
        masked = torch.where(mask, NEG_INF, S)

        def library():
            return torch.topk(torch.where(mask, NEG_INF, S), k)

    got_int = kernel(*int_args, k=k)
    check_exact(name, got_int, plain(*int_args, k=k))
    lowest_seen = [i for i in range(k + 1) if i != 5][: k - 3]
    if not given and (got_int[1][0, 3:].tolist() != lowest_seen
                      or got_int[0][0, 3].item() > NEG_INF / 2):
        raise AssertionError(f"{name}: the masked slots of user 0 are not its lowest seen ids")
    got = kernel(*args, k=k)
    torch.cuda.synchronize()
    err = check_close(name, got, plain(*args, k=min(k + 1, I)), masked)
    t_bound, bound_by = topk_bound(name, U, I, D, k)
    launcher = getattr(cuda_topk, name)
    row = {
        "shape": {"users": U, "items": I, "dim": D, "k": k,
                  **({"seen": label} if label else {})} if name == "topk_serve_matmul"
        else {"users": U, "items": I, "k": k, **({"seen": label} if label else {})},
        "exact_on_integer_inputs": True,
        "max_abs_err": err,
        **lookup_times(lambda: kernel(*args, k=k), lambda: plain(*args, k=k), library,
                       (lambda: launcher(*args, k)) if U <= HOST_TIMED_USERS else None),
        "bound_ms": t_bound,
        "bound_by": bound_by,
    }
    del masked
    torch.cuda.empty_cache()
    return row


def host_us(fn) -> float:
    """Host microseconds per call of ``fn`` over HOST_CALLS calls without a
    synchronise (where the card is slower than the host, the launch queue fills
    and this reads the card's rate)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(HOST_CALLS):
        fn()
    elapsed = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return elapsed / HOST_CALLS / 1e3


def lookup_times(kernel, plain, library, launcher=None) -> dict:
    """kernel_ms, plain_ms, library_ms and, given the launcher, host_us and
    library_host_us of a lookup or top-k row (see LOOKUP_INTERLEAVE_MS)."""
    times = {"kernel_ms": time_ms(kernel, LOOKUP_BUDGET_MS)}
    fast = times["kernel_ms"] < LOOKUP_INTERLEAVE_MS
    if not fast:  # a slow call: timed again at time_ms's usual budget
        times["kernel_ms"] = time_ms(kernel)
    times["plain_ms"] = time_ms(plain, LOOKUP_BUDGET_MS) if fast else time_ms(plain)
    if fast:
        fns = {"kernel_ms": kernel, "library_ms": library}
        runs = {key: [] for key in fns}
        for i in range(LOOKUP_RUNS):
            for key in (("kernel_ms", "library_ms") if i % 2 == 0 else ("library_ms", "kernel_ms")):
                runs[key].append(time_ms(fns[key], LOOKUP_BUDGET_MS))
        times.update({key: statistics.median(v) for key, v in runs.items()},
                     timing=f"median of {LOOKUP_RUNS} interleaved runs")
    else:
        times.update(library_ms=time_ms(library), timing="one run")
    if launcher is not None:
        times.update(host_us=host_us(launcher), library_host_us=host_us(library))
    return times


def check_gather(table_name: str, table: torch.Tensor, ids: torch.Tensor) -> dict:
    """gather_rows_kernel against its plain version: bit-equal on any input.
    The bound reads only the table rows the ids touch (wrapped, then clamped)."""
    got = gat.gather_rows_kernel(table, ids)
    if not torch.equal(got, gat.gather_rows_kernel_plain(table, ids)):
        raise AssertionError(f"gather_rows ({table_name}): kernel != plain version")
    (V, D), B = table.shape, ids.shape[0]
    es = table.element_size()
    touched = torch.where(ids < 0, ids + V, ids).clamp(0, V - 1).unique().numel()
    t_bound, bound_by = bound_of(0, B * D * es + B * ids.element_size() + touched * D * es)
    return {
        "shape": {"table": table_name, "vocab": V, "dim": D, "ids": B,
                  "dtype": str(table.dtype).split(".")[1]},
        "exact": True, "max_abs_err": 0.0,
        **lookup_times(lambda: gat.gather_rows_kernel(table, ids),
                       lambda: gat.gather_rows_kernel_plain(table, ids),
                       lambda: torch.index_select(table, 0, ids),
                       lambda: cuda_gather.gather_rows(table, ids)),
        "bound_ms": t_bound, "bound_by": bound_by,
    }


def check_sum_order(name: str, got: torch.Tensor, ids: torch.Tensor, g: torch.Tensor, V: int):
    """``got`` = float32 sums of the rows of ``g`` per id, in any order: each
    value lies within the float32 bound of recursive summation, n u sum|g|
    (n the row's count, u = 2^-24), of the float64 sum. Atomics add in an
    order that changes between runs, so no tighter equality holds."""
    idx = ids.long()
    ref = torch.zeros((V, g.shape[1]), dtype=torch.float64, device=g.device)
    ref.index_add_(0, idx, g.double())
    mass = torch.zeros_like(ref).index_add_(0, idx, g.double().abs())
    count = torch.bincount(idx, minlength=V).double()[:, None]
    err = (got.double() - ref).abs()
    if not bool((err <= count * 2.0 ** -24 * mass).all()):
        raise AssertionError(f"{name}: a sum is off by more than float32 summation allows")


def check_grad(table_name: str, ids: torch.Tensor, V: int, D: int, dtype,
               gen: torch.Generator, owned: torch.Tensor | None = None) -> dict:
    """onehot_grad against its plain version: exact on integer cotangents;
    on normal ones both within the float32 summation bound of the exact sums.
    ``owned`` [N] zeroes the cotangent rows of the ids an EP block does not
    own, as ``parallel/embedding.py`` hands them to the kernel."""
    N = ids.shape[0]
    keep = (torch.ones(N, device=DEVICE) if owned is None else owned.float())[:, None].to(dtype)
    g_int = torch.randint(-8, 9, (N, D), generator=gen, device=DEVICE).to(dtype) * keep
    if not torch.equal(gat.onehot_grad(ids, g_int, V), gat.onehot_grad_plain(ids, g_int, V)):
        raise AssertionError(f"onehot_grad ({table_name}): kernel != plain on integer cotangents")
    g = torch.randn((N, D), generator=gen, device=DEVICE).to(dtype) * keep
    got, want = gat.onehot_grad(ids, g, V), gat.onehot_grad_plain(ids, g, V)
    check_sum_order(f"onehot_grad ({table_name})", got, ids, g, V)
    check_sum_order(f"onehot_grad_plain ({table_name})", want, ids, g, V)
    ids64 = ids.long()
    t_bound, bound_by = bound_of(N * D, N * D * g.element_size() + N * ids.element_size()
                                 + V * D * 4)
    return {
        "shape": {"table": table_name, "vocab": V, "dim": D, "ids": N,
                  "dtype": str(dtype).split(".")[1]},
        "exact_on_integer_inputs": True,
        "max_abs_err": float((got - want).abs().max()),
        # index_add_ takes float32 sources only into a float32 table: bf16 pays a cast
        **lookup_times(lambda: gat.onehot_grad(ids, g, V),
                       lambda: gat.onehot_grad_plain(ids, g, V),
                       lambda: torch.zeros((V, D), device=DEVICE).index_add_(
                           0, ids64, g if g.dtype == torch.float32 else g.float()),
                       lambda: cuda_gather.onehot_grad(ids, g, V)),
        "bound_ms": t_bound, "bound_by": bound_by,
    }


def check_ep_blocks(ds: MovieLens100K, ids_by_model: dict, rows: dict) -> None:
    """The lookup pair's and both top-k kernels' rows at the mesh phase's EP
    blocks, appended to ``rows``: block 2 of 2 of MF's (D 64) and DeepFM's
    (D 128) user and item tables on their train ids, clamped into the block,
    the cotangent rows of the ids it does not own zeroed
    (``parallel/embedding.py::_owned_rows``); MF's sharded top-k
    (``parallel/serving.py::sharded_topk``: the block's fused top-k of every
    user over 841 items with the block's seen mask, then the merge of 2 x
    MESH_TOPK candidates) and DeepFM's block top-k of its block scores
    (``sharded_feature_topk``); and a block with vocab-pad columns (block 4
    of 4: 2 of 421 columns past 1682) marked seen."""
    gen = torch.Generator(device=DEVICE).manual_seed(EP_ROWS_SEED)
    m = 2
    for model_name, (D, user_ids, item_ids) in ids_by_model.items():
        for field, V, ids in (("user", ds.num_users, user_ids), ("item", ds.num_items, item_ids)):
            block_rows = padded_height(V, m) // m
            local = ids.long() - (m - 1) * block_rows
            owned = (local >= 0) & (local < block_rows)
            local = local.clamp(0, block_rows - 1).contiguous()
            tname = f"{model_name} {field} EP block {m} of {m}"
            table = torch.randn((block_rows, D), generator=gen, device=DEVICE)
            rows["gather_rows"].append(check_gather(tname, table, local))
            emit({"phase": "kernel_check", "kernel": "gather_rows", **rows["gather_rows"][-1]})
            rows["onehot_grad"].append(check_grad(tname, local, block_rows, D, torch.float32, gen,
                                                  owned=owned))
            emit({"phase": "kernel_check", "kernel": "onehot_grad", **rows["onehot_grad"][-1]})
    seen = torch.as_tensor(ds.seen_mask(ds.train, ds.valid, ds.test), device=DEVICE)
    for blocks, name, D in ((m, "topk_serve_matmul", EMBEDDING_DIM), (m, "topk_scores", 0),
                            (4, "topk_serve_matmul", EMBEDDING_DIM)):
        block_rows = padded_height(ds.num_items, blocks) // blocks
        blk = _seen_block(seen, ds.num_users, (blocks - 1) * block_rows, block_rows,
                          ds.num_items, DEVICE)
        label = (f"EP block {blocks} of {blocks}, "
                 f"{block_rows * blocks - ds.num_items} vocab-pad columns marked")
        rows[name].append(check_topk(name, ds.num_users, block_rows, D, MESH_TOPK, gen,
                                     seen=blk, label=label))
        emit({"phase": "kernel_check", "kernel": name, **rows[name][-1]})
    no_seen = torch.zeros((ds.num_users, m * MESH_TOPK), dtype=torch.int8, device=DEVICE)
    rows["topk_scores"].append(check_topk("topk_scores", ds.num_users, m * MESH_TOPK, 0,
                                          MESH_TOPK, gen, seen=no_seen,
                                          label=f"merge of {m} EP blocks' candidates"))
    emit({"phase": "kernel_check", "kernel": "topk_scores", **rows["topk_scores"][-1]})


def mf_epoch_bound(B: int, U: int, I: int, D: int, epochs: int):
    """(bound_ms, bound_by) of ``epochs`` fused MF epochs: uid, iid, y and the
    two initial tables read once, the two tables and the losses written once;
    per row and epoch the dot product (2D), BCE and sigmoid (20) and the two
    gradient rows and their sums (4D), and per table value and epoch Adam (15)."""
    flops = epochs * (B * (6 * D + 20) + 15 * (U + I) * D)
    nbytes = B * (4 + 4 + 4) + 2 * (U + I) * D * 4 + epochs * 4
    return bound_of(flops, nbytes)


def reorder_rows(kind: str, ids: tuple, V: tuple, rest: tuple, gen: torch.Generator):
    """The trainers' rows as TRAINER_ROWS describes them: (ids, rest) with the
    rows permuted ("shuffled"), or with skewed and out-of-range ids ("skewed");
    ids[k] indexes a table of V[k] rows, rest are the other per-row tensors."""
    B = ids[0].shape[0]
    if kind == "shuffled":
        perm = torch.randperm(B, generator=gen, device=DEVICE)
        return tuple(t[perm].contiguous() for t in ids), tuple(t[perm].contiguous() for t in rest)
    out = []
    for t, n in zip(ids, V):
        t = t.clone()
        t[torch.rand(B, generator=gen, device=DEVICE) < 0.2] = n // 3
        bad = torch.rand(B, generator=gen, device=DEVICE) < 1e-3
        t[bad] = torch.where(torch.rand(B, generator=gen, device=DEVICE) < 0.5, -1, n)[bad].to(t.dtype)
        out.append(t)
    return tuple(out), rest


def check_mf_epoch(batch, U: int, I: int, dtype: str, gen: torch.Generator,
                   timed_epochs: int, D: int = EMBEDDING_DIM, rows: str = "as batched") -> dict:
    """mf_fullbatch_train against its plain version over MF_CHECK_EPOCHS epochs
    at the MF training shape (factors of width D, the rows as ``rows`` says:
    TRAINER_ROWS); two calls must give the same bits; times per epoch."""
    (uid, iid), y = batch
    if rows != "as batched":
        (uid, iid), (y,) = reorder_rows(rows, (uid, iid), (U, I), (y,), gen)
    pu0 = 0.1 * torch.randn((U, D), generator=gen, device=DEVICE)
    pi0 = 0.1 * torch.randn((I, D), generator=gen, device=DEVICE)
    args = (uid, iid, y, pu0, pi0)
    got = mfe.mf_fullbatch_train(*args, MF_CHECK_EPOCHS, 0.01, 1e-5, dtype)
    want = mfe.mf_fullbatch_train_plain(*args, MF_CHECK_EPOCHS, 0.01, 1e-5, dtype)
    rtol, atol = MF_TOL[dtype]
    torch.testing.assert_close(got[2], want[2], rtol=rtol, atol=0)
    for g_t, w_t in zip(got[:2], want[:2]):
        torch.testing.assert_close(g_t, w_t, rtol=0, atol=atol)
    again = mfe.mf_fullbatch_train(*args, MF_CHECK_EPOCHS, 0.01, 1e-5, dtype)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"mf_fullbatch_train ({dtype}, D {D}, {rows}): two calls differ")
    err = max(float((g_t - w_t).abs().max()) for g_t, w_t in zip(got, want))
    B = uid.shape[0]
    E = timed_epochs

    pu = pu0.clone().requires_grad_(True)
    pi = pi0.clone().requires_grad_(True)
    opt = torch.optim.Adam([pu, pi], lr=0.01, weight_decay=1e-5)

    # an id outside the table matches no row (TRAINER_ROWS' skewed ids)
    u_ok, i_ok = ((uid >= 0) & (uid < U))[:, None], ((iid >= 0) & (iid < I))[:, None]
    u_in, i_in = uid.clamp(0, U - 1), iid.clamp(0, I - 1)

    def library_epoch():  # one autograd epoch with torch.optim.Adam
        opt.zero_grad(set_to_none=True)
        z = (torch.where(u_ok, pu[u_in], 0.0) * torch.where(i_ok, pi[i_in], 0.0)).sum(dim=1)
        F.binary_cross_entropy_with_logits(z, y).backward()
        opt.step()

    t_bound, bound_by = mf_epoch_bound(B, U, I, D, E)
    return {
        "shape": {"rows": B, "users": U, "items": I, "dim": D, "compute_dtype": dtype,
                  "order": rows, "epochs_per_call": E},
        "unit": "per epoch",
        "max_abs_err": err,
        "kernel_ms": time_ms(lambda: mfe.mf_fullbatch_train(*args, E, 0.01, 1e-5, dtype)) / E,
        "plain_ms": time_ms(lambda: mfe.mf_fullbatch_train_plain(*args, E, 0.01, 1e-5, dtype)) / E,
        "library_ms": time_ms(library_epoch),
        "bound_ms": t_bound / E, "bound_by": bound_by,
    }


def library_epoch(params, loss_fn, learning_rate: float):
    """One eager autograd epoch with torch.optim.Adam over ``params``."""
    opt = torch.optim.Adam(params, lr=learning_rate)

    def epoch():
        opt.zero_grad(set_to_none=True)
        loss_fn().backward()
        opt.step()

    return epoch


def lr_bound(mode: str, args, epochs: int):
    """(bound_ms, bound_by) of ``epochs`` fused LR epochs. Bytes: every input
    read once and w and the losses written once, for the whole call, except
    that the wide mode reads its design matrix once an epoch: at 737 MB it is
    far beyond the card's 50 MB L2, and each epoch's scores need the weights
    of the epoch before. Operations per epoch: the row's score and its
    gradient (2 per column each, the dense product counted whole in the wide
    mode), 20 for the loss and g, 15 per weight for Adam."""
    nbytes = sum(t.numel() * t.element_size() for t in args) + args[-1].numel() * 4 + epochs * 4
    if mode == "wide":
        nbytes += (epochs - 1) * args[0].numel() * args[0].element_size()
        (B, F), cols = args[0].shape, args[0].shape[1]
    else:
        B, cols = args[2].shape[0], args[2].shape[1] + 2
        F = args[-1].numel()
    return bound_of(epochs * (B * (4 * cols + 20) + 15 * F), nbytes)


def check_lr(model, params, x, y, mode: str, learning_rate: float, timed_epochs: int,
             rows: str = "as batched", gen: torch.Generator = None) -> dict:
    """A fused LR trainer against its plain version over LR_CHECK_EPOCHS epochs at
    the LR train batch, as ``fast_fit`` feeds it (the compact mode also with
    its rows as ``rows`` says: TRAINER_ROWS, drawn from ``gen``); two calls
    must give the same bits; times per epoch."""
    U, I = model.spec.num_users, model.spec.num_items
    args = model.fused_inputs(params, x, y, mode)
    if mode == "compact":
        kernel, plain, extra = lre.lr_fullbatch_train_compact, lre.lr_fullbatch_train_compact_plain, (U, I)
        if rows != "as batched":
            ids, rest = reorder_rows(rows, args[:2], (U, I), args[2:4], gen)
            args = ids + rest + args[4:]
    else:
        kernel, plain, extra = lre.lr_fullbatch_train, lre.lr_fullbatch_train_plain, ()
    got = kernel(*args, LR_CHECK_EPOCHS, learning_rate, *extra)
    want = plain(*args, LR_CHECK_EPOCHS, learning_rate, *extra)
    torch.testing.assert_close(got[1], want[1], rtol=LR_TOL[0], atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=LR_TOL[1])
    again = kernel(*args, LR_CHECK_EPOCHS, learning_rate, *extra)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"lr_fullbatch_train ({mode}, {rows}): two calls differ")
    err = max(float((g_t - w_t).abs().max()) for g_t, w_t in zip(got, want))

    w = args[-1].reshape(-1).clone().requires_grad_(True)
    if mode == "compact":
        uid, iid, dense, yy, _ = args
        # an id outside [0, U) (or [0, I)) matches no weight (TRAINER_ROWS' skewed ids)
        u_ok, i_ok = (uid >= 0) & (uid < U), (iid >= 0) & (iid < I)
        u_in, i_in = uid.clamp(0, U - 1), iid.clamp(0, I - 1)

        def loss():
            return F.binary_cross_entropy_with_logits(
                torch.where(u_ok, w[u_in], 0.0) + torch.where(i_ok, w[U + i_in], 0.0)
                + dense @ w[U + I:], yy)
    else:
        x_aug, yy, _ = args

        def loss():
            return F.binary_cross_entropy_with_logits(x_aug @ w, yy)

    E = timed_epochs
    t_bound, bound_by = lr_bound(mode, args, E)
    return {
        "shape": {"rows": int(y.shape[0]), "users": U, "items": I,
                  "columns": int(args[0].shape[1]) if mode == "wide" else int(args[2].shape[1]),
                  "mode": mode, "order": rows, "epochs_per_call": E},
        "unit": "per epoch",
        "max_abs_err": err,
        "kernel_ms": time_ms(lambda: kernel(*args, E, learning_rate, *extra)) / E,
        "plain_ms": time_ms(lambda: plain(*args, E, learning_rate, *extra)) / E,
        "library_ms": time_ms(library_epoch([w], loss, learning_rate)),
        "library": "one eager autograd epoch with torch.optim.Adam",
        "bound_ms": t_bound / E, "bound_by": bound_by,
    }


def afm_work(B: int, D: int, A: int, backward: bool):
    """The AFM pool's work on B rows: (z, dc, dW, other, bytes), the three
    products apart, 2 D A per row and pair each: z = c W (the forward's, which
    the backward recomputes), dc = W dz and dW = sum c^T dz (the backward's; 0
    in the forward). Other operations, per row and pair: the product c (D), the
    bias, relu and dot with h (4 A), the pool (2 D); the softmax 45 a row; the
    backward adds per pair g . c (2 D), dz, dh and db (5 A), dW's c (D), dc's w g
    (2 D) and de (4 D), and no pool."""
    z = B * 15 * 2 * D * A
    other = B * (15 * (4 * A + 3 * D) + 45)
    params = (D * A + 2 * A) * 4
    if not backward:
        return z, 0, 0, other, B * 6 * D * 4 + B * D * 4 + params
    other += B * 15 * (7 * D + 5 * A)
    return z, z, z, other, 2 * B * 6 * D * 4 + B * D * 4 + 2 * params


def afm_library_fwd(fields, W, b, h):
    """The eager composition: pair products, torch.matmul for c @ W, softmax,
    torch.bmm for the pool."""
    cross = pairwise_products(fields)
    wts = torch.softmax(torch.relu(torch.matmul(cross, W) + b) @ h, dim=1)
    return torch.bmm(wts.transpose(1, 2), cross)[:, 0]


def afm_library_bwd(fields, W, b, h, g):
    leaves = [t.detach().requires_grad_(True) for t in (fields, W, b, h)]
    return torch.autograd.grad(afm_library_fwd(*leaves), leaves, g)


def normwise_err(name: str, got: torch.Tensor, want: torch.Tensor, rtol: float) -> float:
    err = float((got - want).abs().max())
    if not err <= rtol * float(want.abs().max()):
        raise AssertionError(f"{name}: kernel off by {err}, above {rtol} x max |plain|")
    return err


def check_afm(B: int, D: int, A: int, gen: torch.Generator, label: str, backward: bool) -> dict:
    """The AFM pool's forward (or backward) kernel against its plain version on
    B rows of random fields at the scale of the model's embeddings and
    standard-normal attention weights, as the model draws them."""
    fields = 0.1 * torch.randn((B, 6, D), generator=gen, device=DEVICE)
    W = torch.randn((D, A), generator=gen, device=DEVICE)
    b = torch.randn((A,), generator=gen, device=DEVICE)
    h = torch.randn((A, 1), generator=gen, device=DEVICE)
    g = torch.randn((B, D), generator=gen, device=DEVICE) / B
    if backward:
        args, kernel, plain = (fields, W, b, h, g), afm.afm_attention_pool_bwd, afm.afm_attention_pool_bwd_plain
        got, want = kernel(*args), plain(*args)
        err = max(normwise_err(f"afm_attention_pool_bwd d{n}", gt, wt, AFM_BWD_RTOL)
                  for n, gt, wt in zip(("fields", "W", "b", "h"), got, want))
        if not all(torch.equal(a, b_) for a, b_ in zip(kernel(*args), got)):
            raise AssertionError("afm_attention_pool_bwd: two launches differ")
        del got, want
        library, lib_name = afm_library_bwd, "eager composition's autograd (forward included)"
    else:
        args, kernel, plain = (fields, W, b, h), afm.afm_attention_pool, afm.afm_attention_pool_plain
        got = kernel(*args)
        err = normwise_err("afm_attention_pool", got, plain(*args), AFM_FWD_RTOL)
        if not torch.equal(kernel(*args), got):
            raise AssertionError("afm_attention_pool: two launches differ")
        del got
        library, lib_name = afm_library_fwd, "eager: pair products, torch.matmul for c @ W, softmax, torch.bmm"
    torch.cuda.synchronize()
    z, dc, dw, other, nbytes = afm_work(B, D, A, backward)
    cuda_core = bound_of(z + dc + dw + other, nbytes)
    # z and dc multiply on the tensor cores in 3xTF32; dW and the rest on CUDA cores
    t_bound, bound_by = bound_of(dw + other, nbytes, 3 * (z + dc))
    row = {
        "shape": {"rows": B, "fields": 6, "dim": D, "attention": A, "batch": label},
        "max_abs_err": err,
        "kernel_ms": time_ms(lambda: kernel(*args)),
        "plain_ms": time_ms(lambda: plain(*args)),
        "library_ms": time_ms(lambda: library(*args)),
        "library": lib_name,
        "bound_ms": t_bound, "bound_by": bound_by, "cuda_core_bound_ms": cuda_core[0],
    }
    del fields, g
    torch.cuda.empty_cache()
    return row


def din_work(B: int, L: int, D: int, A: tuple, F: tuple, part: str, es: int = 4):
    """(products, other operations, bytes) of a DIN kernel on B rows of L
    positions, its inputs ``es`` bytes an element. Products (the operations
    whose operands the head's bf16 path rounds, ``_mdot``/``_cdot``), per row:
    t @ wt (2 D A1); per position h @ wh (2 D A1), the second layer
    (2 A1 A2 + 2 A2) and the score (2 A2); for the head, the fc (2 (2D) F1 +
    2 F1 F2 + 2 F2); the backward takes them three times (the forward again,
    d input and d weight). Other operations: per position the t term, bias and
    relu (3 A1 + 2 A2), the softmax (4 L) and the float32 pool (2 L D); the
    head's fc biases and relus (2 F1 + 4 F2 + 1) and b3 (L); the backward adds
    the pool's backward (4 L D), per position 6 A1 + 5 A2 + 6 D and per row
    6 F1 + 4 F2 + 6 D for the masks, sums and the softmax's backward. The pool
    kernel has no fc and no last bias. Bytes: each input once (the logits in
    the inputs' dtype), the backward's gradients in float32."""
    A1, A2 = A[0], A[1]
    F1, F2 = F[0], F[1]
    att_mm = 2 * D * A1 + L * (2 * D * A1 + 2 * A1 * A2 + 2 * A2)
    att_ops = L * (3 * A1 + 2 * A2) + 4 * L + 2 * L * D
    att_w = 2 * D * A1 + A1 + A1 * A2 + A2 + A2
    if part == "pool":
        return B * att_mm, B * att_ops, es * (B * L * D + B * D + att_w) + 4 * B * D
    fc_mm = 2 * 2 * D * F1 + 2 * F1 * F2 + 2 * F2
    fwd = att_ops + 2 * F1 + 4 * F2 + 1 + L
    weights = att_w + 1 + 2 * D * F1 + F1 + F1 * F2 + F2 + F2 + 1
    inputs = B * L * D + B * D + weights
    if part == "fwd":
        return B * (att_mm + fc_mm), B * fwd, es * (inputs + B)
    bwd = fwd + 4 * L * D + L * (6 * A1 + 5 * A2 + 6 * D) + 6 * F1 + 4 * F2 + 6 * D
    return 3 * B * (att_mm + fc_mm), B * bwd, es * (inputs + B) + 4 * inputs


def din_bwd_tensor_products(B: int, L: int, D: int, A: tuple, F: tuple) -> int:
    """The float32 backward's products that run in 3xTF32 on the tensor cores
    (0 where its widths take din_head_bwd_kernel<float>, CUDA cores
    throughout): the fc head's recompute (in din_head_bwd_fc_head_kernel or,
    where its tile does not fit, din_head_bwd_fc_stream_kernel), [pooled | t] u1 and f1 u2, and its
    two input gradients, dzf2 u2^T and dzf1 u1^T, 2 (2 (2D) F1 + 2 F1 F2) a
    row. The rest (the attention unit, the weight gradients, f2 u3) is float32
    on CUDA cores."""
    if not cuda_dh.fits(L, D, A[0], A[1], F[0], F[1]) & cuda_dh.SPLIT_F32:
        return 0
    return B * 2 * (2 * 2 * D * F[0] + 2 * F[0] * F[1])


def din_library_fwd(hist, tgt, att, fc):
    """The eager composition: attention_pool and mlp, torch.matmul throughout."""
    return mlp(fc, torch.cat([attention_pool(att, hist, tgt), tgt], dim=-1))[:, 0]


def din_library_pool(hist, tgt, att):
    """The JAX package's composition (``ops/attention.py``, concat
    decomposed): torch.matmul of [B L, D] by wh and of t by wt, relu,
    torch.matmul, softmax over L, torch.bmm for the pool; b3 dropped as the
    kernel drops it."""
    B, L, D = hist.shape
    w1 = att[0]["w"]
    wh, wt = w1[:D] + w1[D:2 * D], w1[2 * D:] - w1[D:2 * D]
    z1 = (torch.matmul(hist.reshape(B * L, D), wh).reshape(B, L, -1)
          + (torch.matmul(tgt, wt) + att[0]["b"])[:, None, :])
    z2 = torch.relu(torch.matmul(torch.relu(z1), att[1]["w"]) + att[1]["b"])
    w = torch.softmax(torch.matmul(z2, att[2]["w"])[..., 0], dim=-1)
    return torch.bmm(w[:, None, :], hist)[:, 0]


def din_library_bwd(hist, tgt, att, fc, g):
    leaves = [hist.detach().requires_grad_(True), tgt.detach().requires_grad_(True)]
    att = [{k: v.detach().requires_grad_(True) for k, v in layer.items()} for layer in att]
    fc = [{k: v.detach().requires_grad_(True) for k, v in layer.items()} for layer in fc]
    params = [v for net in (att, fc) for layer in net for v in layer.values()]
    return torch.autograd.grad(din_library_fwd(leaves[0], leaves[1], att, fc), leaves + params, g)


def din_inputs(B: int, L: int, D: int, A: tuple, F: tuple, gen: torch.Generator):
    """Normal history and target rows, the two MLPs as DIN draws them (seeded CPU
    generator, then moved), and a logit cotangent of the loss's scale."""
    cpu = torch.Generator().manual_seed(B)
    att = [{k: v.to(DEVICE) for k, v in layer.items()} for layer in mlp_init(cpu, (3 * D,) + A)]
    fc = [{k: v.to(DEVICE) for k, v in layer.items()} for layer in mlp_init(cpu, (2 * D,) + F)]
    hist = 0.5 * torch.randn((B, L, D), generator=gen, device=DEVICE)
    tgt = 0.5 * torch.randn((B, D), generator=gen, device=DEVICE)
    g = torch.randn((B,), generator=gen, device=DEVICE) / B
    return hist, tgt, att, fc, g


def kink_distance(hist, tgt, weights, near: float = 0.0):
    """[B]: each row's least |relu input| (z1, z2, f1 and f2 before the relu)
    over its layer's largest |value|, in float64, each product's operand
    rounded to the weights' dtype where the head rounds it (``_mdot``). Given
    ``near``, also [B]: each row's count of relu inputs within ``near`` of 0 by
    that measure."""
    dt = weights[0].dtype
    wh, wt, b1, w2, b2, w3, b3, u1p, u1t, c1, u2, c2, u3, c3 = (w.double() for w in weights)
    h, t = hist.double(), tgt.double()

    def rnd(x):
        return x.to(dt).double()

    z1 = h @ wh + (t @ wt + b1)[:, None, :]
    z2 = rnd(torch.relu(z1)) @ w2 + b2
    w = torch.softmax((rnd(torch.relu(z2)) @ w3 + b3)[..., 0], dim=-1)
    y1 = rnd(torch.einsum("bl,bld->bd", w, h)) @ u1p + t @ u1t + c1
    y2 = rnd(torch.relu(y1)) @ u2 + c2
    dist = torch.full((h.shape[0],), float("inf"), dtype=torch.float64, device=h.device)
    count = torch.zeros((h.shape[0],), dtype=torch.int64, device=h.device)
    for z in (z1, z2, y1, y2):
        z = z.abs().reshape(h.shape[0], -1)
        dist = torch.minimum(dist, z.amin(dim=1) / z.max())
        if near:
            count += (z <= near * z.max()).sum(dim=1)
    return (dist, count) if near else dist


def din_head_fwd_exact(hist, tgt, weights) -> torch.Tensor:
    """The head's logits in the weights' dtype with every sum in float64: each
    product's operand rounded to the weights' dtype where the head rounds it
    (``_mdot``; relu(z1), relu(z2), pooled, f1 and f2 from float32), the rest
    exact to float64, the logits rounded last."""
    dt = weights[0].dtype
    wh, wt, b1, w2, b2, w3, b3, u1p, u1t, c1, u2, c2, u3, c3 = (w.double() for w in weights)
    B, L, D = hist.shape
    h, t = hist.double(), tgt.double()

    def rnd(x):
        return x.float().to(dt).double()

    z1 = (h.reshape(B * L, D) @ wh).reshape(B, L, -1) + (t @ wt + b1)[:, None, :]
    z2 = rnd(torch.relu(z1)) @ w2 + b2
    w = torch.softmax((rnd(torch.relu(z2)) @ w3 + b3)[..., 0], dim=-1)
    f1 = torch.relu(rnd(torch.einsum("bl,bld->bd", w, h)) @ u1p + t @ u1t + c1)
    f2 = torch.relu(rnd(f1) @ u2 + c2)
    return (rnd(f2) @ u3 + c3)[:, 0].float().to(dt)


def din_head_bwd_exact(hist, tgt, weights, g) -> tuple:
    """The head's backward (``din_head_bwd_plain``'s 16 gradients) with every sum
    in float64: each product's operand rounded to the weights' dtype where the
    head rounds it (``_mdot``, ``_cdot``; from float32), the rest exact to
    float64. The backward twin of ``din_head_fwd_exact``."""
    dt = weights[0].dtype
    wh, wt, b1, w2, b2, w3, b3, u1p, u1t, c1, u2, c2, u3, c3 = (w.double() for w in weights)
    B, L, D = hist.shape
    h, t = hist.double().reshape(B * L, D), tgt.double()

    def rnd(x):
        return x.float().to(dt).double()

    z1 = h @ wh + (t @ wt + b1).repeat_interleave(L, dim=0)
    z2 = rnd(torch.relu(z1)) @ w2 + b2
    w = torch.softmax((rnd(torch.relu(z2)) @ w3 + b3).reshape(B, L), dim=-1)
    pooled = torch.einsum("bl,bld->bd", w, h.reshape(B, L, D))
    f1 = torch.relu(rnd(pooled) @ u1p + t @ u1t + c1)
    f2 = torch.relu(rnd(f1) @ u2 + c2)
    gf = g.double()[:, None]
    du3, dc3 = rnd(f2).T @ rnd(gf), gf.sum(0, keepdim=True)
    dzf2 = (rnd(gf) @ u3.T) * (f2 > 0)
    du2, dc2 = rnd(f1).T @ rnd(dzf2), dzf2.sum(0, keepdim=True)
    dzf1 = (rnd(dzf2) @ u2.T) * (f1 > 0)
    du1p, du1t, dc1 = rnd(pooled).T @ rnd(dzf1), t.T @ rnd(dzf1), dzf1.sum(0, keepdim=True)
    dpooled, dtgt = rnd(dzf1) @ u1p.T, rnd(dzf1) @ u1t.T
    dw_cols = torch.einsum("bd,bld->bl", dpooled, h.reshape(B, L, D))
    ds = (w * (dw_cols - (w * dw_cols).sum(-1, keepdim=True))).reshape(B * L, 1)
    dz2 = (rnd(ds) @ w3.T) * (z2 > 0)
    dw3, db3 = rnd(torch.relu(z2)).T @ rnd(ds), ds.sum(0, keepdim=True)
    dw2, db2 = rnd(torch.relu(z1)).T @ rnd(dz2), dz2.sum(0, keepdim=True)
    dz1 = (rnd(dz2) @ w2.T) * (z1 > 0)
    dwh, db1 = h.T @ rnd(dz1), dz1.sum(0, keepdim=True)
    dz1_rows = dz1.reshape(B, L, -1).sum(1)
    dwt = t.T @ rnd(dz1_rows)
    dtgt = dtgt + rnd(dz1_rows) @ wt.T
    dhist = w[..., None] * dpooled[:, None, :] + (rnd(dz1) @ wh.T).reshape(B, L, D)
    return (dhist, dtgt, dwh, dwt, db1, dw2, db2, dw3, db3, du1p, du1t, dc1, du2, dc2, du3, dc3)


def din_bwd_rows_off(got, want) -> torch.Tensor:
    """[B] bool: the rows whose d hist or d target lies off ``want``'s by more
    than DIN_BF16_BWD_RTOL of that tensor's largest |value|."""
    def beyond(x, y):
        x, y = x.double(), y.double()
        return (x - y).abs().reshape(x.shape[0], -1).amax(dim=1) > DIN_BF16_BWD_RTOL * float(y.abs().max())

    return beyond(got[0], want[0]) | beyond(got[1], want[1])


def din_bwd_row_gap(got, exact, rows) -> float:
    """How far ``got``'s d hist and d target lie from the float64 gradients on
    ``rows``: the largest |difference| over each tensor's largest |value|."""
    if not bool(rows.any()):
        return 0.0
    return max(float((x[rows].double() - e[rows]).abs().max()) / float(e.abs().max())
               for x, e in zip(got[:2], exact[:2]))


def din_bf16_bwd_readings(sub, dist, pooled=None) -> tuple:
    """The bf16 head backward, its plain version and the float64 sums on the
    rows ``sub`` (their kink distances ``dist``): (kernel, plain, readings).
    Readings: the rows off between each pair (``din_bwd_rows_off``) with the
    kink distances of those of kernel against plain, the rows within
    DIN_BF16_KINK of a kink, and how far the kernel's and the plain version's
    off rows lie from the float64 gradients (``din_bwd_row_gap``). ``pooled``:
    pooled rows for the kernel in place of its forward's."""
    got, want = dh.din_head_bwd(*sub, pooled=pooled), dh.din_head_bwd_plain(*sub)
    exact = din_head_bwd_exact(*sub)
    off = din_bwd_rows_off(got, want)
    off_k, off_p = din_bwd_rows_off(got, exact), din_bwd_rows_off(want, exact)
    readings = {
        "rows": int(dist.shape[0]), "near_kink": int((dist <= DIN_BF16_KINK).sum()),
        "off": off, "rows_off": int(off.sum()), "off_kink": dist[off].tolist(),
        "kernel_off_exact": int(off_k.sum()), "plain_off_exact": int(off_p.sum()),
        "kernel_gap": din_bwd_row_gap(got, exact, off_k | off_p),
        "plain_gap": din_bwd_row_gap(want, exact, off_k | off_p),
    }
    del exact
    return got, want, readings


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| past DIN_BF16_FWD_ATOL of the largest |want|, in
    bf16 ulps of each element of ``want``."""
    want = want.float()
    _, e = torch.frexp(want.abs())  # |want| = m 2^e, m in [0.5, 1): ulp 2^(e - 8)
    slack = DIN_BF16_FWD_ATOL * float(want.abs().max())
    return float((((got.float() - want).abs() - slack).clamp_min(0)
                  / torch.ldexp(torch.ones_like(want), e - 8)).max())


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def check_din_bf16_fwd(hist, tgt, weights) -> dict:
    """The bf16 head forward against its plain version: at most
    DIN_BF16_LOGITS_OFF logits differ, each by at most DIN_BF16_FWD_ULPS ulps
    past DIN_BF16_FWD_ATOL, and none farther past that slack from the float64
    sums than the plain version's; the unrounded float32 head differs in ten
    times as many."""
    want = dh.din_head_fwd_plain(hist, tgt, weights)
    got = dh.din_head_fwd(hist, tgt, weights)
    unrounded = dh.din_head_fwd_plain(hist.float(), tgt.float(),
                                      tuple(w.float() for w in weights)).to(want.dtype)
    exact = din_head_fwd_exact(hist, tgt, weights)
    off, ulps = int((got != want).sum()), bf16_ulps(got, want)
    ulps_exact = {"kernel": bf16_ulps(got, exact), "plain": bf16_ulps(want, exact)}
    unrounded_off = int((unrounded != want).sum())
    if off > DIN_BF16_LOGITS_OFF or not ulps <= DIN_BF16_FWD_ULPS:
        raise AssertionError(f"din_head_fused bf16: {off} logits off, up to {ulps} bf16 ulps")
    if not ulps_exact["kernel"] <= ulps_exact["plain"]:
        raise AssertionError(f"din_head_fused bf16: farther from the float64 sums than the plain "
                             f"version: {ulps_exact}")
    if not unrounded_off > 10 * DIN_BF16_LOGITS_OFF:
        raise AssertionError(f"din_head_fused bf16: the unrounded head passes too "
                             f"({unrounded_off} logits off)")
    return {"max_abs_err": float((got.float() - want.float()).abs().max()), "logits_off": off,
            "ulps": ulps, "unrounded_logits_off": unrounded_off,
            "off_exact": {"kernel": int((got != exact).sum()), "plain": int((want != exact).sum())},
            "ulps_exact": ulps_exact}


def check_din_bf16_bwd(sub, dist, near: int) -> dict:
    """The bf16 head backward against its plain version and the float64 sums on
    the rows ``sub`` (their kink distances ``dist``, ``near`` relu inputs within
    DIN_BF16_KINK of 0 among them): at most ceil(DIN_BF16_OFF_SHARE near) rows
    off in d hist or d target, each at a bf16 kink, and at most
    DIN_BF16_EXACT_EXCESS more rows off the float64 gradients than the plain
    version's; without the rows off, every gradient within DIN_BF16_BWD_RTOL
    of its tensor's largest |value|, where the unrounded float32 head is not;
    d b3 as in float32."""
    allowed = int(np.ceil(DIN_BF16_OFF_SHARE * near))
    got, want, r = din_bf16_bwd_readings(sub, dist)
    off = r.pop("off")
    rows_off, off_dist = r["rows_off"], dist[off]
    if rows_off > allowed or not bool((off_dist <= DIN_BF16_KINK).all()):
        raise AssertionError(f"din_head_fused_bwd bf16: {rows_off} rows off (at most {allowed}), "
                             f"kink distances {off_dist.tolist()[:8]}")
    if r["kernel_off_exact"] > r["plain_off_exact"] + DIN_BF16_EXACT_EXCESS:
        raise AssertionError(f"din_head_fused_bwd bf16: {r['kernel_off_exact']} rows off the float64 "
                             f"gradients, the plain version {r['plain_off_exact']} "
                             f"(+ {DIN_BF16_EXACT_EXCESS})")
    if rows_off:  # the weight gradients sum over every row: again without the off rows
        keep = ~off
        sub = tuple(x[keep].contiguous() if i != 2 else x for i, x in enumerate(sub))
        got, want = dh.din_head_bwd(*sub), dh.din_head_bwd_plain(*sub)
    unrounded = dh.din_head_bwd_plain(sub[0].float(), sub[1].float(),
                                      tuple(w.float() for w in sub[2]), sub[3].float())
    errs, rels, gaps = [], {}, {}
    for n, gt, wt, ut in zip(("hist", "target") + dh.WEIGHT_NAMES, got, want, unrounded):
        errs.append(float((gt - wt).abs().max()))
        if n == "b3":  # the sum of ds: 0 up to rounding in all three
            if not errs[-1] <= DIN_DB3_ATOL * float(sub[3].float().abs().sum()):
                raise AssertionError(f"din_head_fused_bwd bf16 db3: off by {errs[-1]}")
        else:
            rels[n], gaps[n] = rel_err(gt, wt), rel_err(ut, wt)
    worst = max(rels, key=rels.get)
    if rels[worst] > DIN_BF16_BWD_RTOL:
        raise AssertionError(f"din_head_fused_bwd bf16 d{worst}: {rels[worst]} of its largest")
    gap = min(gaps[n] for n in DIN_BF16_ROUNDED)
    if not gap > DIN_BF16_BWD_RTOL:
        raise AssertionError(f"din_head_fused_bwd bf16: the unrounded head passes too: {gaps}")
    return {"max_abs_err": max(errs), "rows_off_allowed": allowed, "inputs_near_a_bf16_kink": near,
            **{k: v for k, v in r.items() if k not in ("rows", "off_kink")},
            "off_rows_kink": off_dist.tolist(), "rtol": rels[worst], "rtol_of": f"d{worst}",
            "unrounded_min_rtol": gap}


def din_inputs_as(dtype, B: int, L: int, D: int, A: tuple, F: tuple, gen: torch.Generator):
    """din_inputs in ``dtype``, with the head's 14 weights: (hist, tgt, att, fc,
    g, weights)."""
    hist, tgt, att, fc, g = din_inputs(B, L, D, A, F, gen)
    if dtype != torch.float32:
        hist, tgt, g = hist.to(dtype), tgt.to(dtype), g.to(dtype)
        att, fc = ([{k: v.to(dtype) for k, v in layer.items()} for layer in net] for net in (att, fc))
    return hist, tgt, att, fc, g, dh.din_head_weights(att, fc, D)


def check_din(part: str, B: int, L: int, D: int, A: tuple, F: tuple, gen: torch.Generator,
              label: str, dtype: torch.dtype = torch.float32, seeds: tuple = ()) -> dict:
    """A DIN kernel ("fwd", "bwd": the fused head; "pool": the attention pool)
    against its plain version on B rows at the model's scale, its inputs in
    ``dtype`` (the head takes float32 or bfloat16, the pool float32). With
    ``seeds`` (the bf16 forward), the check runs on the inputs of a generator of
    each seed in turn, and the row is timed on the last; ``gen`` still draws
    the row's inputs once, so the rows after it draw what they drew before."""
    hist, tgt, att, fc, g, weights = din_inputs_as(dtype, B, L, D, A, F, gen)
    checked = {}
    if seeds:
        by_seed = []
        for seed in seeds:
            del hist, tgt, att, fc, g, weights
            hist, tgt, att, fc, g, weights = din_inputs_as(
                dtype, B, L, D, A, F, torch.Generator(device=DEVICE).manual_seed(seed))
            by_seed.append({"seed": seed, **check_din_bf16_fwd(hist, tgt, weights)})
        checked = {"max_abs_err": max(r.pop("max_abs_err") for r in by_seed), "seeds": by_seed}
    if part == "fwd":
        args, kernel, plain = (hist, tgt, weights), dh.din_head_fwd, dh.din_head_fwd_plain
        if dtype == torch.bfloat16:
            checked = checked or check_din_bf16_fwd(*args)
        else:
            got = kernel(*args)
            checked["max_abs_err"] = normwise_err("din_head_fused", got, plain(*args), DIN_FWD_RTOL)
            if not torch.equal(kernel(*args), got):
                raise AssertionError("din_head_fused: two launches differ")
            del got
        library, lib_args = din_library_fwd, (hist, tgt, att, fc)
        lib_name = "eager: attention_pool and mlp, torch.matmul"
    elif part == "bwd":
        args, kernel, plain = (hist, tgt, weights, g), dh.din_head_bwd, dh.din_head_bwd_plain
        dist, near = kink_distance(hist, tgt, weights, DIN_BF16_KINK)
        smooth = dist > DIN_KINK
        kinked = int((~smooth).sum())
        if kinked > B // 20 * max(1, L // 10):  # a row's relu inputs grow with L
            raise AssertionError(f"din_head_fused_bwd: {kinked} of {B} rows at a relu kink")
        sub = (hist[smooth].contiguous(), tgt[smooth].contiguous(), weights, g[smooth].contiguous())
        got = kernel(*sub)
        if not all(torch.equal(a, b) for a, b in zip(kernel(*sub), got)):
            raise AssertionError("din_head_fused_bwd: two launches differ")
        split = cuda_dh.SPLIT_BF16 if dtype == torch.bfloat16 else cuda_dh.SPLIT_F32
        if cuda_dh.fits(L, D, A[0], A[1], F[0], F[1]) & split:
            # the forward's pooled rows: the same gradients, bit for bit, one launch fewer
            pooled = cuda_dh.din_head_fused_pooled(*sub[:3])[1]
            if not all(torch.equal(a, b) for a, b in zip(kernel(*sub, pooled=pooled), got)):
                raise AssertionError("din_head_fused_bwd: the forward's pooled rows change it")
            full = cuda_dh.din_head_fused_pooled(hist, tgt, weights)[1]
            checked["kernel_ms_pooled_given"] = time_ms(lambda: kernel(*args, pooled=full))
            del pooled, full
        if dtype == torch.bfloat16:
            del got
            checked.update(check_din_bf16_bwd(sub, dist[smooth], int(near[smooth].sum())))
        else:
            want = plain(*sub)
            errs = []
            for n, gt, wt in zip(("hist", "target") + dh.WEIGHT_NAMES, got, want):
                if n == "b3":  # the sum of ds: 0 up to rounding in both versions
                    e = float((gt - wt).abs().max())
                    if not e <= DIN_DB3_ATOL * float(sub[3].float().abs().sum()):
                        raise AssertionError(f"din_head_fused_bwd db3: off by {e}")
                    errs.append(e)
                else:
                    errs.append(normwise_err(f"din_head_fused_bwd d{n}", gt, wt, DIN_BWD_RTOL))
            checked["max_abs_err"] = max(errs)
            del got, want
        checked = {"max_abs_err": checked.pop("max_abs_err"), "rows_at_a_kink": kinked, **checked}
        del sub, dist, near
        library, lib_args = din_library_bwd, (hist, tgt, att, fc, g)
        lib_name = "eager composition's autograd (forward included)"
    else:
        args, kernel, plain = (hist, tgt, att), dinatt.din_attention_pool, dinatt.din_attention_pool_plain
        got = kernel(*args)
        checked["max_abs_err"] = normwise_err("din_attention_pool", got, plain(*args), DIN_FWD_RTOL)
        if not torch.equal(kernel(*args), got):
            raise AssertionError("din_attention_pool: two launches differ")
        del got
        library, lib_args = din_library_pool, (hist, tgt, att)
        lib_name = "eager concat-decomposed composition: torch.matmul, softmax, torch.bmm"
    torch.cuda.synchronize()
    mm, ops, nbytes = din_work(B, L, D, A, F, part, hist.element_size())
    if dtype == torch.bfloat16:
        t_bound, bound_by = bound_of(ops, nbytes, bf16_flops=mm)
    elif part == "bwd":  # the products din_bwd_tensor_products counts in 3xTF32, the rest on CUDA cores
        moved = din_bwd_tensor_products(B, L, D, A, F)
        t_bound, bound_by = bound_of(mm - moved + ops, nbytes, 3 * moved)
        if moved:
            checked["cuda_core_bound_ms"] = bound_of(mm + ops, nbytes)[0]
    else:  # the pool and the float32 head's forward multiply in 3xTF32 on the tensor cores
        t_bound, bound_by = bound_of(ops, nbytes, 3 * mm)
        checked["cuda_core_bound_ms"] = bound_of(mm + ops, nbytes)[0]
    row = {
        "shape": {"rows": B, "history": L, "dim": D, "attention": list(A), "fc": list(F),
                  "batch": label, "dtype": str(dtype).split(".")[1]},
        **checked,
        "kernel_ms": time_ms(lambda: kernel(*args)),
        "plain_ms": time_ms(lambda: plain(*args)),
        "library_ms": time_ms(lambda: library(*lib_args)),
        "library": lib_name,
        "bound_ms": t_bound, "bound_by": bound_by,
    }
    del hist, tgt, g, args, lib_args
    torch.cuda.empty_cache()
    return row


def check_din_full_history(ds: MovieLens100K, gen: torch.Generator) -> dict:
    """DIN's full-history catalog scorer at the din-refresh cell's shapes: the
    fixture's complete histories of every user (one position a rating) against
    every item, the preset's nets, the item table Xavier-normal as DIN draws
    it. The kernels against the plain version (the bucketed scorer on the
    card) within DIN_FWD_RTOL, and the same bits twice. Its bound: the products
    the scorer needs (``dfh.products_needed``: the first attention layer once
    per item, the second a position, the fc head a pair), in 3xTF32 (three
    TF32 products each); bytes: the item table, the histories and the
    logits."""
    cfg = PRESETS["din"]
    D = cfg.model_kwargs["embed_size"]
    histories = [row[row >= 0] for row in ds.itemid_matrix(ds.data)]
    U, I = len(histories), ds.num_items
    _, _, att, fc = din_inputs(1, 1, D, DIN_ATTENTION, DIN_FC, gen)[:4]
    item = torch.randn((I, D), generator=gen, device=DEVICE) * (2.0 / (I + D)) ** 0.5
    args = (item, att, fc, histories)
    got = dfh.din_full_history_scores(*args)
    err = normwise_err("din_full_history", got, dfh.din_full_history_scores_plain(*args),
                       DIN_FWD_RTOL)
    if not torch.equal(dfh.din_full_history_scores(*args), got):
        raise AssertionError("din_full_history: two calls differ")
    del got
    lengths = dfh.history_lengths(histories)
    positions = int(lengths.sum())
    products = dfh.products_needed(lengths, I, D, DIN_ATTENTION, DIN_FC)
    t_bound, bound_by = bound_of(0.0, 4 * (I * D + positions + U * I), 3 * products)
    row = {"shape": {"users": U, "items": I, "positions": positions,
                     "longest": max(len(h) for h in histories), "dim": D,
                     "attention": list(DIN_ATTENTION), "fc": list(DIN_FC),
                     "batch": "din-refresh: every user's complete history, every item"},
           "max_abs_err": err,
           "kernel_ms": time_ms(lambda: dfh.din_full_history_scores(*args)),
           "plain_ms": time_ms(lambda: dfh.din_full_history_scores_plain(*args)),
           "library_ms": None, "library": "none: no PyTorch call computes it",
           "bound_ms": t_bound, "bound_by": bound_by,
           "launches_a_call": 2 * -(-U // cuda_dfh.users_per_launch(U, I, D))}
    del item, att, fc
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------- data

def make_dataset(path: str, seed: int = 0) -> MovieLens100K:
    return MovieLens100K(write_ml100k_format(path, seed=seed), seed=seed)


# ---------------------------------------------------------------- phase 4

HISTORY_KEYS = {f"{s}_{m}" for s in ("train", "valid", "test")
                for m in ("loss", "accuracy", "precision", "recall", "f1", "auc")}
HISTORY_KEYS.add("_param_checksum")


def check_counts(phase: str, counts: dict, want: dict) -> None:
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{phase}: {name} launched {counts[name]} times, expected {n}")


def compare_histories(phase: str, card: dict, cpu: dict, card_extras: dict,
                      cpu_extras: dict) -> dict:
    """The card's losses within TRAIN_LOSS_RTOL of the CPU's and its AUCs within
    TRAIN_AUC_ATOL; returns the largest relative loss difference per split."""
    worst = {}
    for key in ("train_loss", "valid_loss", "test_loss"):
        c = np.asarray(cpu[key])
        np.testing.assert_allclose(card[key], c, rtol=TRAIN_LOSS_RTOL, err_msg=f"{phase} {key}")
        worst[key] = float(np.max(np.abs(card[key] / c - 1)))
    for key, v in card_extras.items():
        if abs(v - cpu_extras[key]) > TRAIN_AUC_ATOL:
            raise AssertionError(f"{phase}: {key} {v} on the card, {cpu_extras[key]} on the CPU")
    return worst


def run_train(ds: MovieLens100K) -> dict:
    cfg = PRESETS["mf"].replace(epochs=TRAIN_EPOCHS)
    batch = split_batches(cfg, ds, DEVICE)["train"]
    init = build_model(cfg, ds).to(DEVICE)
    params0 = {k: v.detach().clone() for k, v in init.named_parameters()}

    reset_launches()  # the main path's run starts here
    t0 = time.perf_counter()
    res = run_experiment(cfg, data=ds, device=DEVICE)
    wall_s = time.perf_counter() - t0
    fit_params, fit_losses = init.fast_fit(params0, batch[0], batch[1], TRAIN_EPOCHS,
                                           cfg.learning_rate, cfg.weight_decay, "float32")
    torch.cuda.synchronize()
    counts = launches()  # ... and ends here

    E = TRAIN_EPOCHS
    check_counts("train", counts, {"gather_rows": E * 6 + 6,  # 3 splits an epoch; final AUCs
                                   "onehot_grad": E * 2,
                                   "mf_fullbatch_train": 1})  # fast_fit: one launch a call
    if set(res.history) != HISTORY_KEYS:
        raise AssertionError(f"train: history keys {sorted(res.history)}")
    loss = res.history["train_loss"]
    if not (np.isfinite(loss).all() and loss[-1] < loss[0] - 0.05):
        raise AssertionError(f"train: the train loss did not fall: {loss.tolist()}")

    cpu = run_experiment(cfg, data=ds, device="cpu")  # plain versions on the CPU
    worst = compare_histories("train", res.history, cpu.history, res.extras, cpu.extras)
    fused = fit_losses.cpu().numpy()
    np.testing.assert_allclose(fused, res.history["train_loss"], rtol=TRAIN_LOSS_RTOL)
    for k in ("user", "item"):
        if not bool(torch.isfinite(fit_params[k]).all()):
            raise AssertionError("fast_fit: non-finite factors")
    return {"phase": "train", "config": "mf preset, 20 epochs, track_metrics",
            "rows": int(batch[1].shape[0]), "epochs": E,
            "train_loss": [float(loss[0]), float(loss[-1])],
            "valid_loss_last": float(res.history["valid_loss"][-1]),
            "ranking_test@10": res.ranking["test@10"], "extras": res.extras,
            "wall_s": wall_s, "train_time_s": res.train_time_s,
            "examples_per_s": res.examples_per_sec,
            "max_rel_loss_diff_vs_cpu": worst,
            "max_rel_loss_diff_fast_fit": float(np.max(np.abs(fused / res.history["train_loss"] - 1))),
            "launches": counts}


# ---------------------------------------------------------------- phases 5-6

_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # localhost only


def http(port: int, method: str, path: str, body=None) -> dict:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with _OPENER.open(req, timeout=120) as resp:
        if resp.status != 200:
            raise AssertionError(f"{method} {path} answered {resp.status}")
        return json.loads(resp.read())


def recommend(port, rec, masked, users, k, single=False) -> dict:
    """One /v1/recommend request, held against the plain top-k of ``rec``'s
    factors; checks it took one topk_serve_matmul launch."""
    dev = DEVICE
    before = launches()
    if single:
        out = http(port, "GET", f"/v1/recommend?user={users[0]}&k={k}")
        items, scores = [out["items"]], [out["scores"]]
    else:
        out = http(port, "POST", "/v1/recommend", {"users": users, "k": k})
        items, scores = out["items"], out["scores"]
    after = launches()
    if after["topk_serve_matmul"] - before["topk_serve_matmul"] != 1:
        raise AssertionError(f"recommend {len(users)} users: launches {before} -> {after}")
    u = torch.tensor(users, device=dev)
    gi = torch.tensor(items, dtype=torch.int32, device=dev)
    gv = torch.tensor(scores, dtype=torch.float32, device=dev)
    if tuple(gi.shape) != (len(users), k) or not bool(torch.isfinite(gv).all()):
        raise AssertionError("recommend: wrong shape or non-finite scores")
    if bool(torch.gather(rec.seen[u], 1, gi.long()).any()):
        raise AssertionError("recommend: a seen item was recommended")
    P, Q = (t.detach() for t in rec.model.serving_factors(rec.ctx))
    want = topk.topk_serve_matmul_plain(P[u], Q, rec.seen[u], k=k + 1)
    err = check_close("recommend", (gv, gi), want, masked[u])
    return {"request": f"{'GET' if single else 'POST'} /v1/recommend", "users": len(users),
            "k": k, "max_abs_err": err}


def run_serve(ds: MovieLens100K, data_dir: str, seed: int = 0) -> dict:
    args = serve_cli.parser().parse_args(["--model", "mf", "--data", data_dir, "--epochs",
                                          str(TRAIN_EPOCHS), "--port", "0", "--seed", str(seed)])
    reset_launches()  # the main path's run starts here
    server = serve_cli.build_server(args).serve_background()
    try:
        rec = server.recommender
        P, Q = (t.detach() for t in rec.model.serving_factors(rec.ctx))
        masked = torch.where(rec.seen, NEG_INF, P @ Q.T)
        health = http(server.port, "GET", "/healthz")
        if (health["num_users"], health["num_items"]) != (ds.num_users, ds.num_items):
            raise AssertionError(f"/healthz: {health}")
        rng = np.random.default_rng(seed)
        requests = [recommend(server.port, rec, masked, [12], 10, single=True),
                    recommend(server.port, rec, masked,
                              sorted(rng.choice(ds.num_users, 32, replace=False).tolist()), 50),
                    recommend(server.port, rec, masked, list(range(ds.num_users)), 50)]
        counts = launches()  # ... and ends here
        stats = http(server.port, "GET", "/v1/stats")
    finally:
        server.shutdown()
    E = TRAIN_EPOCHS
    check_counts("serve", counts, {"gather_rows": 2 * E, "onehot_grad": 2 * E,
                                   "topk_serve_matmul": 3})
    return {"phase": "serve", "entry_point": "cli/serve.py::build_server --model mf --epochs 20",
            "requests": requests, "launches": counts, "stats": stats}


class CatalogOnly(nn.Module):
    """An MF model seen as a non-factored one: ``score_catalog`` and no
    ``serving_factors``, so ``Recommender.top_k`` takes its score-matrix branch."""

    def __init__(self, model: MatrixFactorization):
        super().__init__()
        self.inner = model

    def score_catalog(self, ctx: ServingContext) -> torch.Tensor:
        return self.inner.score_catalog(ctx)


def run_slice(ds: MovieLens100K, seed: int = 0) -> dict:
    dev = DEVICE
    seen_np = ds.seen_mask(ds.train, ds.valid, ds.test)
    model = MatrixFactorization(ds.num_users, ds.num_items, EMBEDDING_DIM,
                                generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    ctx = ServingContext(torch.from_numpy(ds.user_features), torch.from_numpy(ds.item_features))
    reset_launches()  # the main path's run starts here
    rec = Recommender(model, ctx, seen=seen_np, device=dev)
    fused = Recommender(CatalogOnly(model), ctx, seen=seen_np, use_pallas="fused", device=dev)
    servers = [RecommenderServer(rec).serve_background(),
               RecommenderServer(fused).serve_background()]
    port, fused_port = servers[0].port, servers[1].port
    P, Q = model.user.detach(), model.item.detach()
    masked = torch.where(rec.seen, NEG_INF, P @ Q.T)
    rng = np.random.default_rng(seed)
    try:
        requests = [recommend(port, rec, masked, [12], 10, single=True),
                    recommend(port, rec, masked,
                              sorted(rng.choice(ds.num_users, 32, replace=False).tolist()), 50)]
        items = rng.choice(ds.num_items, 20, replace=False).tolist()
        got = torch.tensor(http(port, "POST", "/v1/score", {"user": 3, "items": items})["scores"],
                           device=dev)
        if not bool(((got - masked[3, items]).abs() <= RTOL * scale(masked[3])).all()):
            raise AssertionError("/v1/score disagrees with the plain scores")
        requests.append({"request": "POST /v1/score", "items": len(items)})

        # the non-factored branch of Recommender.top_k: the topk_scores kernel
        users = list(range(0, ds.num_users, 7))
        before = launches()
        out = http(fused_port, "POST", "/v1/recommend", {"users": users, "k": 50})
        after = launches()
        if after["topk_scores"] - before["topk_scores"] != 1:
            raise AssertionError(f"fused recommend: launches {before} -> {after}")
        want_v, want_i = topk.topk_scores_plain(fused.scores[users],
                                                torch.zeros_like(rec.seen[users]), 50)
        if out["items"] != want_i.tolist() or out["scores"] != want_v.tolist():
            raise AssertionError("fused recommend: topk_scores != its plain version")
        requests.append({"request": "POST /v1/recommend (use_pallas='fused', non-factored)",
                         "users": len(users), "k": 50})
        counts = launches()  # ... and ends here
        stats = http(port, "GET", "/v1/stats")
    finally:
        for s in servers:
            s.shutdown()
    return {"phase": "slice", "model": "seeded random MF", "requests": requests,
            "launches": counts, "stats": stats}


# ---------------------------------------------------------------- phases 7-9

def n_tiles(ds: MovieLens100K) -> int:
    return -(-ds.num_users // CATALOG_TILE)


def run_lr(ds: MovieLens100K) -> dict:
    cfg = PRESETS["lr"].replace(epochs=TRAIN_EPOCHS)
    E = TRAIN_EPOCHS
    x, y = split_batches(cfg, ds, DEVICE)["train"]
    init = build_model(cfg, ds).to(DEVICE)
    params0 = {k: v.detach().clone() for k, v in init.named_parameters()}

    reset_launches()  # the main path's run starts here
    t0 = time.perf_counter()
    res = run_experiment(cfg, data=ds, device=DEVICE)
    wall_s = time.perf_counter() - t0
    fits = {mode: init.fast_fit(params0, x, y, E, cfg.learning_rate, mode=mode)
            for mode in ("compact", "wide")}
    torch.cuda.synchronize()
    counts = launches()  # ... and ends here

    # 2 bias lookups a forward: train, valid, test an epoch, the final AUCs, the catalog tiles
    check_counts("lr", counts, {"gather_rows": 2 * (3 * E + 3 + n_tiles(ds)), "onehot_grad": 2 * E,
                                "lr_fullbatch_train": 2 * E,  # two launches an epoch
                                "lr_fullbatch_train_compact": 1})  # one launch a call
    if set(res.history) != HISTORY_KEYS:
        raise AssertionError(f"lr: history keys {sorted(res.history)}")
    loss = res.history["train_loss"]
    if not (np.isfinite(loss).all() and loss[-1] < loss[0] - 0.05):
        raise AssertionError(f"lr: the train loss did not fall: {loss.tolist()}")
    cpu = run_experiment(cfg, data=ds, device="cpu")  # plain versions on the CPU
    worst = compare_histories("lr", res.history, cpu.history, res.extras, cpu.extras)
    fused = {}
    for mode, (params, losses) in fits.items():
        got = losses.cpu().numpy()
        np.testing.assert_allclose(got, loss, rtol=TRAIN_LOSS_RTOL, err_msg=f"fast_fit {mode}")
        if not all(bool(torch.isfinite(t).all()) for t in params.values()):
            raise AssertionError(f"fast_fit {mode}: non-finite weights")
        fused[mode] = float(np.max(np.abs(got / loss - 1)))
    return {"phase": "lr", "config": "lr preset, 20 epochs, track_metrics",
            "rows": int(y.shape[0]), "epochs": E,
            "train_loss": [float(loss[0]), float(loss[-1])],
            "ranking_test@10": res.ranking["test@10"], "extras": res.extras,
            "wall_s": wall_s, "train_time_s": res.train_time_s,
            "max_rel_loss_diff_vs_cpu": worst, "max_rel_loss_diff_fast_fit": fused,
            "launches": counts}


def check_feature_run(name: str, cfg, ds: MovieLens100K, res, tile_rtol: float) -> dict:
    """The checks of a feature preset's ``run_experiment`` on the card: the
    history keys are the full set; the train loss falls; the history matches a
    CPU ``Trainer.fit`` over the same batches from the same initial weights
    (plain versions, without the full-catalog ranking); and the catalog scores
    of one tile of CATALOG_TILE users under the card's trained weights match
    the CPU's."""
    if set(res.history) != HISTORY_KEYS:
        raise AssertionError(f"{name}: history keys {sorted(res.history)}")
    loss = res.history["train_loss"]
    if not (np.isfinite(loss).all() and loss[-1] < loss[0]):
        raise AssertionError(f"{name}: the train loss did not fall: {loss.tolist()}")
    batches = split_batches(cfg, ds, "cpu")
    cpu = Trainer(build_model(cfg, ds),
                  TrainConfig(learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
                              epochs=cfg.epochs, track_metrics=True,
                              compute_dtype=cfg.compute_dtype),
                  device="cpu").fit(batches["train"], valid=batches["valid"], test=batches["test"])
    worst = compare_histories(name, res.history, {k: v.numpy() for k, v in cpu.history.items()},
                              res.extras, cpu.extras)
    model = build_model(cfg, ds)
    model.load_state_dict({k: v.cpu() for k, v in res.params.items()})
    tile = ServingContext(torch.from_numpy(ds.user_features[:CATALOG_TILE]),
                          torch.from_numpy(ds.item_features))
    with torch.no_grad():
        want = model.score_catalog(tile)
        got = model.to(DEVICE).score_catalog(tile.to(DEVICE)).cpu()
    catalog_err = normwise_err(f"{name} catalog tile", got, want, tile_rtol)
    return {"rows": res.train_examples, "epochs": cfg.epochs,
            "train_loss": [float(loss[0]), float(loss[-1])],
            "ranking_test@10": res.ranking["test@10"], "extras": res.extras,
            "train_time_s": res.train_time_s, "max_rel_loss_diff_vs_cpu": worst,
            "catalog_tile_max_abs_err_vs_cpu": catalog_err,
            "catalog_tile_max_abs_logit": float(want.abs().max())}


def feature_counts(name: str, ds: MovieLens100K, epochs: int) -> dict:
    """The lookup pair's launches of a feature preset's ``run_experiment``:
    LOOKUPS[name] a forward, the forwards being train, valid and test an epoch,
    the final AUCs and the catalog tiles, and as many ``onehot_grad`` a
    training step."""
    forwards = 3 * epochs + 3 + n_tiles(ds)
    return {"gather_rows": LOOKUPS[name] * forwards, "onehot_grad": LOOKUPS[name] * epochs}


def run_afm(ds: MovieLens100K) -> dict:
    cfg = PRESETS["afm"].replace(epochs=AFM_EPOCHS)
    E = AFM_EPOCHS
    reset_launches()  # the main path's run starts here
    t0 = time.perf_counter()
    res = run_experiment(cfg, data=ds, device=DEVICE)
    wall_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = launches()  # ... and ends here

    forwards = 3 * E + 3 + n_tiles(ds)  # train, valid, test an epoch; final AUCs; catalog tiles
    check_counts("afm", counts, {"afm_attention_pool": forwards, "afm_attention_pool_bwd": 2 * E,
                                 **feature_counts("afm", ds, E)})
    out = check_feature_run("afm", cfg, ds, res, AFM_FWD_RTOL)
    return {"phase": "afm", "config": f"afm preset (embedding 128, attention 64), {E} epochs",
            **out, "wall_s": wall_s, "launches": counts}


def run_deepfm(ds: MovieLens100K) -> dict:
    """DeepFM, the headline model: ``run_experiment(PRESETS["deepfm"])`` at the
    preset's full width (embedding 128, tower (512, 256, 128, 1)) for
    DEEPFM_EPOCHS epochs, every lookup through the gather kernel pair."""
    cfg = PRESETS["deepfm"].replace(epochs=DEEPFM_EPOCHS)
    E = DEEPFM_EPOCHS
    reset_launches()  # the main path's run starts here
    t0 = time.perf_counter()
    res = run_experiment(cfg, data=ds, device=DEVICE)
    wall_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = launches()  # ... and ends here
    check_counts("deepfm", counts, feature_counts("deepfm", ds, E))
    out = check_feature_run("deepfm", cfg, ds, res, FEATURE_TILE_RTOL)
    return {"phase": "deepfm",
            "config": f"deepfm preset (embedding 128, hidden (512, 256, 128, 1)), {E} epochs",
            **out, "wall_s": wall_s, "examples_per_s": res.examples_per_sec, "launches": counts}


def run_feature_zoo(ds: MovieLens100K) -> dict:
    """WideDeep, NFM, PNN, DCN (the ``deepcross`` preset), DeepCrossing and
    FFM, each through ``run_experiment`` at its preset's full width for
    ZOO_EPOCHS epochs, held as ``check_feature_run`` holds DeepFM, with each
    model's exact lookup counts."""
    reset_launches()  # the main path's run starts here
    runs = {}
    for name in ZOO:
        cfg = PRESETS[name].replace(epochs=ZOO_EPOCHS)
        before = launches()
        t0 = time.perf_counter()
        res = run_experiment(cfg, data=ds, device=DEVICE)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        after = launches()
        check_counts(name, {k: after[k] - before[k] for k in after},
                     feature_counts(name, ds, ZOO_EPOCHS))
        runs[name] = {"model_kwargs": {k: list(v) if isinstance(v, tuple) else v
                                       for k, v in cfg.model_kwargs.items()},
                      "wall_s": wall_s, "examples_per_s": res.examples_per_sec, "result": res}
    counts = launches()  # ... and ends here
    for name, run in runs.items():  # the CPU references, after the counted runs
        cfg = PRESETS[name].replace(epochs=ZOO_EPOCHS)
        run.update(check_feature_run(name, cfg, ds, run.pop("result"), FEATURE_TILE_RTOL))
    return {"phase": "feature_zoo", "epochs": ZOO_EPOCHS, "runs": runs, "launches": counts}


def recommend_scores(port, rec, users, k, single=False) -> dict:
    """One /v1/recommend request to a non-factored model, held against the
    stable top-k of the server's masked catalog scores (``rec.scores``, which
    ``run_serve_model`` holds against the model's own scores)."""
    if single:
        out = http(port, "GET", f"/v1/recommend?user={users[0]}&k={k}")
        items, scores = [out["items"]], [out["scores"]]
    else:
        out = http(port, "POST", "/v1/recommend", {"users": users, "k": k})
        items, scores = out["items"], out["scores"]
    u = torch.tensor(users, device=DEVICE)
    want_v, want_i = topk.stable_top_k(rec.scores[u], k)
    if items != want_i.tolist() or scores != want_v.tolist():
        raise AssertionError("recommend: not the plain top-k of the masked scores")
    if bool(torch.gather(rec.seen[u], 1, torch.tensor(items, device=DEVICE)).any()):
        raise AssertionError("recommend: a seen item was recommended")
    return {"request": f"{'GET' if single else 'POST'} /v1/recommend", "users": len(users), "k": k}


def run_serve_model(ds: MovieLens100K, data_dir: str, name: str, epochs: int,
                    seed: int = 0) -> dict:
    """``cli/serve.py::build_server --model name`` trains the model and serves
    it over HTTP, each answer held against the plain top-k. LR serves through
    its rank-2 factors (``topk_serve_matmul``); a non-factored model (AFM,
    DeepFM, NeuralCF, AutoRec) serves its masked catalog scores (the plain
    stable top-k), and then a second ``Recommender`` over the same model,
    context and seen mask with ``use_pallas="fused"`` takes the
    ``topk_scores`` kernel, whose lists must be the plain stable top-k's
    exactly. The lookups: LOOKUPS[name] a forward, one forward an epoch
    (no metrics), and three catalogs of CATALOG_TILE-user tiles (the ranking
    eval's, the server's and the fused recommender's)."""
    args = serve_cli.parser().parse_args(["--model", name, "--data", data_dir, "--epochs",
                                          str(epochs), "--port", "0", "--seed", str(seed)])
    reset_launches()  # the main path's run starts here
    t0 = time.perf_counter()
    server = serve_cli.build_server(args).serve_background()
    try:
        rec = server.recommender
        health = http(server.port, "GET", "/healthz")
        if (health["num_users"], health["num_items"]) != (ds.num_users, ds.num_items):
            raise AssertionError(f"/healthz: {health}")
        rng = np.random.default_rng(seed)
        batch = sorted(rng.choice(ds.num_users, 32, replace=False).tolist())
        fused = None
        if name == "lr":
            P, Q = (t.detach() for t in rec.model.serving_factors(rec.ctx))
            if P.shape[1] != 2:
                raise AssertionError(f"lr serving factors of width {P.shape[1]}")
            masked = torch.where(rec.seen, NEG_INF, P @ Q.T)
            requests = [recommend(server.port, rec, masked, [12], 10, single=True),
                        recommend(server.port, rec, masked, batch, 50),
                        recommend(server.port, rec, masked, list(range(ds.num_users)), 50)]
        else:
            requests = [recommend_scores(server.port, rec, [12], 10, single=True),
                        recommend_scores(server.port, rec, batch, 50)]
            fused = Recommender(rec.model, rec.ctx, seen=rec.seen, use_pallas="fused",
                                device=DEVICE)
            for users, k in (([12], 10), (batch, 50)):
                before = launches()["topk_scores"]
                got = fused.top_k(k, users)
                if launches()["topk_scores"] != before + 1:
                    raise AssertionError(f"serve_{name}: the fused recommender did not launch "
                                         "topk_scores")
                _, want = topk.stable_top_k(rec.scores[torch.tensor(users, device=DEVICE)], k)
                if not np.array_equal(got, want.cpu().numpy()):
                    raise AssertionError(f"serve_{name}: topk_scores' lists for {len(users)} "
                                         "users are not the plain stable top-k")
            requests.append({"request": "Recommender(use_pallas='fused').top_k",
                             "users": [1, 32], "k": [10, 50]})
        counts = launches()  # ... and ends here
        wall_s = time.perf_counter() - t0
        stats = http(server.port, "GET", "/v1/stats")
        with torch.no_grad():  # the served scores are the trained model's, masked
            if not torch.equal(rec.scores, torch.where(rec.seen, NEG_INF,
                                                       rec.model.score_catalog(rec.ctx))):
                raise AssertionError(f"serve_{name}: the served scores are not the model's")
        if fused is not None and not torch.equal(fused.scores, rec.scores):
            raise AssertionError(f"serve_{name}: the fused recommender scored another catalog")
    finally:
        server.shutdown()
    tiles = n_tiles(ds)
    if name == "lr":  # training forwards, the ranking eval's and the server's catalog scoring
        want = {"gather_rows": 2 * (epochs + 2 * tiles), "onehot_grad": 2 * epochs,
                "topk_serve_matmul": 3}
    else:  # ... and the fused recommender's catalog scoring (NeuralCF's pair
        # scorer takes tiles of CATALOG_TILE users too; AutoRec looks nothing up)
        n = LOOKUPS[name]
        want = {"gather_rows": n * (epochs + 3 * tiles), "onehot_grad": n * epochs,
                "topk_scores": 2}
        if name == "afm":
            want.update(afm_attention_pool=epochs + 3 * tiles,
                        afm_attention_pool_bwd=2 * epochs)
    check_counts(f"serve_{name}", counts, want)
    return {"phase": f"serve_{name}",
            "entry_point": f"cli/serve.py::build_server --model {name} --epochs {epochs}",
            "wall_s": wall_s, "requests": requests, "launches": counts, "stats": stats}


# ---------------------------------------------------------------- phases 10-11

def history_tiles(ds: MovieLens100K) -> int:
    return -(-ds.num_users // HISTORY_TILE)


def run_din(ds: MovieLens100K) -> dict:
    cfg = PRESETS["din"].replace(epochs=DIN_EPOCHS, full_history_serving=False)
    E = DIN_EPOCHS
    reset_launches()  # the main path's run starts here
    t0 = time.perf_counter()
    res = run_experiment(cfg, data=ds, device=DEVICE)
    wall_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = launches()  # ... and ends here

    forwards = 3 * E + 3  # train, valid, test an epoch; the final AUCs
    tiles = history_tiles(ds)  # one attention-pool launch a window tile
    check_counts("din", counts, {**din_head_counts({"float32": forwards}, {"float32": E}),
                                 "din_attention_pool": tiles, "gather_rows": 2 * (forwards + tiles),
                                 "onehot_grad": 2 * E})
    if set(res.history) != HISTORY_KEYS:
        raise AssertionError(f"din: history keys {sorted(res.history)}")
    loss = res.history["train_loss"]
    if not (np.isfinite(loss).all() and loss[-1] < loss[0]):
        raise AssertionError(f"din: the train loss did not fall: {loss.tolist()}")

    # the CPU reference: Trainer.fit over the same batches from the same initial
    # weights (plain versions), without the full-catalog ranking
    batches = split_batches(cfg, ds, "cpu")
    cpu = Trainer(build_model(cfg, ds),
                  TrainConfig(learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
                              epochs=E, track_metrics=True, compute_dtype=cfg.compute_dtype),
                  device="cpu").fit(batches["train"], valid=batches["valid"], test=batches["test"])
    worst = compare_histories("din", res.history, {k: v.numpy() for k, v in cpu.history.items()},
                              res.extras, cpu.extras)
    # the window catalog scores of one tile of users under the card's trained weights
    model = build_model(cfg, ds)
    model.load_state_dict({k: v.cpu() for k, v in res.params.items()})
    tile = ServingContext(torch.from_numpy(ds.user_features[:HISTORY_TILE]),
                          torch.from_numpy(ds.item_features),
                          history=res.ctx.history[:HISTORY_TILE].cpu())
    with torch.no_grad():
        want = model.score_catalog(tile)
        got = model.to(DEVICE).score_catalog(tile.to(DEVICE)).cpu()
    catalog_err = normwise_err("din window tile", got, want, DIN_FWD_RTOL)
    return {"phase": "din", "config": f"din preset (embedding 64, attention (128, 64, 1), fc "
                                      f"(256, 128, 1), history 10), window serving, {E} epochs",
            "rows": res.train_examples, "epochs": E,
            "train_loss": [float(loss[0]), float(loss[-1])],
            "ranking_test@10": res.ranking["test@10"], "extras": res.extras,
            "wall_s": wall_s, "train_time_s": res.train_time_s,
            "max_rel_loss_diff_vs_cpu": worst,
            "catalog_tile_max_abs_err_vs_cpu": catalog_err, "launches": counts}


DIN_DEPTH_EPOCHS = 2
DIN_DEPTH_ATTENTION = (64, 1)  # one hidden layer: kernel_route refuses it


def run_din_depth(ds: MovieLens100K) -> dict:
    """DIN with an attention net of one hidden layer, which the DIN kernels do
    not take: ``run_experiment`` trains and serves it (window scoring) through
    the composition ``attention_pool`` + ``mlp`` on the card, with no DIN kernel
    launch, and its history matches the same run's on the CPU."""
    base = PRESETS["din"]
    cfg = base.replace(epochs=DIN_DEPTH_EPOCHS, full_history_serving=False,
                       model_kwargs={**base.model_kwargs, "attention_units": DIN_DEPTH_ATTENTION})
    E = DIN_DEPTH_EPOCHS
    reset_launches()  # the path's run starts here
    t0 = time.perf_counter()
    res = run_experiment(cfg, data=ds, device=DEVICE)
    wall_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = launches()  # ... and ends here
    check_counts("din_depth", counts, {**din_head_counts({}, {}), "din_attention_pool": 0})
    if counts["gather_rows"] < 1 or counts["onehot_grad"] < 1:
        raise AssertionError(f"din_depth: the lookups did not go through their kernels: {counts}")
    loss = res.history["train_loss"]
    if set(res.history) != HISTORY_KEYS or not np.isfinite(loss).all():
        raise AssertionError(f"din_depth: history {sorted(res.history)}, train loss {loss.tolist()}")
    batches = split_batches(cfg, ds, "cpu")
    cpu = Trainer(build_model(cfg, ds),
                  TrainConfig(learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
                              epochs=E, track_metrics=True, compute_dtype=cfg.compute_dtype),
                  device="cpu").fit(batches["train"], valid=batches["valid"], test=batches["test"])
    worst = compare_histories("din_depth", res.history,
                              {k: v.numpy() for k, v in cpu.history.items()}, res.extras, cpu.extras)
    return {"phase": "din_depth",
            "config": f"din preset with attention {DIN_DEPTH_ATTENTION} (the composition route), "
                      f"window serving, {E} epochs",
            "rows": res.train_examples, "epochs": E, "train_loss": [float(loss[0]), float(loss[-1])],
            "wall_s": wall_s, "max_rel_loss_diff_vs_cpu": worst, "launches": counts}


def run_din_bf16(ds: MovieLens100K) -> dict:
    """DIN as ``bench.py`` trains it: ``compute_dtype="bfloat16"`` and
    ``indirect_hist=True`` (``run_experiment`` builds the standard (history,
    item) batches, which the flag leaves on the standard route), window
    serving, DIN_BF16_EPOCHS epochs. The train forward and backward run the
    DIN head kernels in bf16; evaluation runs them in float32 on the master
    weights. Held against a CPU ``Trainer.fit`` in bf16 over the same batches."""
    cfg = PRESETS["din"].replace(
        epochs=DIN_BF16_EPOCHS, full_history_serving=False, compute_dtype="bfloat16",
        model_kwargs=dict(PRESETS["din"].model_kwargs, indirect_hist=True))
    E = DIN_BF16_EPOCHS
    reset_launches()  # the main path's run starts here
    t0 = time.perf_counter()
    res = run_experiment(cfg, data=ds, device=DEVICE)
    wall_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = launches()  # ... and ends here

    forwards = 3 * E + 3  # train (bf16), valid and test (f32) an epoch; the final AUCs
    tiles = history_tiles(ds)
    check_counts("din_bf16", counts, {**din_head_counts({"bfloat16": E, "float32": forwards - E},
                                                        {"bfloat16": E}),
                                      "din_attention_pool": tiles,
                                      "gather_rows": 2 * (forwards + tiles), "onehot_grad": 2 * E})
    loss = res.history["train_loss"]
    if not (np.isfinite(loss).all() and loss[-1] < loss[0]):
        raise AssertionError(f"din_bf16: the train loss did not fall: {loss.tolist()}")
    batches = split_batches(cfg, ds, "cpu")
    cpu = Trainer(build_model(cfg, ds),
                  TrainConfig(learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
                              epochs=E, track_metrics=True, compute_dtype=cfg.compute_dtype),
                  device="cpu").fit(batches["train"], valid=batches["valid"], test=batches["test"])
    worst = compare_histories("din_bf16", res.history,
                              {k: v.numpy() for k, v in cpu.history.items()}, res.extras,
                              cpu.extras)
    return {"phase": "din_bf16",
            "config": f"din preset, compute_dtype bfloat16, indirect_hist, window serving, {E} epochs",
            "rows": res.train_examples, "epochs": E,
            "train_loss": [float(loss[0]), float(loss[-1])],
            "ranking_test@10": res.ranking["test@10"], "extras": res.extras,
            "wall_s": wall_s, "train_time_s": res.train_time_s,
            "max_rel_loss_diff_vs_cpu": worst, "launches": counts}


def run_serve_din(ds: MovieLens100K, data_dir: str, epochs: int, seed: int = 0) -> dict:
    args = serve_cli.parser().parse_args(["--model", "din", "--data", data_dir, "--epochs",
                                          str(epochs), "--port", "0", "--seed", str(seed)])
    reset_launches()  # the main path's run starts here
    t0 = time.perf_counter()
    server = serve_cli.build_server(args).serve_background()
    try:
        rec = server.recommender
        health = http(server.port, "GET", "/healthz")
        if (health["num_users"], health["num_items"]) != (ds.num_users, ds.num_items):
            raise AssertionError(f"/healthz: {health}")
        rng = np.random.default_rng(seed)
        batch = sorted(rng.choice(ds.num_users, 32, replace=False).tolist())
        requests = [recommend_scores(server.port, rec, [12], 10, single=True),
                    recommend_scores(server.port, rec, batch, 50)]
        counts = launches()  # ... and ends here
        wall_s = time.perf_counter() - t0
        stats = http(server.port, "GET", "/v1/stats")
        with torch.no_grad():  # the served scores are the trained model's, masked
            scores = rec.model.score_catalog(rec.ctx)
        if not torch.equal(rec.scores <= NEG_INF / 2, rec.seen):
            raise AssertionError("serve_din: the served mask is not the seen items")
        live = ~rec.seen
        served_err = float((rec.scores[live] - scores[live]).abs().max())
        if not served_err <= 1e-6 * float(scores.abs().max()):
            raise AssertionError(f"serve_din: the served scores are off by {served_err}")
    finally:
        server.shutdown()
    if rec.ctx.full_histories is None:
        raise AssertionError("serve_din: the preset did not serve full histories")
    U, D = len(rec.ctx.full_histories), PRESETS["din"].model_kwargs["embed_size"]
    chunks = -(-U // cuda_dfh.users_per_launch(U, ds.num_items, D))  # two launches each
    check_counts("serve_din", counts, {**din_head_counts({"float32": epochs}, {"float32": epochs}),
                                       "din_attention_pool": 0, "onehot_grad": 2 * epochs,
                                       "din_full_history": 2 * 2 * chunks})
    if counts["gather_rows"] < 1:
        raise AssertionError("serve_din: no item lookup went through the gather kernel")

    # full-history scores of a few users, the longest history among them, on the CPU
    full = rec.ctx.full_histories
    longest = int(np.argmax([len(h) for h in full]))
    users = [longest, 0, 1, 2, 3]
    model = build_model(PRESETS["din"], ds)
    model.load_state_dict({k: v.detach().cpu() for k, v in rec.model.state_dict().items()})
    ctx = ServingContext(torch.from_numpy(ds.user_features[users]),
                         torch.from_numpy(ds.item_features),
                         full_histories=[full[u] for u in users])
    with torch.no_grad():
        want = model.score_catalog(ctx)
    full_err = normwise_err("din full-history scores", scores[users].cpu(), want, DIN_FWD_RTOL)
    return {"phase": "serve_din",
            "entry_point": f"cli/serve.py::build_server --model din --epochs {epochs}",
            "serving": "full histories (the full-history kernel)",
            "longest_history": len(full[longest]), "wall_s": wall_s,
            "full_history_max_abs_err_vs_cpu": full_err,
            "requests": requests, "launches": counts, "stats": stats}


# ---------------------------------------------------------------- phases 17-22

def full_history_buckets(histories) -> list:
    """[(bucket length, its users)] as ``catalog_scores_full_history`` groups
    ``histories``, each with the user tile its activation budget allows."""
    lengths = np.array([max(len(h), 1) for h in histories])
    maxlen = int(lengths.max())
    bucket_list = [b for b in FULL_HISTORY_BUCKETS if b < maxlen]
    bucket_list.append(next((b for b in FULL_HISTORY_BUCKETS if b >= maxlen), maxlen))
    out, lo = [], 0
    for Lb in bucket_list:
        users = np.where((lengths > lo) & (lengths <= Lb))[0]
        lo = Lb
        tile = max(1, min(64, FULL_HISTORY_BUDGET // (FULL_HISTORY_CHUNK * Lb * 64)))
        out.append((Lb, users, tile))
    return out


def full_history_work(histories, num_items: int) -> tuple:
    """(user tiles, item chunks, GRU steps) of ``catalog_scores_full_history``
    over ``histories``: one history lookup a user tile (embedded once), one
    target lookup and a bucket's length of GRU steps an item chunk."""
    chunks_per_tile = -(-num_items // FULL_HISTORY_CHUNK)
    tiles = steps = 0
    for Lb, users, tile in full_history_buckets(histories):
        n = -(-users.size // tile)
        tiles += n
        steps += n * chunks_per_tile * Lb
    return tiles, tiles * chunks_per_tile, steps


def bucket_users(histories) -> list:
    """The first user of each length bucket that holds any, and the longest
    history's."""
    first = [int(users[0]) for _, users, _ in full_history_buckets(histories) if users.size]
    longest = int(np.argmax([len(h) for h in histories]))
    return sorted(set(first + [longest]))


def cpu_fit(cfg, ds: MovieLens100K):
    """The CPU reference of a run: ``Trainer.fit`` over the same batches from
    the same initial weights (plain versions), without the ranking eval."""
    batches = split_batches(cfg, ds, "cpu")
    return Trainer(build_model(cfg, ds),
                   TrainConfig(learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
                               epochs=cfg.epochs, track_metrics=True,
                               compute_dtype=cfg.compute_dtype),
                   device="cpu", aux_loss_fn="model" if cfg.aux_weight > 0 else None,
                   aux_weight=cfg.aux_weight).fit(batches["train"], valid=batches["valid"],
                                                  test=batches["test"])


def hold_run(phase: str, cfg, ds: MovieLens100K, res) -> dict:
    """The history keys, a falling finite train loss, and the history against
    ``cpu_fit`` (losses within TRAIN_LOSS_RTOL, AUCs within TRAIN_AUC_ATOL)."""
    if set(res.history) != HISTORY_KEYS:
        raise AssertionError(f"{phase}: history keys {sorted(res.history)}")
    loss = res.history["train_loss"]
    if not (np.isfinite(loss).all() and loss[-1] < loss[0]):
        raise AssertionError(f"{phase}: the train loss did not fall: {loss.tolist()}")
    cpu = cpu_fit(cfg, ds)
    worst = compare_histories(phase, res.history, {k: v.numpy() for k, v in cpu.history.items()},
                              res.extras, cpu.extras)
    return {"rows": res.train_examples, "epochs": cfg.epochs,
            "train_loss": [float(loss[0]), float(loss[-1])],
            "ranking_test@10": res.ranking["test@10"], "extras": res.extras,
            "train_time_s": res.train_time_s, "max_rel_loss_diff_vs_cpu": worst,
            "max_auc_diff_vs_cpu": max((abs(v - cpu.extras[k]) for k, v in res.extras.items()),
                                       default=0.0)}


def timed_run(cfg, ds: MovieLens100K) -> tuple:
    """(result, wall s) of ``run_experiment(cfg)`` on the card."""
    t0 = time.perf_counter()
    res = run_experiment(cfg, data=ds, device=DEVICE)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def window_tiles(ds: MovieLens100K) -> int:
    return -(-ds.num_users // DIEN_WINDOW_TILE)


def trained(cfg, ds: MovieLens100K, res, device) -> nn.Module:
    model = build_model(cfg, ds)
    model.load_state_dict({k: v.cpu() for k, v in res.params.items()})
    return model.to(device)


def run_dien(ds: MovieLens100K) -> dict:
    """``run_experiment(PRESETS["dien"])`` at the preset's width (embedding 16,
    attention (64, 32, 1), fc (128, 64, 1), 30 train negatives) for DIEN_EPOCHS
    epochs, float32, window serving, then the full-history catalog of every
    user on the card, both counted. Every lookup takes the gather kernel pair;
    the attention, the GRU and the MLPs are plain torch, so no DIN head or pool
    kernel launches. Held against a CPU ``Trainer.fit``; the window catalog
    against the CPU's tile by tile; the full-history catalog against the
    CPU's on one user of each length bucket and the longest history."""
    cfg = PRESETS["dien"].replace(epochs=DIEN_EPOCHS, full_history_serving=False)
    E = DIEN_EPOCHS
    full = [row[row >= 0] for row in ds.itemid_matrix(ds.data)]
    ctx_full = ServingContext(torch.from_numpy(ds.user_features), torch.from_numpy(ds.item_features),
                              full_histories=full).to(DEVICE)
    reset_launches()  # the main path's run starts here
    res, wall_s = timed_run(cfg, ds)
    model = trained(cfg, ds, res, DEVICE)
    t0 = time.perf_counter()
    with torch.no_grad():
        scores_full = model.score_catalog(ctx_full)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    counts = launches()  # ... and ends here

    tiles, chunks, steps = full_history_work(full, ds.num_items)
    forwards = 3 * E + 3  # train, valid, test an epoch; the final AUCs
    check_counts("dien", counts, {**din_head_counts({}, {}), "din_attention_pool": 0,
                                  "gather_rows": 2 * (forwards + window_tiles(ds)) + tiles + chunks,
                                  "onehot_grad": 2 * E})
    out = hold_run("dien", cfg, ds, res)
    if tuple(scores_full.shape) != (ds.num_users, ds.num_items) or not bool(
            torch.isfinite(scores_full).all()):
        raise AssertionError("dien: the full-history catalog is not finite [U, I]")
    # the window catalog, tile by tile, under the card's trained weights
    cpu_model = trained(cfg, ds, res, "cpu")
    ctx = ServingContext(torch.from_numpy(ds.user_features), torch.from_numpy(ds.item_features),
                         history=res.ctx.history.cpu())
    with torch.no_grad():
        got, want = model.score_catalog(ctx.to(DEVICE)).cpu(), cpu_model.score_catalog(ctx)
    worst_tile = 0.0
    for u0 in range(0, ds.num_users, DIEN_WINDOW_TILE):
        sl = slice(u0, u0 + DIEN_WINDOW_TILE)
        err = normwise_err(f"dien window tile {u0 // DIEN_WINDOW_TILE}", got[sl], want[sl],
                           FEATURE_TILE_RTOL)
        worst_tile = max(worst_tile, err / float(want[sl].abs().max()))
    # the full-history catalog of one user of each length bucket, the longest
    users = bucket_users(full)
    sub = ServingContext(torch.from_numpy(ds.user_features[users]),
                         torch.from_numpy(ds.item_features), full_histories=[full[u] for u in users])
    t0 = time.perf_counter()
    with torch.no_grad():
        want_full = cpu_model.score_catalog(sub)
    cpu_subset_s = time.perf_counter() - t0
    full_err = normwise_err("dien full-history users", scores_full[users].cpu(), want_full,
                            FEATURE_TILE_RTOL)
    return {"phase": "dien",
            "config": f"dien preset (embedding 16, attention (64, 32, 1), fc (128, 64, 1)), "
                      f"float32, window serving, {E} epochs; then the full-history catalog",
            **out, "wall_s": wall_s, "examples_per_s": res.examples_per_sec,
            "window_worst_tile_rel_err_vs_cpu": worst_tile,
            "full_history": {"wall_s": full_s, "user_tiles": tiles, "item_chunks": chunks,
                             "gru_steps": steps,
                             "users_checked": {int(u): int(len(full[u])) for u in users},
                             "max_abs_err_vs_cpu": full_err,
                             "max_abs_logit": float(want_full.abs().max()),
                             "cpu_subset_s": cpu_subset_s},
            "launches": counts}


def run_dien_bf16_aux(ds: MovieLens100K) -> dict:
    """DIEN as ``bench.py`` trains it, ``compute_dtype="bfloat16"`` with
    ``indirect_hist=True`` (``run_experiment`` builds the standard batches,
    which the flag leaves on the standard route), then ``use_augru=True`` with
    ``aux_weight`` DIEN_AUX_WEIGHT in float32 (the train forward also looks up
    each example's per-step negatives), DIEN_SECOND_EPOCHS epochs each, window
    serving; each against the same run on the CPU."""
    base = PRESETS["dien"]
    E = DIEN_SECOND_EPOCHS
    runs = {
        "bf16_indirect": base.replace(epochs=E, full_history_serving=False,
                                      compute_dtype="bfloat16",
                                      model_kwargs=dict(base.model_kwargs, indirect_hist=True)),
        "augru_aux": base.replace(epochs=E, full_history_serving=False,
                                  aux_weight=DIEN_AUX_WEIGHT,
                                  model_kwargs=dict(base.model_kwargs, use_augru=True)),
    }
    reset_launches()  # the main path's run starts here
    results = {}
    for name, cfg in runs.items():
        before = launches()
        res, wall_s = timed_run(cfg, ds)
        after = launches()
        aux = cfg.aux_weight > 0
        # the train forward looks up the negatives too; the final AUCs' train
        # forward ignores them
        want = {**din_head_counts({}, {}), "din_attention_pool": 0,
                "gather_rows": (3 if aux else 2) * E + 2 * (2 * E + 3 + window_tiles(ds)),
                "onehot_grad": (3 if aux else 2) * E}
        check_counts(f"dien_bf16_aux {name}", {k: after[k] - before[k] for k in after}, want)
        results[name] = (cfg, res, wall_s)
    counts = launches()  # ... and ends here
    out = {name: {**hold_run(f"dien_bf16_aux {name}", cfg, ds, res), "wall_s": wall_s}
           for name, (cfg, res, wall_s) in results.items()}
    return {"phase": "dien_bf16_aux",
            "config": f"dien preset in bf16 with indirect_hist, then AUGRU with aux_weight "
                      f"{DIEN_AUX_WEIGHT} in float32, {E} epochs each, window serving",
            "runs": out, "launches": counts}


def run_neuralcf(ds: MovieLens100K) -> dict:
    """``run_experiment(PRESETS["neuralcf"])`` at the preset's width (mf_dim
    256, layers (512, 256, 128, 64, 32), 60 train negatives) for
    NEURALCF_EPOCHS epochs in float32, then NEURALCF_BF16_EPOCHS in bf16
    (``bench.py:56``); four lookups a forward through the gather pair, the
    catalog through ``catalog_scores_from_pairs`` (CATALOG_TILE-user tiles).
    Each held against the CPU's ``Trainer.fit``, the float32 catalog's first
    tile against the CPU's under the card's trained weights."""
    base = PRESETS["neuralcf"]
    runs = {"float32": base.replace(epochs=NEURALCF_EPOCHS),
            "bfloat16": base.replace(epochs=NEURALCF_BF16_EPOCHS, compute_dtype="bfloat16")}
    reset_launches()  # the main path's run starts here
    results = {}
    for dtype, cfg in runs.items():
        before = launches()
        res, wall_s = timed_run(cfg, ds)
        after = launches()
        E = cfg.epochs
        check_counts(f"neuralcf {dtype}", {k: after[k] - before[k] for k in after},
                     {"gather_rows": 4 * (3 * E + 3 + n_tiles(ds)), "onehot_grad": 4 * E})
        results[dtype] = (cfg, res, wall_s)
    counts = launches()  # ... and ends here
    out = {dtype: {**hold_run(f"neuralcf {dtype}", cfg, ds, res), "wall_s": wall_s,
                   "examples_per_s": res.examples_per_sec}
           for dtype, (cfg, res, wall_s) in results.items()}
    cfg, res, _ = results["float32"]
    tile = {}
    for device in (DEVICE, "cpu"):
        model = trained(cfg, ds, res, device)
        with torch.no_grad():
            tile[str(device)] = catalog_scores_from_pairs(
                model.apply_params, model.params(), CATALOG_TILE, ds.num_items, device).cpu()
    err = normwise_err("neuralcf catalog tile", tile[str(DEVICE)], tile["cpu"], FEATURE_TILE_RTOL)
    out["float32"].update(catalog_tile_max_abs_err_vs_cpu=err,
                          catalog_tile_max_abs_logit=float(tile["cpu"].abs().max()))
    return {"phase": "neuralcf",
            "config": "neuralcf preset (mf_dim 256, layers (512, 256, 128, 64, 32)), "
                      f"{NEURALCF_EPOCHS} epochs float32, {NEURALCF_BF16_EPOCHS} bf16",
            "runs": out, "launches": counts}


def run_autorec(ds: MovieLens100K, name: str) -> dict:
    """``run_experiment(PRESETS[name])`` for AutoRec (user rows) or I-AutoRec
    (item rows) at hidden 256 with 150 global negatives, AUTOREC_EPOCHS
    epochs: the masked loss and its metrics against the same run on the CPU,
    and the whole [U, I] catalog (I-AutoRec's transposed) against the CPU's
    under the card's trained weights. No kernel on this path until a fused
    recommender serves the catalog (``serve_pair_matrix``)."""
    cfg = PRESETS[name].replace(epochs=AUTOREC_EPOCHS)
    reset_launches()  # the main path's run starts here
    res, wall_s = timed_run(cfg, ds)
    counts = launches()  # ... and ends here
    check_counts(name, counts, {k: 0 for k in KERNELS})
    if set(res.history) != HISTORY_KEYS:
        raise AssertionError(f"{name}: history keys {sorted(res.history)}")
    loss = res.history["train_loss"]
    if not (np.isfinite(loss).all() and loss[-1] < loss[0]):
        raise AssertionError(f"{name}: the train loss did not fall: {loss.tolist()}")
    cpu = run_experiment(cfg, data=ds, device="cpu")
    worst = compare_histories(name, res.history, cpu.history, res.extras, cpu.extras)
    if cpu.train_examples != res.train_examples:
        raise AssertionError(f"{name}: {res.train_examples} rated entries, CPU {cpu.train_examples}")
    catalogs = {}
    for device, ctx in ((DEVICE, res.ctx), ("cpu", cpu.ctx)):
        with torch.no_grad():
            catalogs[str(device)] = trained(cfg, ds, res, device).score_catalog(ctx).cpu()
    got, want = catalogs[str(DEVICE)], catalogs["cpu"]
    if tuple(got.shape) != (ds.num_users, ds.num_items):
        raise AssertionError(f"{name}: catalog of shape {tuple(got.shape)}")
    err = normwise_err(f"{name} catalog", got, want, FEATURE_TILE_RTOL)
    return {"phase": name.replace("-", "_"),
            "config": f"{name} preset (hidden 256, 150 global negatives), {AUTOREC_EPOCHS} epochs",
            "rating_matrix": list(res.ctx.rating_matrix.shape), "rows": res.train_examples,
            "epochs": AUTOREC_EPOCHS, "train_loss": [float(loss[0]), float(loss[-1])],
            "ranking_test@10": res.ranking["test@10"], "extras": res.extras,
            "wall_s": wall_s, "train_time_s": res.train_time_s,
            "max_rel_loss_diff_vs_cpu": worst, "catalog_max_abs_err_vs_cpu": err,
            "catalog_max_abs_logit": float(want.abs().max()), "launches": counts}


def run_serve_pair_matrix(ds: MovieLens100K, data_dir: str) -> dict:
    """``cli/serve.py::build_server`` with NeuralCF and with AutoRec, each over
    HTTP and through a fused recommender (``run_serve_model``); each run's
    counts from 0."""
    runs = [run_serve_model(ds, data_dir, "neuralcf", NEURALCF_BF16_EPOCHS),
            run_serve_model(ds, data_dir, "autorec", AUTOREC_EPOCHS)]
    return {"phase": "serve_pair_matrix", "runs": runs,
            "launches": {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]}}


# ---------------------------------------------------------------- phases 23-27

def mode_cfg(name: str, mode: str, **over):
    """The preset in a minibatch training mode: MODE_EPOCHS epochs of
    MINIBATCH_BATCH-row batches."""
    return PRESETS[name].replace(train_mode=mode, epochs=MODE_EPOCHS, batch_size=MINIBATCH_BATCH,
                                 **over)


def mode_fit(cfg, ds: MovieLens100K, device, source: str):
    """``cfg``'s minibatch trainer called directly on ``device``: ``source``
    "minibatch" (the data on the device) or "stream" (host arrays through the
    pinned prefetch); the sparse trainer where ``cfg.train_mode`` is
    "sparse". The same batches, initial weights and order on every device."""
    trainer = Trainer(build_model(cfg, ds),
                      TrainConfig(learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
                                  epochs=cfg.epochs, compute_dtype=cfg.compute_dtype),
                      device=device)
    b, y = split_batches(cfg, ds, "cpu")["train"]
    if source == "stream":
        host = (tree_map(lambda t: t.numpy(), b), y.numpy())
        if cfg.train_mode == "sparse":
            return fit_stream_sparse(trainer, cfg.seed, host, cfg.batch_size,
                                     optimizer=cfg.sparse_optimizer, seed=cfg.seed)
        return fit_stream(trainer, cfg.seed, host, cfg.batch_size, seed=cfg.seed)
    if cfg.train_mode == "sparse":
        return fit_minibatch_sparse(trainer, cfg.seed, (b, y), cfg.batch_size,
                                    optimizer=cfg.sparse_optimizer)
    return fit_minibatch(trainer, cfg.seed, (b, y), cfg.batch_size)


def mode_steps(cfg, ds: MovieLens100K) -> int:
    """Minibatch steps of a run: the train rows' full batches, each epoch."""
    rows = int(split_batches(cfg, ds, "cpu")["train"][1].shape[0])
    return cfg.epochs * (rows // cfg.batch_size)


def hold_mode(label: str, card_losses, cpu_losses) -> dict:
    """The card's epoch losses within MODE_LOSS_RTOL of the CPU's (the same
    call on the same batches), finite; returns them and the largest relative
    loss difference."""
    card_losses, cpu_losses = np.asarray(card_losses), np.asarray(cpu_losses)
    if not np.isfinite(card_losses).all():
        raise AssertionError(f"{label}: non-finite losses {card_losses.tolist()}")
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=MODE_LOSS_RTOL, err_msg=label)
    return {"train_loss": card_losses.tolist(),
            "max_rel_loss_diff_vs_cpu": float(np.max(np.abs(card_losses / cpu_losses - 1)))}


def state_leaves(params: dict, opt_state=None) -> dict:
    """name -> tensor on the host: ``params``, then ``opt_state`` where there
    is one (the dense Adam's moments and steps by param; each sparse table's
    lazy-Adam moments and step, or its AdaGrad accumulators)."""
    out = {}

    def walk(path, node):
        if dataclasses.is_dataclass(node):
            node = {f.name: getattr(node, f.name) for f in dataclasses.fields(node)}
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{path}/{k}", v)
        else:
            out[path] = torch.as_tensor(node).detach().to("cpu", copy=True)

    walk("params", params)
    walk("opt_state", opt_state or {})
    return out


def hold_state(label: str, got: dict, want: dict, tables: dict) -> dict:
    """Every tensor of the card's trained state ``got`` against the CPU's
    ``want`` (``state_leaves``): the same names, shapes and dtypes, each within
    STATE_RTOL of the CPU tensor's largest magnitude. For a sparse run
    (``tables``: the model's ``sparse_tables``), every table row the CPU run
    never touched (its lazy-Adam moments or its AdaGrad accumulator still 0)
    has the same bits on the card, in the table and in its state. Returns the
    largest difference, absolute and relative, the tensor it is in, and the
    count of untouched rows."""
    if got.keys() != want.keys():
        raise AssertionError(f"{label}: state {sorted(got)} on the card, {sorted(want)} on the CPU")
    worst, worst_abs, worst_name = 0.0, 0.0, None
    for name, w in want.items():
        g = got[name]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{label} {name}: {g.dtype}{list(g.shape)} on the card, "
                                 f"{w.dtype}{list(w.shape)} on the CPU")
        err = float((g.double() - w.double()).abs().max()) if w.numel() else 0.0
        scale = float(w.double().abs().max()) if w.numel() else 0.0
        rel = err / scale if scale else (0.0 if err == 0 else float("inf"))
        worst_abs = max(worst_abs, err)
        if rel >= worst:
            worst, worst_name = rel, name
    if not worst <= STATE_RTOL:
        raise AssertionError(f"{label}: {worst_name} is {worst} off the CPU's, relative")
    untouched = 0
    for table, path in tables.items():
        moments = want[f"opt_state/sparse/{table}/mv" if f"opt_state/sparse/{table}/mv" in want
                       else f"opt_state/sparse/{table}/accum"]
        rows = (moments.reshape(moments.shape[0], -1) == 0).all(dim=1)
        names = [f"params/{path}"] + [k for k in want if k.startswith(f"opt_state/sparse/{table}/")
                                      and want[k].dim() > 0]
        for name in names:
            if not torch.equal(got[name][rows], want[name][rows]):
                raise AssertionError(f"{label}: an untouched row of {name} moved on the card")
        untouched += int(rows.sum())
    return {"max_abs_state_diff_vs_cpu": worst_abs, "max_rel_state_diff_vs_cpu": worst,
            "worst_state_tensor": worst_name, "untouched_rows": untouched}


def sparse_tables(cfg, ds: MovieLens100K) -> dict:
    """The model's ``sparse_tables`` in sparse mode, else none."""
    return build_model(cfg, ds).sparse_tables if cfg.train_mode == "sparse" else {}


def mode_counts(cfg, ds: MovieLens100K, lookups: int, sparse: bool, catalog_tiles: int = 0):
    """The lookup pair's launches of a minibatch run: ``lookups`` gathers a
    step (``onehot_grad`` as many, the sparse step none), and the catalog's."""
    steps = mode_steps(cfg, ds)
    return {"gather_rows": lookups * (steps + catalog_tiles),
            "onehot_grad": 0 if sparse else lookups * steps}


def run_mode_experiments(phase: str, runs: dict, ds: MovieLens100K) -> dict:
    """Each ``cfg`` of ``runs`` through ``run_experiment`` on the card (its
    training mode, then the serving and ranking evaluation), counted from 0,
    and held against the same trainer called on the CPU (no catalog there)."""
    reset_launches()  # the main path's run starts here
    results = {}
    for label, (cfg, lookups, tiles) in runs.items():
        before = launches()
        res, wall_s = timed_run(cfg, ds)
        after = launches()
        check_counts(f"{phase} {label}", {k: after[k] - before[k] for k in after},
                     mode_counts(cfg, ds, lookups, cfg.train_mode == "sparse", tiles))
        results[label] = (cfg, res, wall_s)
    counts = launches()  # ... and ends here
    out = {}
    for label, (cfg, res, wall_s) in results.items():
        if set(res.history) != {"train_loss"}:
            raise AssertionError(f"{phase} {label}: history keys {sorted(res.history)}")
        # the experiment's params, then the same trainer's whole state (its
        # optimizer's too, which the experiment does not return), against the CPU
        cpu = mode_fit(cfg, ds, "cpu", "minibatch")
        card = mode_fit(cfg, ds, DEVICE, "minibatch")
        tables = sparse_tables(cfg, ds)
        held = hold_state(f"{phase} {label} params", state_leaves(res.params),
                          state_leaves(cpu.params), {})
        out[label] = {"train_mode": cfg.train_mode, "optimizer": cfg.sparse_optimizer
                      if cfg.train_mode == "sparse" else "adam",
                      "batch": cfg.batch_size, "steps": mode_steps(cfg, ds),
                      **hold_mode(f"{phase} {label}", res.history["train_loss"],
                                  cpu.history["train_loss"].numpy()),
                      "max_abs_param_diff_vs_cpu": held["max_abs_state_diff_vs_cpu"],
                      "max_rel_param_diff_vs_cpu": held["max_rel_state_diff_vs_cpu"],
                      **hold_state(f"{phase} {label} state",
                                   state_leaves(card.params, card.opt_state),
                                   state_leaves(cpu.params, cpu.opt_state), tables),
                      "ranking_test@10": res.ranking["test@10"], "wall_s": wall_s,
                      "train_time_s": res.train_time_s, "examples_per_s": res.examples_per_sec}
    return {"phase": phase, "runs": out, "launches": counts}


def run_minibatch(ds: MovieLens100K) -> dict:
    """``run_experiment`` in minibatch mode: DeepFM at the preset's width
    (embedding 128, tower (512, 256, 128, 1); four lookups a forward, then
    the catalog) and MF at D 64 (two; its catalog is a product), MODE_EPOCHS
    epochs of MINIBATCH_BATCH rows."""
    return run_mode_experiments("minibatch", {
        "deepfm": (mode_cfg("deepfm", "minibatch"), 4, n_tiles(ds)),
        "mf": (mode_cfg("mf", "minibatch"), 2, 0)}, ds)


def check_sentinel(ids: torch.Tensor, V: int, D: int, gen: torch.Generator) -> dict:
    """The row optimizers' padding slots on the card (``train/sparse.py``:
    ``dedup_rows``' CUDA sum and ``_write_slots``), which all read row V - 1.
    SENTINEL_STEPS steps of ``sparse_table_update`` with random row gradients
    into a random [V, D] table, with lazy Adam and with row-wise AdaGrad: the
    first on ``ids`` with row V - 1 among them (repeated, beside the padding
    slots), the others on ``ids`` without it. The table and state against the
    same steps on the CPU (``hold_state``: the rows no step touches keep their
    first bits), and on the card row V - 1 keeps, after the first step, its
    bits in the table and in its state."""
    later = torch.where(ids == V - 1, 0, ids)
    first = later.clone()
    first[:8] = V - 1
    batches = [first] + [later] * (SENTINEL_STEPS - 1)
    table0 = torch.randn((V, D), generator=gen, device=DEVICE)
    grads = [torch.randn((ids.shape[0], D), generator=gen, device=DEVICE) for _ in batches]
    missed = torch.ones(V, dtype=torch.bool)
    missed[first.cpu()] = False
    missed[later.cpu()] = False
    out = {"ids": int(ids.shape[0]), "table": [V, D], "steps": SENTINEL_STEPS,
           "rows_missed": int(missed.sum())}
    for name, init in (("lazy_adam", lambda dev: LazyAdamState.init(V, D, device=dev)),
                       ("rowwise_adagrad", lambda dev: RowwiseAdagradState.init(V, device=dev))):
        def steps(dev):
            """(the state after the first step, the state after the last)"""
            table, state = table0.to(dev, copy=True), init(dev)
            after = []
            for b, g in zip(batches, grads):
                sparse_table_update(table, state, b.to(dev), g.to(dev), SENTINEL_LR)
                after.append(state_leaves({"table": table}, {"sparse": {"table": state}}))
            return after[0], after[-1]

        kept, card = steps(DEVICE)
        held = hold_state(f"sparse sentinel {name}", card, steps(torch.device("cpu"))[1],
                          {"table": "table"})
        if held["untouched_rows"] != out["rows_missed"]:
            raise AssertionError(f"sparse sentinel {name}: {held['untouched_rows']} rows untouched "
                                 f"on the CPU, {out['rows_missed']} missed by the ids")
        if not torch.equal(card["params/table"][missed], table0.cpu()[missed]):
            raise AssertionError(f"sparse sentinel {name}: a row the ids miss moved on the card")
        for leaf, t in card.items():
            if t.dim() and not torch.equal(t[V - 1], kept[leaf][V - 1]):
                raise AssertionError(f"sparse sentinel {name}: row V - 1 of {leaf} moved after "
                                     "the step that touched it")
        out[name] = held
    return out


def run_sparse(ds: MovieLens100K) -> dict:
    """``run_experiment`` in sparse mode: MF and DeepFM with lazy Adam, MF with
    row-wise AdaGrad; the table rows through the gather kernel, no
    ``onehot_grad``. Then ``check_sentinel`` on DeepFM's first MINIBATCH_BATCH
    item ids into its item table."""
    out = run_mode_experiments("sparse", {
        "mf_lazy_adam": (mode_cfg("mf", "sparse"), 2, 0),
        "deepfm_lazy_adam": (mode_cfg("deepfm", "sparse"), 4, n_tiles(ds)),
        "mf_rowwise_adagrad": (mode_cfg("mf", "sparse", sparse_optimizer="rowwise_adagrad"), 2,
                               0)}, ds)
    x, _ = split_batches(PRESETS["deepfm"], ds, DEVICE)["train"]
    first = epoch_order(0, x.shape[0], 1, MINIBATCH_BATCH)[0, 0].to(DEVICE)
    _, items = ds.spec.ids(x[first])
    gen = torch.Generator(device=DEVICE).manual_seed(MINIBATCH_ROWS_SEED)
    out["sentinel"] = check_sentinel(items, ds.num_items,
                                     PRESETS["deepfm"].model_kwargs["embedding_dim"], gen)
    return out


def run_stream(ds: MovieLens100K) -> dict:
    """``fit_stream`` on MF and ``fit_stream_sparse`` on DeepFM (lazy Adam),
    MODE_EPOCHS epochs each: the host arrays through the pinned, side-stream
    prefetch; against the same calls on the CPU."""
    runs = {"mf": (mode_cfg("mf", "stream"), 2), "deepfm_sparse": (mode_cfg("deepfm", "sparse"), 4)}
    reset_launches()  # the main path's run starts here
    results = {}
    for label, (cfg, lookups) in runs.items():
        before = launches()
        t0 = time.perf_counter()
        res = mode_fit(cfg, ds, DEVICE, "stream")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        after = launches()
        check_counts(f"stream {label}", {k: after[k] - before[k] for k in after},
                     mode_counts(cfg, ds, lookups, cfg.train_mode == "sparse"))
        results[label] = (cfg, res, wall_s)
    counts = launches()  # ... and ends here
    out = {}
    for label, (cfg, res, wall_s) in results.items():
        cpu = mode_fit(cfg, ds, "cpu", "stream")
        out[label] = {"trainer": "fit_stream_sparse" if cfg.train_mode == "sparse"
                      else "fit_stream", "batch": cfg.batch_size, "steps": mode_steps(cfg, ds),
                      **hold_mode(f"stream {label}", res.history["train_loss"].cpu().numpy(),
                                  cpu.history["train_loss"].numpy()),
                      **hold_state(f"stream {label}", state_leaves(res.params, res.opt_state),
                                   state_leaves(cpu.params, cpu.opt_state),
                                   sparse_tables(cfg, ds)),
                      "wall_s": wall_s}
    return {"phase": "stream", "runs": out, "launches": counts}


def served_lists(port: int, users: list, k: int) -> list:
    """The lists /v1/recommend answers for ``users`` (one POST) and for the
    first user alone (one GET)."""
    batch = http(port, "POST", "/v1/recommend", {"users": users, "k": k})["items"]
    single = http(port, "GET", f"/v1/recommend?user={users[0]}&k={k}")["items"]
    if single != batch[0]:
        raise AssertionError("checkpoint_serve: GET and POST answer differently")
    return batch


def run_checkpoint_serve(ds: MovieLens100K, data_dir: str) -> dict:
    """Checkpoints on the card. The resume: AutoRec (``matrix_batches``, the
    preset's width) for CHECKPOINT_EPOCHS full-batch epochs, a checkpoint with
    its Adam state, CHECKPOINT_EPOCHS more from it, held against 2 x
    CHECKPOINT_EPOCHS uninterrupted (losses rtol MODE_LOSS_RTOL, params atol
    RESUME_ATOL), and the uninterrupted run against itself (atol RESUME_ATOL
    too). AutoRec looks
    nothing up, so every kernel of its step adds in a fixed order and a run
    repeats its bits; a model with lookups does not (``onehot_grad`` adds with
    atomics, see RESUME_ATOL). Serving: MF and DeepFM, CHECKPOINT_EPOCHS
    full-batch epochs each, saved and served by ``build_server --checkpoint``
    over HTTP; the lists must equal an in-memory ``Recommender``'s over the
    same params (MF through ``topk_serve_matmul``), and DeepFM's also a fused
    recommender's (``topk_scores``). Launches counted exactly."""
    E = CHECKPOINT_EPOCHS
    root = tempfile.mkdtemp(prefix="checkpoints_")
    seen = ds.seen_mask(ds.train, ds.valid, ds.test)
    users = list(range(0, ds.num_users, 29))  # 33 users

    def fit(cfg, model, batches, weights, epochs, **kw):
        tc = TrainConfig(learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
                         epochs=epochs, track_metrics=False)
        return Trainer(model, tc, device=DEVICE).fit(batches["train"], weights=weights, **kw)

    try:
        reset_launches()  # the main path's run starts here
        ar = PRESETS["autorec"]
        ar_batches, ar_weights, _, _ = matrix_batches(ar, ds, DEVICE)
        ar_weights = {"train": ar_weights["train"]}
        whole = fit(ar, build_model(ar, ds), ar_batches, ar_weights, 2 * E)
        again = fit(ar, build_model(ar, ds), ar_batches, ar_weights, 2 * E)
        first = fit(ar, build_model(ar, ds), ar_batches, ar_weights, E)
        mgr = CheckpointManager(f"{root}/autorec")
        mgr.save(E, first.params, opt_state=first.opt_state)
        fresh = build_model(ar, ds)
        state = mgr.restore(template={"params": fresh.state_dict()}, device=DEVICE)
        second = fit(ar, fresh, ar_batches, ar_weights, E, params=state["params"],
                     opt_state=state["opt_state"])
        resumed = torch.cat([first.history["train_loss"], second.history["train_loss"]])
        np.testing.assert_allclose(resumed.cpu().numpy(), whole.history["train_loss"].cpu().numpy(),
                                   rtol=MODE_LOSS_RTOL, err_msg="checkpoint_serve resume")
        resume_err = max(float((second.params[k] - whole.params[k]).abs().max())
                         for k in whole.params)
        rerun_err = max(float((again.params[k] - whole.params[k]).abs().max())
                        for k in whole.params)
        if not resume_err <= RESUME_ATOL:
            raise AssertionError(f"checkpoint_serve: the resumed params are {resume_err} off")
        if not rerun_err <= RESUME_ATOL:
            raise AssertionError(f"checkpoint_serve: a rerun's params are {rerun_err} off")

        mf = PRESETS["mf"]
        mf_res = fit(mf, build_model(mf, ds), split_batches(mf, ds, DEVICE), None, E)
        CheckpointManager(f"{root}/mf").save(E, mf_res.params)
        fm = PRESETS["deepfm"]
        fm_res = fit(fm, build_model(fm, ds), split_batches(fm, ds, DEVICE), None, E)
        CheckpointManager(f"{root}/deepfm").save(E, fm_res.params)

        served = {}
        for name, params in (("mf", mf_res.params), ("deepfm", fm_res.params)):
            args = serve_cli.parser().parse_args(["--model", name, "--data", data_dir, "--port",
                                                  "0", "--checkpoint", f"{root}/{name}"])
            server = serve_cli.build_server(args).serve_background()
            try:
                rec = server.recommender
                got = served_lists(server.port, users, 50)
                model = build_model(PRESETS[name], ds)
                model.load_state_dict({k: v.cpu() for k, v in params.items()})
                memory = Recommender(model, rec.ctx, seen=seen, device=DEVICE)
                if got != memory.top_k(50, users).tolist():
                    raise AssertionError(f"checkpoint_serve {name}: the served lists are not "
                                         "the in-memory Recommender's")
                entry = {"users": len(users), "k": 50}
                if name == "deepfm":
                    fused = Recommender(rec.model, rec.ctx, seen=seen, use_pallas="fused",
                                        device=DEVICE)
                    if fused.top_k(50, users).tolist() != got:
                        raise AssertionError("checkpoint_serve deepfm: the fused lists differ")
                    entry["fused_equal"] = True
                served[name] = entry
            finally:
                server.shutdown()
        torch.cuda.synchronize()
        counts = launches()  # ... and ends here
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # AutoRec looks nothing up. Trainer.fit takes one step an epoch (MF's two
    # lookups, DeepFM's n), and build_server one more epoch of each; DeepFM's
    # catalog is scored four times (the one-epoch run's ranking eval, the
    # server, the in-memory and the fused recommender); MF's top-k three times
    # (the POST, the GET, the in-memory recommender), DeepFM's fused one once
    n = LOOKUPS["deepfm"]
    check_counts("checkpoint_serve", counts, {
        **{k: 0 for k in KERNELS}, "gather_rows": (2 + n) * (E + 1) + 4 * n * n_tiles(ds),
        "onehot_grad": (2 + n) * (E + 1), "topk_serve_matmul": 3, "topk_scores": 1})
    return {"phase": "checkpoint_serve",
            "config": f"autorec {E} + {E} full-batch epochs through a checkpoint against "
                      f"{2 * E}; mf and deepfm ({E} epochs each) served from checkpoints",
            "max_rel_loss_diff_resumed": float(np.max(np.abs(
                resumed.cpu().numpy() / whole.history["train_loss"].cpu().numpy() - 1))),
            "max_abs_param_diff_resumed": resume_err, "max_abs_param_diff_rerun": rerun_err,
            "served": served, "launches": counts}


def run_cf(data_dir: str) -> dict:
    """Classic CF on the card (``cf/``): UserCF and ItemCF on the ``ua`` fold
    (CF_NEIGHBOURS neighbours, top CF_TOP_N), GDCF (CF_GDCF_ITERATIONS
    iterations, top CF_GDCF_K) on ``u1``; each top-k through ``topk_scores``.
    After the counted runs, every UserCF and ItemCF list against the stable
    top-k of the card's own masked predictions, GDCF's last list against the
    stable top-k of its pre-update logits (the final scores of a run one
    iteration shorter), and Recall / Precision / F1 (and GDCF's losses)
    against the same calls on the CPU."""
    ua, ua_tests = load_base_test(data_dir, "ua")
    u1, u1_tests = load_base_test(data_dir, "u1")
    neighbourhood = {"usercf": (user_cf_recommend, user_cf_scores),
                     "itemcf": (item_cf_recommend, item_cf_scores)}
    reset_launches()  # the main path's run starts here
    recs, walls = {}, {}
    for algo, (recommend, _) in neighbourhood.items():
        t0 = time.perf_counter()
        recs[algo] = recommend(ua, CF_NEIGHBOURS, CF_TOP_N, device=DEVICE)
        torch.cuda.synchronize()
        walls[algo] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hist, _ = gdcf_train(u1, iterations=CF_GDCF_ITERATIONS, top_k=CF_GDCF_K, device=DEVICE)
    torch.cuda.synchronize()
    walls["gdcf"] = time.perf_counter() - t0
    counts = launches()  # ... and ends here
    # two top-k each for UserCF and ItemCF (the neighbours, the lists), one a
    # GDCF iteration
    check_counts("cf", counts, {"topk_scores": 2 * 2 + CF_GDCF_ITERATIONS, "gather_rows": 0,
                                "onehot_grad": 0, "topk_serve_matmul": 0})

    out = {}
    m = torch.from_numpy(ua).to(DEVICE)
    for algo, (recommend, scores) in neighbourhood.items():
        pred = torch.where(m > 0, NEG_INF, scores(m, CF_NEIGHBOURS, device=DEVICE))
        if not torch.equal(recs[algo].long(), topk.stable_top_k(pred, CF_TOP_N)[1]):
            raise AssertionError(f"cf {algo}: the lists are not the stable top-k")
        got = cf_eval(recs[algo].cpu().numpy(), ua_tests)
        want = cf_eval(recommend(ua, CF_NEIGHBOURS, CF_TOP_N, device="cpu").numpy(), ua_tests)
        diff = max(abs(a - b) for a, b in zip(got, want))
        if diff > CF_METRIC_ATOL:
            raise AssertionError(f"cf {algo}: recall/precision/f1 {got} on the card, {want} CPU")
        out[algo] = {"fold": "ua", "recall": got[0], "precision": got[1], "f1": got[2],
                     "max_metric_diff_vs_cpu": diff, "wall_s": walls[algo]}
    _, last_logits = gdcf_train(u1, iterations=CF_GDCF_ITERATIONS - 1, top_k=CF_GDCF_K,
                                device=DEVICE)
    if not torch.equal(hist["rec"][-1].long(), topk.stable_top_k(last_logits, CF_GDCF_K)[1]):
        raise AssertionError("cf gdcf: the last list is not the stable top-k of its logits")
    cpu, _ = gdcf_train(u1, iterations=CF_GDCF_ITERATIONS, top_k=CF_GDCF_K, device="cpu")
    losses = hist["loss"].cpu().numpy()
    np.testing.assert_allclose(losses, cpu["loss"].numpy(), rtol=MODE_LOSS_RTOL, err_msg="gdcf")
    got = cf_eval(hist["rec"][-1].cpu().numpy(), u1_tests)
    want = cf_eval(cpu["rec"][-1].numpy(), u1_tests)
    diff = max(abs(a - b) for a, b in zip(got, want))
    if diff > CF_METRIC_ATOL:
        raise AssertionError(f"cf gdcf: recall/precision/f1 {got} on the card, {want} CPU")
    out["gdcf"] = {"fold": "u1", "iterations": CF_GDCF_ITERATIONS, "loss": losses.tolist(),
                   "max_rel_loss_diff_vs_cpu": float(np.max(np.abs(losses / cpu["loss"].numpy()
                                                                   - 1))),
                   "recall": got[0], "precision": got[1], "f1": got[2],
                   "max_metric_diff_vs_cpu": diff, "wall_s": walls["gdcf"]}
    return {"phase": "cf", "runs": out, "launches": counts}


def run_cli(ds: MovieLens100K, data_dir: str) -> dict:
    """On the card (the CLIs' default device), each JSON line parsed and its
    launches counted: ``cli/run.py --model dien --epochs CLI_EPOCHS --json``
    (the preset's full-history serving; finite metrics), ``cli/run.py --model
    mf --train-mode sparse --epochs CLI_EPOCHS --json`` (the table rows through
    the gather kernel, no ``onehot_grad``; the loss held against the same
    sparse run on the CPU), and ``cli/cf.py usercf --json`` (two top-k through
    ``topk_scores``; its metrics against the CPU's)."""
    from deeplearningrecommendationsystem_tpu_torch.cli import cf as cf_cli_module
    from deeplearningrecommendationsystem_tpu_torch.cli import run as run_cli_module

    def command(main, argv) -> tuple:
        buf = io.StringIO()
        before = launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            code = main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        after = launches()
        if code != 0:
            raise AssertionError(f"cli_run {argv}: exit {code}")
        payload = json.loads(buf.getvalue().strip().splitlines()[-1])
        return payload, {k: after[k] - before[k] for k in after}, wall_s

    reset_launches()  # the main path's run starts here
    E = CLI_EPOCHS
    payload, dien_counts, wall_s = command(run_cli_module.main, [
        "--model", "dien", "--epochs", str(E), "--json", "--data", data_dir])
    sparse_argv = ["--model", "mf", "--train-mode", "sparse", "--epochs", str(E), "--json",
                   "--data", data_dir]
    sparse_payload, sparse_counts, sparse_wall_s = command(run_cli_module.main, sparse_argv)
    cf_payload, cf_counts, cf_wall_s = command(cf_cli_module.main,
                                               ["usercf", "--json", "--data", data_dir])
    counts = launches()  # ... and ends here
    if payload["model"] != "dien":
        raise AssertionError(f"cli_run: payload {payload}")
    if not all(np.isfinite(v) for v in payload["final"].values()):
        raise AssertionError(f"cli_run: non-finite metrics {payload['final']}")
    full = [row[row >= 0] for row in ds.itemid_matrix(ds.data)]
    tiles, chunks, _ = full_history_work(full, ds.num_items)
    check_counts("cli_run dien", dien_counts, {**din_head_counts({}, {}), "din_attention_pool": 0,
                                               "gather_rows": 2 * (3 * E + 3) + tiles + chunks,
                                               "onehot_grad": 2 * E})

    mf = PRESETS["mf"].replace(train_mode="sparse", epochs=E)  # the CLI's config
    check_counts("cli_run mf sparse", sparse_counts, mode_counts(mf, ds, 2, True))
    if set(sparse_payload["final"]) != {"train_loss"}:
        raise AssertionError(f"cli_run mf sparse: final {sparse_payload['final']}")
    cpu = mode_fit(mf, ds, "cpu", "minibatch")
    card_loss, cpu_loss = sparse_payload["final"]["train_loss"], float(cpu.history["train_loss"][-1])
    if not abs(card_loss / cpu_loss - 1) <= MODE_LOSS_RTOL:
        raise AssertionError(f"cli_run mf sparse: loss {card_loss} on the card, {cpu_loss} CPU")

    check_counts("cli_run usercf", cf_counts, {"topk_scores": 2, "gather_rows": 0,
                                               "onehot_grad": 0, "topk_serve_matmul": 0})
    m, tests = load_base_test(data_dir, "ua")
    want = cf_eval(user_cf_recommend(m, device="cpu").numpy(), tests)
    got = (cf_payload["recall"], cf_payload["precision"], cf_payload["f1"])
    if max(abs(a - b) for a, b in zip(got, want)) > CF_METRIC_ATOL:
        raise AssertionError(f"cli_run usercf: {got} on the card, {want} CPU")
    return {"phase": "cli_run",
            "command": f"cli/run.py --model dien --epochs {E} --json (device cuda)",
            "wall_s": wall_s, "train_time_s": payload["train_time_s"],
            "examples_per_sec": payload["examples_per_sec"],
            "ranking_test@10": payload["ranking"]["test@10"],
            "sparse": {"command": "cli/run.py " + " ".join(sparse_argv[:-2]), "wall_s": sparse_wall_s,
                       "train_loss": card_loss, "rel_loss_diff_vs_cpu": abs(card_loss / cpu_loss - 1),
                       "ranking_test@10": sparse_payload["ranking"]["test@10"],
                       "launches": sparse_counts},
            "usercf": {"command": "cli/cf.py usercf --json", "wall_s": cf_wall_s,
                       "recall": got[0], "precision": got[1], "f1": got[2],
                       "launches": cf_counts},
            "launches": counts}


# ---------------------------------------------------------------- main


# ---------------------------------------------------------------- phases 28-31

MESH_EPOCHS = 2  # the fullbatch mesh runs' epochs (each rank trains the full model)
MESH_TOPK = 50
MESH_DEADLINE_S = 420.0  # one spawn's deadline: past it every rank is killed and the phase fails
MESH_LOSS_RTOL = 1e-6
MESH_PARAM_RTOL = 1e-5  # of each tensor's largest magnitude: the data axis reorders sums
SPARSE_BATCH = 8192
# (label, preset, mesh, strategy, unshard, mode): the runs of the 2-rank spawn,
# then the 4-rank one's
MESH_RUNS = (("mf_1x2", "mf", (1, 2), "psum", True, "fullbatch"),
             ("deepfm_1x2", "deepfm", (1, 2), "psum", False, "fullbatch"),
             ("deepfm_1x2_scatter", "deepfm", (1, 2), "scatter", True, "fullbatch"),
             ("deepfm_2x1", "deepfm", (2, 1), "psum", True, "fullbatch"),
             ("mf_sparse_1x2", "mf", (1, 2), "psum", False, "sparse"))
MESH_RUNS_4 = (("deepfm_2x2", "deepfm", (2, 2), "psum", True, "fullbatch"),)
COUNTED = ("gather_rows", "onehot_grad", "topk_serve_matmul", "topk_scores")


def mesh_cfg(preset: str, mode: str, **over):
    cfg = PRESETS[preset].replace(track_metrics=False, train_mode=mode, **over)
    if mode == "sparse":
        return cfg.replace(epochs=1, batch_size=SPARSE_BATCH, sparse_optimizer="lazy_adam")
    return cfg.replace(epochs=MESH_EPOCHS)


def same_bits(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: not the same bits")


def cpu_tree(tree: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def counted() -> dict:
    counts = launches()
    return {name: counts[name] for name in COUNTED}


def run_mesh_nccl(ds: MovieLens100K) -> dict:
    """One rank over NCCL on the card: the collectives on CUDA tensors (the
    transport itself, then the public functions of a one-rank group, which
    move nothing), and one epoch of MF through ``run_experiment(mesh_shape=(1,
    1))`` held to the run without a mesh (``hold_repeat``: bit for bit before
    the first backward), its launches equal."""
    from deeplearningrecommendationsystem_tpu_torch.parallel import collectives, make_mesh
    from deeplearningrecommendationsystem_tpu_torch.parallel.mesh import MODEL_AXIS, axis_group
    from deeplearningrecommendationsystem_tpu_torch.runtime import distributed

    store = tempfile.mkdtemp(prefix="nccl_store_")
    distributed.initialize(init_method=f"file://{store}/store", world_size=1, rank=0,
                           backend="nccl")
    try:
        mesh = make_mesh(1, 1)
        group = axis_group(mesh, MODEL_AXIS)
        x = torch.randn((1024, 64), device=DEVICE)
        ops = {"sum": collectives._all_reduce, "all_gather": torch.distributed.all_gather_into_tensor,
               "reduce_scatter": torch.distributed.reduce_scatter_tensor}
        collectives.reset_stats()
        for name, op in ops.items():
            same_bits(f"mesh_nccl {name}", collectives._collective(op, x.shape, x, group), x)
        for name, fn in (("sum_over", collectives.sum_over),
                         ("all_gather_tiled", collectives.all_gather_tiled),
                         ("reduce_scatter_tiled", collectives.reduce_scatter_tiled)):
            same_bits(f"mesh_nccl {name}", fn(x, group), x)
        stats = dict(collectives.STATS)
        if stats["staged_bytes"] or stats["calls"] != 3:
            raise AssertionError(f"mesh_nccl: NCCL staged or skipped a call: {stats}")
        cfg = PRESETS["mf"].replace(epochs=1)
        reset_launches()
        plain = run_experiment(cfg, data=ds, device=DEVICE)
        plain_counts = counted()
        again = run_experiment(cfg, data=ds, device=DEVICE)
        reset_launches()  # the main path's run starts here
        meshed = run_experiment(cfg.replace(mesh_shape=(1, 1)), data=ds, device=DEVICE)
        counts = launches()  # ... and ends here
        check_counts("mesh_nccl", counts, plain_counts)
        held = hold_repeat("mesh_nccl", meshed, plain, again)
        return {"phase": "mesh_nccl", "transport": dict(stats), "launches": counts,
                "train_loss": meshed.history["train_loss"].tolist(), **held,
                "nvidia_smi": card_line()}
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def hold_repeat(phase: str, got, want, again) -> dict:
    """``got`` against the run ``want`` (``again`` is ``want``'s call repeated,
    whose gap to it is the run's own spread): the train split's first history
    entry of every metric, the pre-update forward, which runs before any
    backward, the same bits; everything after a backward within
    MESH_LOSS_RTOL (the history) and MESH_PARAM_RTOL (params and the
    checksum, a sum of both signs), since ``onehot_grad`` sums with atomics
    and a backward's last bits vary run to run on the card (two runs that
    happen to agree say nothing of a third)."""
    same, spread, worst = 0, 0.0, 0.0
    pairs = [(f"history {k}", got.history[k], v, again.history[k]) for k, v in want.history.items()]
    pairs += [(f"param {k}", got.params[k].cpu().numpy(), v.cpu().numpy(),
               again.params[k].cpu().numpy()) for k, v in want.params.items()]
    for name, g, w, a in pairs:
        g, w, a = np.asarray(g), np.asarray(w), np.asarray(a)
        if name.startswith("history train_") and not np.array_equal(g[:1], w[:1]):
            raise AssertionError(f"{phase}: {name}'s pre-update entry differs")
        # a history entry relative to itself, a param to its largest magnitude;
        # the checksum as a param
        loss = name.startswith("history") and not name.endswith("_param_checksum")
        scale = np.abs(w) if name.startswith("history") else max(float(np.max(np.abs(w))), 1e-30)
        tol = MESH_LOSS_RTOL if loss else MESH_PARAM_RTOL
        err = float(np.max(np.abs(g - w) / np.maximum(scale, 1e-30)))
        spread = max(spread, float(np.max(np.abs(a - w) / np.maximum(scale, 1e-30))))
        if err > tol:
            raise AssertionError(f"{phase}: {name} off by {err} (the run's own spread {spread})")
        same += int(np.array_equal(g, w))
        worst = max(worst, err)
    return {"same_bits": same, "compared": len(pairs), "max_rel_diff": worst,
            "repeat_spread": spread}


def mesh_rank(rank: int, world: int, data_dir: str, runs) -> dict:
    """One Gloo rank on the card: each run of ``runs`` through
    ``run_experiment`` on its mesh, its lookups counted and its bytes through
    Gloo; the runs that keep their tables sharded then serve the top
    MESH_TOPK of every user through ``ShardedRecommender``, held here against
    the dense ``Recommender`` over the same params (the blocks gathered)."""
    from deeplearningrecommendationsystem_tpu_torch.parallel import collectives, make_mesh
    from deeplearningrecommendationsystem_tpu_torch.parallel.ep import unshard_model_tables
    from deeplearningrecommendationsystem_tpu_torch.serving import ShardedRecommender

    torch.cuda.set_device(0)
    ds = MovieLens100K(data_dir, seed=0)
    seen = ds.seen_mask(ds.train, ds.valid, ds.test)
    out = {}
    for label, preset, axes, strategy, unshard, mode in runs:
        cfg = mesh_cfg(preset, mode, mesh_shape=axes, ep_strategy=strategy,
                       unshard_params=unshard)
        collectives.reset_stats()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_experiment(cfg, data=ds, device=DEVICE)
        torch.cuda.synchronize()
        row = {"wall_s": time.perf_counter() - t0, "train_time_s": res.train_time_s,
               "launches": counted(), "gloo": dict(collectives.STATS),
               "history": {k: np.asarray(v) for k, v in res.history.items()},
               "params": cpu_tree(res.params), "ranking": res.ranking}
        if not unshard:
            mesh = make_mesh(*axes)
            model = build_model(cfg, ds)
            rec = ShardedRecommender(model, res.params, res.ctx, mesh, seen=seen, device=DEVICE)
            reset_launches()
            t0 = time.perf_counter()
            ids = rec.top_k(MESH_TOPK)
            row["serve_s"] = time.perf_counter() - t0
            row["serve_launches"] = counted()
            dense_model = build_model(cfg, ds)
            dense_model.load_state_dict(unshard_model_tables(res.params, res.ep_heights, mesh))
            dense = Recommender(dense_model, res.ctx, seen=seen, device=DEVICE)
            want = dense.top_k(MESH_TOPK)
            full = (~seen).sum(1) >= MESH_TOPK  # users with at least k unseen items
            row["lists_equal"] = bool(np.array_equal(ids[full], want[full]))
            row["users_held"] = int(full.sum())
        out[label] = row
    return out


def expected_mesh_counts(preset: str, mode: str, unshard: bool, plain: dict,
                         sparse_steps: int) -> dict:
    """Every rank's launches of a mesh run: the one-rank run's where the
    tables come back whole (one gather and one onehot_grad a lookup, the
    ranking's catalog alike); a lookup a forward and a backward where they
    stay sharded (no ranking); two gathers a sparse step."""
    if mode == "sparse":
        return {"gather_rows": 2 * sparse_steps, "onehot_grad": 0, "topk_serve_matmul": 0,
                "topk_scores": 0}
    if unshard:
        return plain[preset]["launches"]
    lookups = LOOKUPS.get(preset, 2)
    return {"gather_rows": lookups * MESH_EPOCHS, "onehot_grad": lookups * MESH_EPOCHS,
            "topk_serve_matmul": 0, "topk_scores": 0}


def expected_serve_counts(preset: str, ds) -> dict:
    """Every rank's launches of one sharded top-k of every user: MF gathers
    the user rows (its user table is sharded) and runs the fused matmul top-k
    on its item block, then merges; DeepFM gathers its two user tables' rows,
    then looks up its four tables once a user tile of its block's forward,
    takes the block's top-k and merges."""
    if preset == "mf":
        return {"gather_rows": 1, "onehot_grad": 0, "topk_serve_matmul": 1, "topk_scores": 1}
    tiles = -(-ds.num_users // CATALOG_TILE)
    return {"gather_rows": 2 + LOOKUPS["deepfm"] * tiles, "onehot_grad": 0,
            "topk_serve_matmul": 0, "topk_scores": 2}


def hold_mesh_run(label: str, got: dict, want, axes, unshard: bool) -> dict:
    """A rank's run against the one-rank run on the card: losses within
    MESH_LOSS_RTOL, every param within MESH_PARAM_RTOL of its largest
    magnitude (the blocks against the rows they hold)."""
    g, w = np.asarray(got["history"]["train_loss"]), want.history["train_loss"]
    if not np.isfinite(g).all():
        raise AssertionError(f"mesh {label}: non-finite losses {g.tolist()}")
    loss_err = float(np.max(np.abs(g / w - 1)))
    if loss_err > MESH_LOSS_RTOL:
        raise AssertionError(f"mesh {label}: losses {g.tolist()} vs {w.tolist()} on one rank")
    worst = 0.0
    for name, p in want.params.items():
        p = p.cpu().numpy()
        q = got["params"][name]
        if q.shape != p.shape:  # a block of a table left sharded: the rows it holds
            rows = q.shape[0]
            lo = got["coord"] * rows
            p = np.concatenate([p, np.zeros((rows * axes[1] - len(p),) + p.shape[1:], p.dtype)])
            p = p[lo:lo + rows]
        err = float(np.max(np.abs(q - p)) / max(float(np.max(np.abs(p))), 1e-30))
        if err > MESH_PARAM_RTOL:
            raise AssertionError(f"mesh {label}: {name} off by {err} of its largest magnitude")
        worst = max(worst, err)
    return {"max_rel_loss_diff": loss_err, "max_param_diff": worst}


def run_mesh(ds: MovieLens100K, data_dir: str) -> dict:
    """Gloo ranks spawned on the one card (NCCL refuses two ranks on one GPU,
    so the phase opens its groups with backend="gloo", whose collectives
    stage CUDA tensors through host memory): the runs of MESH_RUNS on 2 ranks
    and of MESH_RUNS_4 on 4, at the presets' full widths, each held against the
    same run on one rank on the card; every rank's launches counted exactly."""
    from deeplearningrecommendationsystem_tpu_torch.runtime.distributed import spawn

    print("mesh: NCCL refuses a duplicate GPU in one communicator, so the ranks on the "
          "one card run over gloo", flush=True)
    plain = {}
    for preset, mode in (("mf", "fullbatch"), ("deepfm", "fullbatch"), ("mf", "sparse")):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_experiment(mesh_cfg(preset, mode), data=ds, device=DEVICE)
        torch.cuda.synchronize()
        plain[preset if mode == "fullbatch" else f"{preset}_sparse"] = {
            "res": res, "launches": counted(), "wall_s": time.perf_counter() - t0}
    rows = int(split_batches(mesh_cfg("mf", "sparse"), ds, "cpu")["train"][1].shape[0])
    sparse_steps = rows // SPARSE_BATCH
    t0 = time.perf_counter()
    got2 = spawn(mesh_rank, 2, args=(data_dir, MESH_RUNS), deadline_s=MESH_DEADLINE_S,
                 threads=4)
    got4 = spawn(mesh_rank, 4, args=(data_dir, MESH_RUNS_4), deadline_s=MESH_DEADLINE_S,
                 threads=2)
    spawn_s = time.perf_counter() - t0
    out, total = {}, dict.fromkeys(COUNTED, 0)
    for runs, got in ((MESH_RUNS, got2), (MESH_RUNS_4, got4)):
        for label, preset, axes, strategy, unshard, mode in runs:
            ref = plain[preset if mode == "fullbatch" else f"{preset}_sparse"]
            want_counts = expected_mesh_counts(preset, mode, unshard, plain, sparse_steps)
            held = []
            for rank, r in enumerate(got):
                row = r[label]
                row["coord"] = rank % axes[1]
                check_counts(f"mesh {label} rank {rank}", row["launches"], want_counts)
                held.append(hold_mesh_run(f"{label} rank {rank}", row, ref["res"], axes, unshard))
                for k in COUNTED:
                    total[k] += row["launches"][k] + row.get("serve_launches", {}).get(k, 0)
                if not unshard:
                    check_counts(f"mesh {label} serve rank {rank}", row["serve_launches"],
                                 expected_serve_counts(preset, ds))
                    if not row["lists_equal"]:
                        raise AssertionError(f"mesh {label} rank {rank}: the sharded top-"
                                             f"{MESH_TOPK} differs from the dense Recommender's")
                elif row["ranking"] != got[0][label]["ranking"]:
                    raise AssertionError(f"mesh {label}: rank {rank}'s ranking differs")
            r0 = got[0][label]
            line = {"phase": "mesh_run", "run": label, "preset": preset, "mesh": list(axes),
                    "strategy": strategy, "mode": mode, "ranks": len(got),
                    "epochs": mesh_cfg(preset, mode).epochs, "wall_s": r0["wall_s"],
                    "train_time_s": r0["train_time_s"],
                    "one_rank_wall_s": ref["wall_s"], "one_rank_train_time_s": ref["res"].train_time_s,
                    "gloo_bytes_by_rank": [r[label]["gloo"]["moved_bytes"] for r in got],
                    "gloo_staged_bytes_by_rank": [r[label]["gloo"]["staged_bytes"] for r in got],
                    "gloo_calls_by_rank": [r[label]["gloo"]["calls"] for r in got],
                    "launches_by_rank": [r[label]["launches"] for r in got],
                    "train_loss": np.asarray(r0["history"]["train_loss"]).tolist(),
                    "one_rank_train_loss": ref["res"].history["train_loss"].tolist(),
                    **{k: max(h[k] for h in held) for k in held[0]}}
            if not unshard:
                line.update(serve_s=r0["serve_s"], serve_launches=r0["serve_launches"],
                            users_held=r0["users_held"], lists_equal=True)
            emit(line)
            out[label] = {k: line[k] for k in ("mesh", "strategy", "wall_s", "train_time_s",
                                               "gloo_bytes_by_rank", "max_rel_loss_diff",
                                               "max_param_diff")}
    # the ranks' launches; the one-rank reference runs here are comparisons
    counts = {name: 0 for name in launches()}
    counts.update(total)
    return {"phase": "mesh", "transport": "gloo", "runs": out, "spawn_s": spawn_s,
            "launches": counts}


def run_scaling_model(ds: MovieLens100K) -> dict:
    """``program_costs`` of one DeepFM fullbatch step at the preset's width on
    the card, ``predict_weak_scaling`` at 1, 2, 4 and 8 cards from it, and the
    step's measured time beside the prediction."""
    from deeplearningrecommendationsystem_tpu_torch.runtime import scaling_model

    cfg = PRESETS["deepfm"]
    trainer = Trainer(build_model(cfg, ds), TrainConfig(learning_rate=cfg.learning_rate,
                                                        weight_decay=cfg.weight_decay),
                      device=DEVICE)
    b, y = split_batches(cfg, ds, DEVICE)["train"]
    trainer.train_step(b, y)  # warm
    torch.cuda.synchronize()
    reset_launches()
    costs = scaling_model.program_costs(trainer.train_step, b, y)
    counts = launches()
    steps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(b, y)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    grad_bytes = scaling_model.grad_bytes_of(dict(trainer.model.named_parameters()))
    predicted = [scaling_model.predict_weak_scaling(costs["flops"], costs["hbm_bytes"],
                                                    grad_bytes, n) for n in (1, 2, 4, 8)]
    if not (costs["flops"] > 0 and costs["hbm_bytes"] > 0 and step_ms > 0):
        raise AssertionError(f"scaling_model: empty costs {costs}")
    return {"phase": "scaling_model", "nvidia_smi": card_line(), "rows": int(y.shape[0]),
            **costs, "grad_bytes": grad_bytes, "measured_step_ms": step_ms,
            "predicted": predicted,
            "note": "FLOPs and bytes count the torch ops; the gather kernels run outside "
                    "the dispatcher", "launches": counts}


def run_native(data_dir: str) -> dict:
    """The native parser (``data/native.py``, built with c++ here) and the NumPy
    path load the fixture's files to equal arrays; the native one must run."""
    from deeplearningrecommendationsystem_tpu_torch.data import native

    reset_launches()  # the phase launches no kernel
    t0 = time.perf_counter()
    got = MovieLens100K(data_dir, seed=0, use_native=True)
    native_s = time.perf_counter() - t0
    if got.parser != "native":
        raise AssertionError(f"native: the NumPy path ran ({native.build_error()})")
    t0 = time.perf_counter()
    want = MovieLens100K(data_dir, seed=0)
    numpy_s = time.perf_counter() - t0
    for key in ("user_features", "item_features"):
        if not np.array_equal(getattr(got, key), getattr(want, key)):
            raise AssertionError(f"native: {key} differs from the NumPy path's")
    for split in ("data", "train", "valid", "test"):
        for key in ("user", "item"):
            if not np.array_equal(getattr(got, split)[key], getattr(want, split)[key]):
                raise AssertionError(f"native: {split}.{key} differs from the NumPy path's")
    return {"phase": "native", "parser": got.parser, "library": native.library_path().name,
            "load_s_native": native_s, "load_s_numpy": numpy_s, "launches": launches()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full float32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": card, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    print(card, flush=True)

    t0 = time.perf_counter()
    libs = build.build_all(sorted({meta["source"].rsplit("/", 1)[1] for meta in KERNELS.values()}))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [p.name for p in libs.values()]})

    tmp = tempfile.mkdtemp(prefix="ml100k_synthetic_")
    try:
        ds = make_dataset(tmp)
        t0 = time.perf_counter()
        rows = {name: [] for name in KERNELS}
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        for U, I, D, k in KERNEL_SHAPES:
            for name in ("topk_serve_matmul", "topk_scores"):
                rows[name].append(check_topk(name, U, I, D, k, gen))
                emit({"phase": "kernel_check", "kernel": name, **rows[name][-1]})

        batch = split_batches(PRESETS["mf"], ds, DEVICE)["train"]
        (uid, iid), _ = batch
        small = torch.randint(0, 37, (77,), generator=gen, device=DEVICE)  # ragged, a bias table
        tables = [("user", ds.num_users, uid), ("item", ds.num_items, iid), ("small", 37, small)]
        for dtype in (torch.float32, torch.bfloat16):
            for tname, V, ids in tables:
                D = 1 if tname == "small" else EMBEDDING_DIM
                table = torch.randn((V, D), generator=gen, device=DEVICE).to(dtype)
                rows["gather_rows"].append(check_gather(tname, table, ids))
                emit({"phase": "kernel_check", "kernel": "gather_rows", **rows["gather_rows"][-1]})
                rows["onehot_grad"].append(check_grad(tname, ids, V, D, dtype, gen))
                emit({"phase": "kernel_check", "kernel": "onehot_grad", **rows["onehot_grad"][-1]})
        # the lookup pair at the other main paths' shapes, float32: serve_din's
        # smallest target tile, LR's bias lookups, DIN's history batch
        lr_cfg, din_cfg = PRESETS["lr"], PRESETS["din"]
        x, y = split_batches(lr_cfg, ds, DEVICE)["train"]
        lr_model = build_model(lr_cfg, ds).to(DEVICE)
        lr_user, lr_item = lr_model.spec.ids(x)
        (din_hist, _), din_y = split_batches(din_cfg, ds, DEVICE)["train"]
        din_rows = int(din_y.shape[0])
        lookups = [("din target tile", ds.num_items, EMBEDDING_DIM,
                    torch.arange(DIN_TARGET_TILE, device=DEVICE) % 256),
                   ("lr user bias", ds.num_users, 1, lr_user),
                   ("lr item bias", ds.num_items, 1, lr_item),
                   ("din history", ds.num_items, din_cfg.model_kwargs["embed_size"],
                    din_hist.reshape(-1))]
        for tname, V, D, ids in lookups:
            table = torch.randn((V, D), generator=gen, device=DEVICE)
            rows["gather_rows"].append(check_gather(tname, table, ids))
            emit({"phase": "kernel_check", "kernel": "gather_rows", **rows["gather_rows"][-1]})
            rows["onehot_grad"].append(check_grad(tname, ids, V, D, torch.float32, gen))
            emit({"phase": "kernel_check", "kernel": "onehot_grad", **rows["onehot_grad"][-1]})
        # the lookup pair at the feature presets' widths, float32, on DeepFM's
        # train-batch ids: D 128 (DeepFM, WideDeep, NFM, DCN) and D 256 (PNN),
        # from a generator of their own so that the other rows keep their inputs
        feature_gen = torch.Generator(device=DEVICE).manual_seed(FEATURE_ROWS_SEED)
        fm_x, _ = split_batches(PRESETS["deepfm"], ds, DEVICE)["train"]
        fm_user, fm_item = ds.spec.ids(fm_x)
        for model_name, D in (("deepfm", PRESETS["deepfm"].model_kwargs["embedding_dim"]),
                              ("pnn", PRESETS["pnn"].model_kwargs["embedding_dim"])):
            for field, V, ids in (("user", ds.num_users, fm_user), ("item", ds.num_items, fm_item)):
                tname = f"{model_name} {field}"
                table = torch.randn((V, D), generator=feature_gen, device=DEVICE)
                rows["gather_rows"].append(check_gather(tname, table, ids))
                emit({"phase": "kernel_check", "kernel": "gather_rows", **rows["gather_rows"][-1]})
                rows["onehot_grad"].append(check_grad(tname, ids, V, D, torch.float32, feature_gen))
                emit({"phase": "kernel_check", "kernel": "onehot_grad", **rows["onehot_grad"][-1]})
        # the lookup pair at DIEN's and NeuralCF's shapes, from a generator of
        # their own: DIEN's train-batch history ids [B * 10] and targets into
        # 1682 x 16, float32 and bf16; the indirect batch's rows of a [U, 10 * 16]
        # table by user (bf16, as dien_bf16_aux trains it); NeuralCF's train ids
        # into its four tables of D 256
        pair_seq_gen = torch.Generator(device=DEVICE).manual_seed(PAIR_SEQ_ROWS_SEED)
        dien_cfg, ncf_cfg = PRESETS["dien"], PRESETS["neuralcf"]
        (dien_hist, dien_tgt), _ = split_batches(dien_cfg, ds, DEVICE)["train"]
        dien_D = dien_cfg.model_kwargs["embed_size"]
        dien_users = torch.from_numpy(np.concatenate([  # the sampler's users are user-major
            ds.train["user"], np.repeat(np.arange(ds.num_users), dien_cfg.negatives[0])])).to(DEVICE)
        (ncf_user, ncf_item), _ = split_batches(ncf_cfg, ds, DEVICE)["train"]
        ncf_D = ncf_cfg.model_kwargs["mf_dim"]
        pair_seq = [("dien history", ds.num_items, dien_D, dien_hist.reshape(-1), torch.float32),
                    ("dien history", ds.num_items, dien_D, dien_hist.reshape(-1), torch.bfloat16),
                    ("dien target", ds.num_items, dien_D, dien_tgt, torch.float32),
                    ("dien indirect user rows", ds.num_users, dien_cfg.hist_len * dien_D,
                     dien_users, torch.bfloat16),
                    ("neuralcf user", ds.num_users, ncf_D, ncf_user, torch.float32),
                    ("neuralcf item", ds.num_items, ncf_D, ncf_item, torch.float32)]
        for tname, V, D, ids, dtype in pair_seq:
            table = torch.randn((V, D), generator=pair_seq_gen, device=DEVICE).to(dtype)
            rows["gather_rows"].append(check_gather(tname, table, ids))
            emit({"phase": "kernel_check", "kernel": "gather_rows", **rows["gather_rows"][-1]})
            rows["onehot_grad"].append(check_grad(tname, ids, V, D, dtype, pair_seq_gen))
            emit({"phase": "kernel_check", "kernel": "onehot_grad", **rows["onehot_grad"][-1]})
        # the lookup pair at the minibatch modes' batches, from a generator of
        # their own: the first MINIBATCH_BATCH rows of the first epoch's order
        # (epoch_order, seed 0) of DeepFM's train rows into its user and item
        # tables (D 128) and of MF's into its user table (D 64)
        mb_gen = torch.Generator(device=DEVICE).manual_seed(MINIBATCH_ROWS_SEED)
        (mf_u, _), _ = split_batches(PRESETS["mf"], ds, DEVICE)["train"]
        fm_first = epoch_order(0, fm_x.shape[0], 1, MINIBATCH_BATCH)[0, 0].to(DEVICE)
        mf_first = epoch_order(0, mf_u.shape[0], 1, MINIBATCH_BATCH)[0, 0].to(DEVICE)
        fm_D = PRESETS["deepfm"].model_kwargs["embedding_dim"]
        mb_user, mb_item = ds.spec.ids(fm_x[fm_first])
        for tname, V, D, ids in (("deepfm minibatch user", ds.num_users, fm_D, mb_user),
                                 ("deepfm minibatch item", ds.num_items, fm_D, mb_item),
                                 ("mf minibatch user", ds.num_users, EMBEDDING_DIM, mf_u[mf_first])):
            table = torch.randn((V, D), generator=mb_gen, device=DEVICE)
            rows["gather_rows"].append(check_gather(tname, table, ids))
            emit({"phase": "kernel_check", "kernel": "gather_rows", **rows["gather_rows"][-1]})
            rows["onehot_grad"].append(check_grad(tname, ids, V, D, torch.float32, mb_gen))
            emit({"phase": "kernel_check", "kernel": "onehot_grad", **rows["onehot_grad"][-1]})
        # classic CF's top-k: the top 20 unrated items of every user, and
        # UserCF's 10 neighbours of every user
        for U_, I_, k in ((ds.num_users, ds.num_items, CF_TOP_N),
                          (ds.num_users, ds.num_users, CF_NEIGHBOURS)):
            rows["topk_scores"].append(check_topk("topk_scores", U_, I_, 0, k, mb_gen))
            emit({"phase": "kernel_check", "kernel": "topk_scores", **rows["topk_scores"][-1]})
        # the mesh phase's EP blocks, from a generator of their own
        check_ep_blocks(ds, {"mf": (EMBEDDING_DIM, uid, iid), "deepfm": (fm_D, fm_user, fm_item)},
                        rows)
        del mf_u, fm_first, mf_first, mb_user, mb_item
        del lookups, table, din_hist, din_y, lr_user, lr_item, fm_x, fm_user, fm_item
        del pair_seq, dien_hist, dien_tgt, dien_users, ncf_user, ncf_item
        # the rows of widths past the presets' draw from their own generator, so
        # that the other rows see the same inputs as before them
        wide_gen = torch.Generator(device=DEVICE).manual_seed(1)
        rows_gen = torch.Generator(device=DEVICE).manual_seed(TRAINER_ROWS_SEED)
        for dtype, D, draw, order in (
                ("float32", EMBEDDING_DIM, gen, "as batched"),
                ("bfloat16", EMBEDDING_DIM, gen, "as batched"),
                ("float32", MF_WIDE_DIM, wide_gen, "as batched"),
                *((dt, EMBEDDING_DIM, rows_gen, kind) for kind in TRAINER_ROWS
                  for dt in ("float32", "bfloat16"))):
            rows["mf_fullbatch_train"].append(
                check_mf_epoch(batch, ds.num_users, ds.num_items, dtype, draw, TRAIN_EPOCHS, D,
                               order))
            emit({"phase": "kernel_check", "kernel": "mf_fullbatch_train",
                  **rows["mf_fullbatch_train"][-1]})
        del batch, uid, iid
        torch.cuda.empty_cache()

        rows["topk_serve_matmul"].append(check_topk("topk_serve_matmul", *LR_SERVING_SHAPE, gen))
        emit({"phase": "kernel_check", "kernel": "topk_serve_matmul", **rows["topk_serve_matmul"][-1]})
        for mode, name, order in (("wide", "lr_fullbatch_train", "as batched"),
                                  ("compact", "lr_fullbatch_train_compact", "as batched"),
                                  *(("compact", "lr_fullbatch_train_compact", kind)
                                    for kind in TRAINER_ROWS)):
            rows[name].append(check_lr(lr_model, lr_model.params(), x, y, mode,
                                       lr_cfg.learning_rate, TRAIN_EPOCHS, order, rows_gen))
            emit({"phase": "kernel_check", "kernel": name, **rows[name][-1]})
        del x, y, lr_model
        afm_cfg = PRESETS["afm"]
        D, A = afm_cfg.model_kwargs["embedding_dim"], afm_cfg.model_kwargs["attention_dim"]
        afm_rows = int(split_batches(afm_cfg, ds, DEVICE)["train"][1].shape[0])
        for B, label in ((afm_rows, "train batch"),
                         (CATALOG_TILE * ds.num_items, f"catalog tile of {CATALOG_TILE} users")):
            rows["afm_attention_pool"].append(check_afm(B, D, A, gen, label, backward=False))
            emit({"phase": "kernel_check", "kernel": "afm_attention_pool",
                  **rows["afm_attention_pool"][-1]})
        rows["afm_attention_pool_bwd"].append(check_afm(afm_rows, D, A, gen, "train batch",
                                                        backward=True))
        emit({"phase": "kernel_check", "kernel": "afm_attention_pool_bwd",
              **rows["afm_attention_pool_bwd"][-1]})
        # the widths past the preset's that the model takes, both directions
        for wide_D, wide_A in AFM_WIDE:
            for name, backward in (("afm_attention_pool", False), ("afm_attention_pool_bwd", True)):
                rows[name].append(check_afm(AFM_WIDE_ROWS, wide_D, wide_A, wide_gen, "wide widths",
                                            backward=backward))
                emit({"phase": "kernel_check", "kernel": name, **rows[name][-1]})
        din_dims = (din_cfg.hist_len, din_cfg.model_kwargs["embed_size"], DIN_ATTENTION, DIN_FC)
        ragged = "train batch's rows at ragged widths"
        long_dims = (cuda_dh.MAX_HISTORY,) + din_dims[1:]
        long_label = f"{DIN_LONG_ROWS} rows at history {cuda_dh.MAX_HISTORY}"
        wide_fc_dims = din_dims[:3] + (DIN_WIDE_FC,)
        wide_fc_label = f"{DIN_WIDE_FC_ROWS} rows at the widest fc"
        wide_fc_gen = torch.Generator(device=DEVICE).manual_seed(2)
        for name, part, B, dims, label, dtype, draw, seeds in (
                ("din_head_fused", "fwd", din_rows, din_dims, "train batch", torch.float32, gen, ()),
                ("din_head_fused_bwd", "bwd", din_rows, din_dims, "train batch", torch.float32, gen,
                 ()),
                ("din_attention_pool", "pool", HISTORY_TILE * ds.num_items, din_dims,
                 f"window tile of {HISTORY_TILE} users", torch.float32, gen, ()),
                ("din_head_fused", "fwd", din_rows, din_dims, "train batch", torch.bfloat16, gen,
                 DIN_BF16_FWD_SEEDS),
                ("din_head_fused_bwd", "bwd", din_rows, din_dims, "train batch", torch.bfloat16, gen,
                 ()),
                ("din_head_fused", "fwd", din_rows, DIN_RAGGED, ragged, torch.bfloat16, gen, ()),
                ("din_head_fused_bwd", "bwd", din_rows, DIN_RAGGED, ragged, torch.bfloat16, gen, ()),
                ("din_head_fused", "fwd", din_rows, DIN_RAGGED, ragged, torch.float32, wide_gen, ()),
                ("din_head_fused_bwd", "bwd", din_rows, DIN_RAGGED, ragged, torch.float32, wide_gen,
                 ()),
                ("din_head_fused", "fwd", DIN_LONG_ROWS, long_dims, long_label, torch.float32,
                 wide_gen, ()),
                ("din_head_fused_bwd", "bwd", DIN_LONG_ROWS, long_dims, long_label, torch.float32,
                 wide_gen, ()),
                ("din_head_fused_bwd", "bwd", DIN_WIDE_FC_ROWS, wide_fc_dims, wide_fc_label,
                 torch.float32, wide_fc_gen, ()),
                ("din_head_fused_bwd", "bwd", DIN_WIDE_FC_ROWS, wide_fc_dims, wide_fc_label,
                 torch.bfloat16, wide_fc_gen, ()),
                ("din_head_fused", "fwd", DIN_WIDE_FC_ROWS, wide_fc_dims, wide_fc_label,
                 torch.bfloat16, wide_fc_gen, ())):
            rows[name].append(check_din(part, B, *dims, draw, label, dtype, seeds))
            emit({"phase": "kernel_check", "kernel": name, **rows[name][-1]})
        # DIN's full-history scorer, from a generator of its own
        rows["din_full_history"].append(check_din_full_history(
            ds, torch.Generator(device=DEVICE).manual_seed(FULL_HISTORY_ROWS_SEED)))
        emit({"phase": "kernel_check", "kernel": "din_full_history", **rows["din_full_history"][-1]})
        torch.cuda.empty_cache()
        emit({"phase": "kernel_checks", "seconds": time.perf_counter() - t0})

        phases = [run_train(ds), run_serve(ds, tmp), run_slice(ds), run_lr(ds), run_afm(ds),
                  run_serve_model(ds, tmp, "lr", TRAIN_EPOCHS),
                  run_serve_model(ds, tmp, "afm", AFM_EPOCHS), run_din(ds), run_din_bf16(ds),
                  run_serve_din(ds, tmp, DIN_EPOCHS), run_din_depth(ds), run_deepfm(ds),
                  run_serve_model(ds, tmp, "deepfm", DEEPFM_EPOCHS), run_feature_zoo(ds),
                  run_dien(ds), run_dien_bf16_aux(ds), run_neuralcf(ds),
                  run_autorec(ds, "autorec"), run_autorec(ds, "i-autorec"),
                  run_serve_pair_matrix(ds, tmp), run_minibatch(ds), run_stream(ds),
                  run_sparse(ds), run_checkpoint_serve(ds, tmp), run_cf(tmp), run_cli(ds, tmp),
                  run_mesh_nccl(ds), run_mesh(ds, tmp), run_scaling_model(ds), run_native(tmp)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for p in phases:
        emit(p)
    counts = {name: sum(p["launches"][name] for p in phases) for name in KERNELS}

    lines = []
    for name, meta in KERNELS.items():
        if counts[name] < 1:
            raise AssertionError(f"{name} was not launched on the main path")
        main_row = rows[name][0]  # the main path's shape: all MF users, the user table, the train batch
        lines.append({
            "name": name, **meta, "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": main_row["kernel_ms"], "kernel_ms": main_row["kernel_ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            **{k: main_row[k] for k in ("cuda_core_bound_ms",) if k in main_row},
            "library_ms": main_row["library_ms"], "shape": main_row["shape"],
            **({"launches_by_dtype": {dt: sum(p["launches"][f"{name}:{dt}"] for p in phases)
                                      for dt in DIN_HEAD_LAUNCHES[name]}}
               if name in DIN_HEAD_LAUNCHES else {}),
            "launches_by_phase": {p["phase"]: p["launches"][name] for p in phases},
            "at_shapes": rows[name],
        })
    emit({"kernels": lines})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
