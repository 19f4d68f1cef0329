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
   bound. The lookup pair (gather_rows, onehot_grad) is also checked at the
   other main paths' shapes (DIN's history batch and full-history target tile,
   LR's bias tables); its rows carry ``host_us``, the host's time per launcher
   call, and ``library_host_us``, the same for the library call; where a call
   is host-bound, kernel and library are timed in turns;
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
   at D = 2), AFM through its masked catalog scores and the plain top-k;
10. din     -- ``run_experiment(PRESETS["din"])`` at full width (embedding 64,
   attention (128, 64, 1), fc (256, 128, 1), history 10) for DIN_EPOCHS epochs
   with window serving: training and evaluation through the fused DIN head
   kernels, the catalog through the DIN attention-pool kernel, one launch a
   16-user tile. Held against a CPU ``Trainer.fit`` over the same batches and
   the CPU's window scores of one tile under the same trained weights;
11. serve_din -- ``cli/serve.py::build_server --model din``: the preset's
   full-history serving (trained through the DIN head kernels, scored through
   the masked plain-torch route), answers held against the stable top-k of the
   served scores, and the full-history scores of a few users (the longest
   history among them) against the CPU's.

Phases 4-11 are the main paths: each sets the launch counts to 0 just before
it and reads them just after. The last line of stdout is
``{"ok": true, "device": {...}}``; the line before it is the card's name and
power limit, and the line before that the ``kernels`` line.
"""

from __future__ import annotations

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

from deeplearningrecommendationsystem_tpu_torch.cli import serve as serve_cli
from deeplearningrecommendationsystem_tpu_torch.configs import PRESETS
from deeplearningrecommendationsystem_tpu_torch.data import MovieLens100K, write_ml100k_format
from deeplearningrecommendationsystem_tpu_torch.experiments import (
    build_model,
    run_experiment,
    split_batches,
)
from deeplearningrecommendationsystem_tpu_torch.models import MatrixFactorization, ServingContext
from deeplearningrecommendationsystem_tpu_torch.ops import afm_attention as afm
from deeplearningrecommendationsystem_tpu_torch.ops import din_attention as dinatt
from deeplearningrecommendationsystem_tpu_torch.ops import din_head as dh
from deeplearningrecommendationsystem_tpu_torch.ops import gather as gat
from deeplearningrecommendationsystem_tpu_torch.ops import lr_epoch as lre
from deeplearningrecommendationsystem_tpu_torch.ops import mf_epoch as mfe
from deeplearningrecommendationsystem_tpu_torch.ops import serving_topk as topk
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import afm_attention as cuda_afm
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import build
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import din_attention as cuda_dinatt
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import din_head as cuda_dh
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import gather as cuda_gather
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import lr_epoch as cuda_lre
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import mf_epoch as cuda_mfe
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import serving_topk as cuda_topk
from deeplearningrecommendationsystem_tpu_torch.ops.attention import attention_pool
from deeplearningrecommendationsystem_tpu_torch.ops.interactions import pairwise_products
from deeplearningrecommendationsystem_tpu_torch.ops.linear import mlp, mlp_init
from deeplearningrecommendationsystem_tpu_torch.server import RecommenderServer
from deeplearningrecommendationsystem_tpu_torch.serving import Recommender
from deeplearningrecommendationsystem_tpu_torch.train import TrainConfig, Trainer

DEVICE = torch.device("cuda")
NEG_INF = topk.NEG_INF
# H100 SXM data sheet (dense, no sparsity): float32 outside the tensor cores and
# HBM3 bandwidth. The bound of a kernel is the larger of its operations over the
# first and its bytes (each input read once, each output written once) over the
# second.
PEAK_F32_FLOP_S = 67e12
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
SEEN_DENSITY = 100_000 / (943 * 1682)  # ml-100k: every rating is a seen item
# (users, items, dim, k): all users of the MF preset, one batched request of
# the slice below, and the JAX package's large-catalog serving shape
KERNEL_SHAPES = [(943, 1682, EMBEDDING_DIM, 50), (32, 1682, EMBEDDING_DIM, 50),
                 (2048, 131072, EMBEDDING_DIM, 50)]
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
CATALOG_TILE = 64  # users per tile of catalog_scores_from_features
# the DIN head and pool kernels against their plain versions: largest error
# within this share of the tensor's largest |value| (float32 sums over D, the
# widths, the L positions and, for the weight gradients, all rows, in another
# order). The backward is held so on the rows none of whose relu inputs lies
# within DIN_KINK of its layer's largest |value| from 0: at such a kink the
# mask, so the row's gradient, may flip between any two float32 orders of
# summation, and at the train batch a few rows sit there. d b3 is 0 in exact
# arithmetic and held to DIN_DB3_ATOL of sum |g|.
DIN_FWD_RTOL, DIN_BWD_RTOL, DIN_DB3_ATOL, DIN_KINK = 1e-5, 1e-4, 1e-6, 1e-6
DIN_EPOCHS = 3  # the CPU reference's plain path is slow at full width
HISTORY_TILE = 16  # users per tile of catalog_scores_from_history
DIN_ATTENTION, DIN_FC = (128, 64, 1), (256, 128, 1)  # models/din.py's defaults, the preset's
# The lookup pair (gather_rows, onehot_grad): where the kernel takes under
# LOOKUP_INTERLEAVE_MS a call is bound by the host, whose speed drifts within a
# run, so kernel and library are timed in turns (kernel, library, library,
# kernel, ...), LOOKUP_RUNS runs each of LOOKUP_BUDGET_MS, and each reports its
# median. host_us and library_host_us: the host clock over HOST_CALLS calls
# of the launcher and of the library call, no synchronise, per call.
LOOKUP_INTERLEAVE_MS, LOOKUP_RUNS, LOOKUP_BUDGET_MS = 0.1, 5, 20.0
HOST_CALLS = 1_000
DIN_TARGET_TILE = 512  # serve_din's smallest target tile: 2 users x 256 catalog items
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
}
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
             "din_attention_pool": cuda_dinatt.din_attention_pool}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def launches() -> dict:
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


def reset_launches() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0


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


def bound_of(flops: float, nbytes: float):
    """(bound_ms, bound_by) for this work on the card's peaks."""
    t_ops, t_bytes = flops / PEAK_F32_FLOP_S * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def topk_bound(name: str, U: int, I: int, D: int, k: int):
    out_bytes = U * k * (4 + 4)
    if name == "topk_serve_matmul":  # float32 FMA work; P, Q, seen (1 byte), outputs
        return bound_of(2 * U * I * D, U * D * 4 + I * D * 4 + U * I + out_bytes)
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


def check_topk(name: str, U: int, I: int, D: int, k: int, gen: torch.Generator) -> dict:
    dev = DEVICE
    seen = fewer_than_k(torch.rand((U, I), generator=gen, device=dev) < SEEN_DENSITY)
    kernel, plain = getattr(topk, name), getattr(topk, f"{name}_plain")
    if name == "topk_serve_matmul":
        p_int = torch.randint(-3, 4, (U, D), generator=gen, device=dev).float()
        q_int = torch.randint(-3, 4, (I, D), generator=gen, device=dev).float()
        P = torch.randn((U, D), generator=gen, device=dev)
        Q = torch.randn((I, D), generator=gen, device=dev)
        int_args, args = (p_int, q_int, seen), (P, Q, seen)
        masked = torch.where(seen, NEG_INF, P @ Q.T)

        def library():
            return torch.topk(torch.where(seen, NEG_INF, torch.matmul(P, Q.T)), k)
    else:
        s_int = torch.randint(-20, 21, (U, I), generator=gen, device=dev).float()
        S = torch.randn((U, I), generator=gen, device=dev)
        int_args, args = (s_int, seen), (S, seen)
        masked = torch.where(seen, NEG_INF, S)

        def library():
            return torch.topk(torch.where(seen, NEG_INF, S), k)

    got_int = kernel(*int_args, k=k)
    check_exact(name, got_int, plain(*int_args, k=k))
    lowest_seen = [i for i in range(k + 1) if i != 5][: k - 3]
    if got_int[1][0, 3:].tolist() != lowest_seen or got_int[0][0, 3].item() > NEG_INF / 2:
        raise AssertionError(f"{name}: the masked slots of user 0 are not its lowest seen ids")
    got = kernel(*args, k=k)
    torch.cuda.synchronize()
    err = check_close(name, got, plain(*args, k=min(k + 1, I)), masked)
    t_bound, bound_by = topk_bound(name, U, I, D, k)
    row = {
        "shape": {"users": U, "items": I, "dim": D, "k": k} if name == "topk_serve_matmul"
        else {"users": U, "items": I, "k": k},
        "exact_on_integer_inputs": True,
        "max_abs_err": err,
        "kernel_ms": time_ms(lambda: kernel(*args, k=k)),
        "plain_ms": time_ms(lambda: plain(*args, k=k)),
        "library_ms": time_ms(library),
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


def lookup_times(kernel, plain, library, launcher) -> dict:
    """kernel_ms, plain_ms, library_ms, host_us and library_host_us of a
    lookup row (see LOOKUP_INTERLEAVE_MS)."""
    times = {"kernel_ms": time_ms(kernel, LOOKUP_BUDGET_MS),
             "plain_ms": time_ms(plain, LOOKUP_BUDGET_MS)}
    if times["kernel_ms"] < LOOKUP_INTERLEAVE_MS:
        fns = {"kernel_ms": kernel, "library_ms": library}
        runs = {key: [] for key in fns}
        for i in range(LOOKUP_RUNS):
            for key in (("kernel_ms", "library_ms") if i % 2 == 0 else ("library_ms", "kernel_ms")):
                runs[key].append(time_ms(fns[key], LOOKUP_BUDGET_MS))
        times.update({key: statistics.median(v) for key, v in runs.items()},
                     timing=f"median of {LOOKUP_RUNS} interleaved runs")
    else:
        times.update(library_ms=time_ms(library, LOOKUP_BUDGET_MS), timing="one run")
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
               gen: torch.Generator) -> dict:
    """onehot_grad against its plain version: exact on integer cotangents;
    on normal ones both within the float32 summation bound of the exact sums."""
    N = ids.shape[0]
    g_int = torch.randint(-8, 9, (N, D), generator=gen, device=DEVICE).to(dtype)
    if not torch.equal(gat.onehot_grad(ids, g_int, V), gat.onehot_grad_plain(ids, g_int, V)):
        raise AssertionError(f"onehot_grad ({table_name}): kernel != plain on integer cotangents")
    g = torch.randn((N, D), generator=gen, device=DEVICE).to(dtype)
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


def mf_epoch_bound(B: int, U: int, I: int, D: int, epochs: int):
    """(bound_ms, bound_by) of ``epochs`` fused MF epochs: uid, iid, y and the
    two initial tables read once, the two tables and the losses written once;
    per row and epoch the dot product (2D), BCE and sigmoid (20) and the two
    gradient rows and their sums (4D), and per table value and epoch Adam (15)."""
    flops = epochs * (B * (6 * D + 20) + 15 * (U + I) * D)
    nbytes = B * (4 + 4 + 4) + 2 * (U + I) * D * 4 + epochs * 4
    return bound_of(flops, nbytes)


def check_mf_epoch(batch, U: int, I: int, dtype: str, gen: torch.Generator,
                   timed_epochs: int) -> dict:
    """mf_fullbatch_train against its plain version over MF_CHECK_EPOCHS epochs
    at the MF training shape; times per epoch."""
    (uid, iid), y = batch
    D = EMBEDDING_DIM
    pu0 = 0.1 * torch.randn((U, D), generator=gen, device=DEVICE)
    pi0 = 0.1 * torch.randn((I, D), generator=gen, device=DEVICE)
    args = (uid, iid, y, pu0, pi0)
    got = mfe.mf_fullbatch_train(*args, MF_CHECK_EPOCHS, 0.01, 1e-5, dtype)
    want = mfe.mf_fullbatch_train_plain(*args, MF_CHECK_EPOCHS, 0.01, 1e-5, dtype)
    rtol, atol = MF_TOL[dtype]
    torch.testing.assert_close(got[2], want[2], rtol=rtol, atol=0)
    for g_t, w_t in zip(got[:2], want[:2]):
        torch.testing.assert_close(g_t, w_t, rtol=0, atol=atol)
    err = max(float((g_t - w_t).abs().max()) for g_t, w_t in zip(got, want))
    B = uid.shape[0]
    E = timed_epochs

    pu = pu0.clone().requires_grad_(True)
    pi = pi0.clone().requires_grad_(True)
    opt = torch.optim.Adam([pu, pi], lr=0.01, weight_decay=1e-5)

    def library_epoch():  # one autograd epoch with torch.optim.Adam
        opt.zero_grad(set_to_none=True)
        z = (pu[uid] * pi[iid]).sum(dim=1)
        F.binary_cross_entropy_with_logits(z, y).backward()
        opt.step()

    t_bound, bound_by = mf_epoch_bound(B, U, I, D, E)
    return {
        "shape": {"rows": B, "users": U, "items": I, "dim": D, "compute_dtype": dtype,
                  "epochs_per_call": E},
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
    read once and w and the losses written once, for the whole call. Operations
    per epoch: the row's score and its gradient (2 per column each, the dense
    product counted whole in the wide mode), 20 for the loss and g, 15 per
    weight for Adam."""
    nbytes = sum(t.numel() * t.element_size() for t in args) + args[-1].numel() * 4 + epochs * 4
    if mode == "wide":
        (B, F), cols = args[0].shape, args[0].shape[1]
    else:
        B, cols = args[2].shape[0], args[2].shape[1] + 2
        F = args[-1].numel()
    return bound_of(epochs * (B * (4 * cols + 20) + 15 * F), nbytes)


def check_lr(model, params, x, y, mode: str, learning_rate: float, timed_epochs: int) -> dict:
    """A fused LR trainer against its plain version over LR_CHECK_EPOCHS epochs at
    the LR train batch, as ``fast_fit`` feeds it; times per epoch."""
    U, I = model.spec.num_users, model.spec.num_items
    args = model.fused_inputs(params, x, y, mode)
    if mode == "compact":
        kernel, plain, extra = lre.lr_fullbatch_train_compact, lre.lr_fullbatch_train_compact_plain, (U, I)
    else:
        kernel, plain, extra = lre.lr_fullbatch_train, lre.lr_fullbatch_train_plain, ()
    got = kernel(*args, LR_CHECK_EPOCHS, learning_rate, *extra)
    want = plain(*args, LR_CHECK_EPOCHS, learning_rate, *extra)
    torch.testing.assert_close(got[1], want[1], rtol=LR_TOL[0], atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=LR_TOL[1])
    err = max(float((g_t - w_t).abs().max()) for g_t, w_t in zip(got, want))

    w = args[-1].reshape(-1).clone().requires_grad_(True)
    if mode == "compact":
        uid, iid, dense, yy, _ = args

        def loss():
            return F.binary_cross_entropy_with_logits(w[uid] + w[U + iid] + dense @ w[U + I:], yy)
    else:
        x_aug, yy, _ = args

        def loss():
            return F.binary_cross_entropy_with_logits(x_aug @ w, yy)

    E = timed_epochs
    t_bound, bound_by = lr_bound(mode, args, E)
    return {
        "shape": {"rows": int(y.shape[0]), "users": U, "items": I,
                  "columns": int(args[0].shape[1]) if mode == "wide" else int(args[2].shape[1]),
                  "mode": mode, "epochs_per_call": E},
        "unit": "per epoch",
        "max_abs_err": err,
        "kernel_ms": time_ms(lambda: kernel(*args, E, learning_rate, *extra)) / E,
        "plain_ms": time_ms(lambda: plain(*args, E, learning_rate, *extra)) / E,
        "library_ms": time_ms(library_epoch([w], loss, learning_rate)),
        "library": "one eager autograd epoch with torch.optim.Adam",
        "bound_ms": t_bound / E, "bound_by": bound_by,
    }


def afm_work(B: int, D: int, A: int, backward: bool):
    """(operations, bytes) of the AFM pool on B rows. Forward, per row and pair:
    the product c (D), c W (2 D A), the bias, relu and dot with h (4 A), the pool
    (2 D); the softmax 45 a row. Backward: the forward again, then per pair g . c
    (2 D), dz, dh and db (5 A), dW (D + 2 D A), dc (2 D A + 2 D) and de (4 D)."""
    ops = B * (15 * (2 * D * A + 4 * A + 3 * D) + 45)
    params = (D * A + 2 * A) * 4
    if not backward:
        return ops, B * 6 * D * 4 + B * D * 4 + params
    ops += B * 15 * (4 * D * A + 9 * D + 5 * A)
    return ops, 2 * B * 6 * D * 4 + B * D * 4 + 2 * params


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
        library, lib_name = afm_library_bwd, "eager composition's autograd (forward included)"
    else:
        args, kernel, plain = (fields, W, b, h), afm.afm_attention_pool, afm.afm_attention_pool_plain
        err = normwise_err("afm_attention_pool", kernel(*args), plain(*args), AFM_FWD_RTOL)
        library, lib_name = afm_library_fwd, "eager: pair products, torch.matmul for c @ W, softmax, torch.bmm"
    torch.cuda.synchronize()
    t_bound, bound_by = bound_of(*afm_work(B, D, A, backward))
    row = {
        "shape": {"rows": B, "fields": 6, "dim": D, "attention": A, "batch": label},
        "max_abs_err": err,
        "kernel_ms": time_ms(lambda: kernel(*args)),
        "plain_ms": time_ms(lambda: plain(*args)),
        "library_ms": time_ms(lambda: library(*args)),
        "library": lib_name,
        "bound_ms": t_bound, "bound_by": bound_by,
    }
    del fields, g
    torch.cuda.empty_cache()
    return row


def din_work(B: int, L: int, D: int, A: tuple, F: tuple, part: str):
    """(operations, bytes) of a DIN kernel on B rows of L positions. Forward,
    per row: t @ wt (2 D A1); per position h @ wh (2 D A1), the t term, bias
    and relu (3 A1), the second layer (2 A1 A2 + 2 A2) and the score (2 A2);
    the softmax (4 L) and the pool (2 L D); for the head, the fc
    (2 (2D) F1 + 2 F1 + 2 F1 F2 + 2 F2 + 2 F2 + 1). The pool kernel has no fc
    and no last bias. Backward: the forward again, twice the forward's products
    (d input and d weight), and per position 6 A1 + 5 A2 + 6 D, per row
    6 F1 + 4 F2 + 6 D for the masks, sums and the softmax's backward."""
    A1, A2 = A[0], A[1]
    F1, F2 = F[0], F[1]
    att_mm = 2 * D * A1 + L * (2 * D * A1 + 2 * A1 * A2 + 2 * A2)
    att_ops = att_mm + L * (3 * A1 + 2 * A2) + 4 * L + 2 * L * D
    att_w = 2 * D * A1 + A1 + A1 * A2 + A2 + A2
    if part == "pool":
        return B * att_ops, 4 * (B * L * D + B * D + att_w + B * D)
    fc_mm = 2 * 2 * D * F1 + 2 * F1 * F2 + 2 * F2
    fwd = att_ops + fc_mm + 2 * F1 + 4 * F2 + 1 + L  # + b3 on each score
    weights = att_w + 1 + 2 * D * F1 + F1 + F1 * F2 + F2 + F2 + 1
    if part == "fwd":
        return B * fwd, 4 * (B * L * D + B * D + weights + B)
    bwd = fwd + 2 * (att_mm + 2 * L * D + fc_mm) + L * (6 * A1 + 5 * A2 + 6 * D) + 6 * F1 + 4 * F2 + 6 * D
    return B * bwd, 4 * (2 * (B * L * D + B * D) + B + 2 * weights)


def din_library_fwd(hist, tgt, att, fc):
    """The eager composition: attention_pool and mlp, torch.matmul throughout."""
    return mlp(fc, torch.cat([attention_pool(att, hist, tgt), tgt], dim=-1))[:, 0]


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


def away_from_kinks(hist, tgt, weights) -> torch.Tensor:
    """[B] bool: rows none of whose relu inputs (z1, z2, f1 and f2 before the
    relu, in float64) lies within DIN_KINK of its layer's largest |value|."""
    wh, wt, b1, w2, b2, w3, b3, u1p, u1t, c1, u2, c2, u3, c3 = (w.double() for w in weights)
    h, t = hist.double(), tgt.double()
    z1 = h @ wh + (t @ wt + b1)[:, None, :]
    z2 = torch.relu(z1) @ w2 + b2
    w = torch.softmax((torch.relu(z2) @ w3 + b3)[..., 0], dim=-1)
    y1 = torch.einsum("bl,bld->bd", w, h) @ u1p + t @ u1t + c1
    y2 = torch.relu(y1) @ u2 + c2
    ok = torch.ones(h.shape[0], dtype=torch.bool, device=h.device)
    for z in (z1, z2, y1, y2):
        z = z.abs().reshape(h.shape[0], -1)
        ok &= (z > DIN_KINK * z.max()).all(dim=1)
    return ok


def check_din(part: str, B: int, L: int, D: int, A: tuple, F: tuple, gen: torch.Generator,
              label: str) -> dict:
    """A DIN kernel ("fwd", "bwd": the fused head; "pool": the attention pool)
    against its plain version on B rows at the model's scale."""
    hist, tgt, att, fc, g = din_inputs(B, L, D, A, F, gen)
    weights = dh.din_head_weights(att, fc, D)
    if part == "fwd":
        args, kernel, plain = (hist, tgt, weights), dh.din_head_fwd, dh.din_head_fwd_plain
        err = normwise_err("din_head_fused", kernel(*args), plain(*args), DIN_FWD_RTOL)
        library, lib_args = din_library_fwd, (hist, tgt, att, fc)
        lib_name = "eager: attention_pool and mlp, torch.matmul"
    elif part == "bwd":
        args, kernel, plain = (hist, tgt, weights, g), dh.din_head_bwd, dh.din_head_bwd_plain
        smooth = away_from_kinks(hist, tgt, weights)
        kinked = int((~smooth).sum())
        if kinked > B // 20:
            raise AssertionError(f"din_head_fused_bwd: {kinked} of {B} rows at a relu kink")
        sub = (hist[smooth].contiguous(), tgt[smooth].contiguous(), weights, g[smooth].contiguous())
        got, want = kernel(*sub), plain(*sub)
        names = ("hist", "target") + dh.WEIGHT_NAMES
        errs = []
        for n, gt, wt in zip(names, got, want):
            if n == "b3":  # the sum of ds: 0 up to rounding in both versions
                e = float((gt - wt).abs().max())
                if not e <= DIN_DB3_ATOL * float(sub[3].abs().sum()):
                    raise AssertionError(f"din_head_fused_bwd db3: off by {e}")
                errs.append(e)
            else:
                errs.append(normwise_err(f"din_head_fused_bwd d{n}", gt, wt, DIN_BWD_RTOL))
        err = max(errs)
        del sub, got, want
        library, lib_args = din_library_bwd, (hist, tgt, att, fc, g)
        lib_name = "eager composition's autograd (forward included)"
    else:
        args, kernel, plain = (hist, tgt, att), dinatt.din_attention_pool, dinatt.din_attention_pool_plain
        err = normwise_err("din_attention_pool", kernel(*args), plain(*args), DIN_FWD_RTOL)
        library, lib_args = (lambda h, t, a: attention_pool(a, h, t)), (hist, tgt, att)
        lib_name = "eager attention_pool (the plain version itself)"
    torch.cuda.synchronize()
    t_bound, bound_by = bound_of(*din_work(B, L, D, A, F, part))
    row = {
        "shape": {"rows": B, "history": L, "dim": D, "attention": list(A), "fc": list(F),
                  "batch": label},
        "max_abs_err": err,
        **({"rows_at_a_kink": kinked} if part == "bwd" else {}),
        "kernel_ms": time_ms(lambda: kernel(*args)),
        "plain_ms": time_ms(lambda: plain(*args)),
        "library_ms": time_ms(lambda: library(*lib_args)),
        "library": lib_name,
        "bound_ms": t_bound, "bound_by": bound_by,
    }
    del hist, tgt, g, args, lib_args
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
                                   "onehot_grad": E * 2, "mf_fullbatch_train": E * 2})
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
                                "lr_fullbatch_train": 2 * E, "lr_fullbatch_train_compact": 2 * E})
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
                                 "gather_rows": 4 * forwards, "onehot_grad": 4 * E})
    if set(res.history) != HISTORY_KEYS:
        raise AssertionError(f"afm: history keys {sorted(res.history)}")
    loss = res.history["train_loss"]
    if not (np.isfinite(loss).all() and loss[-1] < loss[0]):
        raise AssertionError(f"afm: the train loss did not fall: {loss.tolist()}")

    # the CPU reference: Trainer.fit over the same batches from the same initial
    # weights (plain versions), without the full-catalog ranking
    batches = split_batches(cfg, ds, "cpu")
    cpu = Trainer(build_model(cfg, ds),
                  TrainConfig(learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
                              epochs=E, track_metrics=True, compute_dtype=cfg.compute_dtype),
                  device="cpu").fit(batches["train"], valid=batches["valid"], test=batches["test"])
    worst = compare_histories("afm", res.history, {k: v.numpy() for k, v in cpu.history.items()},
                              res.extras, cpu.extras)
    # the catalog scores of one tile of users under the card's trained weights
    model = build_model(cfg, ds)
    model.load_state_dict({k: v.cpu() for k, v in res.params.items()})
    tile = ServingContext(torch.from_numpy(ds.user_features[:CATALOG_TILE]),
                          torch.from_numpy(ds.item_features))
    with torch.no_grad():
        want = model.score_catalog(tile)
        got = model.to(DEVICE).score_catalog(tile.to(DEVICE)).cpu()
    catalog_err = normwise_err("afm catalog tile", got, want, AFM_FWD_RTOL)
    return {"phase": "afm", "config": f"afm preset (embedding 128, attention 64), {E} epochs",
            "rows": res.train_examples, "epochs": E,
            "train_loss": [float(loss[0]), float(loss[-1])],
            "ranking_test@10": res.ranking["test@10"], "extras": res.extras,
            "wall_s": wall_s, "train_time_s": res.train_time_s,
            "max_rel_loss_diff_vs_cpu": worst,
            "catalog_tile_max_abs_err_vs_cpu": catalog_err, "launches": counts}


def recommend_scores(port, rec, users, k, single=False) -> dict:
    """One /v1/recommend request to a non-factored model, held against the
    stable top-k of the server's masked catalog scores (``rec.scores``, which
    ``run_serve_feature`` holds against the model's own scores)."""
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


def run_serve_feature(ds: MovieLens100K, data_dir: str, name: str, epochs: int,
                      seed: int = 0) -> dict:
    args = serve_cli.parser().parse_args(["--model", name, "--data", data_dir, "--epochs",
                                          str(epochs), "--port", "0", "--seed", str(seed)])
    reset_launches()  # the main path's run starts here
    server = serve_cli.build_server(args).serve_background()
    try:
        rec = server.recommender
        health = http(server.port, "GET", "/healthz")
        if (health["num_users"], health["num_items"]) != (ds.num_users, ds.num_items):
            raise AssertionError(f"/healthz: {health}")
        rng = np.random.default_rng(seed)
        batch = sorted(rng.choice(ds.num_users, 32, replace=False).tolist())
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
        counts = launches()  # ... and ends here
        stats = http(server.port, "GET", "/v1/stats")
        with torch.no_grad():  # the served scores are the trained model's, masked
            if not torch.equal(rec.scores, torch.where(rec.seen, NEG_INF,
                                                       rec.model.score_catalog(rec.ctx))):
                raise AssertionError(f"serve_{name}: the served scores are not the model's")
    finally:
        server.shutdown()
    tiles = n_tiles(ds)
    if name == "lr":  # training forwards, the ranking eval's and the server's catalog scoring
        want = {"gather_rows": 2 * (epochs + 2 * tiles), "onehot_grad": 2 * epochs,
                "topk_serve_matmul": 3}
    else:
        want = {"afm_attention_pool": epochs + 2 * tiles, "afm_attention_pool_bwd": 2 * epochs,
                "gather_rows": 4 * (epochs + 2 * tiles), "onehot_grad": 4 * epochs}
    check_counts(f"serve_{name}", counts, want)
    return {"phase": f"serve_{name}",
            "entry_point": f"cli/serve.py::build_server --model {name} --epochs {epochs}",
            "requests": requests, "launches": counts, "stats": stats}


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
    check_counts("din", counts, {"din_head_fused": forwards, "din_head_fused_bwd": 3 * E,
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
    check_counts("serve_din", counts, {"din_head_fused": epochs, "din_head_fused_bwd": 3 * epochs,
                                       "din_attention_pool": 0, "onehot_grad": 2 * epochs})
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
            "serving": "full histories (masked plain-torch route)",
            "longest_history": len(full[longest]), "wall_s": wall_s,
            "full_history_max_abs_err_vs_cpu": full_err,
            "requests": requests, "launches": counts, "stats": stats}


# ---------------------------------------------------------------- main

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
        del lookups, table, din_hist, din_y, lr_user, lr_item
        for dtype in ("float32", "bfloat16"):
            rows["mf_fullbatch_train"].append(
                check_mf_epoch(batch, ds.num_users, ds.num_items, dtype, gen, TRAIN_EPOCHS))
            emit({"phase": "kernel_check", "kernel": "mf_fullbatch_train",
                  **rows["mf_fullbatch_train"][-1]})
        del batch, uid, iid
        torch.cuda.empty_cache()

        rows["topk_serve_matmul"].append(check_topk("topk_serve_matmul", *LR_SERVING_SHAPE, gen))
        emit({"phase": "kernel_check", "kernel": "topk_serve_matmul", **rows["topk_serve_matmul"][-1]})
        for mode, name in (("wide", "lr_fullbatch_train"), ("compact", "lr_fullbatch_train_compact")):
            rows[name].append(check_lr(lr_model, lr_model.params(), x, y, mode,
                                       lr_cfg.learning_rate, TRAIN_EPOCHS))
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
        din_dims = (din_cfg.hist_len, din_cfg.model_kwargs["embed_size"], DIN_ATTENTION, DIN_FC)
        for name, part, B, label in (
                ("din_head_fused", "fwd", din_rows, "train batch"),
                ("din_head_fused_bwd", "bwd", din_rows, "train batch"),
                ("din_attention_pool", "pool", HISTORY_TILE * ds.num_items,
                 f"window tile of {HISTORY_TILE} users")):
            rows[name].append(check_din(part, B, *din_dims, gen, label))
            emit({"phase": "kernel_check", "kernel": name, **rows[name][-1]})
        torch.cuda.empty_cache()
        emit({"phase": "kernel_checks", "seconds": time.perf_counter() - t0})

        phases = [run_train(ds), run_serve(ds, tmp), run_slice(ds), run_lr(ds), run_afm(ds),
                  run_serve_feature(ds, tmp, "lr", TRAIN_EPOCHS),
                  run_serve_feature(ds, tmp, "afm", AFM_EPOCHS), run_din(ds),
                  run_serve_din(ds, tmp, DIN_EPOCHS)]
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
            "library_ms": main_row["library_ms"], "shape": main_row["shape"],
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
