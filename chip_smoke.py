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
   bound;
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
   HTTP, through both top-k kernels.

Phases 4-6 are the main paths: each sets the launch counts to 0 just before
it and reads them just after. The last line of stdout is
``{"ok": true, "device": {...}}``; the line before it is the card's name and
power limit, and the line before that the ``kernels`` line.
"""

from __future__ import annotations

import json
import shutil
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
from deeplearningrecommendationsystem_tpu_torch.experiments import build_model, run_experiment
from deeplearningrecommendationsystem_tpu_torch.models import MatrixFactorization, ServingContext
from deeplearningrecommendationsystem_tpu_torch.ops import gather as gat
from deeplearningrecommendationsystem_tpu_torch.ops import mf_epoch as mfe
from deeplearningrecommendationsystem_tpu_torch.ops import serving_topk as topk
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import build
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import gather as cuda_gather
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import mf_epoch as cuda_mfe
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import serving_topk as cuda_topk
from deeplearningrecommendationsystem_tpu_torch.sampling import NegativeSampler
from deeplearningrecommendationsystem_tpu_torch.server import RecommenderServer
from deeplearningrecommendationsystem_tpu_torch.serving import Recommender

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
}
LAUNCHERS = {"topk_serve_matmul": cuda_topk.topk_serve_matmul,
             "topk_scores": cuda_topk.topk_scores,
             "gather_rows": cuda_gather.gather_rows,
             "onehot_grad": cuda_gather.onehot_grad,
             "mf_fullbatch_train": cuda_mfe.mf_fullbatch_train}


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


def check_gather(table_name: str, table: torch.Tensor, ids: torch.Tensor) -> dict:
    """gather_rows_kernel against its plain version: bit-equal on any input."""
    got = gat.gather_rows_kernel(table, ids)
    if not torch.equal(got, gat.gather_rows_kernel_plain(table, ids)):
        raise AssertionError(f"gather_rows ({table_name}): kernel != plain version")
    (V, D), B = table.shape, ids.shape[0]
    es = table.element_size()
    t_bound, bound_by = bound_of(0, B * D * es + B * ids.element_size() + V * D * es)
    return {
        "shape": {"table": table_name, "vocab": V, "dim": D, "ids": B,
                  "dtype": str(table.dtype).split(".")[1]},
        "exact": True, "max_abs_err": 0.0,
        "kernel_ms": time_ms(lambda: gat.gather_rows_kernel(table, ids)),
        "plain_ms": time_ms(lambda: gat.gather_rows_kernel_plain(table, ids)),
        "library_ms": time_ms(lambda: torch.index_select(table, 0, ids)),
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
        "kernel_ms": time_ms(lambda: gat.onehot_grad(ids, g, V)),
        "plain_ms": time_ms(lambda: gat.onehot_grad_plain(ids, g, V)),
        # index_add_ takes float32 sources only into a float32 table: bf16 pays a cast
        "library_ms": time_ms(lambda: torch.zeros((V, D), device=DEVICE).index_add_(
            0, ids64, g if g.dtype == torch.float32 else g.float())),
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


# ---------------------------------------------------------------- data

def make_dataset(path: str, seed: int = 0) -> MovieLens100K:
    return MovieLens100K(write_ml100k_format(path, seed=seed), seed=seed)


def train_batch(ds: MovieLens100K, cfg):
    """The train batch ``run_experiment`` builds for ``cfg``: the same sampler,
    seed and order, so the same negatives."""
    sampler = NegativeSampler(ds.seen_mask(ds.train, ds.valid, ds.test), seed=cfg.seed,
                              device=DEVICE)
    combined = MovieLens100K.concat_splits(ds.train, sampler.sample(cfg.negatives[0]))
    users = torch.from_numpy(combined["user"]).to(DEVICE)
    items = torch.from_numpy(combined["item"]).to(DEVICE)
    return (users, items), torch.from_numpy(combined["rating"]).to(DEVICE)


# ---------------------------------------------------------------- phase 4

HISTORY_KEYS = {f"{s}_{m}" for s in ("train", "valid", "test")
                for m in ("loss", "accuracy", "precision", "recall", "f1", "auc")}
HISTORY_KEYS.add("_param_checksum")


def run_train(ds: MovieLens100K) -> dict:
    cfg = PRESETS["mf"].replace(epochs=TRAIN_EPOCHS)
    batch = train_batch(ds, cfg)
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
    want = {"gather_rows": E * 6 + 6,  # train, valid, test lookups per epoch; final AUCs
            "onehot_grad": E * 2, "mf_fullbatch_train": E * 2}
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"train: {name} launched {counts[name]} times, expected {n}")
    if set(res.history) != HISTORY_KEYS:
        raise AssertionError(f"train: history keys {sorted(res.history)}")
    loss = res.history["train_loss"]
    if not (np.isfinite(loss).all() and loss[-1] < loss[0] - 0.05):
        raise AssertionError(f"train: the train loss did not fall: {loss.tolist()}")

    cpu = run_experiment(cfg, data=ds, device="cpu")  # plain versions on the CPU
    worst = {}
    for key in ("train_loss", "valid_loss", "test_loss"):
        np.testing.assert_allclose(res.history[key], cpu.history[key], rtol=TRAIN_LOSS_RTOL,
                                   err_msg=key)
        worst[key] = float(np.max(np.abs(res.history[key] / cpu.history[key] - 1)))
    for key, v in res.extras.items():
        if abs(v - cpu.extras[key]) > TRAIN_AUC_ATOL:
            raise AssertionError(f"train: {key} {v} on the card, {cpu.extras[key]} on the CPU")
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
    want = {"gather_rows": 2 * E, "onehot_grad": 2 * E, "topk_serve_matmul": 3}
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"serve: {name} launched {counts[name]} times, expected {n}")
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
        rows = {name: [] for name in KERNELS}
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        for U, I, D, k in KERNEL_SHAPES:
            for name in ("topk_serve_matmul", "topk_scores"):
                rows[name].append(check_topk(name, U, I, D, k, gen))
                emit({"phase": "kernel_check", "kernel": name, **rows[name][-1]})

        batch = train_batch(ds, PRESETS["mf"])
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
        for dtype in ("float32", "bfloat16"):
            rows["mf_fullbatch_train"].append(
                check_mf_epoch(batch, ds.num_users, ds.num_items, dtype, gen, TRAIN_EPOCHS))
            emit({"phase": "kernel_check", "kernel": "mf_fullbatch_train",
                  **rows["mf_fullbatch_train"][-1]})
        del batch, uid, iid
        torch.cuda.empty_cache()

        phases = [run_train(ds), run_serve(ds, tmp), run_slice(ds)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for p in phases:
        emit(p)
    counts = {name: sum(p["launches"][name] for p in phases) for name in KERNELS}

    lines = []
    for name, meta in KERNELS.items():
        if counts[name] < 1:
            raise AssertionError(f"{name} was not launched on the main path")
        main_row = rows[name][0]  # the main path's shape: all MF users, or the user table
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
