#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Every phase is fatal: any failure raises, the script exits non-zero and prints
no result line.

1. device  -- the card's name and power limit, as nvidia-smi gives them;
2. build   -- nvcc builds every kernel of the serving path from ``csrc/``;
3. kernels -- each kernel against its plain PyTorch version on the card, at the
   MF serving shapes and the JAX package's large-catalog shape: integer-valued
   inputs must agree exactly (ties included), normal inputs within a stated
   tolerance; one user has fewer unseen items than k. Times of the kernel,
   its plain version and one PyTorch library call, beside the card's bound;
4. slice   -- the MF serving path through the entry points a user calls: a
   synthetic ml-100k-format dataset, ``MatrixFactorization(943, 1682, 64)``
   from a seeded generator, ``Recommender`` behind ``RecommenderServer``,
   answering HTTP requests. Each answer is held against the plain version on
   the card, and the kernels' launch counts show the requests went through
   them.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line before
it is the card's name and power limit.
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
from torch import nn

from deeplearningrecommendationsystem_tpu_torch.data import MovieLens100K, write_ml100k_format
from deeplearningrecommendationsystem_tpu_torch.models import MatrixFactorization, ServingContext
from deeplearningrecommendationsystem_tpu_torch.ops import serving_topk as topk
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import build
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import serving_topk as cuda_topk
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
# Values within RTOL of the row's largest |score| count as equal (float32 sums
# in another order than cuBLAS); integer-valued inputs must agree exactly.
RTOL = 1e-4
EMBEDDING_DIM = 64
SEEN_DENSITY = 100_000 / (943 * 1682)  # ml-100k: every rating is a seen item
# (users, items, dim, k): all users of the MF preset, one batched request of
# the slice below, and the JAX package's large-catalog serving shape
KERNEL_SHAPES = [(943, 1682, EMBEDDING_DIM, 50), (32, 1682, EMBEDDING_DIM, 50),
                 (2048, 131072, EMBEDDING_DIM, 50)]
SOURCE = "deeplearningrecommendationsystem_tpu_torch/csrc/serving_topk.cu"
PALLAS = "deeplearningrecommendationsystem_tpu/ops/pallas/serving_topk.py"
KERNELS = {
    "topk_serve_matmul": {"route": "cuda", "source": SOURCE, "replaces": f"{PALLAS}:137"},
    "topk_scores": {"route": "cuda", "source": SOURCE, "replaces": f"{PALLAS}:236"},
}
LAUNCHERS = {"topk_serve_matmul": cuda_topk.topk_serve_matmul,
             "topk_scores": cuda_topk.topk_scores}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def bound(name: str, U: int, I: int, D: int, k: int):
    """(bound_ms, bound_by) of ``name`` at this shape on the card's peaks."""
    out_bytes = U * k * (4 + 4)
    if name == "topk_serve_matmul":
        flops = 2 * U * I * D  # float32 FMA work of the scores
        nbytes = U * D * 4 + I * D * 4 + U * I + out_bytes  # P, Q, seen (1 byte), outputs
    else:
        flops = U * I  # one compare per score
        nbytes = U * I * 4 + U * I + out_bytes  # scores, seen, outputs
    t_ops, t_bytes = flops / PEAK_F32_FLOP_S * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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


def check_kernel(name: str, U: int, I: int, D: int, k: int, gen: torch.Generator) -> dict:
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
    t_bound, bound_by = bound(name, U, I, D, k)
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


# ---------------------------------------------------------------- phase 4

class CatalogOnly(nn.Module):
    """An MF model seen as a non-factored one: ``score_catalog`` and no
    ``serving_factors``, so ``Recommender.top_k`` takes its score-matrix branch."""

    def __init__(self, model: MatrixFactorization):
        super().__init__()
        self.inner = model

    def score_catalog(self, ctx: ServingContext) -> torch.Tensor:
        return self.inner.score_catalog(ctx)


_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # localhost only


def http(port: int, method: str, path: str, body=None) -> dict:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with _OPENER.open(req, timeout=120) as resp:
        if resp.status != 200:
            raise AssertionError(f"{method} {path} answered {resp.status}")
        return json.loads(resp.read())


def launches() -> dict:
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


def run_slice(seed: int = 0) -> dict:
    dev = DEVICE
    tmp = tempfile.mkdtemp(prefix="ml100k_synthetic_")
    try:
        ds = MovieLens100K(write_ml100k_format(tmp, seed=seed), seed=seed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seen_np = ds.seen_mask(ds.train, ds.valid, ds.test)
    model = MatrixFactorization(ds.num_users, ds.num_items, EMBEDDING_DIM,
                                generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    ctx = ServingContext(torch.from_numpy(ds.user_features), torch.from_numpy(ds.item_features))
    rec = Recommender(model, ctx, seen=seen_np, device=dev)
    fused = Recommender(CatalogOnly(model), ctx, seen=seen_np, use_pallas="fused", device=dev)
    servers = [RecommenderServer(rec).serve_background(),
               RecommenderServer(fused).serve_background()]
    port, fused_port = servers[0].port, servers[1].port
    P, Q = model.user.detach(), model.item.detach()
    seen = rec.seen
    masked = torch.where(seen, NEG_INF, P @ Q.T)
    rng = np.random.default_rng(seed)
    requests = []
    try:
        for name in LAUNCHERS:  # the main path's run starts here
            LAUNCHERS[name].launches = 0
        health = http(port, "GET", "/healthz")
        if (health["num_users"], health["num_items"]) != (943, 1682):
            raise AssertionError(f"/healthz: {health}")

        def recommend(users, k, single=False):
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
            if bool(torch.gather(seen[u], 1, gi.long()).any()):
                raise AssertionError("recommend: a seen item was recommended")
            want = topk.topk_serve_matmul_plain(P[u], Q, seen[u], k=k + 1)
            err = check_close("slice", (gv, gi), want, masked[u])
            requests.append({"request": f"{'GET' if single else 'POST'} /v1/recommend",
                             "users": len(users), "k": k, "max_abs_err": err})

        recommend([12], 10, single=True)
        recommend(sorted(rng.choice(ds.num_users, 32, replace=False).tolist()), 50)
        recommend(list(range(ds.num_users)), 50)

        items = rng.choice(ds.num_items, 20, replace=False).tolist()
        got = torch.tensor(http(port, "POST", "/v1/score", {"user": 3, "items": items})["scores"],
                           device=dev)
        want = masked[3, items]
        if not bool(((got - want).abs() <= RTOL * scale(masked[3])).all()):
            raise AssertionError("/v1/score disagrees with the plain scores")
        requests.append({"request": "POST /v1/score", "items": len(items)})

        # the non-factored branch of Recommender.top_k: the topk_scores kernel
        users = list(range(0, ds.num_users, 7))
        before = launches()
        out = http(fused_port, "POST", "/v1/recommend", {"users": users, "k": 50})
        after = launches()
        if after["topk_scores"] - before["topk_scores"] != 1:
            raise AssertionError(f"fused recommend: launches {before} -> {after}")
        want_v, want_i = topk.topk_scores_plain(fused.scores[users], torch.zeros_like(seen[users]), 50)
        if out["items"] != want_i.tolist() or out["scores"] != want_v.tolist():
            raise AssertionError("fused recommend: topk_scores != its plain version")
        requests.append({"request": "POST /v1/recommend (use_pallas='fused', non-factored)",
                         "users": len(users), "k": 50})
        counts = launches()  # the main path's run ends here
        stats = http(port, "GET", "/v1/stats")
    finally:
        for s in servers:
            s.shutdown()
    return {"phase": "slice", "dataset": {"users": ds.num_users, "items": ds.num_items,
                                          "ratings": int(len(ds.data["user"]))},
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

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    shapes = {name: [] for name in KERNELS}
    for U, I, D, k in KERNEL_SHAPES:
        for name in KERNELS:
            row = check_kernel(name, U, I, D, k, gen)
            shapes[name].append(row)
            emit({"phase": "kernel_check", "kernel": name, **row})

    emit(run_slice(seed=0))
    counts = launches()

    lines = []
    for name, meta in KERNELS.items():
        if counts[name] < 1:
            raise AssertionError(f"{name} was not launched on the main path")
        main_row = shapes[name][0]  # all 943 users of the MF preset
        lines.append({
            "name": name, **meta, "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in shapes[name]),
            "ms": main_row["kernel_ms"], "kernel_ms": main_row["kernel_ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "shape": main_row["shape"],
            "at_shapes": shapes[name],
        })
    emit({"kernels": lines})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
