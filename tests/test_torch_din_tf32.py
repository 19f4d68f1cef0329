"""The float32 DIN head's forward on the tensor cores (3xTF32 ``mma.sync``
m16n8k8: ``csrc/din_common.cuh::warp_mm_tf32``, ``block_mm_tf32``,
``Tf32Mat``; ``csrc/din_head.cu::din_head_fc_kernel``), modelled on the CPU,
where the CUDA code cannot run:

* B's fragments (``Tf32Mat``: W[k][n] and W[k + 1][n] split into TF32 hi and
  lo as they are read, u1 as u1p over u1t, zeros past K and N) and the
  warp's task lane by lane: A's permuted k slots, B's interleaved columns
  (column slot c of n8 tile j is column n0 + 2c + j), the C fragment read as
  four neighbouring columns of a row (``row4``), chunks of 8 k-steps summed
  apart, and rows and columns past the widths. On integer-valued inputs every
  product is exact, so the model must reproduce A @ W bit for bit; on normal
  inputs within 2^-20 of float64;
* a plain-torch emulation of the head's float32 forward with every product in
  3xTF32 (hi and lo by TF32 rounding of the bits) at a small size: it matches
  ``din_head_fwd_plain`` and the JAX ``din_head_fused`` (interpret mode) within
  1e-5 of the largest |logit| (``chip_smoke.py``'s ``DIN_FWD_RTOL``), and a
  single-pass TF32 emulation does not;
* the backward's products with a transposed B (``Tf32MatT``: dzf2 u2^T and
  dzf1 [u1p | u1t]^T in ``din_head_bwd_fc_head_kernel``) lane by lane, bit for
  bit on integers;
* the float32 backward split as the card runs it (the pooled rows, the fc
  head's backward, then the attention unit's from dpooled and dt alone): in
  float32 it matches ``din_head_bwd_plain`` and the Pallas backward
  (``_call_bwd``, interpret mode) within 1e-5 of each gradient's largest
  |value|; with the fc head's four products in 3xTF32 (relu inputs within
  the kernel's bound of 0 summed again in float32) it still does, and in
  single-pass TF32 it does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.ops.pallas.din_head import _call_bwd, din_head_fused
from deeplearningrecommendationsystem_tpu_torch.ops import din_head as dh
from deeplearningrecommendationsystem_tpu_torch.ops.linear import mlp_init

LIMIT = 1e-5  # DIN_FWD_RTOL
CHUNK = 8  # kTf32Chunk: k8 steps a chunk
COLS = 16  # kTf32Cols: columns of a warp's task


def _tf32(x) -> np.ndarray:
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(np.asarray(x, np.float32) - hi)


def _round(n, m):
    return -(-n // m) * m


# ---- B's fragments and one warp's task, lane by lane

def _frag(top, bottom, n, k):
    """Tf32Mat::frag: (hi, lo) of W[k][n] and W[k + 1][n], W = top over bottom
    (bottom may be None), zeros past K and N."""
    W = top if bottom is None else np.concatenate([top, bottom])
    K, N = W.shape
    x = W[k:k + 2, n] if n < N and k < K else np.zeros(2, np.float32)
    hi, lo = _split(x)
    return hi, lo


def _frag_t(top, bottom, n, k):
    """Tf32MatT::frag, B = W^T: (hi, lo) of W[n][k] and W[n][k + 1] (one 8-byte
    load of row n), W [N][K] = top over bottom, zeros past K and N."""
    W = top if bottom is None else np.concatenate([top, bottom])
    N, K = W.shape
    x = W[n, k:k + 2] if n < N and k < K else np.zeros(2, np.float32)
    return _split(x)


def _mma(acc, a, b):
    """acc [32][4] += A (16 x 8) B (8 x 8) from the lanes' fragments (PTX ISA
    m16n8k8 TF32): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
    b0 (t, g), b1 (t + 4, g); c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
    c3 (g + 8, 2t + 1). Exact products, one float32 rounding."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for reg, (r, c) in enumerate(((g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4))):
            A[r, c] = a[lane][reg]
        B[t, g], B[t + 4, g] = b[lane]
    C = A @ B
    for lane in range(32):
        g, t = divmod(lane, 4)
        acc[lane] = (acc[lane] + np.array([C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t],
                                           C[g + 8, 2 * t + 1]])).astype(np.float32)


def _warp_task(A, M, K, top, bottom, m0, n0, kmt, frag=_frag):
    """warp_mm_tf32: acc [kmt][2][32][4] for the m16 tiles m0 + 16 i and the 16
    columns n0 ..; A [rows][K'] with rows past M and columns past K holding
    garbage (NaN), which must never enter; B's fragments from ``frag``
    (Tf32Mat's, or Tf32MatT's for A @ W^T)."""
    acc = np.zeros((kmt, 2, 32, 4), np.float32)
    Kp = _round(K, 8)
    for kc in range(0, Kp, 8 * CHUNK):
        part = np.zeros_like(acc)
        for k0 in range(kc, min(Kp, kc + 8 * CHUNK), 8):
            bh = np.zeros((2, 32, 2), np.float32)
            bl = np.zeros_like(bh)
            for lane in range(32):
                g, t = divmod(lane, 4)
                for j in range(2):  # column slot g of n8 tile j: column n0 + 2g + j
                    bh[j, lane], bl[j, lane] = frag(top, bottom, n0 + 2 * g + j, k0 + 2 * t)
            for i in range(kmt):
                if m0 + 16 * i >= M:
                    break
                a = np.zeros((32, 4), np.float32)
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    k, ra = k0 + 2 * t, m0 + 16 * i + g
                    u = A[ra, k:k + 2] if ra < M and k < K else np.zeros(2, np.float32)
                    v = A[ra + 8, k:k + 2] if ra + 8 < M and k < K else np.zeros(2, np.float32)
                    a[lane] = [u[0], v[0], u[1], v[1]]
                ah, al = _split(a)
                for lo_a, lo_b in ((al, bh), (ah, bl), (ah, bh)):  # mma_3xtf32's passes
                    for j in range(2):
                        _mma(part[i, j], lo_a, lo_b[j])
        acc += part
    return acc


def _block_mm(A, M, K, W, kmt, bottom=None, frag=_frag):
    """block_mm_tf32: every (row < M, four columns < N) handed to the epilogue
    once, from row4 of the lanes' C fragments; returns (C, the epilogue's
    calls). W over bottom is B, or with ``frag=_frag_t`` its transpose (N the
    rows of W over bottom)."""
    N = W.shape[1] if frag is _frag else W.shape[0] + (0 if bottom is None else bottom.shape[0])
    C = np.full((M, N), np.nan, np.float32)
    calls = []
    for m0 in range(0, M, 16 * kmt):
        for n0 in range(0, N, COLS):
            acc = _warp_task(A, M, K, W, bottom, m0, n0, kmt, frag)
            for lane in range(32):
                g, t = divmod(lane, 4)
                col = n0 + 4 * t
                if col >= N:
                    continue
                for i in range(kmt):
                    for h in range(2):
                        row = m0 + 16 * i + g + 8 * h
                        if row < M:
                            c = acc[i, :, lane]  # row4: (c[0][2h], c[1][2h], c[0][2h+1], c[1][2h+1])
                            C[row, col:col + 4] = [c[0, 2 * h], c[1, 2 * h], c[0, 2 * h + 1],
                                                   c[1, 2 * h + 1]]
                            calls.append((row, col))
    return C, calls


def _garbage_padded(X, rows, cols):
    out = np.full((rows, cols), np.nan, np.float32)
    out[:X.shape[0], :X.shape[1]] = X
    return out


@pytest.mark.parametrize("M,K,N,kmt", [(16, 8, 16, 1), (40, 36, 44, 2), (21, 12, 20, 4),
                                       (70, 132, 28, 2)])
def test_block_mm_tf32_fragments_reproduce_the_product(M, K, N, kmt):
    rng = np.random.default_rng(M + K + N)
    A = rng.integers(-8, 9, (M, K)).astype(np.float32)
    W = rng.integers(-8, 9, (K, N)).astype(np.float32)
    Ap = _garbage_padded(A, _round(M, 16 * kmt) + 8, K + 4)  # past M and K: never read
    C, calls = _block_mm(Ap, M, K, W, kmt)
    assert np.array_equal(C, (A.astype(np.float64) @ W).astype(np.float32))
    assert sorted(calls) == [(r, c) for r in range(M) for c in range(0, N, 4)]


@pytest.mark.parametrize("M,K,N", [(24, 64, 32), (16, 136, 20)])
def test_block_mm_tf32_is_float32_accurate(M, K, N):
    """Normal values: hi and lo in their slots, chunks summed apart: within
    2^-20 of the float64 product (single-pass TF32 is 2^-11 off)."""
    rng = np.random.default_rng(K)
    A = rng.normal(size=(M, K)).astype(np.float32)
    W = rng.normal(size=(K, N)).astype(np.float32)
    C, _ = _block_mm(_garbage_padded(A, _round(M, 32) + 8, K + 4), M, K, W, 2)
    exact = A.astype(np.float64) @ W
    scale = np.abs(A).astype(np.float64) @ np.abs(W)
    assert (np.abs(C - exact) / scale).max() <= 2.0 ** -20
    single = _tf32(A).astype(np.float64) @ _tf32(W)
    assert (np.abs(single - exact) / scale).max() > 2.0 ** -14


def test_stacked_b_is_u1p_over_u1t():
    """u1 = [u1p; u1t] read from its two halves (K a multiple of 4: a fragment's
    two rows lie in one half) gives the product of the stacked matrix."""
    rng = np.random.default_rng(5)
    top, bottom = (rng.integers(-8, 9, (12, 20)).astype(np.float32) for _ in range(2))
    A = rng.integers(-8, 9, (18, 24)).astype(np.float32)
    C, _ = _block_mm(_garbage_padded(A, 40, 28), 18, 24, top, 2, bottom)
    assert np.array_equal(C, (A.astype(np.float64) @ np.concatenate([top, bottom])).astype(np.float32))


@pytest.mark.parametrize("M,K,top_rows,bottom_rows,kmt", [(64, 32, 16, 16, 2), (21, 12, 20, 0, 2),
                                                            (40, 36, 8, 12, 4), (16, 8, 12, 0, 1)])
def test_transposed_b_fragments_reproduce_the_product(M, K, top_rows, bottom_rows, kmt):
    """Tf32MatT, the B of dzf1 = dzf2 u2^T and [dpooled | dt] = dzf1 [u1p | u1t]^T
    in din_head_bwd_fc_head_kernel: each lane's W[n][k], W[n][k + 1] (rows past N
    and columns past K zeros, the rows of u1t after those of u1p) give A @ W^T
    bit for bit on integers, every (row, four columns) handed over once."""
    rng = np.random.default_rng(M + K + top_rows)
    top = rng.integers(-8, 9, (top_rows, K)).astype(np.float32)
    bottom = rng.integers(-8, 9, (bottom_rows, K)).astype(np.float32) if bottom_rows else None
    A = rng.integers(-8, 9, (M, K)).astype(np.float32)
    C, calls = _block_mm(_garbage_padded(A, _round(M, 16 * kmt) + 8, K + 4), M, K, top, kmt,
                         bottom, frag=_frag_t)
    W = top if bottom is None else np.concatenate([top, bottom])
    assert np.array_equal(C, (A.astype(np.float64) @ W.T.astype(np.float64)).astype(np.float32))
    assert sorted(calls) == [(r, c) for r in range(M) for c in range(0, W.shape[0], 4)]


def test_transposed_b_needs_the_rows_of_w():
    """A Tf32MatT that read W's columns (Tf32Mat's fragment) would multiply by W,
    not W^T: the model tells the two apart on a W that is not symmetric."""
    rng = np.random.default_rng(9)
    W = rng.integers(-8, 9, (16, 16)).astype(np.float32)
    A = rng.integers(-8, 9, (16, 16)).astype(np.float32)
    C, _ = _block_mm(_garbage_padded(A, 40, 20), 16, 16, W, 1, frag=_frag_t)
    assert np.array_equal(C, (A.astype(np.float64) @ W.T).astype(np.float32))
    assert not np.array_equal(C, (A.astype(np.float64) @ W).astype(np.float32))


# ---- the head's float32 forward in 3xTF32, emulated in torch

def _tf32_t(x: torch.Tensor) -> torch.Tensor:
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b):
    """a @ b in 3xTF32: lo_a hi_b + hi_a lo_b + hi_a hi_b, float32 sums."""
    ah, bh = _tf32_t(a), _tf32_t(b)
    al, bl = _tf32_t(a - ah), _tf32_t(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm1(a, b):
    return _tf32_t(a) @ _tf32_t(b)


def _head(hist, tgt, weights, mm):
    """The float32 head's logits with its products through ``mm``, the float32
    forward's order: t wt, h wh, relu(z1) w2 and the fc's [pooled | t] u1 and f1
    u2 through ``mm``; the scores and f2 u3 in float32."""
    wh, wt, b1, w2, b2, w3, b3, u1p, u1t, c1, u2, c2, u3, c3 = weights
    B, L, D = hist.shape
    h = hist.reshape(B * L, D)
    T = (mm(tgt, wt) + b1).repeat_interleave(L, dim=0)
    z2 = mm(torch.relu(mm(h, wh) + T), w2) + b2
    w = torch.softmax((torch.relu(z2) @ w3 + b3).reshape(B, L), dim=-1)
    x = torch.cat([torch.einsum("bl,bld->bd", w, hist), tgt], dim=-1)
    f1 = torch.relu(mm(x, torch.cat([u1p, u1t], dim=0)) + c1)
    return (torch.relu(mm(f1, u2) + c2) @ u3 + c3)[:, 0]


def _inputs(B, L, D, A, F, seed):
    gen = torch.Generator().manual_seed(seed)
    att, fc = mlp_init(gen, (3 * D,) + A), mlp_init(gen, (2 * D,) + F)
    rng = np.random.default_rng(seed)
    hist = torch.from_numpy((0.5 * rng.normal(size=(B, L, D))).astype(np.float32))
    tgt = torch.from_numpy((0.5 * rng.normal(size=(B, D))).astype(np.float32))
    return att, fc, hist, tgt


def _normwise(got, want) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


def test_tf32_head_emulation_matches_plain_and_pallas():
    D, L, A, F = 16, 10, (32, 16, 1), (64, 32, 1)
    att, fc, hist, tgt = _inputs(70, L, D, A, F, seed=4)
    weights = dh.din_head_weights(att, fc, D)
    emulated = _head(hist, tgt, weights, _mm3)
    plain = dh.din_head_fwd_plain(hist, tgt, weights)
    jax_tree = [[{k: jnp.asarray(v.numpy()) for k, v in layer.items()} for layer in net]
                for net in (att, fc)]
    pallas = torch.from_numpy(np.array(din_head_fused(
        jax_tree[0], jax_tree[1], jnp.asarray(hist.numpy()), jnp.asarray(tgt.numpy()),
        block_rows=32, interpret=True)))
    assert _normwise(emulated, plain) <= LIMIT
    assert _normwise(emulated, pallas) <= LIMIT
    single = _head(hist, tgt, weights, _mm1)
    assert _normwise(single, plain) > LIMIT


# ---- the float32 backward as the card splits it: the fc head apart

KINK = 2.0 ** -14  # kKink in csrc/din_head.cu


def _relu_input(x, W, b, mm):
    """x W + b through ``mm``, each value within KINK sum|x| max|W[:, c]| of 0
    summed again in float32 (din_head.cu's relu_refined)."""
    z = mm(x, W) + b
    near = z.abs() < KINK * x.abs().sum(1, keepdim=True) * W.abs().amax(0)
    return torch.where(near, x @ W + b, z)


def _split_bwd(hist, tgt, weights, g, mm):
    """The float32 backward as din_head.cu splits it: the pooled rows (the
    forward's attention stage), the fc head's backward (din_head_bwd_fc_head_
    kernel: f1, f2, dzf1 = dzf2 u2^T and [dpooled | dt] = dzf1 u1^T through
    ``mm``), then the attention unit's backward from dpooled and dt alone
    (din_head_bwd_att_kernel), float32. Returns din_head_bwd_plain's 16
    gradients."""
    wh, wt, b1, w2, b2, w3, b3, u1p, u1t, c1, u2, c2, u3, c3 = weights
    B, L, D = hist.shape
    h = hist.reshape(B * L, D)
    z1 = h @ wh + (tgt @ wt + b1).repeat_interleave(L, dim=0)
    z2 = torch.relu(z1) @ w2 + b2
    w = torch.softmax((torch.relu(z2) @ w3 + b3).reshape(B, L), dim=-1)
    pooled = torch.einsum("bl,bld->bd", w, hist)
    # the fc head
    x, u1 = torch.cat([pooled, tgt], dim=-1), torch.cat([u1p, u1t], dim=0)
    f1 = torch.relu(_relu_input(x, u1, c1, mm))
    f2 = torch.relu(_relu_input(f1, u2, c2, mm))
    gf = g[:, None]
    dzf2 = (f2 > 0) * gf * u3.T
    dzf1 = (f1 > 0) * mm(dzf2, u2.T)
    dpt = mm(dzf1, u1.T)
    dpooled, dt = dpt[:, :D], dpt[:, D:]
    du1 = x.T @ dzf1
    fc_grads = (du1[:D], du1[D:], dzf1.sum(0, keepdim=True), f1.T @ dzf2,
                dzf2.sum(0, keepdim=True), f2.T @ gf, gf.sum(0, keepdim=True))
    # the attention unit, from dpooled and dt
    dw_cols = torch.einsum("bd,bld->bl", dpooled, hist)
    ds = (w * (dw_cols - (w * dw_cols).sum(-1, keepdim=True))).reshape(B * L, 1)
    dz2 = (ds @ w3.T) * (z2 > 0)
    dz1 = (dz2 @ w2.T) * (z1 > 0)
    dz1_rows = dz1.reshape(B, L, -1).sum(1)
    dhist = w[..., None] * dpooled[:, None, :] + (dz1 @ wh.T).reshape(B, L, D)
    att_grads = (h.T @ dz1, tgt.T @ dz1_rows, dz1.sum(0, keepdim=True), torch.relu(z1).T @ dz2,
                 dz2.sum(0, keepdim=True), torch.relu(z2).T @ ds, ds.sum(0, keepdim=True))
    return (dhist, dt + dz1_rows @ wt.T) + att_grads + fc_grads


def _backward_case():
    D, L, A, F = 16, 10, (32, 16, 1), (64, 32, 1)
    att, fc, hist, tgt = _inputs(70, L, D, A, F, seed=6)
    g = torch.from_numpy(np.random.default_rng(7).normal(size=70).astype(np.float32))
    weights = dh.din_head_weights(att, fc, D)
    plain = dh.din_head_bwd_plain(hist, tgt, weights, g)
    pallas = _call_bwd(jnp.asarray(hist.numpy()), jnp.asarray(tgt.numpy()),
                       tuple(jnp.asarray(w.numpy()) for w in weights), jnp.asarray(g.numpy()), 32, True)
    return (hist, tgt, weights, g), plain, [torch.from_numpy(np.array(x)) for x in pallas]


def _worst(got, want, g) -> float:
    """The largest normwise error over the 16 gradients; d b3 (0 in exact
    arithmetic) against sum |g| instead."""
    errs = []
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        scale = float(g.abs().sum()) if i == 8 else float(b.abs().max())
        errs.append(float((a - b).abs().max()) / scale)
    return max(errs)


def test_split_backward_matches_plain_and_pallas():
    """The attention unit needs only dpooled and dt of the fc head: the split
    backward in float32 gives din_head_bwd_plain's and the Pallas backward's
    gradients (interpret mode) within 1e-5."""
    args, plain, pallas = _backward_case()
    got = _split_bwd(*args, mm=torch.matmul)
    assert _worst(got, plain, args[3]) <= LIMIT
    assert _worst(got, pallas, args[3]) <= LIMIT


def test_tf32_fc_backward_emulation_meets_the_limit_and_tf32_does_not():
    """The fc head's four products in 3xTF32, dzf2 u2^T and dzf1 u1^T with B the
    transposed weight, relu inputs near 0 summed again: within 1e-5 of
    din_head_bwd_plain and the Pallas backward; in single-pass TF32, not."""
    args, plain, pallas = _backward_case()
    got = _split_bwd(*args, mm=_mm3)
    assert _worst(got, plain, args[3]) <= LIMIT
    assert _worst(got, pallas, args[3]) <= LIMIT
    assert _worst(_split_bwd(*args, mm=_mm1), plain, args[3]) > LIMIT
