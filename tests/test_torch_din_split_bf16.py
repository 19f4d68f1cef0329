"""The DIN head's backward split in bfloat16, and its streamed fc head
(``csrc/din_head.cu``: ``din_head_bwd_fc_stream_kernel``, ``stream_mm``,
``warp_chunk_mm``, ``Bf16Mat``, ``Bf16MatT``, ``stream_kink``;
``din_head_bwd_att_kernel<bf16>``), modelled on the CPU, where the CUDA code
cannot run:

* the bf16 backward as the card splits it: the forward's pooled rows, the fc
  head's backward from them (f1, f2, dzf2, dzf1 = dzf2 u2^T, [dpooled | dt] =
  dzf1 [u1p | u1t]^T and the fc weight gradients, each product's operands
  rounded to bf16 where the JAX kernel casts them, float32 sums), then the
  attention unit's backward from [dpooled | dt] alone. At the preset's widths
  (fewer rows) and at ragged ones it matches ``din_head_bwd_plain`` within
  1e-5 of each gradient's largest |value| (measured: equal) and the Pallas
  backward (``_call_bwd``, interpret mode) on the same bf16 inputs within 1e-4
  (measured: 3.5e-5 in d u3 at the preset's widths, where the plain version
  lies as far: a sum over few rows of f2 rounded to bf16 in another order);
  the same split with no operand rounded misses each rounded gradient by more
  than ten times 1e-5;
* the streamed product in bf16 lane by lane: A staged 128 columns at a time
  (zeros past K), warp w of a 256-column panel taking columns n_lo + 16 w for
  every m16 tile of the rows, B from ``Bf16Mat`` (rows k .. k + 3 of a column
  pair, two 32-bit loads a row merged by ``__byte_perm``: f2's u2) or
  ``Bf16MatT`` (one 8-byte load of W's row n: dzf1's u2^T, [dpooled | dt]'s
  u1^T). On integer-valued inputs every product is exact, so the model must
  give A @ W and A @ W^T bit for bit, each (row, four columns) handed to the
  epilogue once;
* ``stream_kink``, the bound that decides which relu inputs the kernel sums
  again in k order, as a share of sum |x_k w_k|: a bf16 sum in the tensor
  cores' order (each k16 step's exact products summed and cut toward zero,
  the steps added in float32) lies within it of the k-order fma chain, whose
  mask the kernel takes; a 3xTF32 sum in ``warp_mm_tf32``'s order lies within
  it of the exact sum; at every K the kernels take;
* the streamed fc head in float32 at fc (2048, 2048) (the layout the parent's
  fc head kernel could not hold): 3xTF32 products taken 256 output columns at a
  time, 128 columns of A at a time in chunks of 64 summed apart, relu inputs
  near 0 summed again: on a few rows it matches ``din_head_bwd_plain`` and the
  Pallas backward within 1e-5;
* ``fits`` takes the preset's and fc (2048, 2048) into the split in both
  dtypes, and ``kernel_route`` takes the widest fc; it refuses widths whose
  bits lack the bf16 split, since bf16 has no other backward.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_din_mma_layout import _byte_perm, _mma, _pack, _rne_top16
from test_torch_din_tf32 import _mm3, _split_bwd, _worst

from deeplearningrecommendationsystem_tpu.ops.pallas.din_head import _call_bwd
from deeplearningrecommendationsystem_tpu_torch.ops import din_head as dh
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import din_head as cuda_dh
from deeplearningrecommendationsystem_tpu_torch.ops.linear import mlp_init

LIMIT = 1e-5  # the bf16 plain head against the Pallas backward (tests/test_torch_din_ops.py)
PALLAS_LIMIT = 1e-4  # against the Pallas backward at the preset's widths (see above)
STREAM_K, PANEL, WARPS = 128, 256, 16  # kStreamK, kStreamPanel, kThreads / 32
# gradients the rounding moves (d b3 is 0 in exact arithmetic; d c2, d c3 are
# sums of g and of dzf2 alone)
ROUNDED = (0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 14)


def _bf(x: torch.Tensor) -> torch.Tensor:
    """op<bf16>: x rounded to the nearest bf16, as float32."""
    return x.to(torch.bfloat16).float()


def _keep(x: torch.Tensor) -> torch.Tensor:
    return x


def _split_bwd_bf16(hist, tgt, weights, g, rnd=_bf):
    """The bf16 backward as din_head.cu splits it, float32 sums, each product's
    operands through ``rnd`` where the JAX kernel casts them: the pooled rows
    (din_fwd_kernel<bf16>'s), din_head_bwd_fc_stream_kernel<bf16>'s fc head,
    then din_head_bwd_att_kernel<bf16>'s attention unit from dpooled and dt.
    Returns din_head_bwd_plain's 16 gradients."""
    wh, wt, b1, w2, b2, w3, b3, u1p, u1t, c1, u2, c2, u3, c3 = (w.float() for w in weights)
    B, L, D = hist.shape
    h, t = hist.float().reshape(B * L, D), tgt.float()
    z1 = h @ wh + (t @ wt + b1).repeat_interleave(L, dim=0)
    z2 = rnd(torch.relu(z1)) @ w2 + b2
    w = torch.softmax((rnd(torch.relu(z2)) @ w3 + b3).reshape(B, L), dim=-1)
    pooled = torch.einsum("bl,bld->bd", w, h.reshape(B, L, D))
    # the fc head, from the pooled rows
    x, u1 = torch.cat([rnd(pooled), t], dim=-1), torch.cat([u1p, u1t], dim=0)
    f1 = torch.relu(x @ u1 + c1)
    f2 = torch.relu(rnd(f1) @ u2 + c2)
    gf = g.float()[:, None]
    dzf2 = (f2 > 0) * (rnd(gf) * u3.T)
    dzf1 = (f1 > 0) * (rnd(dzf2) @ u2.T)
    dpt = rnd(dzf1) @ u1.T
    dpooled, dt = dpt[:, :D], dpt[:, D:]
    du1 = x.T @ rnd(dzf1)
    fc_grads = (du1[:D], du1[D:], dzf1.sum(0, keepdim=True), rnd(f1).T @ rnd(dzf2),
                dzf2.sum(0, keepdim=True), rnd(f2).T @ rnd(gf), gf.sum(0, keepdim=True))
    # the attention unit, from dpooled and dt
    dw_cols = torch.einsum("bd,bld->bl", dpooled, h.reshape(B, L, D))
    ds = (w * (dw_cols - (w * dw_cols).sum(-1, keepdim=True))).reshape(B * L, 1)
    dz2 = (rnd(ds) @ w3.T) * (z2 > 0)
    dz1 = (rnd(dz2) @ w2.T) * (z1 > 0)
    dz1_rows = dz1.reshape(B, L, -1).sum(1)
    dhist = w[..., None] * dpooled[:, None, :] + (rnd(dz1) @ wh.T).reshape(B, L, D)
    att_grads = (h.T @ rnd(dz1), t.T @ rnd(dz1_rows), dz1.sum(0, keepdim=True),
                 rnd(torch.relu(z1)).T @ rnd(dz2), dz2.sum(0, keepdim=True),
                 rnd(torch.relu(z2)).T @ rnd(ds), ds.sum(0, keepdim=True))
    return (dhist, dt + rnd(dz1_rows) @ wt.T) + att_grads + fc_grads


def _bf16_case(B, L, D, A, F, seed):
    gen = torch.Generator().manual_seed(seed)
    att, fc = mlp_init(gen, (3 * D,) + A), mlp_init(gen, (2 * D,) + F)
    rng = np.random.default_rng(seed)
    hist = torch.from_numpy((0.5 * rng.normal(size=(B, L, D))).astype(np.float32)).bfloat16()
    tgt = torch.from_numpy((0.5 * rng.normal(size=(B, D))).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.normal(size=B).astype(np.float32) / B).bfloat16()
    weights = tuple(w.bfloat16() for w in dh.din_head_weights(att, fc, D))
    return hist, tgt, weights, g


def _pallas_bwd(hist, tgt, weights, g):
    """The Pallas backward (interpret mode) on the same bf16 inputs: its float32
    gradients before the cast."""
    def j(x):
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)

    out = _call_bwd(j(hist), j(tgt), tuple(j(w) for w in weights), j(g), 16, True)
    return [torch.from_numpy(np.asarray(x, np.float32)) for x in out]


# (B, L, D, A, F): the preset's nets on fewer rows, and ragged widths (no width
# a multiple of 8 or 16: the fragments end inside a width)
BF16_SPLIT_CASES = [(24, 10, 64, (128, 64, 1), (256, 128, 1)),
                    (37, 7, 8, (12, 8, 1), (20, 12, 1))]


@pytest.mark.parametrize("B,L,D,A,F", BF16_SPLIT_CASES)
def test_bf16_split_backward_matches_plain_and_pallas(B, L, D, A, F):
    args = _bf16_case(B, L, D, A, F, seed=B + D)
    got = _split_bwd_bf16(*args)
    g = args[3].float()
    assert _worst(got, dh.din_head_bwd_plain(*args), g) <= LIMIT
    assert _worst(got, _pallas_bwd(*args), g) <= PALLAS_LIMIT


@pytest.mark.parametrize("B,L,D,A,F", BF16_SPLIT_CASES)
def test_bf16_split_limit_fails_unrounded(B, L, D, A, F):
    """The limit above tells rounding from not rounding: the same split with no
    operand rounded misses every gradient that the rounding moves by more than
    ten times it."""
    args = _bf16_case(B, L, D, A, F, seed=B + D)
    plain = dh.din_head_bwd_plain(*args)
    unrounded = _split_bwd_bf16(*args, rnd=_keep)
    for i in ROUNDED:
        gap = float((unrounded[i] - plain[i]).abs().max()) / float(plain[i].abs().max())
        assert gap > 10 * LIMIT, i


# ---- the streamed product in bf16, lane by lane

def _bits(W):
    return _rne_top16(np.asarray(W, np.float32)).view(np.uint32) >> 16


def _frag(Wb, n, k, trans):
    """Bf16Mat::frag (trans False: W [K][N]) or Bf16MatT::frag (trans True: W
    [N][K]) for columns n, n + 1 and rows k .. k + 3: [n8 tile j][register];
    zeros past K and N. Wb holds W's bf16 bits."""
    b = [[0, 0], [0, 0]]
    if trans:
        N, K = Wb.shape
        for j in range(2):
            if n + j < N and k < K:
                q = [int(v) for v in Wb[n + j, k:k + 4]]
                b[j] = [q[0] | (q[1] << 16), q[2] | (q[3] << 16)]
        return b
    K, N = Wb.shape
    if n >= N or k >= K:
        return b
    w = [int(Wb[k + i, n]) | (int(Wb[k + i, n + 1]) << 16) for i in range(4)]
    b[0] = [_byte_perm(w[0], w[1], 0x5410), _byte_perm(w[2], w[3], 0x5410)]
    b[1] = [_byte_perm(w[0], w[1], 0x7632), _byte_perm(w[2], w[3], 0x7632)]
    return b


def _stream_mm(A, W, trans, kmt=4):
    """stream_mm with warp_chunk_mm<bf16>: C = A [R][K] @ W (or W^T), returns C
    and how often each (row, four columns) reached the epilogue."""
    R, K = A.shape
    N = W.shape[0] if trans else W.shape[1]
    Wb = _bits(W)
    C = np.full((R, N), np.nan)
    seen = np.zeros((R, N // 4), int)
    for n_lo in range(0, N, PANEL):
        for warp in range(WARPS):
            n0 = n_lo + 16 * warp
            if n0 >= N:
                continue
            acc = np.zeros((kmt, 2, 32, 4))
            for k_lo in range(0, K, STREAM_K):
                kn = min(STREAM_K, K - k_lo)
                kp = -(-kn // 16) * 16
                chunk = np.zeros((R, kp), np.float32)  # zeros past K
                chunk[:, :kn] = A[:, k_lo:k_lo + kn]
                for k0 in range(0, kp, 16):
                    b = [_frag(Wb, n0 + 2 * (l // 4), k_lo + k0 + 4 * (l % 4), trans)
                         for l in range(32)]
                    for i in range(kmt):
                        if 16 * i >= R:
                            break
                        a = []
                        for l in range(32):
                            g, t = l // 4, l % 4
                            u = chunk[16 * i + g, k0 + 4 * t:k0 + 4 * t + 4]
                            v = chunk[16 * i + g + 8, k0 + 4 * t:k0 + 4 * t + 4]
                            a.append([_pack(u[0], u[1]), _pack(v[0], v[1]), _pack(u[2], u[3]),
                                      _pack(v[2], v[3])])
                        for j in range(2):
                            step = np.zeros((32, 4))
                            _mma(step, a, [b[l][j] for l in range(32)])
                            acc[i, j] = (acc[i, j] + step).astype(np.float32)  # mma_bf16's float32 add
            for lane in range(32):
                g, t = lane // 4, lane % 4
                col = n0 + 4 * t
                if col >= N:
                    continue
                for i in range(kmt):
                    if 16 * i >= R:
                        break
                    for h in range(2):
                        row = 16 * i + g + 8 * h
                        c = acc[i, :, lane]  # row4
                        C[row, col:col + 4] = [c[0, 2 * h], c[1, 2 * h], c[0, 2 * h + 1], c[1, 2 * h + 1]]
                        seen[row, col // 4] += 1
    return C, seen


# (R, K, N, trans): f2's product (u2), dzf1's and [dpooled | dt]'s (W^T); K past
# one staged chunk and not a multiple of 16, N past one panel
STREAM_SHAPES = [(16, 24, 20, False), (32, 136, 40, False), (16, 20, 300, False),
                 (48, 148, 24, True), (16, 40, 24, True)]


@pytest.mark.parametrize("R,K,N,trans", STREAM_SHAPES)
def test_bf16_stream_fragments_reproduce_the_product(R, K, N, trans):
    rng = np.random.default_rng(R + K + N)
    A = rng.integers(-8, 9, (R, K)).astype(np.float32)
    W = rng.integers(-8, 9, (N, K) if trans else (K, N)).astype(np.float32)
    C, seen = _stream_mm(A, W, trans)
    want = A.astype(np.float64) @ (W.T if trans else W)
    assert np.array_equal(C, want)
    assert (seen == 1).all()


def test_bf16_stream_rounds_its_operands():
    """Values that are not bf16 enter the products rounded to bf16, as op<bf16>."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(16, 32)).astype(np.float32)
    W = rng.normal(size=(32, 16)).astype(np.float32)
    C, _ = _stream_mm(A, W, False)
    want = _rne_top16(A).astype(np.float64) @ _rne_top16(W)
    assert np.abs(C - want).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(A.astype(np.float64) @ W - want).max() > 1e-3 * np.abs(want).max()


# ---- stream_kink: the relu refine's bound

def _trunc32(x: np.ndarray) -> np.ndarray:
    """float64 -> float32 toward zero (a truncating alignment's worst case)."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(y, np.float32(0)), y).astype(np.float32)


@pytest.mark.parametrize("K", [16, 40, 128, 256, 2048])
def test_bf16_stream_kink_bounds_the_gap_to_the_k_order_sum(K):
    """A relu input's bf16 tensor-core sum (each k16 step's exact products
    summed and cut to float32 toward zero, the steps added in float32) and
    refine_dot's k-order chain (each exact product added in float32) lie within
    stream_kink<bf16>(K) = (K + 32) 2^-23 of sum |x_k w_k| of each other, also
    where the terms nearly cancel: outside it both sums have one sign."""
    rng = np.random.default_rng(K)
    x = _rne_top16(rng.normal(size=(400, K)).astype(np.float32))
    w = _rne_top16(rng.normal(size=K).astype(np.float32))
    x[:200] = _rne_top16(np.abs(x[:200]) * np.sign(w))  # all terms of one sign
    x[200:, -1] = _rne_top16(-(x[200:, :-1].astype(np.float64) @ w[:-1]) / w[-1])  # cancelling
    prods = x.astype(np.float64) * w  # exact: bf16 x bf16 fits in float32
    steps = np.zeros(len(x), np.float32)
    for k0 in range(0, K, 16):
        steps = (steps + _trunc32(prods[:, k0:k0 + 16].sum(1))).astype(np.float32)
    chain = np.zeros(len(x), np.float32)
    for k in range(K):
        chain = (chain + prods[:, k].astype(np.float32)).astype(np.float32)
    bound = (K + 32) * 2.0 ** -23 * np.abs(prods).sum(1)
    assert (np.abs(steps.astype(np.float64) - chain) <= bound).all()


@pytest.mark.parametrize("K", [16, 128, 2048])
def test_f32_stream_kink_bounds_the_3xtf32_sum(K):
    """The 3xTF32 sum in warp_mm_tf32's order (chunks of 64 k from zero, added
    in float32) lies within stream_kink<float>(K) = (60 + K / 64) 2^-23 of sum
    |x_k w_k| from the exact sum."""
    rng = np.random.default_rng(K + 1)
    x = torch.from_numpy(rng.normal(size=(300, K)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(K, 1)).astype(np.float32))
    x[150:, -1] = (-(x[150:, :-1].double() @ w[:-1].double()) / w[-1].double())[:, 0].float()
    got = torch.zeros((300, 1))
    for k0 in range(0, K, 64):
        got = got + _mm3(x[:, k0:k0 + 64], w[k0:k0 + 64])
    exact = x.double() @ w.double()
    bound = (60 + K // 64) * 2.0 ** -23 * (x.double().abs() @ w.double().abs())
    assert ((got.double() - exact).abs() <= bound).all()


# ---- the streamed fc head in float32 at the widest fc

def _streamed(mm):
    """a @ b through ``mm`` as din_head_bwd_fc_stream_kernel<float> takes it:
    256 output columns at a time, each the sum over chunks of 64 of A's columns
    (two a staged chunk of 128), each chunk's product from zero, then added in
    float32."""
    def product(a, b):
        cols = []
        for n_lo in range(0, b.shape[1], PANEL):
            acc = torch.zeros((a.shape[0], min(PANEL, b.shape[1] - n_lo)))
            for k0 in range(0, a.shape[1], 64):
                acc = acc + mm(a[:, k0:k0 + 64], b[k0:k0 + 64, n_lo:n_lo + PANEL])
            cols.append(acc)
        return torch.cat(cols, dim=1)
    return product


def test_streamed_f32_fc_head_at_the_widest_fc_matches_plain_and_pallas():
    D, L, A, F = 16, 6, (32, 16, 1), (2048, 2048, 1)
    gen = torch.Generator().manual_seed(8)
    att, fc = mlp_init(gen, (3 * D,) + A), mlp_init(gen, (2 * D,) + F)
    rng = np.random.default_rng(8)
    hist = torch.from_numpy((0.5 * rng.normal(size=(6, L, D))).astype(np.float32))
    tgt = torch.from_numpy((0.5 * rng.normal(size=(6, D))).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=6).astype(np.float32))
    weights = dh.din_head_weights(att, fc, D)
    got = _split_bwd(hist, tgt, weights, g, mm=_streamed(_mm3))
    assert _worst(got, dh.din_head_bwd_plain(hist, tgt, weights, g), g) <= LIMIT
    pallas = _call_bwd(jnp.asarray(hist.numpy()), jnp.asarray(tgt.numpy()),
                       tuple(jnp.asarray(w.numpy()) for w in weights), jnp.asarray(g.numpy()), 8, True)
    assert _worst(got, [torch.from_numpy(np.array(x)) for x in pallas], g) <= LIMIT


# ---- the route

def test_the_split_takes_the_preset_and_the_widest_fc_in_both_dtypes():
    split = cuda_dh.SPLIT_F32 | cuda_dh.SPLIT_BF16
    for F in ((256, 128), (2048, 2048)):
        assert cuda_dh.fits(10, 64, 128, 64, *F) & split == split
    # the streamed fc head keeps 64 rows a tile at the widest fc, in both dtypes
    for bf16 in (False, True):
        assert 4 * cuda_dh._fc_stream_floats(64, 2048, 2048, 64, bf16) <= cuda_dh.SMEM_LIMIT
    # D 512 at L 64: float32 keeps din_head_bwd_kernel<float> (its forward has no
    # tensor-core tile), bf16 takes the split
    bits = cuda_dh.fits(64, 512, 8, 4, 8, 4)
    assert bits & cuda_dh.BWD and not bits & cuda_dh.SPLIT_F32 and bits & cuda_dh.SPLIT_BF16
    gen = torch.Generator().manual_seed(0)
    att, fc = mlp_init(gen, (3 * 64, 128, 64, 1)), mlp_init(gen, (2 * 64, 2048, 2048, 1))
    assert dh.kernel_route(att, fc, 10, 64)


def test_kernel_route_needs_the_bf16_split(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    att, fc = mlp_init(gen, (3 * 64, 128, 64, 1)), mlp_init(gen, (2 * 64, 256, 128, 1))
    assert dh.kernel_route(att, fc, 10, 64)
    every = cuda_dh.FWD | cuda_dh.BWD | cuda_dh.POOL
    monkeypatch.setattr(cuda_dh, "fits", lambda *widths: every | cuda_dh.SPLIT_F32)
    assert not dh.kernel_route(att, fc, 10, 64)
    monkeypatch.undo()
    # the float32 tile walk fits and the bf16 split does not: D 1612 at L 4
    # (tests/test_torch_cuda_kernels.py holds the launches there on the card)
    assert cuda_dh.fits(4, 1612, 12, 8, 20, 12) == cuda_dh.FWD | cuda_dh.BWD
