"""The float32-accurate tensor-core products of the two attention pools
(``csrc/din_attention.cu::din_pool_kernel``, ``csrc/afm_attention.cu::
afm_pool_fwd_kernel``; 3xTF32 ``mma.sync`` m16n8k8, ``csrc/tf32_mma.cuh``),
modelled lane by lane in numpy on the CPU.

The CUDA code cannot run here, so these tests pin what it rests on:

* ``cvt.rna.tf32.f32``: round to nearest, ties away from zero, to 10
  mantissa bits, and the split x = hi + lo with hi = tf32(x), lo = tf32(x - hi);
* the index algebra: each lane's A, B and C fragments under the PTX ISA's
  m16n8k8 TF32 layout, with the kernels' permuted k slots (slot t takes
  k0 + 2t, slot t + 4 takes k0 + 2t + 1), the DIN pool's split weights in
  shared memory (one 16-byte load a B fragment, no bank conflicts), its
  register hand-off of relu(z1) from the first layer's C fragments to the
  second layer's A fragments (a0 = c0, a1 = c2, a2 = c1, a3 = c3, B's rows
  permuted to match), its column panels, the AFM forward's pair rows (15 pairs and a zero row an
  m16 tile), the AFM backward's hand-off of dz from z's C fragments to the A
  fragments of dc = dz W^T (W^T's B fragment holding W[d][2t], W[d][2t + 1])
  and zeros past widths that are multiples of 4 only. On
  integer-valued inputs every product is exact, so the model must reproduce
  the scores bit for bit;
* the accuracy: the modelled 3xTF32 pools lie within the card's limit (1e-5
  of the largest value, ``chip_smoke.py``'s ``DIN_FWD_RTOL`` and
  ``AFM_FWD_RTOL``) of the float32 plain versions at the presets' widths,
  and a model of single-pass TF32 does not.
"""

import itertools

import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu_torch.ops.afm_attention import afm_attention_pool_plain
from deeplearningrecommendationsystem_tpu_torch.ops.din_attention import din_attention_pool_plain
from deeplearningrecommendationsystem_tpu_torch.ops.linear import mlp_init

PANEL = 8  # kPanel in both sources: n8 tiles of a column panel
LIMIT = 1e-5  # DIN_FWD_RTOL, AFM_FWD_RTOL


def _tf32(x) -> np.ndarray:
    """``cvt.rna.tf32.f32`` on the bits: add half of the 13 dropped bits to the
    magnitude (ties away from zero), then drop them."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(np.asarray(x, np.float32) - hi)


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=5000), rng.uniform(-1e6, 1e6, 5000)]).astype(np.float32)
    # independently, in float64: |x| to a multiple of its ulp 2^(e - 10), halves up
    m, e = np.frexp(np.abs(x).astype(np.float64))  # |x| = m 2^e, m in [0.5, 1)
    ulp = np.ldexp(1.0, e - 11)
    want = np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp
    assert np.array_equal(_tf32(x).astype(np.float64), want)
    one = np.float32(1.0)
    halfway = np.array([0x3F801000, 0xBF801000, 0x3F803000], np.uint32).view(np.float32)
    assert _tf32(halfway).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2 * 2.0 ** -10]
    assert _tf32(np.nextafter(halfway[0], one)) == one  # below the halfway point: down
    assert (_tf32(x).view(np.uint32) & 0x1FFF == 0).all()


def test_split_keeps_22_bits():
    rng = np.random.default_rng(1)
    x = rng.normal(size=20000).astype(np.float32)
    hi, lo = _split(x)
    rel = np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -22
    assert (np.abs(lo) <= np.abs(hi) * 2.0 ** -11).all()
    # integers up to 2^11 are exact in TF32: their lo is 0
    ints = np.arange(-2048, 2049, dtype=np.float32)
    assert (_tf32(ints) == ints).all()


# ---- one mma.sync m16n8k8 TF32 over the 32 lanes

def _mma(acc, a, b):
    """acc [32][4] float32 += A B, A (16 x 8) from a [32][4] and B (8 x 8) from
    b [32][2] as the PTX ISA lays the fragments out: a0 (g, t), a1 (g + 8, t),
    a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g); C c0 (g, 2t),
    c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1). Products exact, one
    rounding to float32 a step."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for reg, (r, c) in enumerate(((g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4))):
            A[r, c] = a[lane][reg]
        B[t, g], B[t + 4, g] = b[lane]
    C = A @ B
    for lane in range(32):
        g, t = lane // 4, lane % 4
        acc[lane] = (acc[lane] + np.array([C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t],
                                           C[g + 8, 2 * t + 1]])).astype(np.float32)


def _mma3(acc, a, b):
    """3xTF32: acc += lo_a hi_b, then hi_a lo_b, then hi_a hi_b."""
    ah, al = _split(a)
    bh, bl = _split(b)
    _mma(acc, al, bh)
    _mma(acc, ah, bl)
    _mma(acc, ah, bh)


def _c_matrix(acc):
    C = np.zeros((16, 8), np.float32)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], C[g + 8, 2 * t + 1] = acc[lane]
    return C


def _a_permuted(X, k0):
    """A fragments of rows 0 .. 15 of X at the k-step k0: slot t takes column
    k0 + 2t and slot t + 4 column k0 + 2t + 1 (one 8-byte load a row)."""
    return [[X[g, k0 + 2 * t], X[g + 8, k0 + 2 * t], X[g, k0 + 2 * t + 1], X[g + 8, k0 + 2 * t + 1]]
            for g, t in (divmod(lane, 4) for lane in range(32))]


def _b_pair(WT, n, k):
    """B's k slots t and t + 4 of column n are W's rows k and k + 1 (``frag``
    of ``SplitMat`` and ``GlobalMat``; WT [N][K] is W transposed)."""
    return [WT[n, k], WT[n, k + 1]]


def _round8(n):
    return -(-n // 8) * 8


def _pad(x, shape):
    out = np.zeros(shape, np.float32)
    out[tuple(slice(0, s) for s in x.shape)] = x
    return out


# ---- the DIN pool: one m16 tile of positions

def _din_tile_scores(Hp, Tp, wh, w2, b2, w3, hand_off=True):
    """``position_scores``: scores of 16 positions (rows of Hp, with their t wt
    + b1 in Tp), lane by lane. wh [D, A1], w2 [A1, A2], b2, w3 [A2]; widths
    padded with zeros to 8 here, to column panels of 64 in the kernel (whose
    extra n8 tiles are zeros and add nothing)."""
    D, A1 = wh.shape
    A2 = w2.shape[1]
    Dk, A1k, A2k = _round8(D), _round8(A1), _round8(A2)
    H = _pad(Hp, (16, Dk))
    T = _pad(Tp, (16, A1k))
    whT = _pad(wh, (Dk, A1k)).T.copy()
    w2T = _pad(w2, (A1k, A2k)).T.copy()
    b2p, w3p = _pad(b2, (A2k,)), _pad(w3, (A2k,))
    score = np.zeros((32, 2), np.float32)  # rows g, g + 8, per lane
    for n2 in range(0, A2k, 8 * PANEL):
        n2t = min(PANEL, (A2k - n2) // 8)
        acc2 = [np.zeros((32, 4), np.float32) for _ in range(n2t)]
        for n1 in range(0, A1k, 8 * PANEL):
            n1t = min(PANEL, (A1k - n1) // 8)
            acc1 = []
            for j in range(n1t):
                c = n1 + 8 * j
                acc1.append(np.array([[T[g, c + 2 * t], T[g, c + 2 * t + 1], T[g + 8, c + 2 * t],
                                       T[g + 8, c + 2 * t + 1]]
                                      for g, t in (divmod(lane, 4) for lane in range(32))], np.float32))
            for k0 in range(0, Dk, 8):
                a = np.array(_a_permuted(H, k0), np.float32)
                for j in range(n1t):
                    b = np.array([_b_pair(whT, n1 + 8 * j + lane // 4, k0 + 2 * (lane % 4))
                                  for lane in range(32)], np.float32)
                    _mma3(acc1[j], a, b)
            for j in range(n1t):
                r = np.maximum(acc1[j], 0)
                if hand_off:  # C -> A in registers
                    a = r[:, [0, 2, 1, 3]]
                    kk = [n1 + 8 * j + 2 * (lane % 4) for lane in range(32)]
                else:  # the unpermuted reading: slot t is column 8j + t
                    a = np.array(_a_permuted(_c_matrix(r), 0), np.float32)
                    kk = [n1 + 8 * j + lane % 4 for lane in range(32)]
                for i in range(n2t):
                    if hand_off:
                        b = [_b_pair(w2T, n2 + 8 * i + lane // 4, kk[lane]) for lane in range(32)]
                    else:
                        b = [[w2T[n2 + 8 * i + lane // 4, kk[lane]],
                              w2T[n2 + 8 * i + lane // 4, kk[lane] + 4]] for lane in range(32)]
                    _mma3(acc2[i], a, np.array(b, np.float32))
        for i in range(n2t):
            for lane in range(32):
                c = n2 + 8 * i + 2 * (lane % 4)
                z = acc2[i][lane] + np.array([b2p[c], b2p[c + 1]] * 2, np.float32)
                w = np.array([w3p[c], w3p[c + 1]] * 2, np.float32)
                p = np.maximum(z, 0) * w
                score[lane] += [p[0] + p[1], p[2] + p[3]]
    out = np.zeros(16, np.float32)
    for g in range(8):  # the quad's sum
        out[g] = score[4 * g:4 * g + 4, 0].sum()
        out[g + 8] = score[4 * g:4 * g + 4, 1].sum()
    return out


def _ints(rng, shape, lo=-3, hi=3):
    return rng.integers(lo, hi + 1, shape).astype(np.float32)


# (D, A1, A2): the DIN preset (two column panels of the first layer), the CUDA
# tests' narrow widths, widths that are multiples of 4 only (12, 20: zero slots
# in the last n8 tile and k-step), and an A1 of 256 (four panels)
DIN_WIDTHS = [(64, 128, 64), (16, 32, 16), (8, 12, 8), (12, 20, 12), (20, 12, 20), (16, 256, 8)]


@pytest.mark.parametrize("D,A1,A2", DIN_WIDTHS)
def test_din_pool_fragments_reproduce_the_scores(D, A1, A2):
    rng = np.random.default_rng(D * 100 + A1 + A2)
    H, T = _ints(rng, (16, D)), _ints(rng, (16, A1), -20, 20)
    wh, w2 = _ints(rng, (D, A1)), _ints(rng, (A1, A2))
    b2, w3 = _ints(rng, (A2,), -50, 50), _ints(rng, (A2,))
    z1 = H.astype(np.float64) @ wh + T
    want = np.maximum(np.maximum(z1, 0) @ w2 + b2, 0) @ w3
    assert np.array_equal(_din_tile_scores(H, T, wh, w2, b2, w3), want)


def test_din_pool_hand_off_needs_the_permuted_rows():
    """Read as slot t = column 8j + t (no permutation), the same C registers
    give other scores: the test sees the permutation."""
    rng = np.random.default_rng(7)
    D, A1, A2 = 16, 32, 16
    H, T = _ints(rng, (16, D)), _ints(rng, (16, A1), -20, 20)
    wh, w2, b2, w3 = _ints(rng, (D, A1)), _ints(rng, (A1, A2)), _ints(rng, (A2,)), _ints(rng, (A2,))
    z1 = H.astype(np.float64) @ wh + T
    want = np.maximum(np.maximum(z1, 0) @ w2 + b2, 0) @ w3
    assert not np.array_equal(_din_tile_scores(H, T, wh, w2, b2, w3, hand_off=False), want)


def test_din_pool_target_term_fragments():
    """``target_term``: T = X wt + b1 for 16 rows by n8 tiles, the same A and B
    fragments as the first layer, written by (row, column pair)."""
    rng = np.random.default_rng(3)
    D, A1 = 20, 12
    X, wt, b1 = _ints(rng, (16, D)), _ints(rng, (D, A1)), _ints(rng, (A1,))
    Dk, A1k = _round8(D), _round8(A1)
    Xp, wtT, b1p = _pad(X, (16, Dk)), _pad(wt, (Dk, A1k)).T.copy(), _pad(b1, (A1k,))
    T = np.full((16, A1k), np.nan, np.float32)
    for n0 in range(0, A1k, 8):
        acc = np.zeros((32, 4), np.float32)
        for k0 in range(0, Dk, 8):
            b = [_b_pair(wtT, n0 + lane // 4, k0 + 2 * (lane % 4)) for lane in range(32)]
            _mma3(acc, np.array(_a_permuted(Xp, k0), np.float32), np.array(b, np.float32))
        for lane in range(32):
            g, c = lane // 4, n0 + 2 * (lane % 4)
            T[g, c:c + 2] = acc[lane][:2] + b1p[c:c + 2]
            T[g + 8, c:c + 2] = acc[lane][2:] + b1p[c:c + 2]
    assert np.array_equal(T[:, :A1], X.astype(np.float64) @ wt + b1)
    assert (T[:, A1:] == 0).all()


# ---- the split weights in shared memory: one 16-byte load a B fragment

def _split_mat(W, rows, P):
    """``stage_split``: W [K][N] as [rows][P] chunks (hi W[k][n], hi W[k+1][n],
    lo W[k][n], lo W[k+1][n]), chunk k / 2 of row n at (k / 2) ^ (4 (n & 1))."""
    K, N = W.shape
    out = np.zeros((rows, P, 4), np.float32)
    for n in range(rows):
        for q in range(P):
            k = 2 * q
            x = [W[k, n] if n < N and k < K else 0.0, W[k + 1, n] if n < N and k + 1 < K else 0.0]
            hi, lo = _split(np.array(x, np.float32))
            out[n, q ^ ((n & 1) << 2)] = [hi[0], hi[1], lo[0], lo[1]]
    return out


@pytest.mark.parametrize("K,N", [(64, 128), (128, 64), (16, 64), (24, 64)])
def test_split_weights_give_each_lane_its_fragment_without_bank_conflicts(K, N):
    """``SplitMat::frag``: lane (g, t) of an n8 tile at column n0 and k-step k0
    reads chunk ((k0 + 2t) / 2) ^ (4 (n & 1)) of row n = n0 + g and finds the hi
    and lo parts of W[k0 + 2t][n], W[k0 + 2t + 1][n]; the 8 lanes of a
    quarter-warp (one 128-byte wavefront) touch 8 different 16-byte bank groups."""
    rng = np.random.default_rng(K + N)
    W = rng.normal(size=(K, N)).astype(np.float32)
    P = -(-(_round8(K) // 2) // 8) * 8
    S = _split_mat(W, _round8(N), P)
    for n0 in range(0, _round8(N), 8):
        for k0 in range(0, _round8(K), 8):
            for quarter in range(4):
                groups = []
                for lane in range(8 * quarter, 8 * quarter + 8):
                    g, t = divmod(lane, 4)
                    n, k = n0 + g, k0 + 2 * t
                    chunk = n * P + ((k >> 1) ^ ((n & 1) << 2))
                    groups.append(chunk % 8)
                    hi, lo = _split(np.array([W[k, n] if k < K else 0, W[k + 1, n] if k + 1 < K else 0],
                                             np.float32))
                    assert S.reshape(-1, 4)[chunk].tolist() == [hi[0], hi[1], lo[0], lo[1]]
                assert sorted(groups) == list(range(8))


# ---- the AFM forward: a row's 15 pairs as an m16 tile

def _pair_i(p):  # afm_attention.cu's pair_i, pair_j
    return 0 if p < 5 else 1 if p < 9 else 2 if p < 12 else 3 if p < 14 else 4


def _pair_j(p):
    return p + 1 - (0 if p < 5 else 4 if p < 9 else 7 if p < 12 else 9 if p < 14 else 10)


def test_pair_order_is_the_plain_versions():
    pairs = [(_pair_i(p), _pair_j(p)) for p in range(15)]
    assert pairs == list(itertools.combinations(range(6), 2))
    e = torch.arange(6.0).reshape(1, 6, 1) + 1
    from deeplearningrecommendationsystem_tpu_torch.ops.interactions import pairwise_products
    assert pairwise_products(e)[0, :, 0].tolist() == [(i + 1) * (j + 1) for i, j in pairs]


def _afm_row_z(E, W):
    """``pool_rows``' products for one row of fields E [6, D]: z [16, A] (row 15
    zeros) from lanes that form c = e_i e_j for pairs g and g + 8 at their k
    slots, and B fragments of W's transposed, pre-split copy."""
    D, A = W.shape
    Dk, Ak = _round8(D), _round8(A)
    Ep, WT = _pad(E, (6, Dk)), _pad(W, (Dk, Ak)).T.copy()
    Z = np.zeros((16, Ak), np.float32)
    for n0 in range(0, Ak, 8 * PANEL):
        nt = min(PANEL, (Ak - n0) // 8)
        acc = [np.zeros((32, 4), np.float32) for _ in range(nt)]
        for k0 in range(0, Dk, 8):
            a = []
            for lane in range(32):
                g, t = divmod(lane, 4)
                k = k0 + 2 * t
                ca = Ep[_pair_i(g), k:k + 2] * Ep[_pair_j(g), k:k + 2]
                cb = Ep[_pair_i(g + 8), k:k + 2] * Ep[_pair_j(g + 8), k:k + 2] if g < 7 else np.zeros(2)
                a.append([ca[0], cb[0], ca[1], cb[1]])
            a = np.array(a, np.float32)
            for j in range(nt):
                b = [_b_pair(WT, n0 + 8 * j + lane // 4, k0 + 2 * (lane % 4)) for lane in range(32)]
                _mma3(acc[j], a, np.array(b, np.float32))
        for j in range(nt):
            Z[:, n0 + 8 * j:n0 + 8 * j + 8] = _c_matrix(acc[j])
    return Z


# (D, A): the AFM preset, the CUDA tests' widths (7 and 5 need padding), A 128
# (two panels) and widths that are multiples of 4 only
AFM_WIDTHS = [(128, 64), (32, 16), (7, 5), (64, 128), (12, 20), (20, 12)]


@pytest.mark.parametrize("D,A", AFM_WIDTHS)
def test_afm_fragments_reproduce_the_pair_products(D, A):
    rng = np.random.default_rng(D + 1000 * A)
    E, W = _ints(rng, (6, D)), _ints(rng, (D, A))
    cross = np.stack([E[i] * E[j] for i, j in itertools.combinations(range(6), 2)]).astype(np.float64)
    Z = _afm_row_z(E, W)
    assert np.array_equal(Z[:15, :A], cross @ W)
    assert (Z[15] == 0).all() and (Z[:, A:] == 0).all()


# ---- accuracy: 3xTF32 against single-pass TF32, at the presets' widths

def _mm(X, Y, passes, init=None):
    """X [M, K] @ Y [K, N] as the kernels sum it: k-steps of 8, each step's
    products exact and added to a float32 accumulator once a pass."""
    K = X.shape[1]
    Kp = _round8(K)
    X, Y = _pad(X, (X.shape[0], Kp)), _pad(Y, (Kp, Y.shape[1]))
    xh, xl = _split(X)
    yh, yl = _split(Y)
    acc = np.zeros((X.shape[0], Y.shape[1]), np.float32) if init is None else init.astype(np.float32)
    terms = [(xl, yh), (xh, yl), (xh, yh)] if passes == 3 else [(xh, yh)]
    for k0 in range(0, Kp, 8):
        for a, b in terms:
            acc = (acc + a[:, k0:k0 + 8].astype(np.float64) @ b[k0:k0 + 8]).astype(np.float32)
    return acc


def _softmax(s, axis):
    e = np.exp(s - s.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


def _din_model(hist, tgt, att, passes):
    B, L, D = hist.shape
    w1 = att[0]["w"].numpy()
    wh, wt = w1[:D] + w1[D:2 * D], w1[2 * D:] - w1[D:2 * D]
    b1, w2, b2 = att[0]["b"].numpy(), att[1]["w"].numpy(), att[1]["b"].numpy()
    w3 = att[2]["w"].numpy()[:, 0]
    T = _mm(tgt, wt, passes) + b1
    z1 = _mm(hist.reshape(B * L, D), wh, passes, init=np.repeat(T, L, axis=0))
    z2 = _mm(np.maximum(z1, 0), w2, passes) + b2
    s = (np.maximum(z2, 0).astype(np.float64) @ w3).astype(np.float32).reshape(B, L)
    return np.einsum("bl,bld->bd", _softmax(s, 1), hist)


def _afm_model(fields, W, b, h, passes):
    cross = np.stack([fields[:, i] * fields[:, j] for i, j in itertools.combinations(range(6), 2)], 1)
    B, P, D = cross.shape
    z = _mm(cross.reshape(B * P, D), W, passes) + b
    s = (np.maximum(z, 0).astype(np.float64) @ h[:, 0]).astype(np.float32).reshape(B, P)
    return np.einsum("bp,bpd->bd", _softmax(s, 1), cross)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_din_pool_3xtf32_meets_the_limit_and_tf32_does_not():
    rng = np.random.default_rng(11)
    B, L, D, A = 300, 10, 64, (128, 64, 1)  # the DIN preset's widths
    att = mlp_init(torch.Generator().manual_seed(11), (3 * D,) + A)
    hist = (0.5 * rng.normal(size=(B, L, D))).astype(np.float32)
    tgt = (0.5 * rng.normal(size=(B, D))).astype(np.float32)
    want = din_attention_pool_plain(torch.from_numpy(hist), torch.from_numpy(tgt), att).numpy()
    assert _rel(_din_model(hist, tgt, att, passes=3), want) <= LIMIT
    assert _rel(_din_model(hist, tgt, att, passes=1), want) > LIMIT


def test_afm_pool_3xtf32_meets_the_limit_and_tf32_does_not():
    rng = np.random.default_rng(12)
    B, D, A = 300, 128, 64  # the AFM preset's widths
    fields = (0.1 * rng.normal(size=(B, 6, D))).astype(np.float32)
    W, b, h = (rng.normal(size=s).astype(np.float32) for s in ((D, A), (A,), (A, 1)))
    want = afm_attention_pool_plain(*(torch.from_numpy(x) for x in (fields, W, b, h))).numpy()
    assert _rel(_afm_model(fields, W, b, h, passes=3), want) <= LIMIT
    assert _rel(_afm_model(fields, W, b, h, passes=1), want) > LIMIT


# ---- the AFM backward: dc = dz W^T with dz handed from z's C fragments

def _afm_dz(Z, ds, b, h):
    """dz [16, Ak] = (z + b > 0) ds_p h, float32, as ``row_backward`` forms it
    (pair 15's ds is 0)."""
    Ak = Z.shape[1]
    bp, hp = _pad(b, (Ak,)), _pad(h, (Ak,))
    dsr = _pad(ds, (16,))
    zp = np.maximum((Z + bp).astype(np.float32), 0)
    return np.where(zp > 0, (dsr[:, None] * hp).astype(np.float32), 0).astype(np.float32)


def _afm_row_dc(Z, ds, b, h, W, permuted_rows=True):
    """``row_backward``'s dc [16, Dc] (no w g term) from lanes: each n8 tile of
    z's C fragments (c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8,
    2t + 1)) becomes dz and is handed on as the A fragment of the k-step over
    those 8 columns of A, a0 = c0, a1 = c2, a2 = c1, a3 = c3, so slot t takes
    column 2t and slot t + 4 column 2t + 1; W^T's B fragment of column d holds
    W[d][2t], W[d][2t + 1] (``permuted_rows``), else the unpermuted W[d][t],
    W[d][t + 4]."""
    D, A = W.shape
    Ak, Dc = Z.shape[1], -(-D // 32) * 32
    Wp = _pad(W, (Dc, Ak))
    dz = _afm_dz(Z, ds, b, h)
    dc = np.zeros((16, Dc), np.float32)
    for d0 in range(0, Dc, 8):
        acc = np.zeros((32, 4), np.float32)
        for n0 in range(0, Ak, 8):
            a, bf = [], []
            for lane in range(32):
                g, t = divmod(lane, 4)
                c = n0 + 2 * t
                cfrag = [dz[g, c], dz[g, c + 1], dz[g + 8, c], dz[g + 8, c + 1]]
                a.append([cfrag[0], cfrag[2], cfrag[1], cfrag[3]])
                d = d0 + g
                bf.append(_b_pair(Wp, d, c) if permuted_rows else [Wp[d, n0 + t], Wp[d, n0 + t + 4]])
            _mma3(acc, np.array(a, np.float32), np.array(bf, np.float32))
        dc[:, d0:d0 + 8] = _c_matrix(acc)
    return dc


AFM_BWD_WIDTHS = [(128, 64), (32, 16), (7, 5), (64, 128), (36, 20), (20, 12)]


@pytest.mark.parametrize("D,A", AFM_BWD_WIDTHS)
def test_afm_backward_hand_off_reproduces_dc(D, A):
    """Integer-valued inputs (b half-integers, so no z + b is 0): every product
    exact, so the lanes must give W dz bit for bit; normal inputs at float32:
    within 1e-5 of the largest |dc| of the float64 product."""
    rng = np.random.default_rng(D + 7 * A)
    E, W = _ints(rng, (6, D)), _ints(rng, (D, A))
    b = (_ints(rng, (A,)) + 0.5).astype(np.float32)
    h, ds = _ints(rng, (A,)), _ints(rng, (15,))
    Z = _afm_row_z(E, W)
    dz = _afm_dz(Z, ds, b, h)
    want = (dz.astype(np.float64) @ _pad(W, (W.shape[0], Z.shape[1])).T.astype(np.float64))
    got = _afm_row_dc(Z, ds, b, h, W)
    assert np.array_equal(got[:, :D], want) and (got[15] == 0).all() and (got[:, D:] == 0).all()

    E = rng.normal(size=(6, D)).astype(np.float32)
    W = rng.normal(size=(D, A)).astype(np.float32)
    b, h = rng.normal(size=A).astype(np.float32), rng.normal(size=A).astype(np.float32)
    ds = (0.1 * rng.normal(size=15)).astype(np.float32)
    Z = _afm_row_z(E, W)
    dz = _afm_dz(Z, ds, b, h)
    want = dz.astype(np.float64) @ _pad(W, (W.shape[0], Z.shape[1])).T.astype(np.float64)
    got = _afm_row_dc(Z, ds, b, h, W)[:, :D]
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_afm_backward_hand_off_needs_the_permuted_rows():
    rng = np.random.default_rng(5)
    E, W = _ints(rng, (6, 32)), _ints(rng, (32, 16))
    b = (_ints(rng, (16,)) + 0.5).astype(np.float32)
    h, ds = _ints(rng, (16,)), _ints(rng, (15,))
    Z = _afm_row_z(E, W)
    assert not np.array_equal(_afm_row_dc(Z, ds, b, h, W, permuted_rows=False),
                              _afm_row_dc(Z, ds, b, h, W))
