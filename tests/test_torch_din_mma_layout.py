"""The bf16 tensor-core products of ``csrc/din_common.cuh`` (``block_mm_mma``,
``block_mm_tn_acc_mma``), modelled lane by lane in numpy on the CPU.

The CUDA code cannot run here, so these tests pin what it rests on:

* the rounding rule of its fragments (``pack_bf16``, ``__floats2bfloat162_rn``):
  ``torch``'s float32 -> bf16 cast, which the plain versions use (``op<bf16>``),
  is round to nearest, ties to even, of the top 16 bits, halfway cases,
  negatives, subnormals and the largest finite values included;
* the index algebra: each lane's A, B and C fragments under the PTX ISA's
  m16n8k16 layout, with ``block_mm_mma``'s permuted k slots and interleaved
  columns (B's bf16 words and ``__byte_perm`` selectors included), the
  kernels' zero fill past M, K and N, the epilogue (every (row, 4 columns) of
  C handed over exactly once, by one lane), and the accumulation of
  ``block_mm_tn_acc_mma`` into G. On
  integer-valued inputs every product is exact, so the model must reproduce
  ``A @ B`` and ``X^T Z`` bit for bit, at the DIN preset's products and at the
  ragged widths of the CUDA tests (``DIN_SHAPES`` in
  ``tests/test_torch_cuda_kernels.py``).
"""

import numpy as np
import pytest
import torch

MMA_NT = 2  # kMmaNT in csrc/din_common.cuh
WARPS = 16  # kThreads / 32


def _rne_top16(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bf16 (ties to even) as float32, on the bits."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return rounded.astype(np.uint32).view(np.float32)


def _pack(x: float, y: float) -> int:
    """``pack_bf16``: x and y rounded to bf16, x in the low half."""
    lo, hi = _rne_top16(np.array([x, y], np.float32)).view(np.uint32) >> 16
    return int(lo) | (int(hi) << 16)


def _unpack(r: int):
    return np.array([(r & 0xFFFF) << 16, r & 0xFFFF0000], np.uint32).view(np.float32)


def test_torch_bf16_cast_is_round_to_nearest_even_of_the_top_16_bits():
    rng = np.random.default_rng(0)
    halfway = [(hi << 16) | 0x8000 for hi in (0x3F80, 0x3F81, 0x3F82, 0x3F83, 0xBF80, 0xBF81,
                                              0x0001, 0x0002, 0x7F7E, 0x7F7D)]
    near = [(hi << 16) | lo for hi in (0x3F80, 0x4049, 0xC2F7, 0x0000, 0x8000)
            for lo in (0x0000, 0x0001, 0x7FFF, 0x8001, 0xFFFF)]
    bits = np.concatenate([np.array(halfway + near, np.uint32),
                           rng.integers(0, 0x7F7F0000, 5000, dtype=np.uint32),
                           rng.integers(0x80000000, 0xFF7F0000, 5000, dtype=np.uint32)])
    x = bits.view(np.float32)
    want = _rne_top16(x)
    got = torch.from_numpy(x.copy()).bfloat16().float().numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # ties go to the even neighbour, both ways
    assert _rne_top16(np.array([0x3F808000], np.uint32).view(np.float32)).view(np.uint32)[0] == 0x3F800000
    assert _rne_top16(np.array([0x3F818000], np.uint32).view(np.float32)).view(np.uint32)[0] == 0x3F820000


def test_pack_puts_the_lower_index_in_the_low_half():
    r = _pack(1.0, -2.0)
    assert r == (0xC000 << 16) | 0x3F80
    assert _unpack(r).tolist() == [1.0, -2.0]


def _mma(acc, a_regs, b_regs):
    """One m16n8k16 over the 32 lanes: a_regs [32][4], b_regs [32][2] packed
    registers, acc [32][4] float64 fragments, as the PTX ISA lays them out."""
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for reg, (r, c) in enumerate(((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8), (g + 8, 2 * t + 8))):
            A[r, c:c + 2] = _unpack(a_regs[lane][reg])
        for reg, k in enumerate((2 * t, 2 * t + 8)):
            B[k:k + 2, g] = _unpack(b_regs[lane][reg])
    C = A @ B
    for lane in range(32):
        g, t = lane // 4, lane % 4
        acc[lane] += [C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], C[g + 8, 2 * t + 1]]


def _byte_perm(x: int, y: int, selector: int) -> int:
    """CUDA's ``__byte_perm``: byte i of the result is byte (selector >> 4i) & 7
    of the 8 bytes y:x."""
    both = x | (y << 32)
    return sum(((both >> (8 * ((selector >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def _block_mm(A, B, trans_b):
    """``block_mm_mma``: C = A @ B (B [K][N]) or A @ B^T (B [N][K]), handed to the
    epilogue as (row, col, 4 values); returns C and how often each (row, 4
    columns) was handed over. Lane t's k slots take k0 + 4t .. k0 + 4t + 3;
    column slot c of n8 tile j is column n0 + 2c + j."""
    M, K = A.shape
    N = B.shape[0] if trans_b else B.shape[1]
    groups = -(-N // (8 * MMA_NT))
    tasks = -(-M // 16) * groups
    C = np.full((M, N), np.nan)
    seen = np.zeros((M, N // 4), int)
    Bb = _rne_top16(B).view(np.uint32) >> 16  # the bf16 bits of B as stored

    def a_regs(r, k):  # (k, k + 1) and (k + 2, k + 3) of row r
        if r >= M or k >= K:
            return 0, 0
        return _pack(A[r, k], A[r, k + 1]), _pack(A[r, k + 2], A[r, k + 3])

    def b_regs(k, nb):  # [tile j][register] for the lane's columns nb, nb + 1
        b = [[0, 0], [0, 0]]
        if k >= K:
            return b
        if trans_b:  # one 8-byte load a column: the bf16 of (nb + j, k .. k + 3)
            for j in range(2):
                if nb + j < N:
                    q = [int(v) for v in Bb[nb + j, k:k + 4]]
                    b[j] = [q[0] | (q[1] << 16), q[2] | (q[3] << 16)]
        elif nb < N:  # one 32-bit load a row: the pair (nb, nb + 1) of rows k .. k + 3
            w = [int(Bb[k + i, nb]) | (int(Bb[k + i, nb + 1]) << 16) for i in range(4)]
            b[0] = [_byte_perm(w[0], w[1], 0x5410), _byte_perm(w[2], w[3], 0x5410)]
            b[1] = [_byte_perm(w[0], w[1], 0x7632), _byte_perm(w[2], w[3], 0x7632)]
        return b

    for warp in range(WARPS):
        for task in range(warp, tasks, WARPS):
            m0, n0 = (task // groups) * 16, (task % groups) * 16
            acc = np.zeros((2, 32, 4))
            for k0 in range(0, K, 16):
                a, b = [], []
                for l in range(32):
                    g, t = l // 4, l % 4
                    (a0, a2), (a1, a3) = a_regs(m0 + g, k0 + 4 * t), a_regs(m0 + g + 8, k0 + 4 * t)
                    a.append([a0, a1, a2, a3])
                    b.append(b_regs(k0 + 4 * t, n0 + 2 * g))
                for j in range(2):
                    _mma(acc[j], a, [b[l][j] for l in range(32)])
            for lane in range(32):
                g, t = lane // 4, lane % 4
                col = n0 + 4 * t
                if col >= N:
                    continue
                for row, (i0, i1) in ((m0 + g, (0, 1)), (m0 + g + 8, (2, 3))):
                    if row < M:
                        C[row, col:col + 4] = [acc[0][lane][i0], acc[1][lane][i0],
                                               acc[0][lane][i1], acc[1][lane][i1]]
                        seen[row, col // 4] += 1
    return C, seen


def _tn_acc(X, Z, G):
    """``block_mm_tn_acc_mma``: G [K][N] += X^T Z, X [M][K] and Z [M][N]; returns
    the lane that owns each element of G."""
    M, K = X.shape
    N = Z.shape[1]
    groups = -(-N // (8 * MMA_NT))
    tasks = -(-K // 16) * groups
    owner = np.full(G.shape, -1)

    def x(m, k):
        return X[m, k] if m < M and k < K else 0.0

    def z(m, n):
        return Z[m, n] if m < M and n < N else 0.0

    for warp in range(WARPS):
        for task in range(warp, tasks, WARPS):
            k_base, n0 = (task // groups) * 16, (task % groups) * 8 * MMA_NT
            acc = np.zeros((MMA_NT, 32, 4))
            for m0 in range(0, M, 16):
                a, b = [], [[] for _ in range(MMA_NT)]
                for l in range(32):
                    g, t = l // 4, l % 4
                    ka, kb, m = k_base + g, k_base + g + 8, m0 + 2 * t
                    a.append([_pack(x(m, ka), x(m + 1, ka)), _pack(x(m, kb), x(m + 1, kb)),
                              _pack(x(m + 8, ka), x(m + 9, ka)), _pack(x(m + 8, kb), x(m + 9, kb))])
                    for j in range(MMA_NT):
                        n = n0 + 8 * j + g
                        b[j].append([_pack(z(m, n), z(m + 1, n)), _pack(z(m + 8, n), z(m + 9, n))])
                for j in range(MMA_NT):
                    _mma(acc[j], a, b[j])
            for j in range(MMA_NT):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    c = n0 + 8 * j + 2 * t
                    if c >= N:
                        continue
                    for k, vals in ((k_base + g, acc[j][lane][:2]), (k_base + g + 8, acc[j][lane][2:])):
                        if k < K:
                            G[k, c:c + 2] += vals
                            assert (owner[k, c:c + 2] == -1).all()
                            owner[k, c:c + 2] = warp * 32 + lane
    return owner


def _ints(rng, shape):
    return rng.integers(-8, 9, shape).astype(np.float32)


# (M, K, N): the DIN preset's products (16-row tiles, L 10: M 160 or 16) and the
# CUDA tests' ragged ones (L 7 with 7 rows a tile: M 49; widths 8, 12 and 20)
MM_SHAPES = [(160, 64, 128), (160, 128, 64), (16, 256, 128), (16, 64, 256),
             (49, 8, 12), (49, 12, 8), (7, 20, 12), (7, 12, 20), (7, 16, 8)]


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("M,K,N", MM_SHAPES)
def test_block_mm_fragments_reproduce_the_product(M, K, N, trans_b):
    rng = np.random.default_rng(M * 1000 + K * 10 + N)
    A = _ints(rng, (M, K))
    B = _ints(rng, (N, K) if trans_b else (K, N))
    C, seen = _block_mm(A, B, trans_b)
    assert (seen == 1).all()
    assert np.array_equal(C, A.astype(np.float64) @ (B.T if trans_b else B))


@pytest.mark.parametrize("M,K,N", MM_SHAPES)
def test_block_mm_tn_acc_fragments_reproduce_the_product(M, K, N):
    rng = np.random.default_rng(M + K + N)
    X, Z = _ints(rng, (M, K)), _ints(rng, (M, N))
    G0 = _ints(rng, (K, N)).astype(np.float64)
    G = G0.copy()
    owner = _tn_acc(X, Z, G)
    assert (owner >= 0).all()
    assert np.array_equal(G, G0 + X.T.astype(np.float64) @ Z)
    # the same lanes own the same elements on the next tile
    assert np.array_equal(_tn_acc(X, Z, G), owner)


def test_fragments_round_their_operands_to_bf16():
    """Non-integer operands enter the products rounded as ``op<bf16>`` rounds."""
    rng = np.random.default_rng(1)
    A = rng.normal(size=(20, 12)).astype(np.float32)
    B = rng.normal(size=(12, 8)).astype(np.float32)
    C, _ = _block_mm(A, B, False)
    want = _rne_top16(A).astype(np.float64) @ _rne_top16(B).astype(np.float64)
    np.testing.assert_allclose(C, want, rtol=1e-12, atol=1e-12)
