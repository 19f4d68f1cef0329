"""DIN's full-history catalog scorer (``ops/din_full_history.py``,
``csrc/din_full_history.cu``).

On the CPU:

* ``full_history_route`` takes the DIN preset and refuses bf16 weights, a
  third attention layer, odd widths, an embedding past 64 and an fc head of
  another depth; DIEN never reaches it;
* DIN's ``score_catalog`` over full histories takes the route and, on CPU
  tensors, gives the bucketed scorer's scores bit for bit;
* the kernel modelled in float64 (``kernel_model``): each warp unit's scores
  lane by lane under the m16n8k8 fragment layout, with the kernel's k-slot
  permutation and w2's split, swizzled layout; then its online softmax and
  pool, two positions a step, the second of an odd last step at -inf. It must
  equal the masked softmax pool (``attention_pool``) at ragged lengths;
* the snake that deals the units to the warps covers every unit once, and a
  warp's units grow from round to round (the kernel stops a warp at its first
  unit past the end);
* ``pack_histories`` (CSR, longest history first within each chunk of users,
  an empty history as item 0) and ``positions_scored``: sum of
  ceil(len / step) step times ceil(I / tile) tile;
* ``users_per_launch`` (the fewest even chunks of users whose pooled and
  target rows fit the budget) and ``products_needed`` (the products the
  scorer needs, the first layer once per item).

Marked ``cuda`` (skipped without a card; on the card with ``python -m pytest
--noconftest -p no:cacheprovider -m cuda tests/test_torch_din_full_history.py``):
the kernel against its plain version at histories of 1, 15, 16, 17, 31 and 700
positions and an empty one, an item count that is not a multiple of the item
tile, the preset's widths and D 32, A (64, 32); two launches a call; the same
bits twice; users split into chunks by a small budget, two launches a chunk
and the same bits as one chunk; the library's ``fits`` against the launcher's; the launcher's
checks; ``score_catalog`` on the card through the kernel. This file imports
neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu_torch.models import DIEN, DIN, ServingContext
from deeplearningrecommendationsystem_tpu_torch.models import din as din_module
from deeplearningrecommendationsystem_tpu_torch.models.base import catalog_scores_full_history
from deeplearningrecommendationsystem_tpu_torch.models.common import layer_list, nest
from deeplearningrecommendationsystem_tpu_torch.ops import din_full_history as dfh
from deeplearningrecommendationsystem_tpu_torch.ops.attention import attention_pool
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import din_full_history as cuda_dfh
from deeplearningrecommendationsystem_tpu_torch.ops.linear import mlp_init

PRESET = (64, (128, 64, 1), (256, 128, 1))  # D, attention units, fc units
NARROW = (32, (64, 32, 1), (64, 32, 1))


def _nets(D, A, F, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    item = (0.5 * torch.randn((1, D), generator=gen)).to(dtype)  # replaced where the rows matter
    return item, mlp_init(gen, (3 * D,) + tuple(A), dtype), mlp_init(gen, (2 * D,) + tuple(F), dtype)


# ------------------------------------------------------------------ the route

def test_route_takes_the_preset():
    assert dfh.full_history_route(*_nets(*PRESET))
    assert dfh.full_history_route(*_nets(*NARROW))


@pytest.mark.parametrize("case", ["bf16", "third_attention_layer", "odd_width", "wide_embedding",
                                  "fc_depth", "no_attention_bias", "attention_out_2"])
def test_route_refuses(case):
    D, A, F = PRESET
    dtype = torch.float32
    if case == "bf16":
        dtype = torch.bfloat16
    elif case == "third_attention_layer":
        A = (128, 64, 32, 1)
    elif case == "odd_width":
        A = (126, 64, 1)
    elif case == "wide_embedding":
        D = 72
    elif case == "fc_depth":
        F = (256, 1)
    elif case == "attention_out_2":
        A = (128, 64, 2)
    item, att, fc = _nets(D, A, F, dtype)
    if case == "no_attention_bias":
        del att[1]["b"]
    assert not dfh.full_history_route(item, att, fc)


def _histories(U, I, lengths=None, seed=0):
    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = rng.integers(1, 40, U)
    return [rng.integers(0, I, n).astype(np.int32) for n in lengths]


def test_din_score_catalog_takes_the_route_and_the_plain_version_on_cpu(monkeypatch):
    """On CPU tensors the route's wrapper takes its plain version: the bucketed
    scorer over DIN's own ``apply_full``, bit for bit."""
    I, U = 90, 7
    model = DIN(I, 16, (32, 16, 1), (64, 32, 1), device="cpu")
    histories = _histories(U, I, [1, 0, 3, 17, 40, 2, 9])
    taken = []
    route = din_module.full_history_route
    monkeypatch.setattr(din_module, "full_history_route",
                        lambda *a: taken.append(route(*a)) or taken[-1])
    ctx = ServingContext(torch.zeros((U, 24)), torch.zeros((I, 19)), full_histories=histories)
    with torch.no_grad():
        got = model.score_catalog(ctx)
        want = catalog_scores_full_history(
            model.apply_full, model.params(), histories, I, "cpu",
            embed_fn=lambda p, h: p["item"][h], apply_embedded_fn=model.apply_full_embedded)
    assert taken == [True]
    assert torch.equal(got, want)


def test_bf16_din_and_dien_take_the_generic_scorer(monkeypatch):
    def refuse(*_):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(din_module, "din_full_history_scores", refuse)
    monkeypatch.setattr(dfh, "full_history_route", refuse)  # DIEN must not reach it at all
    I, U = 60, 4
    histories = _histories(U, I, [3, 1, 12, 5])
    ctx = ServingContext(torch.zeros((U, 24)), torch.zeros((I, 19)), full_histories=histories)
    din = DIN(I, 16, (32, 16, 1), (64, 32, 1), device="cpu").to(torch.bfloat16)
    dien = DIEN(I, device="cpu")
    with torch.no_grad():
        assert din.score_catalog(ctx).shape == (U, I)
        assert dien.score_catalog(ctx).shape == (U, I)


# ------------------------------------------------------------------ the kernel's model

STEP, TILE, PANEL = cuda_dfh.POSITION_STEP, cuda_dfh.ITEM_TILE, 8


def _split_w2(w2, A1p, A2p):
    """stage_w2's storage: chunk (w2[k][n], w2[k + 1][n]) of row n at
    n P2 + ((k / 2) ^ (4 (n & 1))), zeros past the widths."""
    A1, A2 = w2.shape
    P2 = -(-(A1p // 2) // 8) * 8
    store = np.zeros((A2p * P2, 2))
    for n in range(A2p):
        for q in range(P2):
            k = 2 * q
            if n < A2 and k < A1:
                store[n * P2 + (q ^ ((n & 1) << 2))] = w2[k, n], w2[k + 1, n]
    return store, P2


def _lane_scores(hw_rows, tw, w2, b2, w3):
    """step_scores lane by lane: sc [kStep][16] of the unit's 16 items (rows of
    tw [16, A1]) at the step's positions (hw_rows [kStep, A1]), through the
    m16n8k8 fragments as the PTX ISA lays them out."""
    A1, A2 = w2.shape
    A1p, A2p = -(-A1 // 8) * 8, -(-A2 // 64) * 64
    store, P2 = _split_w2(w2, A1p, A2p)
    b2p, w3p = np.zeros(A2p), np.zeros(A2p)
    b2p[:A2], w3p[:A2] = b2, w3
    col = lambda row, k: row[k] if k < A1 else 0.0  # noqa: E731
    part = np.zeros((STEP, 32, 2))
    for n2 in range(0, A2p, 8 * PANEL):
        acc = np.zeros((STEP, PANEL, 32, 4))
        for k0 in range(0, A1p, 8):
            for m in range(STEP):
                A = np.zeros((16, 8))
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    z = lambda r, k: max(col(hw_rows[m], k) + col(tw[r], k), 0.0)  # noqa: E731
                    regs = [z(g, k0 + 2 * t), z(g + 8, k0 + 2 * t),
                            z(g, k0 + 2 * t + 1), z(g + 8, k0 + 2 * t + 1)]
                    for (r, c), v in zip(((g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)), regs):
                        A[r, c] = v
                for j in range(PANEL):
                    B = np.zeros((8, 8))
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        n, k = n2 + 8 * j + g, k0 + 2 * t
                        b0, b1 = store[n * P2 + ((k >> 1) ^ ((n & 1) << 2))]
                        B[t, g], B[t + 4, g] = b0, b1
                    C = A @ B
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        acc[m, j, lane] += [C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t],
                                            C[g + 8, 2 * t + 1]]
        for j in range(PANEL):
            for lane in range(32):
                t = lane % 4
                c = n2 + 8 * j + 2 * t
                for m in range(STEP):
                    z = acc[m, j, lane]
                    part[m, lane, 0] += (max(z[0] + b2p[c], 0) * w3p[c]
                                         + max(z[1] + b2p[c + 1], 0) * w3p[c + 1])
                    part[m, lane, 1] += (max(z[2] + b2p[c], 0) * w3p[c]
                                         + max(z[3] + b2p[c + 1], 0) * w3p[c + 1])
    for sh in (1, 2):  # __shfl_xor_sync over the quad
        part = part + part[:, [lane ^ sh for lane in range(32)]]
    sc = np.zeros((STEP, 16))
    for lane in range(32):
        g = lane // 4
        for m in range(STEP):
            assert part[m, lane, 0] == part[m, lane & ~3, 0]  # every lane of the quad agrees
            sc[m, g], sc[m, g + 8] = part[m, lane]
    return sc


def kernel_model(item, att, hist, items):
    """score_unit in float64: pooled [len(items), D] of the items against
    ``hist``, the step's scores from ``_lane_scores`` (or, for a long history,
    the same sums written as products), the softmax online, two positions a
    step."""
    D = item.shape[1]
    w1 = att[0]["w"].numpy()
    hw = item @ (w1[:D] + w1[D:2 * D])
    tw = item @ (w1[2 * D:] - w1[D:2 * D]) + att[0]["b"].numpy()
    w2, b2, w3 = att[1]["w"].numpy(), att[1]["b"].numpy(), att[2]["w"].numpy()[:, 0]
    lane_level = len(hist) <= 6
    rows = np.zeros((TILE, tw.shape[1]))
    rows[:len(items)] = tw[items]
    n = len(hist)
    mx, den = np.full(TILE, -np.inf), np.zeros(TILE)
    pool = np.zeros((TILE, D))
    for p in range(0, n, STEP):
        ids = [hist[p], hist[p + 1] if p + 1 < n else hist[p]]
        if lane_level:
            sc = _lane_scores(hw[ids], rows, w2, b2, w3)
        else:
            sc = np.stack([np.maximum(np.maximum(hw[i] + rows, 0) @ w2 + b2, 0) @ w3 for i in ids])
        if p + 1 >= n:
            sc[1] = -np.inf
        m = np.maximum(mx, np.maximum(sc[0], sc[1]))
        scale, p0, p1 = np.exp(mx - m), np.exp(sc[0] - m), np.exp(sc[1] - m)
        den = den * scale + p0 + p1
        pool = pool * scale[:, None] + p0[:, None] * item[ids[0]] + p1[:, None] * item[ids[1]]
        mx = m
    return (pool / den[:, None])[:len(items)]


@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 15, 16, 17, 31, 700])
def test_kernel_model_equals_the_masked_softmax_pool(n):
    """The model's online softmax and pool at a ragged length equal
    ``attention_pool`` over the history right-padded to 704 positions and
    masked (float64); the lane-level scores at n <= 6, among them one
    position (the second at -inf) and an odd last step."""
    D, A, _ = NARROW
    I = 40
    gen = torch.Generator().manual_seed(n)
    att = [{k: v.double() for k, v in layer.items()} for layer in mlp_init(gen, (3 * D,) + A)]
    att[2]["b"] = torch.full((1,), 0.7, dtype=torch.float64)  # cancels in the softmax
    item = 0.5 * torch.randn((I, D), generator=gen, dtype=torch.float64)
    rng = np.random.default_rng(n)
    hist = rng.integers(0, I, n)
    items = np.arange(11)  # a unit's tail: 11 of 16 rows
    got = kernel_model(item.numpy(), att, hist, items)
    L = 704
    padded = np.zeros(L, np.int64)
    padded[:n] = hist
    hist_e = item[torch.from_numpy(padded)][None].expand(len(items), L, D)
    mask = (torch.arange(L) < n)[None].expand(len(items), L)
    want = attention_pool(att, hist_e, item[torch.from_numpy(items)], mask)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-14)


def _snake(W, units):
    """The units of each of W warps, as din_full_history_kernel deals them."""
    out = []
    for me in range(W):
        mine, r = [], 0
        while True:
            e = r * W + (W - 1 - me if r & 1 else me)
            if e >= units:
                break
            mine.append(e)
            r += 1
        out.append(mine)
    return out


@pytest.mark.parametrize("W,units", [(1, 5), (8, 8), (8, 61), (1056, 943 * 106), (24, 23)])
def test_snake_deals_every_unit_once(W, units):
    dealt = _snake(W, units)
    flat = sorted(e for mine in dealt for e in mine)
    assert flat == list(range(units))
    assert all(mine == sorted(mine) for mine in dealt)


def test_pack_histories_and_positions_scored():
    histories = [np.array([5, 1, 2], np.int32), np.array([], np.int32), np.array([7], np.int64),
                 np.arange(17, dtype=np.int32), np.array([3, 3], np.int32)]
    lengths = dfh.history_lengths(histories)
    assert lengths.tolist() == [3, 1, 1, 17, 2]
    U = len(histories)
    packed = np.full(2 * U + 1 + 24, -1, np.int32)
    dfh.pack_histories(histories, lengths, U, packed)
    offsets, order, ids = packed[:U + 1], packed[U + 1:2 * U + 1], packed[2 * U + 1:]
    assert offsets.tolist() == [0, 3, 4, 5, 22, 24]
    assert order.tolist() == [3, 0, 4, 1, 2]  # longest first, ties in user order
    assert ids[3] == 0  # the empty history: one position of item 0
    for u, h in enumerate(histories):
        if len(h):
            assert ids[offsets[u]:offsets[u + 1]].tolist() == h.tolist()
    for I in (1, 16, 17, 1682):
        want = sum(-(-n // STEP) * STEP for n in (3, 1, 1, 17, 2)) * (-(-I // TILE) * TILE)
        assert dfh.positions_scored(lengths, I) == want
    assert dfh.positions_scored(lengths, 1682) == (4 + 2 + 2 + 18 + 2) * 1696


def test_pack_histories_in_chunks():
    """With chunks of two users, each chunk's users longest first, numbered
    from the chunk's first; offsets and ids as in one chunk."""
    lengths = np.array([3, 1, 1, 17, 2, 9, 9], np.int64)
    histories = [np.arange(n, dtype=np.int32) for n in lengths]
    U, N = len(histories), int(lengths.sum())
    whole, chunked = (np.full(2 * U + 1 + N, -1, np.int32) for _ in range(2))
    dfh.pack_histories(histories, lengths, U, whole)
    dfh.pack_histories(histories, lengths, 2, chunked)
    assert chunked[U + 1:2 * U + 1].tolist() == [0, 1, 1, 0, 1, 0, 0]
    assert np.array_equal(np.delete(chunked, np.s_[U + 1:2 * U + 1]),
                          np.delete(whole, np.s_[U + 1:2 * U + 1]))


@pytest.mark.parametrize("U,I,D,budget,want", [
    (943, 1682, 64, 1 << 29, 472),  # ml-100k: two chunks of 472 and 471 users
    (943, 1682, 64, 1 << 40, 943),  # one launch
    (10, 8, 4, 3 * 2 * 4 * 8 * 4, 3),  # room for 3: 4 chunks of 3, 3, 3, 1
    (9, 8, 4, 4 * 2 * 4 * 8 * 4, 3),  # room for 4: 3 chunks of 3, not 4, 4, 1
    (5, 10 ** 6, 64, 1, 1),  # no room even for one: one user a launch
])
def test_users_per_launch(monkeypatch, U, I, D, budget, want):
    monkeypatch.setattr(cuda_dfh, "ROW_BUDGET", budget)
    users = cuda_dfh.users_per_launch(U, I, D)
    assert users == want
    assert 2 * 4 * I * D * users <= budget or users == 1
    assert -(-U // users) == -(-U // max(1, budget // (2 * 4 * I * D)))  # the fewest chunks


def test_products_needed():
    """HW and TW once per item, the second layer a (position, item), the fc
    head a (user, item); at ml-100k's 100,000 positions, 943 users and 1,682
    items with the preset's widths, about 2.99e12."""
    lengths = np.array([3, 1, 17], np.int64)
    D, A, F = 8, (12, 4), (16, 8)
    I = 5
    want = (21 * I * (2 * 12 * 4 + 2 * 4) + 3 * I * (2 * 16 * 16 + 2 * 16 * 8 + 2 * 8)
            + 2 * 2 * I * D * 12)
    assert dfh.products_needed(lengths, I, D, A, F) == want
    n = dfh.products_needed(np.full(943, 100_000 / 943), 1682, 64, (128, 64), (256, 128))
    assert 2.98e12 < n < 3.0e12


def test_fits_from_the_widths():
    assert cuda_dfh.fits(64, 128, 64) and cuda_dfh.fits(32, 64, 32) and cuda_dfh.fits(4, 4, 4)
    assert not cuda_dfh.fits(68, 128, 64)  # the pooled columns a lane holds
    assert not cuda_dfh.fits(64, 130, 64)  # not a multiple of 4
    assert not cuda_dfh.fits(64, 512, 128)  # the split w2 alone is 256 KB


# ------------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(cuda, I, D, A, F, seed):
    gen = torch.Generator().manual_seed(seed)
    att = [{k: v.to(cuda) for k, v in layer.items()} for layer in mlp_init(gen, (3 * D,) + A)]
    fc = [{k: v.to(cuda) for k, v in layer.items()} for layer in mlp_init(gen, (2 * D,) + F)]
    item = (0.3 * torch.randn((I, D), generator=gen)).to(cuda)
    return item, att, fc


CARD_CASES = {  # (I, widths, history lengths); 0 is an empty history
    "edges": (203, PRESET, [1, 15, 16, 17, 31, 700, 0, 2, 3]),
    "narrow": (203, NARROW, [1, 15, 16, 17, 31, 700, 0]),
    "many_users": (1682, PRESET, list(np.random.default_rng(1).integers(1, 300, 150))),
    "one_item": (1, NARROW, [5, 1]),
}


def _close(got, want, rtol=1e-5):
    """Within rtol of the largest |score|: float32 sums in another order, the
    softmax online and the second layer in 3xTF32."""
    err = float((got - want).abs().max())
    assert err <= rtol * float(want.abs().max()), (err, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_plain(cuda, case):
    I, (D, A, F), lengths = CARD_CASES[case]
    item, att, fc = _card_inputs(cuda, I, D, A, F, seed=len(lengths))
    histories = _histories(len(lengths), I, lengths, seed=I)
    before = cuda_dfh.din_full_history_scores.launches
    got = dfh.din_full_history_scores(item, att, fc, histories)
    torch.cuda.synchronize()
    assert cuda_dfh.din_full_history_scores.launches == before + 2
    assert got.shape == (len(lengths), I) and got.dtype == torch.float32
    _close(got, dfh.din_full_history_scores_plain(item, att, fc, histories))
    assert torch.equal(dfh.din_full_history_scores(item, att, fc, histories), got)


@pytest.mark.cuda
def test_kernel_in_chunks_of_users(cuda, monkeypatch):
    """A budget with room for 3 users' pooled and target rows splits 10 users
    into 4 launch pairs (3, 3, 3, 1), each chunk its own longest first: the
    same bits as one launch pair, and the plain version's scores."""
    I, (D, A, F) = 203, NARROW
    lengths = [1, 700, 0, 17, 31, 16, 2, 15, 300, 3]
    item, att, fc = _card_inputs(cuda, I, D, A, F, seed=3)
    histories = _histories(len(lengths), I, lengths, seed=5)
    whole = dfh.din_full_history_scores(item, att, fc, histories)
    monkeypatch.setattr(cuda_dfh, "ROW_BUDGET", 3 * 2 * 4 * I * D)
    assert cuda_dfh.users_per_launch(len(lengths), I, D) == 3
    before = cuda_dfh.din_full_history_scores.launches
    got = dfh.din_full_history_scores(item, att, fc, histories)
    torch.cuda.synchronize()
    assert cuda_dfh.din_full_history_scores.launches == before + 2 * 4
    _close(got, dfh.din_full_history_scores_plain(item, att, fc, histories))
    assert torch.equal(got, whole)


@pytest.mark.cuda
def test_library_fits_matches_the_launcher(cuda):
    lib = cuda_dfh._lib()
    for D in (4, 8, 32, 60, 64, 68):
        for A1 in (4, 12, 64, 128, 260, 512):
            for A2 in (4, 36, 64, 128, 256):
                assert bool(lib.din_full_history_fits(D, A1, A2)) == cuda_dfh.fits(D, A1, A2)


@pytest.mark.cuda
def test_launcher_checks_its_inputs(cuda):
    item, att, fc = _card_inputs(cuda, 30, 16, (32, 16, 1), (32, 16, 1), seed=0)
    histories = _histories(3, 30, [2, 5, 1])
    packed = np.empty(3 * 2 + 1 + 8, np.int32)
    dfh.pack_histories(histories, dfh.history_lengths(histories), 3, packed)
    p = torch.from_numpy(packed).to(cuda)
    offsets, order, ids = p[:4], p[4:7], p[7:]
    wide_item, wide_att, wide_fc = _card_inputs(cuda, 30, 72, (32, 16, 1), (32, 16, 1), seed=1)
    for args, err in [((offsets, order, ids, item.double(), att, fc, 3), TypeError),
                      ((offsets.long(), order, ids, item, att, fc, 3), TypeError),
                      ((offsets[:3], order, ids, item, att, fc, 3), ValueError),
                      ((offsets, order, ids, item, att[:2], fc, 3), ValueError),
                      ((offsets, order, ids, wide_item, wide_att, wide_fc, 3), ValueError),
                      ((offsets, order, ids, item.cpu(), att, fc, 3), ValueError),
                      ((offsets, order, ids, item, att, fc, 0), ValueError)]:
        with pytest.raises(err):
            cuda_dfh.din_full_history_scores(*args)
    with pytest.raises(ValueError):
        dfh.din_full_history_scores(item, att, fc, [np.array([30])])  # past the items


@pytest.mark.cuda
def test_score_catalog_on_the_card_takes_the_kernel(cuda):
    I, U = 120, 9
    model = DIN(I, 16, (32, 16, 1), (64, 32, 1), device="cpu")
    histories = _histories(U, I, [1, 0, 40, 2, 7, 70, 3, 16, 9])
    ctx = ServingContext(torch.zeros((U, 24)), torch.zeros((I, 19)), full_histories=histories)
    with torch.no_grad():
        want = model.score_catalog(ctx)
        before = cuda_dfh.din_full_history_scores.launches
        got = model.to(cuda).score_catalog(ctx.to(cuda))
    assert cuda_dfh.din_full_history_scores.launches == before + 2
    _close(got.cpu(), want)
    p = nest(model.params())
    assert not got.requires_grad and dfh.full_history_route(p["item"], layer_list(p["att"]),
                                                            layer_list(p["fc"]))
